"""UCI housing reader (ref: python/paddle/dataset/uci_housing.py) —
synthetic linear-regression stand-in with the real 13-feature schema."""
import numpy as np

_W = None


def _data(n, seed):
    global _W
    rng = np.random.default_rng(seed)
    if _W is None:
        _W = np.random.default_rng(3).standard_normal(13).astype("float32")
    x = rng.standard_normal((n, 13)).astype("float32")
    y = (x @ _W + 0.1 * rng.standard_normal(n)).astype("float32")
    return x, y


def train():
    def reader():
        x, y = _data(404, 5)
        for i in range(len(y)):
            yield x[i], y[i : i + 1]

    return reader


def test():
    def reader():
        x, y = _data(102, 9)
        for i in range(len(y)):
            yield x[i], y[i : i + 1]

    return reader
