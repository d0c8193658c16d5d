"""Movie-review sentiment reader (ref: python/paddle/dataset/sentiment.py).
Yields (word_id_list, 0/1 label); deterministic synthetic corpus with a
learnable polarity signal."""
import numpy as np

__all__ = ["get_word_dict", "train", "test"]

_VOCAB = 400
_POS_BAND = range(10, 60)     # ids that signal positive
_NEG_BAND = range(200, 250)


def get_word_dict():
    return {"w%d" % i: i for i in range(_VOCAB)}


def _samples(split):
    rng = np.random.default_rng(31 if split == "train" else 32)
    n = 600 if split == "train" else 120
    for _ in range(n):
        label = int(rng.integers(0, 2))
        length = int(rng.integers(5, 25))
        words = rng.integers(0, _VOCAB, size=length)
        band = _POS_BAND if label else _NEG_BAND
        k = max(1, length // 4)
        idx = rng.choice(length, size=k, replace=False)
        words[idx] = rng.choice(list(band), size=k)
        yield [int(w) for w in words], label


def train():
    return lambda: _samples("train")


def test():
    return lambda: _samples("test")
