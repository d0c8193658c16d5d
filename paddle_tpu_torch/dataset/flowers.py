"""Flowers-102 reader (ref: python/paddle/dataset/flowers.py). Yields
(3x224x224 float32 image, int64 label); synthetic textured images with a
class-dependent signal stand in for the real download."""
import numpy as np

__all__ = ["train", "test", "valid"]

_N_CLASSES = 102


def _samples(split, n):
    rng = np.random.default_rng({"train": 41, "test": 42, "valid": 43}[split])
    for _ in range(n):
        label = int(rng.integers(0, _N_CLASSES))
        img = rng.random((3, 224, 224)).astype("float32") * 0.3
        # class-keyed stripe pattern
        row = (label * 2) % 224
        img[:, row:row + 4, :] += 0.6
        yield np.clip(img, 0.0, 1.0), label


def _make(split, n, mapper, buffered_size, use_xmap):
    base = lambda: _samples(split, n)  # noqa: E731
    if mapper is None:
        return base
    if use_xmap:
        from ..reader_utils import xmap_readers
        return xmap_readers(mapper, base, 4, buffered_size, order=True)
    return lambda: (mapper(s) for s in base())


def train(mapper=None, buffered_size=1024, use_xmap=False):
    return _make("train", 300, mapper, buffered_size, use_xmap)


def test(mapper=None, buffered_size=1024, use_xmap=False):
    return _make("test", 60, mapper, buffered_size, use_xmap)


def valid(mapper=None, buffered_size=1024, use_xmap=False):
    return _make("valid", 60, mapper, buffered_size, use_xmap)
