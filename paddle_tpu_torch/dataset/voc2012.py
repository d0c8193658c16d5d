"""Pascal VOC2012 segmentation reader (ref: python/paddle/dataset/
voc2012.py). Yields (image CHW float32, label HW int32) pairs; synthetic
deterministic scenes with consistent image/mask geometry (zero egress)."""
import numpy as np

__all__ = ["train", "test", "val"]

_CLASSES = 21  # 20 + background
_HW = 64


def _scene(rng):
    img = rng.uniform(0, 0.2, size=(3, _HW, _HW)).astype("float32")
    label = np.zeros((_HW, _HW), "int32")
    for _ in range(int(rng.integers(1, 4))):
        cls = int(rng.integers(1, _CLASSES))
        x0, y0 = rng.integers(0, _HW - 16, size=2)
        w, h = rng.integers(8, 16, size=2)
        label[y0:y0 + h, x0:x0 + w] = cls
        # objects are brighter, per-class tint so the mapping is learnable
        img[:, y0:y0 + h, x0:x0 + w] = (
            np.array([cls / _CLASSES, 1 - cls / _CLASSES, 0.5],
                     "float32")[:, None, None]
        )
    return img, label


def _creator(split):
    def reader():
        rng = np.random.default_rng(
            {"train": 61, "test": 62, "val": 63}[split]
        )
        n = {"train": 200, "test": 60, "val": 60}[split]
        for _ in range(n):
            yield _scene(rng)

    return reader


def train():
    return _creator("train")


def test():
    return _creator("test")


def val():
    return _creator("val")
