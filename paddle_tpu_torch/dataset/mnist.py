"""MNIST reader (ref: python/paddle/dataset/mnist.py). Loads from
PADDLE_TPU_MNIST_DIR (idx files) when present; otherwise serves a
deterministic synthetic digit set with the same schema: (784 float32 image
in [-1, 1], int64 label)."""
import gzip
import os
import struct

import numpy as np


def _synthetic(n, seed):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, 784)).astype("float32") * 0.3
    labels = rng.integers(0, 10, size=n).astype("int64")
    # inject class-dependent signal so models can actually learn
    for i in range(n):
        c = labels[i]
        images[i, c * 78 : (c + 1) * 78] += 1.5
    images = np.clip(images, -1.0, 1.0)
    return images, labels


def _load_idx(image_path, label_path):
    with gzip.open(image_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        images = np.frombuffer(f.read(), dtype=np.uint8).reshape(n, rows * cols)
    with gzip.open(label_path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        labels = np.frombuffer(f.read(), dtype=np.uint8)
    images = images.astype("float32") / 127.5 - 1.0
    return images, labels.astype("int64")


def _reader_creator(split, n_synth, seed):
    def reader():
        d = os.environ.get("PADDLE_TPU_MNIST_DIR")
        if d:
            prefix = "train" if split == "train" else "t10k"
            images, labels = _load_idx(
                os.path.join(d, "%s-images-idx3-ubyte.gz" % prefix),
                os.path.join(d, "%s-labels-idx1-ubyte.gz" % prefix),
            )
        else:
            images, labels = _synthetic(n_synth, seed)
        for i in range(len(labels)):
            yield images[i], int(labels[i])

    return reader


def train():
    return _reader_creator("train", 8192, 7)


def test():
    return _reader_creator("test", 1024, 11)
