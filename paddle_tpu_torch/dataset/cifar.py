"""CIFAR-10/100 readers (ref: python/paddle/dataset/cifar.py). Loads the
python-pickle batches from PADDLE_TPU_CIFAR_DIR when present, else serves a
deterministic synthetic set with the real schema: (3072 float32 image in
[0, 1] laid out CHW, int64 label)."""
import os
import pickle

import numpy as np

__all__ = ["train10", "test10", "train100", "test100"]


def _synthetic(n, n_classes, seed):
    rng = np.random.default_rng(seed)
    images = rng.random((n, 3072)).astype("float32") * 0.4
    labels = rng.integers(0, n_classes, size=n).astype("int64")
    stride = 3072 // n_classes
    for i in range(n):
        c = int(labels[i])
        images[i, c * stride:(c + 1) * stride] += 0.5
    return np.clip(images, 0.0, 1.0), labels


def _load_batches(d, names, label_key):
    images, labels = [], []
    for name in names:
        with open(os.path.join(d, name), "rb") as f:
            batch = pickle.load(f, encoding="latin1")
        images.append(np.asarray(batch["data"], "float32") / 255.0)
        labels.append(np.asarray(batch[label_key], "int64"))
    return np.concatenate(images), np.concatenate(labels)


def _reader_creator(split, n_classes, n_synth, seed):
    def reader():
        d = os.environ.get("PADDLE_TPU_CIFAR_DIR")
        if d:
            if n_classes == 10:
                names = (
                    ["data_batch_%d" % i for i in range(1, 6)]
                    if split == "train" else ["test_batch"]
                )
                images, labels = _load_batches(d, names, "labels")
            else:
                names = ["train"] if split == "train" else ["test"]
                images, labels = _load_batches(d, names, "fine_labels")
        else:
            images, labels = _synthetic(n_synth, n_classes, seed)
        for i in range(len(labels)):
            yield images[i], int(labels[i])

    return reader


def train10():
    return _reader_creator("train", 10, 2000, 7)


def test10():
    return _reader_creator("test", 10, 400, 8)


def train100():
    return _reader_creator("train", 100, 2000, 9)


def test100():
    return _reader_creator("test", 100, 400, 10)
