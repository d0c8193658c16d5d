"""IMDB sentiment reader (ref: python/paddle/dataset/imdb.py) — synthetic
token-sequence stand-in: word-id sequences + binary label."""
import numpy as np

VOCAB_SIZE = 5147


def word_dict():
    return {("w%d" % i).encode(): i for i in range(VOCAB_SIZE)}


def _reader(n, seed, vocab_size=VOCAB_SIZE):
    def reader():
        rng = np.random.default_rng(seed)
        for _ in range(n):
            label = int(rng.integers(0, 2))
            length = int(rng.integers(8, 64))
            base = rng.integers(0, vocab_size // 2, size=length)
            if label:  # positive reviews skew to upper vocab half
                base = base + vocab_size // 2 - 1
            yield base.astype("int64").tolist(), label

    return reader


def _vocab_size(word_idx):
    return len(word_idx) if word_idx else VOCAB_SIZE


def train(word_idx=None):
    return _reader(2048, 13, _vocab_size(word_idx))


def test(word_idx=None):
    return _reader(512, 17, _vocab_size(word_idx))
