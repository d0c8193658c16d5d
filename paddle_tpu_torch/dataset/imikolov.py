"""PTB language-model reader (ref: python/paddle/dataset/imikolov.py).
Builds a word dict and yields n-gram windows (or sequences) of word ids.
Synthesises a Zipfian corpus when PADDLE_TPU_PTB_PATH is absent."""
import os

import numpy as np

__all__ = ["build_dict", "train", "test", "NGram", "Seq"]

NGram = "ngram"
Seq = "seq"

_SYNTH_VOCAB = 1000


def _corpus(split):
    path = os.environ.get("PADDLE_TPU_PTB_PATH")
    if path:
        fname = os.path.join(
            path, "ptb.train.txt" if split == "train" else "ptb.valid.txt"
        )
        with open(fname) as f:
            for line in f:
                yield line.split()
        return
    rng = np.random.default_rng(3 if split == "train" else 4)
    zipf = rng.zipf(1.3, size=(400, 20)) % _SYNTH_VOCAB
    for row in zipf:
        yield ["w%d" % w for w in row]


def build_dict(min_word_freq=0):
    freq = {}
    for words in _corpus("train"):
        for w in words:
            freq[w] = freq.get(w, 0) + 1
    freq = {w: c for w, c in freq.items() if c > min_word_freq}
    ordered = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
    word_idx = {w: i for i, (w, _) in enumerate(ordered)}
    word_idx["<unk>"] = len(word_idx)
    return word_idx


def _reader_creator(split, word_idx, n, data_type):
    def reader():
        unk = word_idx["<unk>"]
        for words in _corpus(split):
            ids = [word_idx.get(w, unk) for w in words] + [unk]
            if data_type == NGram:
                for i in range(len(ids) - n + 1):
                    yield tuple(ids[i:i + n])
            else:
                yield ids[:-1], ids[1:]

    return reader


def train(word_idx, n, data_type=NGram):
    return _reader_creator("train", word_idx, n, data_type)


def test(word_idx, n, data_type=NGram):
    return _reader_creator("test", word_idx, n, data_type)
