"""WMT14 fr-en reader (ref: python/paddle/dataset/wmt14.py). Same yield
schema — (src_ids, trg_ids, trg_next_ids) with <s>/<e>/<unk> framing —
over a deterministic synthetic parallel corpus (zero egress)."""
import numpy as np

__all__ = ["train", "test", "gen", "get_dict"]

START = "<s>"
END = "<e>"
UNK = "<unk>"
UNK_IDX = 2


def _dicts(dict_size):
    words = [START, END, UNK] + ["w%d" % i for i in range(dict_size - 3)]
    src = {w: i for i, w in enumerate(words)}
    trg = {w: i for i, w in enumerate(words)}
    return src, trg


def _samples(split, dict_size):
    rng = np.random.default_rng({"train": 41, "test": 42, "gen": 43}[split])
    n = {"train": 800, "test": 150, "gen": 50}[split]
    for _ in range(n):
        slen = int(rng.integers(3, 15))
        src = rng.integers(3, dict_size, size=slen)
        trg = [(int(w) * 11 + 5) % (dict_size - 3) + 3 for w in src]
        yield (
            [int(w) for w in src],
            [0] + trg,          # <s> + target
            trg + [1],          # target + <e>
        )


def _creator(split, dict_size):
    def reader():
        yield from _samples(split, dict_size)

    return reader


def train(dict_size):
    return _creator("train", dict_size)


def test(dict_size):
    return _creator("test", dict_size)


def gen(dict_size):
    return _creator("gen", dict_size)


def get_dict(dict_size, reverse=True):
    src, trg = _dicts(dict_size)
    if reverse:
        src = {v: k for k, v in src.items()}
        trg = {v: k for k, v in trg.items()}
    return src, trg


def fetch():
    """No-op (zero-egress): the corpus is synthesized on the fly."""
