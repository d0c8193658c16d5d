"""CoNLL-2005 SRL reader (ref: python/paddle/dataset/conll05.py). Yields the
8-slot tuple the reference's label_semantic_roles chapter consumes:
(word_ids, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, pred_ids, mark, target)."""
import numpy as np

__all__ = ["get_dict", "get_embedding", "test"]

_WORD_VOCAB = 300
_LABEL_N = 30
_PRED_VOCAB = 50


def get_dict():
    word_dict = {"w%d" % i: i for i in range(_WORD_VOCAB)}
    verb_dict = {"v%d" % i: i for i in range(_PRED_VOCAB)}
    label_dict = {"L%d" % i: i for i in range(_LABEL_N)}
    return word_dict, verb_dict, label_dict


def get_embedding():
    rng = np.random.default_rng(17)
    return rng.standard_normal((_WORD_VOCAB, 32)).astype("float32")


def _samples():
    rng = np.random.default_rng(19)
    for _ in range(200):
        n = int(rng.integers(4, 15))
        words = [int(w) for w in rng.integers(0, _WORD_VOCAB, size=n)]
        pred_pos = int(rng.integers(0, n))
        pred = [int(rng.integers(0, _PRED_VOCAB))] * n
        mark = [1 if i == pred_pos else 0 for i in range(n)]

        def ctx(off):
            return [
                words[min(max(i + off, 0), n - 1)] for i in range(n)
            ]

        labels = [
            (words[i] + pred[0] + mark[i] * 7) % _LABEL_N for i in range(n)
        ]
        yield (
            words, ctx(-2), ctx(-1), ctx(0), ctx(1), ctx(2), pred, mark,
            labels,
        )


def test():
    return _samples
