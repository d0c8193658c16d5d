"""WMT16 en-de reader (ref: python/paddle/dataset/wmt16.py). Yields
(src_ids, trg_ids, trg_next_ids) with <s>/<e>/<unk> framing like the
reference; synthesises a deterministic parallel corpus (zero egress)."""
import numpy as np

__all__ = ["train", "test", "validation", "get_dict"]

_VOCAB = 500


def get_dict(lang, dict_size=_VOCAB, reverse=False):
    words = ["<s>", "<e>", "<unk>"] + [
        "%s%d" % (lang, i) for i in range(dict_size - 3)
    ]
    if reverse:
        return {i: w for i, w in enumerate(words)}
    return {w: i for i, w in enumerate(words)}


def _pairs(split, src_dict_size, trg_dict_size):
    rng = np.random.default_rng(
        {"train": 21, "test": 22, "validation": 23}[split]
    )
    n = {"train": 800, "test": 150, "validation": 150}[split]
    for _ in range(n):
        slen = int(rng.integers(3, 12))
        src = rng.integers(3, src_dict_size, size=slen)
        # target = deterministic transform of source (learnable mapping)
        trg = [(int(w) * 7 + 3) % (trg_dict_size - 3) + 3 for w in src]
        if int(rng.integers(0, 2)):
            trg = trg[: max(2, slen - 1)]
        yield (
            [int(w) for w in src],
            [0] + trg,          # <s> + target
            trg + [1],          # target + <e>
        )


def _reader_creator(split, src_dict_size, trg_dict_size, src_lang):
    # src_lang selects translation direction (ref wmt16.py): "en" reads
    # en->de; "de" swaps the pair so the German side is the source.
    if src_lang not in ("en", "de"):
        raise ValueError("wmt16: src_lang must be 'en' or 'de'")
    # generate each side under the vocab that will consume it: for "de"
    # the German (generated-target) side becomes the source, so it must
    # be drawn from src_dict_size
    gen_src, gen_trg = (
        (trg_dict_size, src_dict_size) if src_lang == "de"
        else (src_dict_size, trg_dict_size)
    )

    def reader():
        for src, trg_in, trg_next in _pairs(split, gen_src, gen_trg):
            if src_lang == "de":
                de = trg_in[1:]  # strip <s> to recover the raw target side
                yield de, [0] + src, src + [1]
            else:
                yield src, trg_in, trg_next

    return reader


def train(src_dict_size=_VOCAB, trg_dict_size=_VOCAB, src_lang="en"):
    return _reader_creator("train", src_dict_size, trg_dict_size, src_lang)


def test(src_dict_size=_VOCAB, trg_dict_size=_VOCAB, src_lang="en"):
    return _reader_creator("test", src_dict_size, trg_dict_size, src_lang)


def validation(src_dict_size=_VOCAB, trg_dict_size=_VOCAB, src_lang="en"):
    return _reader_creator(
        "validation", src_dict_size, trg_dict_size, src_lang)
