"""LoDTensor: variable-length sequence batches
(ref: paddle/fluid/framework/lod_tensor.cc, python/paddle/fluid/lod_tensor.py).
A copy of paddle_tpu/fluid/lod.py (numpy only).

Instead of ragged level-of-detail offsets interpreted by C++ kernels,
sequences are stored **dense-padded** with a companion ``seq_lens``
vector, which a feed hands to the program as the ``@SEQ_LEN`` companion
of the var (fluid/executor.py); masking ops recover the ragged semantics
(layers/sequence_lod.py).
"""
import numpy as np

__all__ = ["LoDTensor", "create_lod_tensor", "create_random_int_lodtensor"]


class LoDTensor:
    """Dense-padded batch + per-sequence lengths."""

    def __init__(self, data=None, recursive_seq_lens=None):
        self._ndarray = None if data is None else np.asarray(data)
        self._recursive_seq_lens = recursive_seq_lens or []
        self.seq_lens = None
        if recursive_seq_lens:
            self.seq_lens = np.asarray(recursive_seq_lens[-1], dtype=np.int32)

    # -- construction ---------------------------------------------------
    @staticmethod
    def from_sequences(seqs, pad_value=0):
        """Build a padded (batch, max_len, ...) tensor + lengths from a list
        of per-sample arrays of shape (len_i, ...)."""
        seqs = [np.asarray(s) for s in seqs]
        lens = np.array([s.shape[0] for s in seqs], dtype=np.int32)
        max_len = int(lens.max()) if len(lens) else 0
        trailing = seqs[0].shape[1:] if seqs else ()
        out = np.full(
            (len(seqs), max_len) + tuple(trailing),
            pad_value,
            dtype=seqs[0].dtype if seqs else np.float32,
        )
        for i, s in enumerate(seqs):
            out[i, : s.shape[0]] = s
        t = LoDTensor(out, [lens.tolist()])
        return t

    def set(self, data, place=None):
        self._ndarray = np.asarray(data)

    def set_recursive_sequence_lengths(self, lens):
        self._recursive_seq_lens = lens
        if lens:
            self.seq_lens = np.asarray(lens[-1], dtype=np.int32)

    def recursive_sequence_lengths(self):
        return self._recursive_seq_lens

    def lod(self):
        # offsets form: [0, l1, l1+l2, ...]
        out = []
        for level in self._recursive_seq_lens:
            offs = [0]
            for l in level:
                offs.append(offs[-1] + l)
            out.append(offs)
        return out

    def set_lod(self, lod):
        lens = [[b - a for a, b in zip(l[:-1], l[1:])] for l in lod]
        self.set_recursive_sequence_lengths(lens)

    def shape(self):
        return self._ndarray.shape if self._ndarray is not None else ()

    def __array__(self, dtype=None):
        arr = self._ndarray
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        return "LoDTensor(shape=%s, seq_lens=%s)" % (
            None if self._ndarray is None else self._ndarray.shape,
            None if self.seq_lens is None else self.seq_lens.tolist(),
        )


def create_lod_tensor(data, recursive_seq_lens, place=None):
    """ref python/paddle/fluid/lod_tensor.py:create_lod_tensor. Accepts a
    flat (sum_len, ...) array + lens, returns padded LoDTensor."""
    data = np.asarray(data)
    lens = list(recursive_seq_lens[-1])
    seqs = []
    off = 0
    for l in lens:
        seqs.append(data[off : off + l])
        off += l
    return LoDTensor.from_sequences(seqs)


def create_random_int_lodtensor(recursive_seq_lens, base_shape, place, low,
                                high):
    lens = list(recursive_seq_lens[-1])
    total = sum(lens)
    data = np.random.randint(
        low, high + 1, size=[total] + list(base_shape)
    ).astype("int64")
    return create_lod_tensor(data, recursive_seq_lens, place)
