"""Sequence op lowerings: sequence_pool, sequence_softmax,
sequence_reverse, sequence_expand, sequence_expand_as, sequence_concat,
sequence_conv, sequence_mask, sequence_pad, sequence_unpad,
sequence_enumerate, sequence_slice, sequence_erase, lod_reset,
sequence_reshape, sequence_scatter, edit_distance.

Port of paddle_tpu/ops/sequence_ops.py. A LoD sequence batch travels
dense-padded, (B, T, ...), with a companion (B,) length vector in the
``SeqLen`` slot (fluid/lod.py); these lowerings recover the ragged
semantics by masking, as the JAX package's do, and keep its choices:

- ``sequence_pool`` MAX over a length-0 row gives -inf, ``FIRST`` ignores
  the lengths, ``LAST`` reads index max(len - 1, 0), ``MaxIndex`` is
  int32 zeros. The MAX gradient is split equally among tied maxima, as
  jax's max reduction splits it (``torch.amax``; ``torch.max(dim=)``
  would send it to one index).
- ``sequence_concat`` and ``sequence_scatter`` add (a scatter with
  accumulation): masked-out rows of a concat add zeros at index
  total_t - 1, duplicate scatter ids add up.
- The reference's refusals stay refusals: ``sequence_expand`` of a 3-D
  or larger X, ``sequence_erase`` (lengths that depend on the data) and
  ``sequence_mask`` without a static ``maxlen``. The JAX package's jitted
  step cannot read a ``MaxLenTensor``; the port runs eagerly and could,
  but refuses it too, so a program runs on both or on neither.
- ``edit_distance`` is the f32 Levenshtein program, vectorised over the
  batch and, within a row of the table, over the reference positions (a
  running minimum); normalised by max(ref_len, 1).

Integer results jax gives as int32 (no x64) are int64 here where the
program declares int64 (ROADMAP.md Queue 3).
"""
import torch
import torch.nn.functional as F

from ..fluid import core
from .registry import register_op, single


def _mask(x, lens):
    """(B, T) bool validity mask, shaped to broadcast over x (B, T, ...)."""
    t = x.shape[1]
    m = torch.arange(t, device=x.device)[None, :] < lens[:, None]
    return m.reshape(m.shape + (1,) * (x.ndim - 2))


def _lens(ins, x):
    if ins.get("SeqLen"):
        return ins["SeqLen"][0].reshape(-1).long()
    return torch.full((x.shape[0],), x.shape[1], dtype=torch.long,
                      device=x.device)


def _take_time(x, idx):
    """x[b, idx[b, t], ...]: a gather along axis 1 with a (B, T') index."""
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(idx.shape[:2] + x.shape[2:]))


@register_op("sequence_pool")
def _sequence_pool(ctx, ins, attrs):
    x = ins["X"][0]
    lens = _lens(ins, x)
    ptype = attrs.get("pooltype", "AVERAGE").upper()
    m = _mask(x, lens)
    cnt = lens.clamp(min=1).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 2))
    if ptype in ("SUM", "AVERAGE", "SQRT"):
        out = torch.where(m, x, 0.0).sum(dim=1)
        if ptype == "AVERAGE":
            out = out / cnt
        elif ptype == "SQRT":
            out = out / torch.sqrt(cnt)
    elif ptype == "MAX":
        out = torch.amax(torch.where(m, x, float("-inf")), dim=1)
    elif ptype == "LAST":
        idx = (lens - 1).clamp(min=0)[:, None]
        out = _take_time(x, idx)[:, 0]
    elif ptype == "FIRST":
        out = x[:, 0]
    else:
        raise NotImplementedError("sequence_pool type %s" % ptype)
    return {"Out": [out],
            "MaxIndex": [torch.zeros(out.shape, dtype=torch.int32,
                                     device=x.device)]}


@register_op("sequence_softmax")
def _sequence_softmax(ctx, ins, attrs):
    """Softmax over the time axis of (B, T) or (B, T, 1), padding at 0."""
    x = ins["X"][0]
    m = _mask(x, _lens(ins, x))
    out = torch.softmax(torch.where(m, x, -1e30), dim=1)
    return single(torch.where(m, out, 0.0))


@register_op("sequence_reverse")
def _sequence_reverse(ctx, ins, attrs):
    """Each row's first len steps reversed; the padding stays in place."""
    x = ins["X"][0]
    lens = _lens(ins, x)
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    src = torch.where(idx < lens[:, None], lens[:, None] - 1 - idx, idx)
    return {"Y": [_take_time(x, src)]}


@register_op("sequence_expand")
def _sequence_expand(ctx, ins, attrs):
    """A (B, D) X repeated along Y's time axis: (B, Ty, D). A 3-D or
    larger X would be a ragged repeat, which the padded form cannot hold:
    it raises, as the JAX package's lowering does."""
    x, y = ins["X"][0], ins["Y"][0]
    if x.ndim == 2 and y.ndim >= 2:
        return single(x[:, None, :].expand(x.shape[0], y.shape[1],
                                           x.shape[1]))
    raise NotImplementedError(
        "sequence_expand with %d-D X is a ragged repeat the dense-padded "
        "representation cannot express; restructure with broadcasting or "
        "gather over explicit indices" % x.ndim)


@register_op("sequence_expand_as")
def _sequence_expand_as(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if x.ndim == 2 and y.ndim >= 2:
        return single(x[:, None, :].expand(x.shape[0], y.shape[1],
                                           x.shape[1]))
    return single(x.expand(y.shape))


@register_op("sequence_concat")
def _sequence_concat(ctx, ins, attrs):
    """Concatenation along time: each row's sequences one after another,
    lengths adding (the second starts at the first's length). Without a
    length for every input, a plain concat along axis 1."""
    xs = ins["X"]
    if len(xs) == 1:
        return single(xs[0])
    lens_list = ins.get("SeqLen", [])
    if len(lens_list) != len(xs):
        return single(torch.cat(xs, dim=1))
    total_t = sum(x.shape[1] for x in xs)
    b = xs[0].shape[0]
    dev = xs[0].device
    out = xs[0].new_zeros((b, total_t) + tuple(xs[0].shape[2:]))
    offs = torch.zeros((b,), dtype=torch.long, device=dev)
    bidx = torch.arange(b, device=dev)[:, None]
    for x, lens in zip(xs, lens_list):
        lens = lens.reshape(-1).long()
        t = torch.arange(x.shape[1], device=dev)[None, :]
        valid = t < lens[:, None]
        pos = torch.where(valid, offs[:, None] + t, total_t - 1)
        vals = torch.where(valid.reshape(valid.shape + (1,) * (x.ndim - 2)),
                           x, 0.0)
        out = out.index_put((bidx.expand_as(pos), pos), vals,
                            accumulate=True)
        offs = offs + lens
    return single(out)


@register_op("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    """Context-window convolution over time (ref sequence_conv_op.cc):
    out_t = sum_j x[t + start + j] @ W_j, the padding read as zeros, the
    output zero past each row's length."""
    x = ins["X"][0]                 # (B, T, D)
    w = ins["Filter"][0]            # (k*D, F)
    m = _mask(x, _lens(ins, x))
    k = attrs.get("contextLength", 3)
    start = attrs.get("contextStart", -(k // 2))
    t = x.shape[1]
    xm = torch.where(m, x, 0.0)
    pieces = []
    for j in range(k):
        shift = start + j
        if shift < 0:
            pieces.append(F.pad(xm, (0, 0, -shift, 0))[:, :t])
        elif shift > 0:
            pieces.append(F.pad(xm, (0, 0, 0, shift))[:, shift:])
        else:
            pieces.append(xm)
    out = torch.matmul(torch.cat(pieces, dim=-1), w)
    if ins.get("Bias"):
        out = out + ins["Bias"][0]
    return single(torch.where(m, out, 0.0))


@register_op("sequence_mask")
def _sequence_mask(ctx, ins, attrs):
    """(B, maxlen) mask of lengths X; ``maxlen`` must be a static attr (a
    ``MaxLenTensor`` is refused, as in the JAX package's jitted step)."""
    if ins.get("MaxLenTensor"):
        raise NotImplementedError(
            "sequence_mask needs a static (python int) maxlen: a "
            "MaxLenTensor is a data-dependent output shape the reference's "
            "compiled step cannot hold, so the port refuses it too")
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise NotImplementedError(
            "sequence_mask needs static maxlen (data-dependent shapes "
            "can't be compiled in the reference); pass maxlen explicitly")
    x = ins["X"][0]
    lens = x.reshape(-1).long()
    out = torch.arange(maxlen, device=x.device)[None, :] < lens[:, None]
    return {"Y": [out.to(core.torch_dtype(attrs.get("out_dtype",
                                                    "int64")))]}


@register_op("sequence_pad")
def _sequence_pad(ctx, ins, attrs):
    """Padding set to PadValue (0 without one), the time axis cut or
    extended to ``padded_length`` (-1: as it is); Length is int64."""
    x = ins["X"][0]
    lens = _lens(ins, x)
    plen = attrs.get("padded_length", -1)
    t = x.shape[1]
    if plen is None or plen < 0:
        plen = t
    pad = ins["PadValue"][0] if ins.get("PadValue") else x.new_zeros(())
    out = torch.where(_mask(x, lens), x, pad.to(x.dtype))
    if plen > t:
        fill = torch.broadcast_to(pad.to(x.dtype), (x.shape[0], plen - t)
                                  + tuple(x.shape[2:]))
        out = torch.cat([out, fill], dim=1)
    else:
        out = out[:, :plen]
    return {"Out": [out], "Length": [lens.to(torch.int64)]}


@register_op("sequence_unpad")
def _sequence_unpad(ctx, ins, attrs):
    x = ins["X"][0]
    lens = ins["Length"][0].reshape(-1).long()
    return single(torch.where(_mask(x, lens), x, 0.0))


@register_op("sequence_enumerate")
def _sequence_enumerate(ctx, ins, attrs):
    """(B, T) ids -> (B, T, win): step t holds ids t .. t + win - 1, past
    the end ``pad_value``."""
    x = ins["X"][0]
    win = attrs["win_size"]
    pad = attrs.get("pad_value", 0)
    cols = [x] + [F.pad(x, (0, j), value=pad)[:, j:] for j in range(1, win)]
    return single(torch.stack(cols, dim=-1))


@register_op("sequence_slice")
def _sequence_slice(ctx, ins, attrs):
    """Row b's steps Offset[b] .. Offset[b] + Length[b] - 1 moved to the
    front (a read past the end repeats the last step), the rest zero."""
    x = ins["X"][0]
    offset = ins["Offset"][0].reshape(-1).long()
    length = ins["Length"][0].reshape(-1).long()
    t = x.shape[1]
    idx = torch.arange(t, device=x.device)[None, :]
    valid = idx < length[:, None]
    src = torch.where(valid, (offset[:, None] + idx).clamp(max=t - 1), 0)
    out = _take_time(x, src)
    return single(torch.where(
        valid.reshape(valid.shape + (1,) * (x.ndim - 2)), out, 0.0))


@register_op("sequence_erase")
def _sequence_erase(ctx, ins, attrs):
    raise NotImplementedError(
        "sequence_erase produces data-dependent lengths; filter host-side "
        "before feeding (the reference's compiled step requires static "
        "shapes)")


@register_op("lod_reset")
def _lod_reset(ctx, ins, attrs):
    return single(ins["X"][0])


@register_op("sequence_reshape")
def _sequence_reshape(ctx, ins, attrs):
    x = ins["X"][0]
    dim = attrs["new_dim"]
    b, t = x.shape[0], x.shape[1]
    d = x.shape[2] if x.ndim > 2 else 1
    return single(x.reshape(b, t * d // dim, dim))


@register_op("sequence_scatter")
def _sequence_scatter(ctx, ins, attrs):
    """X[b, Ids[b, k]] += Updates[b, k]; duplicate ids add up, a negative
    id counts from the end (jax's ``.at[].add``)."""
    x = ins["X"][0]
    ids = ins["Ids"][0].long()
    ids = torch.where(ids < 0, ids + x.shape[1], ids)
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    return single(x.index_put((bidx.expand_as(ids), ids),
                              ins["Updates"][0].to(x.dtype),
                              accumulate=True))


@register_op("edit_distance")
def _edit_distance(ctx, ins, attrs):
    """Levenshtein distance between padded hypothesis and reference id
    rows (ref edit_distance_op.cc), in f32. Row i + 1 of the table is
    new[j] = min(new[j - 1] + 1, row[j] + 1, row[j - 1] + cost); with
    c[j] = min(row[j] + 1, row[j - 1] + cost) and c[0] = i + 1 that is
    new[j] = min_{k <= j} (c[k] + j - k), a running minimum of c[k] - k.
    A row past the hypothesis' length keeps the previous one."""
    hyp = ins["Hyps"][0].long()            # (B, Th)
    ref = ins["Refs"][0].long()            # (B, Tr)
    b, th = hyp.shape
    tr = ref.shape[1]
    dev = hyp.device

    def length(slot, full):
        if ins.get(slot):
            return ins[slot][0].reshape(-1).long()
        return torch.full((b,), full, dtype=torch.long, device=dev)

    hyp_lens = length("HypsLength", th)
    ref_lens = length("RefsLength", tr)
    ramp = torch.arange(tr + 1, dtype=torch.float32, device=dev)
    row = ramp.expand(b, tr + 1)
    for i in range(th):
        cost = (hyp[:, i:i + 1] != ref).to(torch.float32)     # (B, Tr)
        c = torch.minimum(row[:, 1:] + 1.0, row[:, :-1] + cost)
        c = torch.cat([torch.full((b, 1), i + 1.0, device=dev), c], dim=1)
        new = torch.cummin(c - ramp, dim=1).values + ramp
        row = torch.where((i < hyp_lens)[:, None], new, row)
    d = row.gather(1, ref_lens.clamp(max=tr)[:, None])[:, 0]
    if attrs.get("normalized", False):
        d = d / ref_lens.clamp(min=1).to(torch.float32)
    return {"Out": [d[:, None]],
            "SequenceNum": [torch.tensor(b, dtype=torch.int64, device=dev)]}
