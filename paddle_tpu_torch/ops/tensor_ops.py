"""Tensor manipulation op lowerings: cast, concat, reshape2, transpose2,
squeeze2, unsqueeze2, flatten2, slice, top_k, arg_max, fill_constant,
fill_constant_batch_size_like, fill_zeros_like, assign, assign_value,
increment, where, gather, gather_nd, expand, expand_as, stack, range,
decode_cache_write. Port of the
paddle_tpu/ops/tensor_ops.py lowerings the port runs;
reshape/transpose/slice/squeeze return views where torch can.

Indices follow the reference's jax semantics, not torch's: ``gather_nd``
and ``decode_cache_write`` (its start, as ``lax.dynamic_update_slice``)
wrap a negative index once and clamp the rest into range; ``gather``
(``jnp.take``) wraps once and fills the rest. Integer results the
reference gives as int32 (jax without x64: ``arg_max``, an int64
``range``, ``fill_constant_batch_size_like`` or ``assign_value``) are
int64 here (ROADMAP.md Queue 3).
"""
import numpy as np
import torch

from ..fluid import core
from .promotion import promote
from .registry import register_op, single


@register_op("cast")
def _cast(ctx, ins, attrs):
    """x in ``out_dtype``. Differentiable: the gradient of a cast weight
    comes back in the weight's own dtype, as jax's convert_element_type
    transposes."""
    return single(ins["X"][0].to(core.torch_dtype(attrs["out_dtype"])))


def _xshape(x):
    # the XShape side output carries only the input's shape (0 elements)
    return torch.zeros((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


@register_op("concat")
def _concat(ctx, ins, attrs):
    axis = (int(ins["AxisTensor"][0]) if ins.get("AxisTensor")
            else attrs.get("axis", 0))
    return single(torch.cat(promote(*ins["X"]), dim=axis))


@register_op("reshape2")
def _reshape(ctx, ins, attrs):
    x = ins["X"][0]
    if ins.get("ShapeTensor"):
        shape = [int(s) for s in ins["ShapeTensor"]]
    else:
        shape = list(attrs["shape"])
    # paddle: 0 means copy dim from input, -1 is inferred
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
    return {"Out": [x.reshape(shape)], "XShape": [_xshape(x)]}


@register_op("transpose2")
def _transpose(ctx, ins, attrs):
    x = ins["X"][0]
    return {"Out": [x.permute(*attrs["axis"])], "XShape": [_xshape(x)]}


@register_op("squeeze2")
def _squeeze(ctx, ins, attrs):
    """Drop the listed axes that have size 1 (every size-1 axis when none
    is listed); a listed axis of another size stays, as in the
    reference."""
    x = ins["X"][0]
    axes = attrs.get("axes", [])
    if axes:
        drop = sorted({a % x.dim() for a in axes if x.shape[a % x.dim()] == 1})
        out = x.squeeze(tuple(drop)) if drop else x
    else:
        out = x.squeeze()
    return {"Out": [out], "XShape": [_xshape(x)]}


@register_op("unsqueeze2")
def _unsqueeze(ctx, ins, attrs):
    x = ins["X"][0]
    out = x
    for a in sorted(attrs["axes"]):
        out = out.unsqueeze(a)
    return {"Out": [out], "XShape": [_xshape(x)]}


@register_op("flatten2")
def _flatten(ctx, ins, attrs):
    """x as (prod(shape[:axis]), prod(shape[axis:]))."""
    x = ins["X"][0]
    lead = 1
    for d in x.shape[:attrs.get("axis", 1)]:
        lead *= int(d)
    return {"Out": [x.reshape(lead, -1)], "XShape": [_xshape(x)]}


@register_op("slice")
def _slice(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = x.shape[ax]
        st = max(st + dim, 0) if st < 0 else min(st, dim)
        en = max(en + dim, 0) if en < 0 else min(en, dim)
        idx[ax] = slice(st, en)
    return single(x[tuple(idx)])


@register_op("top_k")
def _top_k(ctx, ins, attrs):
    """The k largest along the last axis, in descending order; equal
    values in index order, as lax.top_k gives them (a stable sort: torch's
    topk does not order ties). Indices are int64."""
    x = ins["X"][0]
    k = int(ins["K"][0]) if ins.get("K") else int(attrs["k"])
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return {"Out": [vals[..., :k]], "Indices": [idx[..., :k]]}


@register_op("fill_constant")
def _fill_constant(ctx, ins, attrs):
    shape = attrs.get("shape", [])
    if ins.get("ShapeTensor"):
        shape = [int(v) for v in ins["ShapeTensor"]]
    value = attrs.get("value", 0.0)
    if ins.get("ValueTensor"):
        value = ins["ValueTensor"][0].item()
    return single(torch.full(
        tuple(int(s) for s in shape), value,
        dtype=core.torch_dtype(attrs["dtype"]), device=ctx.device))


@register_op("fill_constant_batch_size_like")
def _fill_constant_bsl(ctx, ins, attrs):
    """``shape`` with its ``output_dim_idx`` entry taken from the input's
    ``input_dim_idx`` dim, filled with ``value``."""
    shape = [int(s) for s in attrs["shape"]]
    shape[attrs.get("output_dim_idx", 0)] = int(
        ins["Input"][0].shape[attrs.get("input_dim_idx", 0)])
    return single(torch.full(
        tuple(shape), attrs.get("value", 0.0),
        dtype=core.torch_dtype(attrs["dtype"]), device=ctx.device))


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx, ins, attrs):
    return single(torch.zeros_like(ins["X"][0]))


@register_op("assign")
def _assign(ctx, ins, attrs):
    return single(ins["X"][0])


@register_op("assign_value")
def _assign_value(ctx, ins, attrs):
    """The attrs' ``values`` list as a ``shape`` tensor of ``dtype`` on the
    run's device. Made once a run (``ctx.constant``): inside a loop body
    the op runs every iteration, and beam search's row is vocab long."""
    def make():
        dtype = core.convert_dtype(attrs["dtype"])
        values = np.array(attrs["values"], dtype=core.np_dtype(dtype))
        return torch.as_tensor(values.reshape(attrs["shape"])).to(
            ctx.device)

    return single(ctx.constant(attrs["values"], make))


@register_op("increment")
def _increment(ctx, ins, attrs):
    """X + step, step a weak Python float (an int X gives float32, as jax
    promotes)."""
    return single(torch.add(*promote(ins["X"][0], attrs.get("step", 1.0))))


@register_op("where")
def _where(ctx, ins, attrs):
    """Condition ? X : Y, broadcast, X and Y promoted by jax's rules."""
    x, y = promote(ins["X"][0], ins["Y"][0])
    return single(torch.where(ins["Condition"][0].to(torch.bool), x, y))


@register_op("arg_max")
def _arg_max(ctx, ins, attrs):
    """Index of the largest value along ``axis``: the first one on ties, a
    NaN counting as the largest, as ``jnp.argmax``. int64 (the reference:
    int32, jax without x64)."""
    return single(torch.argmax(ins["X"][0], dim=attrs.get("axis", -1)))


def _jax_index(idx, dim):
    """An index tensor as jax's gather reads it along a dim of size `dim`:
    a negative index wraps once, then every index is clamped into
    [0, dim - 1] (``x[7]`` of 5 rows reads row 4, ``x[-7]`` row 0)."""
    return torch.where(idx < 0, idx + dim, idx).clamp(0, dim - 1)


@register_op("gather_nd")
def _gather_nd(ctx, ins, attrs):
    """Index (..., k) picks x[i0, ..., ik-1] from the first k dims of x:
    ``x[tuple(moveaxis(idx, -1, 0))]`` with jax's index rule
    (:func:`_jax_index`)."""
    x, idx = ins["X"][0], ins["Index"][0].long()
    k = idx.shape[-1]
    return single(x[tuple(_jax_index(idx[..., j], x.shape[j])
                          for j in range(k))])


@register_op("gather")
def _gather(ctx, ins, attrs):
    """Rows Index of X (an (N, 1) Index read as (N,)): ``jnp.take`` along
    axis 0 in jax's fill mode. A negative index counts from the end once;
    a row outside [-n, n) reads the fill value, NaN for floats, the
    dtype's least value for ints, True for bool."""
    x, idx = ins["X"][0], ins["Index"][0].long()
    if idx.dim() == 2 and idx.shape[1] == 1:
        idx = idx[:, 0]
    n = x.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    valid = (idx >= 0) & (idx < n)
    out = x[idx.clamp(0, n - 1)]
    if x.dtype == torch.bool:
        fill = True
    elif x.dtype.is_floating_point:
        fill = float("nan")
    else:
        fill = torch.iinfo(x.dtype).min
    valid = valid.reshape(valid.shape + (1,) * (x.dim() - 1))
    return single(torch.where(valid, out, torch.full(
        (), fill, dtype=x.dtype, device=x.device)))


def _tile(x, times):
    """``jnp.tile``: a short ``times`` is padded with leading 1s."""
    times = [int(t) for t in times]
    return x.repeat([1] * (x.dim() - len(times)) + times)


@register_op("expand")
def _expand(ctx, ins, attrs):
    return single(_tile(ins["X"][0], attrs["expand_times"]))


@register_op("expand_as")
def _expand_as(ctx, ins, attrs):
    x, tgt = ins["X"][0], ins["target_tensor"][0]
    return single(_tile(x, [t // s for t, s in zip(tgt.shape, x.shape)]))


@register_op("stack")
def _stack(ctx, ins, attrs):
    return {"Y": [torch.stack(promote(*ins["X"]), dim=attrs.get("axis", 0))]}


def _scalar(ins, slot, attrs, key):
    return float(ins[slot][0]) if ins.get(slot) else float(attrs[key])


@register_op("range")
def _range(ctx, ins, attrs):
    """``jnp.arange`` over floats, then cast to ``dtype``: jax hands a
    stepped arange to numpy, which fills float32 values as
    ``b0 + i * (b1 - b0)`` in float32, with b0 = start and b1 = start +
    step rounded to float32 (``range(0, 1, 0.1)`` ends in 0.90000004, not
    0.9). Integer ranges below 2**24 come out exact."""
    start = _scalar(ins, "Start", attrs, "start")
    end = _scalar(ins, "End", attrs, "end")
    step = _scalar(ins, "Step", attrs, "step")
    n = max(0, int(np.ceil((end - start) / step)))
    b0 = np.float32(start)
    delta = np.float32(np.float32(start + step) - b0)
    out = torch.arange(n, dtype=torch.float32, device=ctx.device)
    out = out * float(delta) + float(b0)
    return single(out.to(core.torch_dtype(attrs.get("dtype", "float32"))))


@register_op("decode_cache_write")
def _decode_cache_write(ctx, ins, attrs):
    """Out = Cache (B, T, H) with Value (B, P, H) written at time index Pos
    along axis 1, as ``lax.dynamic_update_slice``: a negative start wraps
    once (-1 is T - 1), then the start is clamped into [0, T - P], so a
    position at or past the end writes the last rows. The position is row 0's for every row
    (the reference's uniform decoders) or, with ``per_row``, each row's
    own (slotted continuous batching: a freshly prefilled slot sits at its
    prompt length beside neighbours deep into generation; a dead slot
    writes at 0). Cache is left as it was: the engine feeds the same
    cache pair that the step's outputs then replace."""
    cache, val, pos = ins["Cache"][0], ins["Value"][0], ins["Pos"][0]
    b, t = cache.shape[0], cache.shape[1]
    p = val.shape[1]
    pos = pos.reshape(-1).long()
    start = pos if attrs.get("per_row") else pos[:1].expand(b)
    start = _jax_index(start, t).clamp(max=t - p)
    rows = start[:, None] + torch.arange(p, device=start.device)  # (B, P)
    index = rows[:, :, None].expand(b, p, cache.shape[2])
    return single(cache.scatter(1, index, val.to(cache.dtype)))
