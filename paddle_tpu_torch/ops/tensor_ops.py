"""Tensor manipulation op lowerings: cast, concat, split, reshape2, transpose2,
squeeze2, unsqueeze2, flatten2, slice, top_k, arg_max, fill_constant,
fill_constant_batch_size_like, fill_zeros_like, assign, assign_value,
increment, where, one_hot, argsort, gather, gather_nd, expand, expand_as,
reverse, stack, range, decode_cache_write. Port of the
paddle_tpu/ops/tensor_ops.py lowerings the port runs;
reshape/transpose/slice/squeeze return views where torch can.

Indices follow the reference's jax semantics, not torch's: ``gather_nd``
and ``decode_cache_write`` (its start, as ``lax.dynamic_update_slice``)
wrap a negative index once and clamp the rest into range; ``gather``
(``jnp.take``) wraps once and fills the rest. Integer results the
reference gives as int32 (jax without x64: ``arg_max``, ``argsort``'s
Indices, an int64 ``range``, ``fill_constant_batch_size_like`` or
``assign_value``) are int64 here (ROADMAP.md Queue 3).
"""
import numpy as np
import torch
import torch.nn.functional as F

from ..fluid import core
from .promotion import promote
from .registry import LOWERINGS, register_layout_rule, register_op, single


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


@register_op("split")
def _split(ctx, ins, attrs):
    """x cut along ``axis`` at the running sums of ``sections`` (all but
    the last), or into ``num`` equal parts (a length ``num`` does not
    divide raises, as jnp.split does)."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    sections = attrs.get("sections", [])
    if sections:
        cuts = np.cumsum(sections[:-1]).tolist()
    else:
        num = attrs.get("num", 0)
        size = x.shape[axis]
        if num <= 0 or size % num:
            raise ValueError("split: axis of length %d cannot be split into "
                             "%d equal parts" % (size, num))
        cuts = [size // num * i for i in range(1, num)]
    return {"Out": list(torch.tensor_split(x, cuts, dim=axis))}


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


@register_op("one_hot")
def _one_hot(ctx, ins, attrs):
    """float32 rows with a 1 at each id, ``jax.nn.one_hot``: an id outside
    [0, depth) gives a row of zeros (``F.one_hot`` raises there). The v1
    rule drops a trailing (n, 1) id dim unless ``_squeeze`` is False."""
    x = ins["X"][0]
    if x.dim() >= 2 and x.shape[-1] == 1 and attrs.get("_squeeze", True):
        x = x[..., 0]
    depth = int(attrs["depth"])
    hot = x[..., None] == torch.arange(depth, device=x.device).to(x.dtype)
    return single(hot.to(torch.float32))


def stable_argsort(x, dim=-1, descending=False):
    """``jnp.argsort(-x if descending else x)``: a stable sort, so equal
    keys keep their index order; descending sorts the negation, as the
    reference does. -0.0 is made +0.0 first: jax's sort comparator sees
    them equal, cub's radix sort on the card orders -0.0 first."""
    key = -x if descending else x
    if key.dtype.is_floating_point:
        key = torch.where(key == 0, torch.zeros_like(key), key)
    return torch.argsort(key, dim=dim, stable=True)


@register_op("argsort")
def _argsort(ctx, ins, attrs):
    """Out = X sorted along ``axis`` and Indices (int64; the reference:
    int32, jax without x64), descending as a stable sort of -X, so ties
    come out in ascending index order either way."""
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    idx = stable_argsort(x, axis, attrs.get("descending", False))
    return {"Out": [x.gather(axis, idx)], "Indices": [idx]}


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


@register_op("reverse")
def _reverse(ctx, ins, attrs):
    return single(torch.flip(ins["X"][0], dims=list(attrs["axis"])))


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


# ---------------------------------------------------------------------------
# the rest of paddle_tpu/ops/tensor_ops.py: strided slices, shapes,
# scatters, pads, index ops, constant tables, flips, crop, label_smooth,
# share_data, print
# ---------------------------------------------------------------------------
@register_op("strided_slice")
def _strided_slice(ctx, ins, attrs):
    """x[start:end:stride] on each listed axis, Python's slice rule (a
    negative stride walks backwards)."""
    x = ins["Input"][0]
    out = x
    for ax, st, en, sd in zip(attrs["axes"], attrs["starts"], attrs["ends"],
                              attrs["strides"]):
        if sd > 0:
            idx = [slice(None)] * x.dim()
            idx[ax] = slice(st, en, sd)
            out = out[tuple(idx)]
        else:
            rows = list(range(*slice(st, en, sd).indices(x.shape[ax])))
            out = out.index_select(ax, torch.as_tensor(
                rows, dtype=torch.long).to(x.device, non_blocking=True))
    return single(out)


@register_op("shape")
def _shape(ctx, ins, attrs):
    """The input's shape, int32."""
    return single(torch.tensor(list(ins["Input"][0].shape),
                               dtype=torch.int32).to(ctx.device))


@register_op("size")
def _size(ctx, ins, attrs):
    """The input's element count, an int64 scalar."""
    return single(torch.full((), ins["Input"][0].numel(), dtype=torch.int64,
                             device=ctx.device))


def _dumped(idx, n):
    """jax's scatter index rule along a dim of size n: a negative index
    wraps once, and one still outside [0, n) is dropped, here by sending
    it to a dump row n."""
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))


def _with_dump(x):
    return torch.cat([x, torch.zeros_like(x[:1])])


@register_op("scatter")
def _scatter(ctx, ins, attrs):
    """Rows Ids of X replaced by Updates (``overwrite``), or zeroed and
    then summed with every update they receive: ``x.at[ids].set`` /
    ``.add``, jax's index rule (:func:`_dumped`)."""
    x, idx, upd = ins["X"][0], ins["Ids"][0].long(), ins["Updates"][0]
    if idx.dim() == 2 and idx.shape[1] == 1:
        idx = idx[:, 0]
    n = x.shape[0]
    idx = _dumped(idx, n)
    out = _with_dump(x)
    if attrs.get("overwrite", True):
        return single(out.index_put((idx,), upd.to(x.dtype))[:n])
    out = out.index_put((idx,), torch.zeros_like(upd, dtype=x.dtype))
    return single(out.index_add(0, idx, upd.to(x.dtype))[:n])


@register_op("scatter_nd_add")
def _scatter_nd_add(ctx, ins, attrs):
    """X plus each Updates slice at X[Index[..., :]], summed over repeated
    indices: ``x.at[tuple(moveaxis(idx, -1, 0))].add``, jax's index rule
    on each of the first k dims."""
    x, idx, upd = ins["X"][0], ins["Index"][0].long(), ins["Updates"][0]
    k = idx.shape[-1]
    lead = x.shape[:k]
    rest = tuple(x.shape[k:])
    total = 1
    for s in lead:
        total *= int(s)
    flat = torch.zeros(idx.shape[:-1], dtype=torch.long, device=x.device)
    bad = torch.zeros(idx.shape[:-1], dtype=torch.bool, device=x.device)
    for j in range(k):
        col = idx[..., j]
        col = torch.where(col < 0, col + lead[j], col)
        bad = bad | (col < 0) | (col >= lead[j])
        flat = flat * int(lead[j]) + col
    flat = torch.where(bad, torch.full_like(flat, total), flat).reshape(-1)
    out = _with_dump(x.reshape((total,) + rest))
    out = out.index_add(0, flat, upd.reshape((-1,) + rest).to(x.dtype))
    return single(out[:total].reshape(x.shape))


@register_op("unstack")
def _unstack(ctx, ins, attrs):
    return {"Y": list(torch.unbind(ins["X"][0], dim=attrs.get("axis", 0)))}


@register_op("tile")
def _tile_op(ctx, ins, attrs):
    return single(_tile(ins["X"][0], attrs["repeat_times"]))


def _pad_pairs(pairs):
    """[(lo, hi) per dim] in F.pad's order (last dim first)."""
    out = []
    for lo, hi in reversed(pairs):
        out += [int(lo), int(hi)]
    return out


@register_op("pad")
def _pad(ctx, ins, attrs):
    """``paddings`` = [lo0, hi0, lo1, hi1, ...] filled with ``pad_value``."""
    x = ins["X"][0]
    p = attrs["paddings"]
    return single(F.pad(x, _pad_pairs([(p[2 * i], p[2 * i + 1])
                                       for i in range(x.dim())]),
                        value=attrs.get("pad_value", 0.0)))


@register_op("pad2d")
def _pad2d(ctx, ins, attrs):
    """H and W padded by ``paddings`` = [top, bottom, left, right]: a
    constant, ``reflect`` (the edge row not repeated) or ``edge`` (it is),
    NCHW or NHWC."""
    x = ins["X"][0]
    p = attrs["paddings"]
    mode = attrs.get("mode", "constant")
    nhwc = attrs.get("data_format", "NCHW") != "NCHW"
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    pads = [int(p[2]), int(p[3]), int(p[0]), int(p[1])]
    if mode == "constant":
        out = F.pad(x, pads, value=attrs.get("pad_value", 0.0))
    else:
        out = F.pad(x, pads, mode={"reflect": "reflect",
                                   "edge": "replicate"}[mode])
    return single(out.permute(0, 2, 3, 1) if nhwc else out)


@register_op("pad_constant_like")
def _pad_constant_like(ctx, ins, attrs):
    """Y padded at the high end of each dim to X's shape."""
    x, y = ins["X"][0], ins["Y"][0]
    return single(F.pad(y, _pad_pairs([(0, xs - ys) for xs, ys in zip(
        x.shape, y.shape)]), value=attrs.get("pad_value", 0.0)))


@register_op("arg_min")
def _arg_min(ctx, ins, attrs):
    """Index of the least value along ``axis``, the first one on ties.
    int64 (the reference: int32, jax without x64)."""
    return single(torch.argmin(ins["X"][0], dim=attrs.get("axis", -1)))


@register_op("where_index")
def _where_index(ctx, ins, attrs):
    """(count, rank) int64 coordinates of Condition's nonzero entries in
    row-major order; the count is data-dependent, so it waits for the
    device, as the reference's host-side lowering does."""
    return single(torch.nonzero(ins["Condition"][0]))


@register_op("multiplex")
def _multiplex(ctx, ins, attrs):
    """Row b of the output is row b of X[Ids[b]]."""
    xs = torch.stack(promote(*ins["X"]), dim=0)
    idx = ins["Ids"][0].reshape(-1).long()
    return single(xs[idx, torch.arange(idx.shape[0], device=idx.device)])


def linspace_f32(start, stop, num):
    """``jnp.linspace(start, stop, num)`` in float32, as jax computes it:
    start·(1 - i/(num - 1)) + stop·(i/(num - 1)), then ``stop`` itself."""
    f32 = np.float32
    start, stop = f32(start), f32(stop)
    if num <= 1:
        return np.full((max(num, 0),), start, dtype=f32)
    div = num - 1
    step = np.arange(div, dtype=f32) / f32(div)
    out = start * (f32(1) - step) + stop * step
    return np.concatenate([out, [stop]]).astype(f32)


@register_op("linspace")
def _linspace(ctx, ins, attrs):
    """``num`` float32 values from ``start`` to ``stop`` (tensor inputs
    read on the host); float32 whatever ``dtype`` says, as in the
    reference."""
    start = _scalar(ins, "Start", attrs, "start")
    stop = _scalar(ins, "Stop", attrs, "stop")
    num = int(ins["Num"][0]) if ins.get("Num") else int(attrs["num"])
    return single(torch.from_numpy(linspace_f32(start, stop, num)).to(
        ctx.device, non_blocking=True))


@register_op("eye")
def _eye(ctx, ins, attrs):
    rows = attrs["num_rows"]
    return single(torch.eye(rows, attrs.get("num_columns") or rows,
                            dtype=core.torch_dtype(attrs.get("dtype",
                                                             "float32")),
                            device=ctx.device))


@register_op("diag")
def _diag(ctx, ins, attrs):
    """A vector's diagonal matrix (a matrix's diagonal), ``jnp.diag``."""
    return single(torch.diag(ins["Diagonal"][0]))


@register_op("roll")
def _roll(ctx, ins, attrs):
    """``jnp.roll``: along ``axis``, or over the flattened x when none is
    given."""
    x = ins["X"][0]
    shifts = attrs["shifts"]
    axis = tuple(attrs.get("axis", ()))
    if not axis:
        shifts = shifts[0] if isinstance(shifts, (list, tuple)) else shifts
        return single(torch.roll(x, int(shifts)))
    if not isinstance(shifts, (list, tuple)):
        shifts = [shifts] * len(axis)
    return single(torch.roll(x, [int(s) for s in shifts], list(axis)))


@register_op("flip")
def _flip(ctx, ins, attrs):
    return single(torch.flip(ins["X"][0], dims=list(attrs["axis"])))


@register_op("crop")
def _crop(ctx, ins, attrs):
    """x[o:o + s] per leading dim, s from Y's shape when Y is given, else
    from ``shape``; dims past the offsets' length are kept whole (with Y
    and no offsets, all of x)."""
    x = ins["X"][0]
    shape = tuple(ins["Y"][0].shape) if ins.get("Y") else attrs.get("shape")
    offsets = attrs.get("offsets")
    return single(x[tuple(slice(o, o + s) for o, s in zip(offsets, shape))])


@register_op("label_smooth")
def _label_smooth(ctx, ins, attrs):
    """(1 - eps)·X + eps·PriorDist, or + eps / classes."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.1)
    if ins.get("PriorDist"):
        return single((1 - eps) * x + eps * ins["PriorDist"][0])
    return single((1 - eps) * x + eps / x.shape[-1])


@register_op("share_data")
def _share_data(ctx, ins, attrs):
    return single(ins["X"][0])


@register_op("print")
def _print(ctx, ins, attrs):
    """Prints ``message`` followed by the tensor, as the reference's
    ``jax.debug.print(message + "{x}")`` formats it (numpy's str of the
    array), from the host after the tensor is ready; Out is In."""
    x = ins["In"][0]
    print((attrs.get("message", "") + "{x}").format(
        x=x.detach().cpu().numpy()), flush=True)
    return single(x)


# ---------------------------------------------------------------------------
# layout rules under tensor and sequence parallelism
# (parallel/tensor_parallel.py)
# ---------------------------------------------------------------------------
def _tpl():
    from ..parallel import tensor_parallel

    return tensor_parallel


@register_layout_rule("cast")
def _cast_rule(ctx, ins, attrs, lays):
    return _tpl().unary(ctx, ins, attrs, lays, LOWERINGS["cast"])


def _prefix(shape, n):
    p = 1
    for d in shape[:n]:
        p *= int(d)
    return p


@register_layout_rule("reshape2")
def _reshape_rule(ctx, ins, attrs, lays):
    """A split dim survives while it stays the outer factor of its group:
    input dim d maps to the output dim o with the same product of the
    dims before it, when o's size divides by the axis size. So (B, T, H)
    split on H is (B, T, nh, dh) split on nh when nh divides."""
    tpl = _tpl()
    if ins.get("ShapeTensor"):
        return None
    x, lay = ins["X"][0], lays["X"][0]
    gin = tpl.global_shape(x.shape, lay, ctx.groups)
    shape = [gin[i] if s == 0 else int(s)
             for i, s in enumerate(attrs["shape"])]
    if -1 in shape:
        known = _prefix([s for s in shape if s != -1], len(shape))
        shape[shape.index(-1)] = _prefix(gin, len(gin)) // known
    split = {}
    for a, d in lay.split.items():
        n = ctx.groups[a].size
        at = [o for o in range(len(shape))
              if _prefix(shape, o) == _prefix(gin, d) and shape[o] % n == 0
              and shape[o] > 1]
        if not at:
            return None
        split[a] = at[0]
    local = list(shape)
    for a, o in split.items():
        local[o] //= ctx.groups[a].size
    out = LOWERINGS["reshape2"](ctx, {"X": [x]}, dict(attrs, shape=local))
    return out, {"Out": [tpl.Layout(split, lay.partial)]}


@register_layout_rule("transpose2")
def _transpose_rule(ctx, ins, attrs, lays):
    """The split dims move with the permutation."""
    perm = [p % ins["X"][0].dim() for p in attrs["axis"]]
    lay = lays["X"][0].moved({old: new for new, old in enumerate(perm)})
    return LOWERINGS["transpose2"](ctx, ins, attrs), {"Out": [lay]}


@register_layout_rule("unsqueeze2")
def _unsqueeze_rule(ctx, ins, attrs, lays):
    """The split dims shift past the new ones."""
    x = ins["X"][0]
    pos = list(range(x.dim()))
    for a in sorted(attrs["axes"]):
        a = a if a >= 0 else a + len(pos) + 1
        pos = [p + 1 if p >= a else p for p in pos]
    lay = lays["X"][0].moved(dict(enumerate(pos)))
    return LOWERINGS["unsqueeze2"](ctx, ins, attrs), {"Out": [lay]}


@register_layout_rule("squeeze2")
def _squeeze_rule(ctx, ins, attrs, lays):
    """The split dims shift past the dropped ones; a split dim is never
    dropped (its whole size is not 1)."""
    tpl = _tpl()
    x, lay = ins["X"][0], lays["X"][0]
    gshape = tpl.global_shape(x.shape, lay, ctx.groups)
    axes = attrs.get("axes", [])
    drop = {a % x.dim() for a in axes} if axes else set(range(x.dim()))
    drop = {d for d in drop if gshape[d] == 1}
    if any(x.shape[d] != 1 for d in drop):
        return None
    keep = [d for d in range(x.dim()) if d not in drop]
    out = x.squeeze(tuple(sorted(drop))) if drop else x
    return ({"Out": [out], "XShape": [_xshape(x)]},
            {"Out": [lay.moved({d: i for i, d in enumerate(keep)})]})


@register_layout_rule("slice")
def _slice_rule(ctx, ins, attrs, lays):
    """A slice of dims that are not split keeps every block whole: it
    runs on the rank's block."""
    lay = lays["Input"][0]
    n = ins["Input"][0].dim()
    if any(lay.axis_on(a % n) is not None for a in attrs["axes"]):
        return None
    return LOWERINGS["slice"](ctx, ins, attrs), {"Out": [lay]}
