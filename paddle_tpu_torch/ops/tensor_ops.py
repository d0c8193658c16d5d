"""Tensor manipulation op lowerings: cast, reshape2, transpose2,
unsqueeze2, flatten2, slice, top_k, fill_constant, fill_zeros_like,
assign, where. Port of
the paddle_tpu/ops/tensor_ops.py lowerings the port runs;
reshape/transpose/slice return views where torch can.
"""
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


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx, ins, attrs):
    return single(torch.zeros_like(ins["X"][0]))


@register_op("assign")
def _assign(ctx, ins, attrs):
    return single(ins["X"][0])


@register_op("where")
def _where(ctx, ins, attrs):
    """Condition ? X : Y, broadcast, X and Y promoted by jax's rules."""
    x, y = promote(ins["X"][0], ins["Y"][0])
    return single(torch.where(ins["Condition"][0].to(torch.bool), x, y))
