"""jax's dtype promotion, for the port's binary lowerings.

The JAX package's lowerings promote per op by jax's rules, and the
mixed-precision rewrite relies on it: it casts the inputs of the matrix
products to bfloat16 and inserts no cast back, because the f32 bias add
after each product promotes the result to f32
(paddle_tpu/fluid/contrib/mixed_precision/__init__.py:76-77). Torch
promotes differently:

- ``torch.matmul`` raises on bfloat16 × float32, where ``jnp.matmul``
  gives float32;
- a 0-dim tensor takes a back seat in torch (bfloat16[n] + float32[] is
  bfloat16, int32[n] + int64[] is int32); jax has no such rule, only
  Python scalars are weak there;
- bfloat16 with float16 is float32 in jax and in torch alike, but only
  the table below says so for every pair.

``result_dtype`` is jax's table over the dtypes the port meets (bool,
int32, int64, bfloat16, float16, float32, each 0-dim or not) and Python
scalars, which are weak in both libraries: they take the tensor's dtype
where its kind can hold them (``bf16 * 2.0`` stays bfloat16), else the
default of their kind. Other dtypes fall back to ``torch.promote_types``.
jax also rounds a weak scalar to that dtype before the op (``bf16 * 0.3``
multiplies by 0.30078125), where torch computes with the scalar unrounded;
:func:`promote` rounds it.

One difference stays, by design: jax without x64 has no 64-bit integers
(an int64 array becomes int32, and a weak int defaults to int32), so
where jax gives int32 because an operand was int64, or for bool with a
Python int, the port gives int64 (ROADMAP.md Queue 3, ``fill_constant``
with int64).
"""
import torch

_TABLE_DTYPES = (torch.bool, torch.int32, torch.int64, torch.bfloat16,
                 torch.float16, torch.float32)


def _kind(dtype):
    if dtype == torch.bool:
        return 0
    return 2 if dtype.is_floating_point else 1


def _join(a, b):
    """jax's join of two non-weak dtypes."""
    if a == b:
        return a
    if a not in _TABLE_DTYPES or b not in _TABLE_DTYPES:
        return torch.promote_types(a, b)
    ka, kb = _kind(a), _kind(b)
    if ka != kb:                       # bool < ints < floats
        return a if ka > kb else b
    if ka == 1:                        # int32 with int64
        return torch.int64
    return torch.float32               # two different floats: bf16/f16/f32


def _scalar_kind(v):
    if isinstance(v, bool):
        return 0
    return 1 if isinstance(v, int) else 2


def result_dtype(*operands):
    """jax's result dtype for tensors and Python scalars (at least one
    tensor)."""
    dtype = None
    for v in operands:
        if isinstance(v, torch.Tensor):
            dtype = v.dtype if dtype is None else _join(dtype, v.dtype)
    if dtype is None:
        raise TypeError("result_dtype needs at least one tensor")
    for v in operands:
        if not isinstance(v, torch.Tensor):
            k = _scalar_kind(v)
            if k > _kind(dtype):       # a weak scalar lifts only the kind
                dtype = torch.int64 if k == 1 else torch.float32
    return dtype


def _narrow(v, dtype):
    """Python float `v` rounded to a narrow float dtype, as jax converts a
    weak scalar; anything else as it is."""
    if isinstance(v, float) and dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(v, dtype=dtype))
    return v


def promote(*operands):
    """`operands` with every tensor cast to :func:`result_dtype` (a no-op,
    and no copy, where it has that dtype already), and Python floats
    rounded to it where it is bfloat16 or float16. The cast is
    differentiable: its gradient comes back in the operand's own dtype."""
    dtype = result_dtype(*operands)
    return tuple(v.to(dtype) if isinstance(v, torch.Tensor)
                 else _narrow(v, dtype) for v in operands)
