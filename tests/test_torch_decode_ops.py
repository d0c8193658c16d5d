"""The 13 op lowerings the GPT decode slice adds to the port, each against
the JAX lowering on the same numpy inputs and attrs.

Tolerances: data movement and comparisons exact; sums (cumsum) 1e-6 in
f32 and exact in ints. jax without x64 has no 64-bit ints, so where the
JAX lowering gives int32 the port gives int64, the declared dtype (ROADMAP
Queue 3): the values must still be equal. Index semantics are jax's, not
torch's: ``gather_nd`` and ``decode_cache_write`` (its start, as
``lax.dynamic_update_slice``) wrap a negative index once and clamp the
rest into range.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
from paddle_tpu.ops.registry import get_lowering as jax_lowering
from paddle_tpu_torch.ops.registry import LowerContext
from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering

SUM_TOL = 1e-6

NEW_OPS = ("arg_max", "concat", "cumsum", "decode_cache_write",
           "elementwise_sub", "equal", "fill_constant_batch_size_like",
           "gather_nd", "less_equal", "less_than", "range", "squeeze2",
           "stack")


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _run_both(op_type, ins, attrs):
    """The port's and the JAX package's lowering of `op_type` on the same
    numpy inputs; returns ({slot: [np]}, {slot: [np]}) and the port's
    input tensors (to check that they were left as they were)."""
    pt_ins = {k: [_torch(a) for a in v] for k, v in ins.items()}
    got = pt_lowering(op_type)(
        LowerContext(torch.device("cpu"), generator=torch.Generator()),
        pt_ins, dict(attrs))
    want = jax_lowering(op_type)(
        JaxLowerContext(rng=jax.random.PRNGKey(0), platform="cpu"),
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        dict(attrs))
    return ({k: [t.numpy() for t in v] for k, v in got.items()},
            {k: [np.asarray(x) for x in v] for k, v in want.items()},
            pt_ins)


def _assert_same(got, want, tol=0.0, slot="Out"):
    """Equal shapes, the same dtype (int64 in the port where jax gives
    int32), values within `tol` (exact at 0)."""
    for a, w in zip(got[slot], want[slot]):
        assert a.shape == w.shape, (a.shape, w.shape)
        assert a.dtype == w.dtype or (
            w.dtype == np.int32 and a.dtype == np.int64), (a.dtype, w.dtype)
        if tol:
            np.testing.assert_allclose(a, w, rtol=0, atol=tol)
        else:
            np.testing.assert_array_equal(a, w.astype(a.dtype))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ints(*shape, lo=-3, hi=9, seed=0):
    return np.random.default_rng(seed).integers(
        lo, hi, size=shape).astype(np.int64)


def test_every_new_op_has_a_port_lowering():
    for op in NEW_OPS:
        pt_lowering(op)


# ---------------------------------------------------------------------------
# math: elementwise_sub, comparisons, cumsum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("x,y,axis", [
    (_rand(2, 3, 4), _rand(2, 3, 4, seed=1), -1),
    (_rand(2, 3, 4), _rand(4, seed=1), -1),
    (_rand(2, 3, 4), _rand(3, seed=1), 1),
    (_ints(5, 1), np.ones(1, np.int64), -1),       # prefill: len - 1
])
def test_elementwise_sub(x, y, axis):
    got, want, _ = _run_both("elementwise_sub", {"X": [x], "Y": [y]},
                             {"axis": axis})
    _assert_same(got, want)


def test_elementwise_sub_bf16_promotes_to_f32():
    x = _rand(3, 4)
    y = _rand(3, 4, seed=2).astype(jnp.bfloat16)
    got = pt_lowering("elementwise_sub")(
        LowerContext(torch.device("cpu")),
        {"X": [_torch(x)],
         "Y": [_torch(y.astype(np.float32)).to(torch.bfloat16)]},
        {"axis": -1})["Out"][0]
    want = np.asarray(jax_lowering("elementwise_sub")(
        JaxLowerContext(rng=None, platform="cpu"),
        {"X": [jnp.asarray(x)], "Y": [jnp.asarray(y)]},
        {"axis": -1})["Out"][0])
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)


_STEPS = np.arange(6, dtype=np.int64)


@pytest.mark.parametrize("op", ["equal", "less_than", "less_equal"])
@pytest.mark.parametrize("x,y", [
    (_STEPS[None, :], np.array([[0], [3], [5], [9], [-1]], np.int64)),
    (_STEPS[None, :], _STEPS[:, None]),            # the causal mask
    (np.array([1.0, np.nan, 2.0, -0.0], np.float32),
     np.array([1.0, np.nan, 3.0, 0.0], np.float32)),
    (_ints(3, 4), _ints(4, seed=1)),
])
def test_comparisons(op, x, y):
    got, want, _ = _run_both(op, {"X": [x], "Y": [y]}, {})
    assert got["Out"][0].dtype == np.bool_
    _assert_same(got, want)


@pytest.mark.parametrize("attrs", [
    {"axis": -1},
    {"axis": 0},
    {"axis": 0, "exclusive": True},                # _row_coords
    {"axis": 1, "reverse": True},
    {"axis": -1, "exclusive": True, "reverse": True},
    {"axis": 1, "flatten": True},
    {"axis": 0, "flatten": True, "exclusive": True, "reverse": True},
])
@pytest.mark.parametrize("kind", ["float32", "int64"])
def test_cumsum(attrs, kind):
    x = _rand(4, 5, 3) if kind == "float32" else _ints(4, 5, 3)
    got, want, _ = _run_both("cumsum", {"X": [x]}, attrs)
    _assert_same(got, want, SUM_TOL if kind == "float32" else 0.0)


def test_cumsum_exclusive_ones_are_row_numbers():
    got, want, _ = _run_both("cumsum", {"X": [np.ones((5, 1), np.float32)]},
                             {"axis": 0, "exclusive": True})
    np.testing.assert_array_equal(got["Out"][0][:, 0], np.arange(5))
    _assert_same(got, want)


# ---------------------------------------------------------------------------
# tensor: concat, squeeze2, fill_constant_batch_size_like, gather_nd,
# stack, arg_max, range, decode_cache_write
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shapes,axis", [
    ([(2, 3), (2, 5)], 1),
    ([(2, 3, 4), (1, 3, 4), (3, 3, 4)], 0),
    ([(2, 3, 4), (2, 3, 2)], -1),
])
@pytest.mark.parametrize("kind", ["float32", "int64"])
def test_concat(shapes, axis, kind):
    xs = [(_rand(*s, seed=i) if kind == "float32" else _ints(*s, seed=i))
          for i, s in enumerate(shapes)]
    got, want, _ = _run_both("concat", {"X": xs}, {"axis": axis})
    _assert_same(got, want)


@pytest.mark.parametrize("shape,axes", [
    ((3, 1, 4), [1]),
    ((3, 4, 1), [-1]),
    ((3, 1, 4), [0]),            # not of size 1: stays
    ((1, 3, 1, 4, 1), []),       # every size-1 axis
    ((1, 3, 1), [0, 2]),
])
def test_squeeze2(shape, axes):
    got, want, _ = _run_both("squeeze2", {"X": [_rand(*shape)]},
                             {"axes": axes})
    _assert_same(got, want)
    assert got["XShape"][0].shape == (0,) + shape


@pytest.mark.parametrize("dtype,value,shape,in_idx,out_idx", [
    ("float32", 1.0, [-1, 1], 0, 0),               # _row_coords
    ("float32", 0.0, [-1, 7, 4], 0, 0),            # prefill's pad
    ("int64", 3, [2, -1], 1, 1),
    ("int32", -2, [-1, 2], 2, 0),
])
def test_fill_constant_batch_size_like(dtype, value, shape, in_idx,
                                       out_idx):
    got, want, _ = _run_both(
        "fill_constant_batch_size_like", {"Input": [_rand(5, 3, 6)]},
        {"shape": shape, "dtype": dtype, "value": float(value),
         "input_dim_idx": in_idx, "output_dim_idx": out_idx})
    assert got["Out"][0].dtype == np.dtype(dtype)
    _assert_same(got, want)


@pytest.mark.parametrize("x_shape,index", [
    ((5, 2), [[7], [-1], [-7], [-6], [2]]),          # past the end, negative
    ((4, 6, 3), [[0, 5], [3, 0], [1, 9], [2, -2]]),  # _row_coords into (B,P,H)
    ((4, 6, 3), [[[0, 1, 2], [3, 5, 0]], [[9, -9, 4], [1, 1, 1]]]),
    ((16, 8), [[3], [0], [15], [16]]),               # the position table
])
def test_gather_nd(x_shape, index):
    x = _rand(*x_shape)
    got, want, _ = _run_both("gather_nd",
                             {"X": [x], "Index": [np.asarray(index,
                                                              np.int64)]},
                             {})
    _assert_same(got, want)


def test_gather_nd_reads_clamped_and_wrapped_rows():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    got, _, _ = _run_both("gather_nd",
                          {"X": [x], "Index": [np.array([[7], [-1]])]}, {})
    np.testing.assert_array_equal(got["Out"][0], x[[4, 4]])


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_stack(axis):
    xs = [_rand(2, 3, 4, seed=i) for i in range(3)]
    got, want, _ = _run_both("stack", {"X": xs}, {"axis": axis})
    _assert_same(got, want, slot="Y")


@pytest.mark.parametrize("x,axis", [
    (np.array([[1.0, 3.0, 3.0, 2.0], [5.0, 5.0, 5.0, 5.0]], np.float32), -1),
    (np.array([[1.0, np.nan, 3.0, np.nan], [np.nan, 0.0, 9.0, 1.0]],
              np.float32), -1),
    (np.array([[1.0, 3.0], [3.0, 3.0], [0.0, 3.0]], np.float32), 0),
    (_rand(3, 7, 5), 1),
    (_ints(4, 6, lo=0, hi=3), -1),
])
def test_arg_max_first_index_on_ties_and_nan(x, axis):
    got, want, _ = _run_both("arg_max", {"X": [x]}, {"axis": axis})
    assert got["Out"][0].dtype == np.int64
    _assert_same(got, want)


@pytest.mark.parametrize("dtype", ["int64", "int32", "float32"])
@pytest.mark.parametrize("start,end,step", [
    (0, 1024, 1),          # the decode mask's steps
    (0, 7, 1),
    (3, 20, 4),
    (0, 1, 0.1),           # numpy's float32 fill: ends in 0.90000004
    (5, -3, -0.7),
    (2, 2, 1),             # empty
])
def test_range(dtype, start, end, step):
    got, want, _ = _run_both("range", {}, {"start": float(start),
                                          "end": float(end),
                                          "step": float(step),
                                          "dtype": dtype})
    assert got["Out"][0].dtype == np.dtype(dtype)
    _assert_same(got, want)


def test_range_from_tensors():
    got, want, _ = _run_both(
        "range", {"Start": [np.array(1.0, np.float32)],
                  "End": [np.array(9.0, np.float32)],
                  "Step": [np.array(2.0, np.float32)]},
        {"dtype": "int64"})
    _assert_same(got, want)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("pos", [
    [[3], [0], [7], [1]],
    [[7], [8], [100], [-1]],       # at or past cache_len, negative
    [[-5], [2], [2], [-20]],
])
def test_decode_cache_write(per_row, pos):
    cache = _rand(4, 8, 6)
    val = _rand(4, 1, 6, seed=1)
    pos = np.asarray(pos, np.int64)
    before = cache.copy()
    got, want, pt_ins = _run_both(
        "decode_cache_write",
        {"Cache": [cache], "Value": [val], "Pos": [pos]},
        {"per_row": per_row})
    _assert_same(got, want)
    # functional: the fed cache is left as it was
    np.testing.assert_array_equal(pt_ins["Cache"][0].numpy(), before)
    # where each row's value landed: a negative start wrapped once, then
    # clamped into [0, T - 1]
    start = pos[:, 0] if per_row else np.repeat(pos[0, 0], 4)
    rows = np.clip(np.where(start < 0, start + 8, start), 0, 7)
    out = got["Out"][0]
    for b, r in enumerate(rows):
        np.testing.assert_array_equal(out[b, r], val[b, 0])


@pytest.mark.parametrize("per_row", [False, True])
def test_decode_cache_write_block_clamps_to_fit(per_row):
    """A (B, P, H) value (a delta prefill or a verify block) whose start
    lies too near the end is moved back to end at T, as
    dynamic_update_slice clamps."""
    cache = _rand(3, 8, 4)
    val = _rand(3, 3, 4, seed=1)
    pos = np.array([[6], [2], [-2]], np.int64)
    got, want, _ = _run_both(
        "decode_cache_write",
        {"Cache": [cache], "Value": [val], "Pos": [pos]},
        {"per_row": per_row})
    _assert_same(got, want)


def test_decode_cache_write_sliced_layer_view():
    """The step writes into a (S, T, H) view of one layer of the
    (S, L, T, H) pair: the pair stays as it was."""
    pair = torch.from_numpy(_rand(2, 3, 8, 4))
    before = pair.clone()
    view = pair[:, 1]
    out = pt_lowering("decode_cache_write")(
        LowerContext(torch.device("cpu")),
        {"Cache": [view], "Value": [torch.ones(2, 1, 4)],
         "Pos": [torch.tensor([[2], [9]])]}, {"per_row": True})["Out"][0]
    assert torch.equal(pair, before)
    assert torch.equal(out[0, 2], torch.ones(4))
    assert torch.equal(out[1, 7], torch.ones(4))
    assert torch.equal(out[0, :2], view[0, :2])
