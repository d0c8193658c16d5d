"""Each op lowering of the BERT inference slice against the JAX lowering,
with the same numpy inputs and attrs. Tolerances: 1e-6 for data movement
(exact in practice), 1e-5 for arithmetic (f32, different summation
order). fill_constant and uniform_random are checked for shape, dtype and
range only: torch's generator draws other values than jax's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
from paddle_tpu.ops.registry import get_lowering as jax_lowering
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.ops.registry import LowerContext
from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering

MOVE_TOL = 1e-6
MATH_TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, name generator and scope of the port."""
    old_main = pt_framework.switch_main_program(pt_framework.Program())
    old_startup = pt_framework.switch_startup_program(pt_framework.Program())
    old_gen = pt_unique_name.switch()
    old_scopes = pt_executor._scope_stack[:]
    pt_executor._scope_stack[:] = [pt_executor.Scope()]
    yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)
    pt_executor._scope_stack[:] = old_scopes


def _run_both(op_type, ins, attrs):
    """Run the port's and the JAX package's lowering of `op_type` on the
    same numpy inputs; returns ({slot: [np]}, {slot: [np]})."""
    pt_ctx = LowerContext(torch.device("cpu"), generator=torch.Generator())
    jax_ctx = JaxLowerContext(rng=jax.random.PRNGKey(0), platform="cpu")
    got = pt_lowering(op_type)(
        pt_ctx, {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
                 for k, v in ins.items()}, dict(attrs))
    want = jax_lowering(op_type)(
        jax_ctx, {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        dict(attrs))
    to_np = lambda d: {k: [np.asarray(x) for x in v] for k, v in d.items()}
    return ({k: [t.numpy() for t in v] for k, v in got.items()},
            to_np(want))


def _assert_close(got, want, tol, slots=("Out",)):
    for slot in slots:
        for a, w in zip(got[slot], want[slot]):
            assert a.shape == w.shape, (slot, a.shape, w.shape)
            assert a.dtype == w.dtype, (slot, a.dtype, w.dtype)
            np.testing.assert_allclose(a, w, rtol=0, atol=tol)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("xs,ys,axis", [
    ((2, 3, 4), (2, 3, 4), -1),     # same shape
    ((2, 3, 4), (4,), -1),          # trailing broadcast
    ((2, 3, 4), (4,), 2),           # fc bias, axis = num_flatten_dims
    ((2, 3, 4), (1, 3, 4), -1),     # BERT position add (unsqueezed)
    ((2, 3, 4), (3,), 1),           # mid-axis alignment
])
def test_elementwise_add(xs, ys, axis):
    got, want = _run_both("elementwise_add",
                          {"X": [_rand(*xs)], "Y": [_rand(*ys, seed=1)]},
                          {"axis": axis})
    _assert_close(got, want, MATH_TOL)


@pytest.mark.parametrize("xs,ys,xnc", [((2, 3, 8), (8, 5), 2),
                                       ((4, 6), (6, 3), 1)])
def test_mul(xs, ys, xnc):
    got, want = _run_both("mul", {"X": [_rand(*xs)], "Y": [_rand(*ys, seed=1)]},
                          {"x_num_col_dims": xnc, "y_num_col_dims": 1})
    _assert_close(got, want, MATH_TOL)


@pytest.mark.parametrize("xs,ys,tx,ty,alpha", [
    ((2, 3, 4, 8), (2, 3, 5, 8), False, True, 0.125),   # q @ k^T
    ((2, 5, 16), (30, 16), False, True, 1.0),           # tied MLM head
    ((2, 8, 4), (2, 8, 6), True, False, 1.0),
])
def test_matmul(xs, ys, tx, ty, alpha):
    got, want = _run_both("matmul", {"X": [_rand(*xs)], "Y": [_rand(*ys, seed=1)]},
                          {"transpose_X": tx, "transpose_Y": ty,
                           "alpha": alpha})
    _assert_close(got, want, MATH_TOL)


@pytest.mark.parametrize("shape", [[0, 0, 4, 2], [-1, 8], [6, 0, -1]])
def test_reshape2(shape):
    got, want = _run_both("reshape2", {"X": [_rand(6, 3, 8)]},
                          {"shape": shape})
    _assert_close(got, want, MOVE_TOL, slots=("Out", "XShape"))


def test_transpose2():
    got, want = _run_both("transpose2", {"X": [_rand(2, 3, 4, 5)]},
                          {"axis": [0, 2, 1, 3]})
    _assert_close(got, want, MOVE_TOL, slots=("Out", "XShape"))


@pytest.mark.parametrize("axes", [[0], [1, 3], [-1]])
def test_unsqueeze2(axes):
    got, want = _run_both("unsqueeze2", {"X": [_rand(3, 4)]},
                          {"axes": axes})
    _assert_close(got, want, MOVE_TOL, slots=("Out", "XShape"))


@pytest.mark.parametrize("axes,starts,ends", [
    ([2], [8], [16]), ([0], [0], [5]), ([0, 2], [-3, 1], [100, -2])])
def test_slice(axes, starts, ends):
    got, want = _run_both("slice", {"Input": [_rand(6, 3, 24)]},
                          {"axes": axes, "starts": starts, "ends": ends})
    _assert_close(got, want, MOVE_TOL)


@pytest.mark.parametrize("padding_idx", [-1, 3])
def test_lookup_table_v2(padding_idx):
    ids = np.random.default_rng(2).integers(0, 10, size=(3, 7)).astype(
        np.int64)
    ids[0, :3] = [3, -2, 12]   # padding row, negative (wraps), out of range
    got, want = _run_both("lookup_table_v2",
                          {"W": [_rand(10, 6)], "Ids": [ids]},
                          {"padding_idx": padding_idx})
    _assert_close(got, want, MOVE_TOL)


@pytest.mark.parametrize("approximate", [False, True])
def test_gelu(approximate):
    got, want = _run_both("gelu", {"X": [_rand(4, 33) * 3]},
                          {"approximate": approximate})
    _assert_close(got, want, MATH_TOL)


def test_layer_norm():
    rng = np.random.default_rng(4)
    got, want = _run_both(
        "layer_norm",
        {"X": [_rand(2, 5, 16)], "Scale": [rng.normal(size=16).astype(
            np.float32)], "Bias": [rng.normal(size=16).astype(np.float32)]},
        {"epsilon": 1e-5, "begin_norm_axis": 2})
    _assert_close(got, want, MATH_TOL, slots=("Y", "Mean"))
    _assert_close(got, want, 10 * MATH_TOL, slots=("Variance",))


@pytest.mark.parametrize("causal,use_kpm", [(False, False), (True, True)])
def test_fused_multihead_attention(causal, use_kpm):
    q, k, v = (_rand(2, 2, 24, 8, seed=s) for s in range(3))
    ins = {"Q": [q], "K": [k], "V": [v]}
    if use_kpm:
        kpm = np.zeros((2, 24), np.float32)
        kpm[:, -5:] = -1e30
        ins["KeyPaddingMask"] = [kpm]
    got, want = _run_both("fused_multihead_attention", ins,
                          {"causal": causal, "dropout_prob": 0.1,
                           "is_test": True})
    _assert_close(got, want, 2e-5)


@pytest.mark.parametrize("dtype,value", [("float32", 1.0), ("int32", 7.0),
                                         ("float32", 0.0)])
def test_fill_constant(dtype, value):
    got, want = _run_both("fill_constant", {},
                          {"shape": [3, 4], "dtype": dtype, "value": value})
    _assert_close(got, want, 0.0)


def test_uniform_random_shape_dtype_range():
    attrs = {"shape": [64, 32], "dtype": "float32", "min": -0.5, "max": 0.5,
             "seed": 0}
    got, want = _run_both("uniform_random", {}, attrs)
    a, w = got["Out"][0], want["Out"][0]
    assert a.shape == w.shape == (64, 32)
    assert a.dtype == w.dtype == np.float32
    assert a.min() >= -0.5 and a.max() < 0.5
    assert abs(float(a.mean())) < 0.05 and a.std() > 0.2


def test_unported_op_names_the_gap():
    # every op type of the JAX package's registry is ported (the
    # collectives came last, with the parallel slice): an unknown type
    # still names the gap
    with pytest.raises(NotImplementedError, match="no torch lowering yet"):
        pt_lowering("no_such_op")
