"""Mixed-precision training (fluid.contrib.mixed_precision) in the port
against the JAX package, on the CPU.

- The 11 op types dynamic loss scaling adds (cast, assign,
  fill_zeros_like, where, elementwise_mul/div/max, scale, reduce_sum,
  greater_equal, isfinite) get the same inputs and attrs as the JAX
  lowerings: values and dtypes exact (f32 elementwise, casts, small
  integer-valued sums, and bfloat16 where both compute the same roundings).
- jax's dtype promotion: every binary lowering gives jax's result dtype
  for each pair of bool, int32, int64, bfloat16, float16 and float32, with
  Y 0-dim or not, save the one named difference (int64 where jax, without
  x64, says int32; ops/promotion.py).
- ``decorate`` builds the same Program JSON in both packages, bf16 and
  dynamic scaling; the scale, good-steps and bad-steps trajectory is
  identical; an overflow step leaves every optimizer state bit-identical;
  the scale floors at 1; a power-of-two scale gives the f32 step's bits.
- bert_tiny in bf16 AMP + Adam, 5 steps in both packages: see
  :func:`test_bert_tiny_bf16_amp_matches_jax` for the tolerances and how
  they were chosen.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.fluid.contrib import mixed_precision as jmp
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
from paddle_tpu.ops.registry import get_lowering as jax_lowering
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import lowering as pt_lowering_mod
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.contrib import mixed_precision as mp
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops.promotion import result_dtype
from paddle_tpu_torch.ops.registry import LowerContext
from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering

SEQ = 16
DTYPES = ["bool", "int32", "int64", "bfloat16", "float16", "float32"]


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


# ---------------------------------------------------------------------------
# helpers: one input in both packages, both lowerings, results as numpy
# ---------------------------------------------------------------------------
def _pair(a, dtype=None):
    """(torch tensor, jax array) of numpy `a` in `dtype` (a name; default
    a's own): a bfloat16 pair is rounded from the same f32 values."""
    dtype = dtype or str(a.dtype)
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(getattr(torch, dtype)), jnp.asarray(a).astype(dtype)


def _np(v):
    """(values widened to float64, dtype name) of a torch or jax result."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return v.double().numpy(), str(v.dtype)[len("torch."):]
    v = np.asarray(v)
    return v.astype(np.float64), str(v.dtype)


def _run_both(op_type, ins, attrs=None):
    """The port's and the JAX package's lowering of `op_type`; `ins` maps a
    slot to a list of :func:`_pair`s. Returns ({slot: [(values, dtype)]},
    the same for jax)."""
    got = pt_lowering(op_type)(
        LowerContext(torch.device("cpu"), generator=torch.Generator()),
        {k: [p[0] for p in v] for k, v in ins.items()}, dict(attrs or {}))
    want = jax_lowering(op_type)(
        JaxLowerContext(rng=jax.random.PRNGKey(0), platform="cpu"),
        {k: [p[1] for p in v] for k, v in ins.items()}, dict(attrs or {}))
    return ({k: [_np(x) for x in v] for k, v in got.items()},
            {k: [_np(x) for x in v] for k, v in want.items()})


def _assert_same(got, want, slot="Out"):
    """Same shapes, dtypes and values, bit for bit (NaN where NaN)."""
    for (a, adt), (w, wdt) in zip(got[slot], want[slot]):
        assert adt == wdt, (slot, adt, wdt)
        assert a.shape == w.shape, (slot, a.shape, w.shape)
        np.testing.assert_array_equal(a, w, err_msg=slot)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ints(*shape, seed=0, lo=-4, hi=5):
    """Small integer values as f32: sums and products of a few of them are
    exact in every float dtype, whatever the order."""
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the 11 op types
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("op", ["elementwise_mul", "elementwise_div",
                                "elementwise_max"])
@pytest.mark.parametrize("xs,ys,axis", [
    ((2, 3, 4), (2, 3, 4), -1),
    ((2, 3, 4), (4,), -1),
    ((2, 3, 4), (3,), 1),
    ((2, 3, 4), (), -1),            # a 0-dim Y, as the loss-scale product
    ((1,), (1,), -1),               # the [1] state vars of the scale update
])
def test_elementwise_f32_exact(op, xs, ys, axis):
    y = _rand(*ys, seed=1)
    if op == "elementwise_div":
        y = np.where(np.abs(y) < 0.1, 0.5, y).astype(np.float32)
    got, want = _run_both(op, {"X": [_pair(_rand(*xs))], "Y": [_pair(y)]},
                          {"axis": axis})
    _assert_same(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_greater_equal(dtype):
    # ties on purpose: small integers
    got, want = _run_both("greater_equal",
                          {"X": [_pair(_ints(5, 6), dtype)],
                           "Y": [_pair(_ints(5, 6, seed=1), dtype)]},
                          {"axis": -1})
    _assert_same(got, want)
    assert got["Out"][0][1] == "bool"


@pytest.mark.parametrize("src,dst", [
    ("float32", "bfloat16"), ("bfloat16", "float32"), ("bool", "float32"),
    ("float32", "float16"), ("float32", "int32"), ("int32", "float32"),
])
def test_cast(src, dst):
    x = _rand(4, 7) * 300          # past bfloat16's 8 bits, and negative
    x[0, :3] = [np.inf, -np.inf, np.nan]
    if src == "bool":
        x = x > 0
    elif dst.startswith("int") or src.startswith("int"):
        x = np.nan_to_num(x, posinf=0, neginf=0)
    got, want = _run_both("cast", {"X": [_pair(x, src)]},
                          {"in_dtype": src, "out_dtype": dst})
    _assert_same(got, want)
    assert got["Out"][0][1] == dst


def test_cast_gradient_comes_back_in_the_input_dtype():
    """d sum(c · cast(w, bf16)) / dw: f32, and the same values as jax's
    (the transpose of convert_element_type)."""
    w, c = _rand(6, 5), _rand(6, 5, seed=1)
    wt = torch.from_numpy(w).requires_grad_()
    out = pt_lowering("cast")(LowerContext(torch.device("cpu")),
                              {"X": [wt]}, {"out_dtype": "bfloat16"})
    got, = torch.autograd.grad(
        (out["Out"][0] * torch.from_numpy(c).to(torch.bfloat16)).sum(), wt)

    def f(w):
        o = jax_lowering("cast")(JaxLowerContext(platform="cpu"), {"X": [w]},
                                 {"out_dtype": "bfloat16"})["Out"][0]
        return jnp.sum(o * jnp.asarray(c).astype(jnp.bfloat16))

    want = jax.grad(f)(jnp.asarray(w))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bias_after_scale", [True, False])
@pytest.mark.parametrize("scale,bias", [(-1.0, 1.0), (0.3, 0.7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bool"])
def test_scale(bias_after_scale, scale, bias, dtype):
    x = _rand(3, 8)
    if dtype == "bool":
        x = x > 0
    got, want = _run_both("scale", {"X": [_pair(x, dtype)]},
                          {"scale": scale, "bias": bias,
                           "bias_after_scale": bias_after_scale})
    _assert_same(got, want)
    assert got["Out"][0][1] == dtype


def test_scale_tensor():
    """A ScaleTensor (f32 [1]) on bfloat16 x: computed in f32 and cast back
    to x's dtype, as the JAX lowering does."""
    got, want = _run_both("scale", {"X": [_pair(_rand(3, 8), "bfloat16")],
                                    "ScaleTensor": [_pair(
                                        np.array([0.3], np.float32))]},
                          {"bias": 0.5, "bias_after_scale": True})
    _assert_same(got, want)


@pytest.mark.parametrize("dim,keep_dim,reduce_all", [
    (None, False, True), (None, True, True), ([1], False, False),
    ([0, 2], True, False), ([-1], False, False), ([0, 1, 2], False, False),
    ([], False, False),             # no axis: jnp.sum(axis=()) sums nothing
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_reduce_sum(dim, keep_dim, reduce_all, dtype):
    got, want = _run_both("reduce_sum", {"X": [_pair(_ints(3, 4, 5), dtype)]},
                          {"dim": dim, "keep_dim": keep_dim,
                           "reduce_all": reduce_all})
    _assert_same(got, want)


def test_reduce_sum_of_bool_is_int64_where_jax_says_int32():
    """The named difference (ops/promotion.py): jax without x64 counts in
    int32, the port in int64; the values agree."""
    x = _rand(4, 6) > 0
    got, want = _run_both("reduce_sum", {"X": [_pair(x)]},
                          {"dim": None, "keep_dim": False, "reduce_all": True})
    assert got["Out"][0][1] == "int64" and want["Out"][0][1] == "int32"
    assert got["Out"][0][0] == want["Out"][0][0] == x.sum()


@pytest.mark.parametrize("poison", [None, np.inf, -np.inf, np.nan])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_isfinite(poison, dtype):
    x = _rand(5, 7)
    if poison is not None:
        x[3, 2] = poison
    got, want = _run_both("isfinite", {"X": [_pair(x, dtype)]})
    _assert_same(got, want)
    assert got["Out"][0][0].shape == () and got["Out"][0][1] == "bool"
    assert bool(got["Out"][0][0]) == (poison is None)


def test_isfinite_of_ints_is_true():
    got, want = _run_both("isfinite", {"X": [_pair(_ints(3, 3), "int32")]})
    _assert_same(got, want)
    assert bool(got["Out"][0][0])


@pytest.mark.parametrize("cond_shape", [(4, 5), ()])
@pytest.mark.parametrize("ydt", ["float32", "bfloat16"])
def test_where(cond_shape, ydt):
    """A 0-dim condition over n-dim X and Y is how the dynamic scaling
    zeroes a non-finite gradient."""
    cond = np.asarray(_rand(*cond_shape, seed=2) > 0)
    x, y = _rand(4, 5), _rand(4, 5, seed=1)
    x[0, 0] = np.nan               # a select, not an arithmetic blend
    got, want = _run_both("where", {"Condition": [_pair(cond)],
                                    "X": [_pair(x)], "Y": [_pair(y, ydt)]})
    _assert_same(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_fill_zeros_like_and_assign(dtype):
    x = _pair(_ints(3, 5), dtype)
    for op in ("fill_zeros_like", "assign"):
        got, want = _run_both(op, {"X": [x]})
        _assert_same(got, want)


# ---------------------------------------------------------------------------
# jax's promotion in every binary lowering
# ---------------------------------------------------------------------------
def _operand(dtype, shape, seed):
    vals = _ints(*shape, seed=seed, lo=1, hi=4)   # nonzero: Y divides
    return _pair(vals > 1 if dtype == "bool" else vals, dtype)


def _port_dtype(jax_dtype, *dtypes):
    """The dtype the port owes where jax gives `jax_dtype`: int64 for
    jax's int32 when an operand was int64 (jax without x64 has no int64)."""
    if jax_dtype == "int32" and "int64" in dtypes:
        return "int64"
    return jax_dtype


@pytest.mark.parametrize("y_shape", [(3, 4), ()], ids=["n-dim", "0-dim"])
@pytest.mark.parametrize("op", ["elementwise_add", "elementwise_mul",
                                "elementwise_div", "elementwise_max",
                                "greater_equal", "where"])
def test_promotion_table(op, y_shape):
    for xdt in DTYPES:
        for ydt in DTYPES:
            x = _operand(xdt, (3, 4), 0)
            y = _operand(ydt, y_shape, 1)
            if op == "where":
                cond = _pair(_rand(3, 4) > 0)
                got, want = _run_both(op, {"Condition": [cond], "X": [x],
                                           "Y": [y]})
            else:
                got, want = _run_both(op, {"X": [x], "Y": [y]},
                                      {"axis": -1})
            (a, adt), = got["Out"]
            (w, wdt), = want["Out"]
            assert adt == _port_dtype(wdt, xdt, ydt), (op, xdt, ydt, adt, wdt)
            np.testing.assert_allclose(a, w, rtol=2 ** -8,
                                       err_msg="%s %s %s" % (op, xdt, ydt))


@pytest.mark.parametrize("op", ["mul", "matmul"])
def test_product_promotion(op):
    """Products over the float dtypes AMP meets: bf16 × f32 is f32 (torch
    alone raises), bf16 × bf16 stays bf16."""
    floats = ["bfloat16", "float16", "float32"]
    for xdt in floats:
        for ydt in floats:
            x, y = _operand(xdt, (2, 3, 4), 0), _operand(ydt, (4, 5), 1)
            attrs = ({"x_num_col_dims": 2, "y_num_col_dims": 1}
                     if op == "mul" else {})
            got, want = _run_both(op, {"X": [x], "Y": [y]}, attrs)
            _assert_same(got, want)


def test_soft_label_product_promotes():
    """f32 soft labels on bfloat16 logits: the loss is f32, as jax's
    ``label * logp`` makes it; within one bfloat16 ulp (2^-8 relative) of
    jax's, the rounding of the bfloat16 log-softmax it sums."""
    soft = np.random.default_rng(2).random((4, 9)).astype(np.float32)
    soft /= soft.sum(axis=-1, keepdims=True)
    got, want = _run_both("softmax_with_cross_entropy",
                          {"Logits": [_pair(_rand(4, 9), "bfloat16")],
                           "Label": [_pair(soft)]},
                          {"soft_label": True, "axis": -1})
    assert got["Loss"][0][1] == want["Loss"][0][1] == "float32"
    assert got["Softmax"][0][1] == want["Softmax"][0][1] == "bfloat16"
    np.testing.assert_allclose(got["Loss"][0][0], want["Loss"][0][0],
                               rtol=2 ** -8)


@pytest.mark.parametrize("scalar", [True, 2, 2.5])
def test_result_dtype_of_python_scalars(scalar):
    """Python scalars are weak in both libraries: they take the tensor's
    dtype where its kind holds them."""
    for dt in DTYPES:
        t, j = _operand(dt, (3,), 0)
        want = str((j + scalar).dtype)
        got = str(result_dtype(t, scalar))[len("torch."):]
        if dt == "bool" and isinstance(scalar, int) \
                and not isinstance(scalar, bool):
            want = _port_dtype(want, "int64")   # jax's weak int is int32
        assert got == _port_dtype(want, dt), (dt, scalar, got, want)


# ---------------------------------------------------------------------------
# the SkipGate and the executor's f32 sums
# ---------------------------------------------------------------------------
def _fc_program(pkg, decorate_kw=None, mp_mod=None, width=3):
    """x -> fc(width) -> fc(1) -> mean, Adam(0.1), decorated with
    ``mp_mod.decorate(**decorate_kw)`` when given. Returns (main, startup,
    loss, optimizer)."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.data("x", shape=[None, 4], dtype="float32")
        h = pkg.layers.fc(x, size=width, param_attr=pkg.ParamAttr(name="w1"))
        y = pkg.layers.fc(h, size=1, param_attr=pkg.ParamAttr(name="w2"))
        loss = pkg.layers.mean(y)
        opt = pkg.optimizer.Adam(learning_rate=0.1)
        if decorate_kw is not None:
            opt = mp_mod.decorate(opt, **decorate_kw)
        opt.minimize(loss)
    return main, startup, loss, opt


def _both_from_jax_start(jmain, jstart, pmain, seed=7):
    """JAX and port scopes holding the same startup values (the JAX
    startup run with a fixed seed, copied by name)."""
    jstart.random_seed = seed
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=jscope)
    scope = fluid.Scope()
    names = [v.name for v in pmain.global_block().vars.values()
             if v.persistable and v.name in jscope]
    for n, t in params_from_numpy({n: np.array(jscope[n]) for n in names},
                                  torch.device("cpu")).items():
        scope.set(n, t)
    return jscope, scope


def _state(scope, names):
    return {n: np.array(scope[n].numpy() if isinstance(scope[n], torch.Tensor)
                        else scope[n]) for n in names}


def test_skip_gate_on_adam():
    """A SkipGate input on every adam op: where it reads 0 the op is a
    true no-op (param, moments and beta powers keep their bits), where it
    reads 1 the update is the ungated one; both packages agree."""
    runs = {}
    for pkg in (jfluid, fluid):
        main, startup, loss, _ = _fc_program(pkg)
        block = main.global_block()
        block.create_var(name="gate", shape=[1], dtype="float32")
        adams = [op for op in block.ops if op.type == "adam"]
        assert len(adams) == 4
        for op in adams:
            op.inputs["SkipGate"] = ["gate"]
        runs[pkg] = main, startup, adams
    jmain, jstart, jadams = runs[jfluid]
    pmain, _, padams = runs[fluid]
    state = sorted({n for op in padams for ns in op.outputs.values()
                    for n in ns})
    jscope, scope = _both_from_jax_start(jmain, jstart, pmain)
    jexe, exe = jfluid.Executor(jfluid.CPUPlace()), fluid.Executor(
        fluid.CPUPlace())
    x = _rand(2, 4, seed=3)
    before = _state(scope, state)
    for gate in (0.0, 1.0):
        feed = {"x": x, "gate": np.array([gate], np.float32)}
        jexe.run(jmain, feed=feed, scope=jscope)
        exe.run(pmain, feed=feed, scope=scope)
        got = _state(scope, state)
        for n in state:
            np.testing.assert_allclose(got[n], np.asarray(jscope[n]),
                                       rtol=1e-6, atol=1e-7, err_msg=n)
            if gate == 0.0:
                np.testing.assert_array_equal(got[n], before[n], err_msg=n)
    moved = [n for n in state if not np.array_equal(got[n], before[n])]
    assert sorted(moved) == state          # the open gate moved everything


def test_f32_accumulation_is_scoped():
    """The executor's context turns cuBLAS's reduced-precision bf16/fp16
    reductions off and gives the caller's settings back when the last
    concurrent run leaves."""
    flags = torch.backends.cuda.matmul
    old = (flags.allow_bf16_reduced_precision_reduction,
           flags.allow_fp16_reduced_precision_reduction)
    try:
        flags.allow_bf16_reduced_precision_reduction = True
        flags.allow_fp16_reduced_precision_reduction = True
        with pt_lowering_mod.f32_precision():
            assert not flags.allow_bf16_reduced_precision_reduction
            assert not flags.allow_fp16_reduced_precision_reduction
            with pt_lowering_mod.f32_precision():
                flags.allow_bf16_reduced_precision_reduction = False
            # an inner run leaving does not give the settings back
            assert not flags.allow_bf16_reduced_precision_reduction
        assert flags.allow_bf16_reduced_precision_reduction
        assert flags.allow_fp16_reduced_precision_reduction
    finally:
        (flags.allow_bf16_reduced_precision_reduction,
         flags.allow_fp16_reduced_precision_reduction) = old


# ---------------------------------------------------------------------------
# dynamic loss scaling in both packages
# ---------------------------------------------------------------------------
DYN = dict(use_bf16=False, use_dynamic_loss_scaling=True,
           init_loss_scaling=2.0 ** 4, incr_every_n_steps=2,
           decr_every_n_nan_or_inf=2, incr_ratio=2.0, decr_ratio=0.5)


def test_dynamic_scaling_trajectory_matches_jax():
    """Scale, good steps, bad steps and the finite flag over a fixed
    sequence of good and bad feeds (inf and NaN) are identical in both
    packages, through a raise (2 good steps), decays (2 bad steps), resets
    and the floor at 1; losses and parameters agree as f32 does."""
    jmain, jstart, jloss, jopt = _fc_program(jfluid, DYN, jmp)
    pmain, _, loss, opt = _fc_program(fluid, DYN, mp)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    jscope, scope = _both_from_jax_start(jmain, jstart, pmain)
    fetch = [opt.get_loss_scaling(), opt._good_steps, opt._bad_steps,
             opt.get_finite_flag()]
    jfetch = [jopt.get_loss_scaling(), jopt._good_steps, jopt._bad_steps,
              jopt.get_finite_flag()]
    jexe, exe = jfluid.Executor(jfluid.CPUPlace()), fluid.Executor(
        fluid.CPUPlace())
    seq = "GGGBGBBGGGB" + "BN" * 6 + "GG"
    seen = []
    for i, kind in enumerate(seq):
        x = _rand(2, 4, seed=i)
        if kind != "G":
            x[1, 2] = np.inf if kind == "B" else np.nan
        jout = jexe.run(jmain, feed={"x": x}, fetch_list=[jloss] + jfetch,
                        scope=jscope)
        pout = exe.run(pmain, feed={"x": x}, fetch_list=[loss] + fetch,
                       scope=scope)
        for a, w in zip(pout[1:], jout[1:]):
            np.testing.assert_array_equal(a, np.asarray(w), err_msg=str(i))
        np.testing.assert_allclose(pout[0], np.asarray(jout[0]), rtol=1e-6,
                                   atol=1e-6)
        seen.append(float(pout[1][0]))
    for n in ("w1", "w2"):
        np.testing.assert_allclose(scope[n].numpy(), np.asarray(jscope[n]),
                                   rtol=1e-6, atol=1e-7)
    assert max(seen) == 32.0 and seen[-3] == 1.0, seen   # raised; floored


def test_amp_overflow_skips_optimizer_state():
    """Port of tests/test_round4_fixes.py's test of the same name: an
    overflow step leaves the weights, both moments and both beta powers
    bit-identical, and the next good step moves them again."""
    main, startup, loss, _ = _fc_program(fluid, dict(
        init_loss_scaling=8.0, use_dynamic_loss_scaling=True,
        use_bf16=False, decr_every_n_nan_or_inf=1, decr_ratio=0.5), mp,
        width=1)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    scope = fluid.global_scope()

    def snap():
        return {n: scope[n].clone() for n in scope.keys()
                if "moment" in n or "beta" in n or n in ("w1", "w2")}

    ok = np.ones((2, 4), "float32")
    exe.run(main, feed={"x": ok}, fetch_list=[loss])
    before = snap()
    assert sum("moment" in k for k in before) == 8, list(before)
    exe.run(main, feed={"x": np.full((2, 4), np.inf, "float32")},
            fetch_list=[loss])
    after = snap()
    for k, v in before.items():
        assert torch.equal(v, after[k]), \
            "state %s advanced on an overflow step" % k
    exe.run(main, feed={"x": ok}, fetch_list=[loss])
    moved = snap()
    assert all(not torch.equal(moved[k], after[k]) for k in moved
               if "beta" in k or k in ("w1", "w2"))


def test_amp_scale_floors_at_one():
    """Port of tests/test_round4_fixes.py's test of the same name, with
    Adam: a streak of overflow steps decays the scale to 1 and no further,
    and the parameters stay finite."""
    main, startup, loss, opt = _fc_program(fluid, dict(
        init_loss_scaling=2.0, use_dynamic_loss_scaling=True,
        use_bf16=False, decr_every_n_nan_or_inf=1, decr_ratio=0.5), mp)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    bad = np.full((2, 4), np.inf, "float32")
    for _ in range(4):
        exe.run(main, feed={"x": bad}, fetch_list=[loss])
    scope = fluid.global_scope()
    assert float(scope[opt.get_loss_scaling().name]) == 1.0
    for n in ("w1", "w2"):
        assert torch.isfinite(scope[n]).all()


def test_power_of_two_scale_gives_the_f32_bits():
    """bert_tiny + Adam with a dynamic loss scale of 2^15 against the
    undecorated f32 program from the same parameters, 3 steps: every
    parameter, moment and loss bit-identical. A power of two and its
    inverse scale every gradient exactly, in every op of the step."""
    results = []
    for scaled in (False, True):
        pt_unique_name.switch()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            io = bert.build_bert_pretrain(bert.bert_tiny(SEQ), SEQ)
            opt = fluid.optimizer.Adam(learning_rate=1e-4)
            if scaled:
                opt = mp.decorate(opt, use_bf16=False,
                                  init_loss_scaling=2.0 ** 15)
            opt.minimize(io["loss"])
        startup.random_seed = 11
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        ids, labels = bert.synthetic_batch(bert.bert_tiny(SEQ), 2, SEQ,
                                           seed=3)
        losses = [exe.run(main, feed={"input_ids": ids, "mlm_labels": labels},
                          fetch_list=[io["loss"]], scope=scope)[0]
                  for _ in range(3)]
        results.append((losses, {n: t.clone() for n, t in scope.items()}))
    (plain_losses, plain), (scaled_losses, scaled) = results
    assert [float(x) for x in plain_losses] == [float(x)
                                                for x in scaled_losses]
    assert set(plain) < set(scaled)          # the scale's own state too
    for n, t in plain.items():
        assert torch.equal(t, scaled[n]), n


# ---------------------------------------------------------------------------
# the decorator's surface and Program parity
# ---------------------------------------------------------------------------
def _build_bert_amp(pkg, bert_mod, mp_mod, **kw):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        io = bert_mod.build_bert_pretrain(bert_mod.bert_tiny(SEQ), SEQ)
        opt = pkg.optimizer.Adam(learning_rate=1e-4)
        if kw:
            opt = mp_mod.decorate(opt, **kw)
        opt.minimize(io["loss"])
    return main, startup, io


@pytest.mark.parametrize("kw", [
    dict(use_bf16=True),
    dict(use_bf16=False, use_dynamic_loss_scaling=True),
    dict(use_bf16=False, use_dynamic_loss_scaling=False,
         init_loss_scaling=128.0),
], ids=["bf16", "dynamic", "static"])
def test_amp_program_parity(kw):
    jmain, jstart, _ = _build_bert_amp(jfluid, jbert, jmp, **kw)
    pmain, pstart, _ = _build_bert_amp(fluid, bert, mp, **kw)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert json.loads(pstart.to_json()) == json.loads(jstart.to_json())
    types = [op.type for op in pmain.global_block().ops]
    if kw["use_bf16"]:
        # 4 products per layer and the MLM matmul, word_emb cast once
        assert types.count("cast") == 2 * 4 * 2 + 2
        assert "isfinite" not in types
    elif kw["use_dynamic_loss_scaling"]:
        assert {"isfinite", "where", "fill_zeros_like", "scale",
                "reduce_sum", "assign", "greater_equal", "elementwise_mul",
                "elementwise_div", "elementwise_max", "cast"} <= set(types)
        assert all(op.input("SkipGate") for op in pmain.global_block().ops
                   if op.type == "adam")
    else:
        assert "cast" not in types and types.count("scale") == 1 + 28


def test_decorator_surface():
    assert fluid.contrib.__all__ == ["mixed_precision"]
    lists = mp.AutoMixedPrecisionLists(custom_white_list=["conv2d_transpose"],
                                       custom_black_list=["gelu"])
    assert "conv2d_transpose" in lists.white_list and "mul" in lists.white_list
    assert "gelu" in lists.black_list
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        decorator, fp16_lists, fp16_utils)
    assert decorator.decorate is mp.decorate
    assert fp16_lists.white_list == mp.WHITE_LIST
    pairs = [("p", "g")]
    assert fp16_utils.create_master_params_grads(pairs, None, None, 1.0) \
        == pairs
    assert fp16_utils.master_param_to_train_param(pairs, pairs, None) is None
    with pytest.raises(NotImplementedError, match="decorate"):
        fp16_utils.update_loss_scaling()
    with pytest.raises(NotImplementedError, match="decorate"):
        with mp.bf16_compute_guard():
            pass
    opt = mp.decorate(fluid.optimizer.Adam(1e-3), use_bf16=False,
                      use_dynamic_loss_scaling=False, init_loss_scaling=4.0)
    assert opt.get_loss_scaling() == 4.0 and opt.get_finite_flag() is None
    assert opt.type == "adam"            # forwarded to the inner optimizer
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        opt.publish_step_telemetry()


# ---------------------------------------------------------------------------
# the slice: bert_tiny in bf16 AMP + Adam, 5 steps, both packages
# ---------------------------------------------------------------------------
AMP_STEPS = 5
AMP_SEED = 5                       # the worst of the 8 seeds measured
LOSS_RTOL = 1.6e-2
GRAD_MAX_RTOL = 2e-2
GRAD_OFF_FRACTION = 2e-2


def _off_by_more_than_an_ulp(got, want):
    """(elements, of which off): gradient elements farther from the JAX
    package's than one bfloat16 ulp (2^-8 relative), not counting
    differences under 1e-3 of the parameter's max|grad|."""
    scale = float(np.abs(want).max())
    off = np.abs(got - want) > 2.0 ** -8 * np.abs(want) + 1e-3 * scale
    return off.size, int(off.sum())


def _amp_parity(seed):
    """bert_tiny + Adam(1e-4), decorated use_bf16=True, 5 steps on one
    batch in both packages from the JAX startup values of `seed`. Returns
    the worst loss error of the port's own 5-step run, and of the gradients
    of a port run re-synced to the JAX state before every step: the worst
    max|d|/max|grad| of any parameter at any step, and the fraction of
    elements off by more than a bfloat16 ulp; the last two also for the
    undecorated f32 program re-synced the same way (the control)."""
    jmain, jstart, jio = _build_bert_amp(jfluid, jbert, jmp, use_bf16=True)
    pmain, pstart, pio = _build_bert_amp(fluid, bert, mp, use_bf16=True)
    pt_unique_name.switch()
    fmain, _, fio = _build_bert_amp(fluid, bert, mp)
    jscope, own = _both_from_jax_start(jmain, jstart, pmain, seed=seed)
    persist = [v.name for v in pmain.global_block().vars.values()
               if v.persistable]
    jexe, exe = jfluid.Executor(jfluid.CPUPlace()), fluid.Executor(
        fluid.CPUPlace())
    ids, labels = bert.synthetic_batch(bert.bert_tiny(SEQ), 2, SEQ, seed=3)
    feed = {"input_ids": ids, "mlm_labels": labels}
    grads = sorted(p.name + "@GRAD" for p in pmain.all_parameters())
    loss_err, worst = 0.0, {"amp": 0.0, "f32": 0.0}
    off = {"amp": [0, 0], "f32": [0, 0]}
    for _ in range(AMP_STEPS):
        synced = {}
        for kind in ("amp", "f32"):
            synced[kind] = fluid.Scope()
            for n, t in params_from_numpy(
                    {n: np.array(jscope[n]) for n in persist},
                    torch.device("cpu")).items():
                synced[kind].set(n, t)
        jout = jexe.run(jmain, feed=feed, fetch_list=[jio["loss"]] + grads,
                        scope=jscope)
        jloss = float(np.asarray(jout[0]).astype(np.float32))
        mine = exe.run(pmain, feed=feed, fetch_list=[pio["loss"]],
                       scope=own)[0]
        assert mine.dtype == np.float32 and mine.shape == ()  # bf16, widened
        loss_err = max(loss_err, abs(float(mine) - jloss) / abs(jloss))
        for kind, (main, loss) in (("amp", (pmain, pio["loss"])),
                                   ("f32", (fmain, fio["loss"]))):
            out = exe.run(main, feed=feed, fetch_list=[loss] + grads,
                          scope=synced[kind])
            for name, a, w in zip(grads, out[1:], jout[1:]):
                w = np.asarray(w)
                assert a.dtype == w.dtype == np.float32, name
                assert np.isfinite(a).all(), name
                worst[kind] = max(worst[kind], float(np.abs(a - w).max())
                                  / float(np.abs(w).max()))
                n, k = _off_by_more_than_an_ulp(a, w)
                off[kind][0] += n
                off[kind][1] += k
    return (loss_err, worst, {k: v[1] / v[0] for k, v in off.items()})


def test_bert_tiny_bf16_amp_matches_jax():
    """bert_tiny in bf16 AMP, 5 Adam steps, against the JAX package.

    Why the bounds are what they are: the products' inputs and outputs are
    rounded to bfloat16 in both packages, but the f32 parts around them
    (LayerNorm, attention, the products' own sums) differ in their last
    bits, and where such a value lies near a bfloat16 rounding boundary the
    packages round it to neighbouring values. One such flip in the
    backward moves every gradient below it, so in some steps the two
    packages' gradients differ nearly as much as AMP and f32 do, while in
    most steps they agree to f32's last bits. No per-parameter bound tells
    AMP from f32 in those steps; the share of gradient elements that
    differ by more than a bfloat16 ulp, over the 5 steps, does.

    Measured over startup seeds 0-7 on the CPU (JAX startup, copied by
    name; ``python tests/test_torch_amp.py`` prints the sweep), at torch's
    default 8 threads and at 1 thread alike: the port's
    own 5-step losses within rel 4.6e-3 of the JAX losses (the losses are
    bfloat16: one ulp near 1.0 is 3.9e-3 to 7.8e-3); the gradients of a
    port run re-synced to the JAX state before every step within
    7.5e-3·max|grad| of each parameter, and at most 0.76% of their
    elements more than a bfloat16 ulp off (seed 5); the f32 program
    re-synced the same way: 3.2% (seed 4) to 5.4% of its elements off,
    against the 2% bound. Each bound is at least 2× the worst of the 8
    seeds (the loss bound 2× one ulp below 2.0); the test runs seed 5, the
    worst. The per-parameter bound does not tell AMP from f32 (the f32
    program's gradients are within 8.6e-3 to 1.1e-2·max|grad|), nor can
    the loss bound (one bfloat16 ulp): they catch a fault in one step or
    one parameter."""
    loss_err, worst, off = _amp_parity(AMP_SEED)
    assert loss_err <= LOSS_RTOL, loss_err
    assert worst["amp"] <= GRAD_MAX_RTOL, worst
    assert off["amp"] <= GRAD_OFF_FRACTION, off
    # the control: the same comparison with AMP off exceeds the bound
    assert off["f32"] > GRAD_OFF_FRACTION, off


def test_per_parameter_learning_rate_matches_jax():
    """A ParamAttr learning rate scales the global one through the
    ``scale`` layer, as in the JAX package: the same Program, and the same
    Adam step."""
    progs = {}
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.data("x", shape=[None, 4], dtype="float32")
            y = pkg.layers.fc(x, size=2, param_attr=pkg.ParamAttr(
                name="w_slow", learning_rate=0.25))
            loss = pkg.layers.mean(y)
            pkg.optimizer.Adam(learning_rate=0.1).minimize(loss)
        progs[pkg] = main, startup
    (jmain, jstart), (pmain, _) = progs[jfluid], progs[fluid]
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert "scale" in [op.type for op in pmain.global_block().ops]
    jscope, scope = _both_from_jax_start(jmain, jstart, pmain)
    feed = {"x": _rand(3, 4)}
    jfluid.Executor(jfluid.CPUPlace()).run(jmain, feed=feed, scope=jscope)
    fluid.Executor(fluid.CPUPlace()).run(pmain, feed=feed, scope=scope)
    np.testing.assert_allclose(scope["w_slow"].numpy(),
                               np.asarray(jscope["w_slow"]), rtol=1e-6)


def _ce_logits_grad_share_off(seed, port_log_softmax=True):
    """Share of the elements of d mean(loss) / d logits (bfloat16 MLM
    logits (2, 16, 1024), hard labels, a third ignored) that differ from
    the JAX package's, for the port's lowering or, with
    ``port_log_softmax=False``, for one built on ``torch.log_softmax``."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(2, 16, 1024)) * 2).astype(np.float32)
    lab = rng.integers(0, 1024, size=(2, 16, 1)).astype(np.int64)
    lab[0, ::3] = -1
    attrs = {"ignore_index": -1, "axis": -1, "soft_label": False}

    def jloss(xb):
        out = jax_lowering("softmax_with_cross_entropy")(
            JaxLowerContext(platform="cpu"),
            {"Logits": [xb], "Label": [jnp.asarray(lab)]}, attrs)
        return jnp.mean(out["Loss"][0])

    want = np.asarray(jax.grad(jloss)(
        jnp.asarray(x).astype(jnp.bfloat16))).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    if port_log_softmax:
        loss = pt_lowering("softmax_with_cross_entropy")(
            LowerContext(torch.device("cpu")),
            {"Logits": [xt], "Label": [torch.from_numpy(lab)]},
            attrs)["Loss"][0]
    else:
        logp = torch.log_softmax(xt, dim=-1)
        lt = torch.from_numpy(lab)
        loss = (-logp.gather(-1, lt.clamp(0, 1023))).masked_fill(lt == -1,
                                                                 0.0)
    got, = torch.autograd.grad(loss.mean(), xt)
    return float((got.float().numpy() != want).mean())


def test_bf16_log_softmax_follows_jax():
    """On bfloat16 logits the port computes the log-softmax as jax does,
    op by op (ops/loss_ops.py ``_log_softmax``). Measured over seeds 0-7
    (``python tests/test_torch_amp.py``): its logits gradient differs from
    the JAX package's in 0-9.2% of the elements (where XLA fuses part of
    jax's sequence on the CPU); with ``torch.log_softmax`` (one rounding of
    an f32 computation) in 71-75%, which made the packages' bf16 AMP
    gradients differ as much as AMP and f32 do. Bound 20%, 2× the worst;
    the test runs seed 0, the worst; the control must exceed the bound."""
    assert _ce_logits_grad_share_off(0) <= 0.2
    assert _ce_logits_grad_share_off(0, port_log_softmax=False) > 0.2


if __name__ == "__main__":
    # The seed sweeps behind the bounds above, on this CPU:
    #     JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_amp.py
    from paddle_tpu.fluid import framework as jframework
    from paddle_tpu.fluid import unique_name as junique_name

    for s in range(8):
        print("log-softmax, seed %d: share of the logits gradient off, port "
              "%.4f, torch.log_softmax %.4f" % (
                  s, _ce_logits_grad_share_off(s),
                  _ce_logits_grad_share_off(s, port_log_softmax=False)),
              flush=True)
    for s in range(8):
        for fw, names in ((pt_framework, pt_unique_name),
                          (jframework, junique_name)):
            fw.switch_main_program(fw.Program())
            fw.switch_startup_program(fw.Program())
            names.switch()
        loss_err, worst, off = _amp_parity(s)
        print("bert_tiny bf16 AMP, seed %d: loss rel %.3e; max|d|/max|grad| "
              "AMP %.3e, f32 control %.3e; share > 1 bf16 ulp off AMP %.4f, "
              "f32 control %.4f" % (s, loss_err, worst["amp"], worst["f32"],
                                    off["amp"], off["f32"]), flush=True)
