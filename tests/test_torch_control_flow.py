"""The control-flow slice of the port against the JAX package, on the CPU.

- The 25 op lowerings the slice adds, each against the JAX lowering on
  the same numpy inputs and attrs: bit for bit for the integer, logical,
  comparison and data-movement ops (negative operands of ``mod`` and
  ``floordiv`` included: the remainder takes the divisor's sign), the
  float ``mod``/``floordiv``/``min`` too (one IEEE operation each, or
  jax's own fmod-based sequence); ``log`` within 1e-6 relative. jax
  without x64 has no 64-bit ints, so where the JAX lowering gives int32
  the port gives int64, the declared dtype (ROADMAP Queue 3): the values
  must still be equal. ``sampling_id`` draws from another generator, so
  it is held by support (never an index of zero probability), by its
  distribution over 4,000 rows (each frequency within 0.03 of its
  probability) and by determinism under a seed.
- While, while_loop, cond, case, switch_case, IfElse, Switch, StaticRNN
  and gather_tree programs: the same Program JSON as the JAX package's
  (sub-blocks included), and the same results on the same feeds and
  parameters, exact for integer results and within 1e-6·max of float
  ones (the same f32 ops; a StaticRNN's fc sums in another order).
- A ``backward`` over a control-flow op raises, naming the later slice,
  as do DynamicRNN and the ``dynamic_rnn`` op (the sequence slice) and
  the RNN cells and ``rnn()`` (the RNN slice).
- A ``lod_level`` = 1 feed gets its ``@SEQ_LEN`` companion filled with
  full lengths, as in the JAX package, unless the caller feeds it.
- Liveness (``fluid/lowering.py`` ``LivePlan``): a ``static_rnn`` stacks
  only the outputs a run reads, and its step block runs only the ops they
  and its live memories need; ops nothing reads are skipped, except a
  dropout, which still draws (a later draw is unchanged, bit for bit), and
  an op that writes a persistable (``auc``'s statistics, the optimizer's
  update) with no fetched output. A fetch name no op computes still
  raises ``OpLoweringError``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
from paddle_tpu.ops.registry import get_lowering as jax_lowering
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import lowering as pt_lowering_mod
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.ops.registry import LowerContext
from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering

LOG_TOL = 1e-6
PROGRAM_TOL = 1e-6

NEW_OPS = ("while", "conditional_block", "cond", "static_rnn",
           "dynamic_rnn", "gather_tree", "is_empty", "select_input",
           "select_output", "expand", "expand_as", "gather", "assign_value",
           "increment", "log", "elementwise_min", "elementwise_mod",
           "elementwise_floordiv", "not_equal", "greater_than",
           "logical_and", "logical_or", "logical_xor", "logical_not",
           "sampling_id")


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


def _torch(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _run_both(op_type, ins, attrs):
    """The port's and the JAX package's lowering of `op_type` on the same
    numpy inputs, as ({slot: [np]}, {slot: [np]})."""
    got = pt_lowering(op_type)(
        LowerContext(torch.device("cpu"), generator=torch.Generator()),
        {k: [_torch(a) for a in v] for k, v in ins.items()}, dict(attrs))
    want = jax_lowering(op_type)(
        JaxLowerContext(rng=jax.random.PRNGKey(0), platform="cpu"),
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        dict(attrs))
    return ({k: [t.numpy() for t in v] for k, v in got.items()},
            {k: [np.asarray(x) for x in v] for k, v in want.items()})


def _assert_same(got, want, rtol=0.0):
    """Equal shapes, the same dtype (int64 in the port where jax gives
    int32), values equal (NaN where NaN) or within `rtol`."""
    for a, w in zip(got["Out"], want["Out"]):
        assert a.shape == w.shape, (a.shape, w.shape)
        assert a.dtype == w.dtype or (
            w.dtype == np.int32 and a.dtype == np.int64), (a.dtype, w.dtype)
        if rtol:
            np.testing.assert_allclose(a, w, rtol=rtol, atol=0)
        else:
            np.testing.assert_array_equal(a, w.astype(a.dtype))


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ints(*shape, lo=-9, hi=10, seed=0):
    return np.random.default_rng(seed).integers(
        lo, hi, size=shape).astype(np.int64)


def _nonzero(*shape, seed=1):
    """Ints in [-7, 7] without 0 (a divisor)."""
    v = _ints(*shape, lo=1, hi=8, seed=seed)
    return v * np.where(_ints(*shape, lo=0, hi=2, seed=seed + 1) == 0, -1, 1)


def test_every_new_op_has_a_port_lowering():
    for op in NEW_OPS:
        pt_lowering(op)


# ---------------------------------------------------------------------------
# elementwise, comparison and logical ops
# ---------------------------------------------------------------------------
_FLOAT_DIVISOR = np.array([2.0, -2.0, 0.75, -0.75, 3.0, -1.5],
                          np.float32)


@pytest.mark.parametrize("op", ["elementwise_min", "elementwise_mod",
                                "elementwise_floordiv"])
@pytest.mark.parametrize("x,y,axis", [
    (_ints(3, 6), _nonzero(3, 6), -1),                   # negatives both
    (_ints(3, 6), _nonzero(6), -1),                      # broadcast
    (_ints(3, 6), _nonzero(3, seed=4), 0),               # axis
    (_ints(4, 1), np.array([7], np.int64), -1),          # beam // vocab
    (_rand(4, 6) * 5, np.tile(_FLOAT_DIVISOR, (4, 1)), -1),
    (np.array([-7.5, 7.5, -0.0, 6.0], np.float32),
     np.array([2.0, -2.0, 3.0, -3.0], np.float32), -1),
])
def test_elementwise_integer_semantics(op, x, y, axis):
    got, want = _run_both(op, {"X": [x], "Y": [y]}, {"axis": axis})
    _assert_same(got, want)


@pytest.mark.parametrize("op", ["not_equal", "greater_than"])
@pytest.mark.parametrize("x,y", [
    (_ints(3, 4), _ints(4, seed=1)),
    (np.array([1.0, np.nan, 2.0, -0.0], np.float32),
     np.array([1.0, np.nan, 3.0, 0.0], np.float32)),
    (np.arange(6, dtype=np.int64)[None, :], np.array([[2], [5]], np.int64)),
])
def test_comparisons(op, x, y):
    got, want = _run_both(op, {"X": [x], "Y": [y]}, {"axis": -1})
    assert got["Out"][0].dtype == np.bool_
    _assert_same(got, want)


_BOOLS = np.array([[True, False, True], [False, False, True]])


@pytest.mark.parametrize("op", ["logical_and", "logical_or", "logical_xor"])
@pytest.mark.parametrize("x,y", [
    (_BOOLS, _BOOLS[::-1].copy()),
    (_BOOLS, np.array([True, False, False])),
    (_ints(2, 3, lo=-1, hi=2), _ints(2, 3, lo=0, hi=2, seed=5)),
])
def test_logical_binary(op, x, y):
    got, want = _run_both(op, {"X": [x], "Y": [y]}, {})
    _assert_same(got, want)


@pytest.mark.parametrize("x", [_BOOLS, _ints(2, 3, lo=-1, hi=2),
                               np.array([0.0, -0.0, 0.5], np.float32)])
def test_logical_not(x):
    got, want = _run_both("logical_not", {"X": [x]}, {})
    _assert_same(got, want)


def test_log():
    x = np.abs(_rand(4, 33)) + 1e-3
    got, want = _run_both("log", {"X": [x]}, {})
    _assert_same(got, want, rtol=LOG_TOL)
    # 0 gives -inf, a negative NaN, in both
    edge = np.array([0.0, -1.0, 1.0], np.float32)
    got, want = _run_both("log", {"X": [edge]}, {})
    _assert_same(got, want)


# ---------------------------------------------------------------------------
# data movement and constants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("x,times", [
    (_rand(2, 3), [2, 1]),
    (_rand(4, 1, 5), [1, 3, 1]),         # beam tiling
    (_ints(2, 1), [1, 4]),
    (_rand(2, 3), [2]),                  # short times: leading 1s
])
def test_expand(x, times):
    got, want = _run_both("expand", {"X": [x]}, {"expand_times": times})
    _assert_same(got, want)


def test_expand_as():
    got, want = _run_both("expand_as", {"X": [_rand(2, 1, 3)],
                                        "target_tensor": [_rand(4, 5, 3)]},
                          {})
    _assert_same(got, want)


@pytest.mark.parametrize("x,idx", [
    (_rand(5, 3), np.array([4, 0, 2], np.int64)),
    (_rand(5, 3), np.array([[1], [3]], np.int64)),     # (N, 1) index
    (_rand(5, 3), np.array([-1, -5, -6, 5, 9], np.int64)),  # wrap, fill
    (_rand(5), np.array([2, -2, 7], np.int64)),
    (_ints(5, 2), np.array([0, -1, 3], np.int64)),
    (_ints(4, 3).T.copy(), np.array([2], np.int64)),   # the prompt column
])
def test_gather(x, idx):
    """``jnp.take`` in fill mode: a negative index wraps once, a row
    outside [-n, n) reads NaN (the int fill is the dtype's least value,
    which differs between int32 and int64, so int rows stay in range)."""
    got, want = _run_both("gather", {"X": [x], "Index": [idx]}, {})
    _assert_same(got, want)


@pytest.mark.parametrize("dtype,shape,values", [
    ("float32", [1, 4], [0.0, -1e9, -1e9, -1e9]),
    ("float32", [1, 1, 6], [-1e9, 0.0, -1e9, -1e9, -1e9, -1e9]),
    ("int64", [2, 2], [1, -2, 3, 4]),
    ("bool", [3], [True, False, True]),
])
def test_assign_value(dtype, shape, values):
    got, want = _run_both("assign_value", {}, {
        "dtype": dtype, "shape": shape, "values": values})
    _assert_same(got, want)


@pytest.mark.parametrize("x,step", [
    (np.array([3.0], np.float32), 1.0),
    (np.array([[2.5, -1.0]], np.float32), -0.5),
    (np.array([4], np.int64), 1.0),       # an int counter becomes float32
])
def test_increment(x, step):
    got, want = _run_both("increment", {"X": [x]}, {"step": step})
    _assert_same(got, want)


def test_is_empty_select_input_select_output():
    for x in (_rand(2, 3), np.zeros((0, 3), np.float32)):
        got, want = _run_both("is_empty", {"X": [x]}, {})
        _assert_same(got, want)
    xs = [_rand(2, 3), _rand(2, 3, seed=1), _rand(2, 3, seed=2)]
    for mask in (0, 2, 5, -1):            # out of range clamps, -1 wraps
        got, want = _run_both("select_input", {
            "X": xs, "Mask": [np.array([mask], np.int32)]}, {})
        _assert_same(got, want)
    got, want = _run_both("select_output", {"X": [xs[0]]}, {})
    _assert_same(got, want)


@pytest.mark.parametrize("steps,batch,beam,seed", [
    (1, 2, 3, 0), (5, 2, 3, 1), (6, 3, 4, 2)])
def test_gather_tree(steps, batch, beam, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 50, size=(steps, batch, beam)).astype(np.int64)
    parents = rng.integers(0, beam, size=(steps, batch, beam)).astype(
        np.int64)
    got, want = _run_both("gather_tree", {"Ids": [ids],
                                          "Parents": [parents]}, {})
    _assert_same(got, want)


def _sampling_id(probs, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return pt_lowering("sampling_id")(
        LowerContext(torch.device("cpu"), generator=gen),
        {"X": [_torch(probs)]}, {})["Out"][0].numpy()


def test_sampling_id_support_distribution_and_seed():
    probs = np.array([0.1, 0.0, 0.6, 0.3], np.float32)
    rows = np.tile(probs, (4000, 1))
    got = _sampling_id(rows, 3)
    assert got.shape == (4000,) and got.dtype == np.int64
    assert (got != 1).all()
    freq = np.bincount(got, minlength=4) / len(got)
    assert np.abs(freq - probs).max() <= 0.03, freq
    np.testing.assert_array_equal(got, _sampling_id(rows, 3))
    assert not np.array_equal(got, _sampling_id(rows, 4))
    # the JAX lowering draws from the same support
    want = np.asarray(jax_lowering("sampling_id")(
        JaxLowerContext(rng=jax.random.PRNGKey(0), platform="cpu"),
        {"X": [jnp.asarray(rows[:200])]}, {})["Out"][0])
    assert (want != 1).all()


# ---------------------------------------------------------------------------
# programs: built and run by both packages
# ---------------------------------------------------------------------------
def _build(fl, un, fn):
    un.switch()
    main, start = fl.Program(), fl.Program()
    start.random_seed = 7
    with fl.program_guard(main, start):
        fetch = fn(fl)
    return main, start, fetch


def _while_prog(fl):
    L = fl.layers
    i = L.fill_constant([1], "float32", 0.0)
    n = fl.data("n", [1], dtype="float32")
    x = fl.data("x", [-1, 3], dtype="float32")
    acc = L.fill_constant([2, 3], "float32", 0.0)
    cond = L.less_than(i, n)
    w = L.While(cond)
    with w.block():
        L.assign(L.elementwise_add(acc, L.scale(x, scale=0.5)), acc)
        L.increment(i)
        L.less_than(i, n, cond=cond)
    return [acc, i]


def _while_loop_prog(fl):
    L = fl.layers
    i = L.fill_constant([1], "int64", 0)
    ten = L.fill_constant([1], "int64", 10)
    s = fl.data("x", [-1, 3], dtype="float32")
    one = L.fill_constant([1], "int64", 1)

    def cond(i, s):
        return L.less_than(i, ten)

    def body(i, s):
        return [L.elementwise_add(i, one), L.scale(s, scale=1.5, bias=0.25)]

    return L.while_loop(cond, body, [i, s])


def _cond_prog(fl):
    L = fl.layers
    x = fl.data("x", [-1, 3], dtype="float32")
    n = fl.data("n", [1], dtype="float32")
    pred = L.greater_than(n, L.fill_constant([1], "float32", 2.0))
    out = L.cond(pred, lambda: L.scale(x, scale=2.0),
                 lambda: L.elementwise_sub(x, L.fill_constant(
                     [1], "float32", 1.0)))
    return [out]


def _case_prog(fl):
    L = fl.layers
    x = fl.data("x", [-1, 3], dtype="float32")
    n = fl.data("n", [1], dtype="float32")
    one = L.fill_constant([1], "float32", 1.0)
    three = L.fill_constant([1], "float32", 3.0)
    out = L.case(
        [(L.less_than(n, one), lambda: L.scale(x, scale=-1.0)),
         (L.less_than(n, three), lambda: L.scale(x, scale=3.0))],
        default=lambda: L.scale(x, bias=10.0))
    return [out]


def _switch_case_prog(fl):
    L = fl.layers
    x = fl.data("x", [-1, 3], dtype="float32")
    k = fl.data("k", [1], dtype="int64")
    out = L.switch_case(
        k, {0: lambda: L.scale(x, scale=2.0),
            2: lambda: L.scale(x, bias=-4.0)},
        default=lambda: L.log(L.scale(x, scale=0.0, bias=3.0)))
    return [out]


def _ifelse_prog(fl):
    L = fl.layers
    x = fl.data("x", [-1, 3], dtype="float32")
    n = fl.data("n", [1], dtype="float32")
    ie = L.IfElse(L.less_than(n, L.fill_constant([1], "float32", 2.0)))
    with ie.true_block():
        ie.output(L.scale(ie.input(x), scale=5.0))
    with ie.false_block():
        ie.output(L.elementwise_max(ie.input(x), L.fill_constant(
            [1], "float32", 0.0)))
    return ie()


def _switch_prog(fl):
    L = fl.layers
    n = fl.data("n", [1], dtype="float32")
    out = L.fill_constant([1], "float32", -1.0)
    sw = L.Switch()
    with sw.case(L.less_than(n, L.fill_constant([1], "float32", 1.0))):
        L.assign(L.fill_constant([1], "float32", 10.0), out)
    with sw.case(L.less_than(n, L.fill_constant([1], "float32", 3.0))):
        L.assign(L.scale(n, scale=2.0), out)
    with sw.default():
        L.assign(L.fill_constant([1], "float32", 30.0), out)
    return [out]


def _static_rnn_prog(fl):
    L = fl.layers
    x = fl.data("xs", [5, -1, 3], dtype="float32")
    h0 = fl.data("h0", [-1, 4], dtype="float32")
    rnn = L.StaticRNN()
    with rnn.step():
        xt = rnn.step_input(x)
        h_prev = rnn.memory(init=h0)
        h = L.elementwise_add(
            L.fc(xt, 4, param_attr=fl.ParamAttr(name="rnn.wx"),
                 bias_attr=fl.ParamAttr(name="rnn.b")),
            L.fc(h_prev, 4, param_attr=fl.ParamAttr(name="rnn.wh"),
                 bias_attr=False), act="relu")
        rnn.update_memory(h_prev, h)
        rnn.step_output(h)
        rnn.step_output(L.reduce_sum(xt, dim=[1]))
    return rnn()


def _gather_tree_prog(fl):
    L = fl.layers
    ids = fl.data("ids", [4, -1, 3], dtype="int64")
    parents = fl.data("parents", [4, -1, 3], dtype="int64")
    return [L.gather_tree(ids, parents)]


_RNG = np.random.default_rng(0)
_X = _rand(2, 3, seed=9)
PROGRAMS = {
    "while": (_while_prog, [{"x": _X, "n": np.array([4.0], np.float32)},
                            {"x": _X, "n": np.array([0.0], np.float32)}]),
    "while_loop": (_while_loop_prog, [{"x": _X}]),
    "cond": (_cond_prog, [{"x": _X, "n": np.array([3.0], np.float32)},
                          {"x": _X, "n": np.array([1.0], np.float32)}]),
    "case": (_case_prog, [{"x": _X, "n": np.array([v], np.float32)}
                          for v in (0.0, 2.0, 5.0)]),
    "switch_case": (_switch_case_prog, [
        {"x": _X, "k": np.array([v], np.int64)} for v in (0, 2, 1)]),
    "ifelse": (_ifelse_prog, [{"x": _X, "n": np.array([v], np.float32)}
                              for v in (1.0, 3.0)]),
    "switch": (_switch_prog, [{"n": np.array([v], np.float32)}
                              for v in (0.5, 2.0, 4.0)]),
    "static_rnn": (_static_rnn_prog, [
        {"xs": _rand(5, 2, 3, seed=3), "h0": _rand(2, 4, seed=4)}]),
    "gather_tree": (_gather_tree_prog, [
        {"ids": _RNG.integers(0, 9, (4, 2, 3)).astype(np.int64),
         "parents": _RNG.integers(0, 3, (4, 2, 3)).astype(np.int64)}]),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_control_flow_program_matches_jax(name):
    fn, feeds = PROGRAMS[name]
    jmain, jstart, jfetch = _build(jfluid, jax_unique_name, fn)
    pmain, pstart, pfetch = _build(fluid, pt_unique_name, fn)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert json.loads(pstart.to_json()) == json.loads(jstart.to_json())
    assert len(pmain.blocks) > 1 or name == "gather_tree"
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    scope = fluid.Scope()
    persist = {v.name: np.array(jscope[v.name])
               for v in jstart.global_block().vars.values() if v.persistable}
    for n, t in params_from_numpy(persist, torch.device("cpu")).items():
        scope.set(n, t)
    exe = fluid.Executor(fluid.CPUPlace())
    for feed in feeds:
        want = jexe.run(jmain, feed=feed, fetch_list=jfetch, scope=jscope)
        got = exe.run(pmain, feed=feed, fetch_list=pfetch, scope=scope)
        for a, w in zip(got, want):
            w = np.asarray(w)
            assert a.shape == w.shape, (a.shape, w.shape)
            if w.dtype.kind == "f":
                assert a.dtype == w.dtype
                assert float(np.abs(a - w).max()) <= PROGRAM_TOL * max(
                    float(np.abs(w).max()), 1.0)
            else:
                np.testing.assert_array_equal(a, w.astype(a.dtype))


def test_static_rnn_stacks_every_step():
    """The step outputs come back (T, ...): row t is step t's value."""
    pmain, pstart, pfetch = _build(fluid, pt_unique_name, _static_rnn_prog)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(pstart, scope=scope)
    xs = _rand(5, 2, 3, seed=3)
    hs, sums = exe.run(pmain, feed={"xs": xs, "h0": _rand(2, 4, seed=4)},
                       fetch_list=pfetch, scope=scope)
    assert hs.shape == (5, 2, 4) and sums.shape == (5, 2)
    np.testing.assert_allclose(sums, xs.sum(-1), rtol=1e-6)


# ---------------------------------------------------------------------------
# what waits for a later slice
# ---------------------------------------------------------------------------
def test_backward_through_control_flow_raises():
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        x = fluid.data("x", [-1, 3], dtype="float32")
        n = fluid.data("n", [1], dtype="float32")
        y = fluid.layers.fc(x, 3)
        out = fluid.layers.cond(
            fluid.layers.greater_than(n, fluid.layers.fill_constant(
                [1], "float32", 0.0)),
            lambda: fluid.layers.scale(y, scale=2.0),
            lambda: fluid.layers.scale(y, scale=3.0))
        loss = fluid.layers.mean(out)
        fluid.optimizer.SGD(0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(start, scope=scope)
    with pytest.raises(NotImplementedError, match="later training slice"):
        exe.run(main, feed={"x": _X, "n": np.array([1.0], np.float32)},
                fetch_list=[loss], scope=scope)


def test_dynamic_rnn_waits_for_the_sequence_slice():
    with pytest.raises(NotImplementedError, match="sequence slice"):
        fluid.layers.DynamicRNN()
    with pytest.raises(NotImplementedError, match="sequence slice"):
        pt_lowering("dynamic_rnn")(LowerContext(torch.device("cpu")), {}, {})
    for name in ("RNNCell", "GRUCell", "LSTMCell"):
        with pytest.raises(NotImplementedError, match="RNN slice"):
            getattr(fluid.layers, name)(4)
    with pytest.raises(NotImplementedError, match="RNN slice"):
        fluid.layers.rnn(None, None)


def _seq_len_prog(fl):
    ids = fl.data("ids", [-1, 5], dtype="int64", lod_level=1)
    return [ids.name + "@SEQ_LEN"]


def test_lod_feed_gets_full_lengths():
    jmain, _, jfetch = _build(jfluid, jax_unique_name, _seq_len_prog)
    pmain, _, pfetch = _build(fluid, pt_unique_name, _seq_len_prog)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    var = pmain.global_block().var("ids@SEQ_LEN")
    assert var.dtype == "int32" and var.is_data and var.shape == (-1,)
    ids = _ints(3, 5, lo=0, hi=9)
    exe = fluid.Executor(fluid.CPUPlace())
    got, = exe.run(pmain, feed={"ids": ids}, fetch_list=pfetch)
    want, = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed={"ids": ids}, fetch_list=jfetch, scope=jfluid.Scope())
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.full(3, 5, np.int32))
    np.testing.assert_array_equal(got, np.asarray(want))
    lens = np.array([5, 2, 1], np.int32)
    got, = exe.run(pmain, feed={"ids": ids, "ids@SEQ_LEN": lens},
                   fetch_list=pfetch)
    np.testing.assert_array_equal(got, lens)


# ---------------------------------------------------------------------------
# liveness: what a run skips, and what it never skips
# ---------------------------------------------------------------------------
class _record_static_rnn:
    """While active, the port's static_rnn lowering records its outputs."""

    def __init__(self):
        from paddle_tpu_torch.ops import registry

        self.lowerings, self.outs = registry.LOWERINGS, []

    def __enter__(self):
        orig = self.orig = self.lowerings["static_rnn"]

        def recording(ctx, ins, attrs):
            out = orig(ctx, ins, attrs)
            self.outs.append(list(out["Out"]))
            return out

        self.lowerings["static_rnn"] = recording
        return self

    def __exit__(self, *exc):
        self.lowerings["static_rnn"] = self.orig


def test_static_rnn_stacks_only_the_outputs_a_run_reads(monkeypatch):
    pmain, pstart, (hs, sums) = _build(fluid, pt_unique_name,
                                       _static_rnn_prog)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(pstart, scope=scope)
    feed = {"xs": _rand(5, 2, 3, seed=3), "h0": _rand(2, 4, seed=4)}
    with _record_static_rnn() as rec:
        only, = exe.run(pmain, feed=feed, fetch_list=[sums], scope=scope)
        both = exe.run(pmain, feed=feed, fetch_list=[hs, sums], scope=scope)
    # fetching the sums alone: no stack of the hidden states, and the step
    # block's fc ops and its memory are dead
    assert rec.outs[0][0] is None and rec.outs[0][1].shape == (5, 2)
    assert all(o is not None for o in rec.outs[1])
    np.testing.assert_array_equal(only, both[1])
    plan = pt_lowering_mod.live_plan(pmain, [sums.name])
    assert [op.type for op in plan.ops[1]] == ["reduce_sum"]
    rnn = pmain.global_block().ops[-1]
    assert plan.rnn[id(rnn)] == ({1}, set())
    # the full op list (no plan) gives the same bits
    monkeypatch.setattr(pt_lowering_mod, "live_plan", lambda p, f: None)
    full = exe.run(pmain, feed=feed, fetch_list=[hs, sums], scope=scope)
    for a, b in zip(both, full):
        np.testing.assert_array_equal(a, b)


def _two_dropouts(first=True):
    main, start = fluid.Program(), fluid.Program()
    main.random_seed = 3
    with fluid.program_guard(main, start):
        x = fluid.data("x", [-1, 64], dtype="float32")
        d1 = fluid.layers.dropout(x, 0.5) if first else None
        d2 = fluid.layers.dropout(x, 0.5)
    return main, d1, d2


def test_a_dead_dropout_still_draws():
    x = np.ones((4, 64), np.float32)
    main, d1, d2 = _two_dropouts()
    plan = pt_lowering_mod.live_plan(main, [d2.name])
    assert [op.type for op in plan.ops[0]] == ["dropout", "dropout"]
    alone, = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"x": x}, fetch_list=[d2])
    both = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"x": x}, fetch_list=[d1, d2])
    np.testing.assert_array_equal(alone, both[1])
    # the first draw is what moves the second: without it the mask differs
    main1, _, d2b = _two_dropouts(first=False)
    main1.random_seed = 3
    single, = fluid.Executor(fluid.CPUPlace()).run(
        main1, feed={"x": x}, fetch_list=[d2b])
    assert not np.array_equal(single, alone)


def test_ops_that_write_persistables_run_unfetched():
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        x = fluid.data("x", [-1, 3], dtype="float32")
        label = fluid.data("label", [-1, 1], dtype="int64")
        prob = fluid.layers.sigmoid(fluid.layers.fc(x, 1))
        loss = fluid.layers.mean(fluid.layers.log_loss(
            prob, fluid.layers.cast(label, "float32")))
        _, (pos, neg) = fluid.layers.auc(prob, label)
        fluid.layers.scale(loss, scale=2.0)           # read by nothing
        fluid.optimizer.SGD(0.5).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(start, scope=scope)
    w = main.all_parameters()[0].name
    before = scope[w].clone()
    plan = pt_lowering_mod.live_plan(main, [])
    assert "scale" not in [op.type for op in plan.ops[0]]
    assert {"auc", "sgd", "backward"} <= {op.type for op in plan.ops[0]}
    assert exe.run(main, feed={"x": _rand(8, 3),
                               "label": np.ones((8, 1), np.int64)},
                   scope=scope) == []
    assert float(scope[pos.name].sum()) == 8.0
    assert float(scope[neg.name].sum()) == 0.0
    assert not torch.equal(scope[w], before)


def test_a_fetch_no_op_computes_still_raises():
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        x = fluid.data("x", [-1, 3], dtype="float32")
        fluid.layers.scale(x, scale=2.0)
        orphan = main.global_block().create_var(name="orphan", shape=(3,),
                                                dtype="float32")
    with pytest.raises(pt_lowering_mod.OpLoweringError,
                       match="never computed"):
        fluid.Executor(fluid.CPUPlace()).run(
            main, feed={"x": _rand(2, 3)}, fetch_list=[orphan])


def test_every_lowering_that_draws_is_kept_live():
    """Each lowering that reads the run's generator (``next_rng`` or
    ``next_seed``) is in ``DRAWS``, so a run never skips its draw."""
    import inspect
    import re

    from paddle_tpu_torch.ops.registry import LOWERINGS

    draws = {name for name, fn in LOWERINGS.items()
             if re.search(r"next_(rng|seed)\(", inspect.getsource(fn))}
    assert draws and draws <= pt_lowering_mod.DRAWS
    assert pt_lowering_mod.DRAWS <= set(LOWERINGS)
