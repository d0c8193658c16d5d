"""The 30 activation op types of paddle_tpu/ops/nn_ops.py:37-166 and their
layers, in the port against the JAX package, on the CPU.

- Each op type's port lowering against the JAX lowering on the same
  seeded numpy inputs and attrs: outputs within FWD_TOL (1e-6) of the
  largest value (``erf``, ``selu`` and ``log_softmax`` included), and
  the gradient through torch.autograd against jax.vjp under one random
  cotangent within GRAD_TOL (1e-5) of the largest JAX gradient. The JAX
  outputs and jax.vjp of a case are one jitted function.
- Every input holds the op's kinks exactly: 0 for the ``x >= 0`` ops, the
  clip bounds of ``relu6``, ``brelu``, ``hard_sigmoid``, ``hard_swish``
  and ``soft_relu`` (where jax's maximum and minimum give half of the
  cotangent to each side), the thresholds of the shrinks and of
  ``thresholded_relu``, and tied maxima in ``maxout``. The subgradients
  there are jax.vjp's, asserted by value too.
- The layers of fluid/layers/ops.py and fluid/layers/nn.py that append
  these ops (``prelu`` with its ``Alpha`` parameter in each mode) build
  the same Program JSON in both packages, startup included.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from test_torch_detection import _jax_run, _port_run, _rand

FWD_TOL = 1e-6
GRAD_TOL = 1e-5

ACTIVATION_OPS = (
    "rsqrt", "reciprocal", "sin", "tan", "asin", "acos", "atan", "sinh",
    "cosh", "erf", "logsigmoid", "softplus", "softsign", "tanh_shrink",
    "selu", "swish", "stanh", "soft_relu", "elu", "softshrink",
    "hard_shrink", "hard_sigmoid", "hard_swish", "relu6", "brelu",
    "leaky_relu", "thresholded_relu", "maxout", "prelu", "log_softmax")


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


def assert_close(a, w, tol, what=""):
    """Same shape and dtype (int64 where jax gives int32); integers and
    bools equal; floats: NaN and inf where jax has them, the rest within
    tol of the largest finite JAX value."""
    assert a.shape == w.shape, (what, a.shape, w.shape)
    assert a.dtype == w.dtype or (
        w.dtype == np.int32 and a.dtype == np.int64), (what, a.dtype, w.dtype)
    if not np.issubdtype(w.dtype, np.floating):
        np.testing.assert_array_equal(a, w.astype(a.dtype), err_msg=what)
        return
    fin = np.isfinite(w)
    np.testing.assert_array_equal(fin, np.isfinite(a), err_msg=what)
    np.testing.assert_array_equal(a[~fin], w[~fin], err_msg=what)
    if fin.any():
        scale = max(float(np.abs(w[fin]).max()), 1e-30)
        err = float(np.abs(a[fin] - w[fin]).max())
        assert err <= tol * scale, (what, err, scale)


def check(op_type, ins, attrs, wrt=(), out_slot="Out", fwd_tol=FWD_TOL,
          grad_tol=GRAD_TOL, seed=5):
    """The port's lowering against the JAX lowering: every output within
    fwd_tol, and with `wrt` the gradients of out_slot in those inputs
    (NaN where jax.vjp gives NaN) within grad_tol of the largest.
    Returns the port's outputs and gradients."""
    got, ggot, cot = _port_run(op_type, ins, attrs, wrt, out_slot, seed)
    want, gwant = _jax_run(op_type, ins, attrs, wrt, out_slot, cot, False)
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for a, w in zip(got[slot], want[slot]):
            assert_close(a, w, fwd_tol, "%s.%s" % (op_type, slot))
    assert len(ggot) == len(gwant) == sum(len(ins[s]) for s in wrt)
    for i, (a, w) in enumerate(zip(ggot, gwant)):
        assert_close(a, w, grad_tol, "%s grad %d" % (op_type, i))
    return got, ggot


def _with(values, seed=0, scale=2.0, shape=(4, 6)):
    """A seeded normal array (times scale) whose first entries are
    `values` exactly."""
    x = (scale * _rand(*shape, seed=seed)).reshape(-1)
    x[:len(values)] = values
    return x.reshape(shape)


def _unif(lo, hi, shape=(4, 6), seed=0):
    return np.random.default_rng(seed).uniform(lo, hi, size=shape).astype(
        np.float32)


def _maxout_x():
    x = _rand(2, 6, 3, 3, seed=3)
    x[0, 3, 0] = x[0, 0, 0]            # ties across the two groups
    x[1, 4, :, 1] = x[1, 1, :, 1]
    return x


def _case(name):
    """(op, ins, attrs)."""
    zero = [0.0, -0.0, 1e-3, -1e-3]
    return {
        "rsqrt": ("rsqrt", {"X": [_unif(0.05, 4.0)]}, {}),
        "reciprocal": ("reciprocal", {"X": [_with([0.5, -0.5, 3.0])]}, {}),
        "sin": ("sin", {"X": [_with(zero)]}, {}),
        "tan": ("tan", {"X": [_unif(-1.4, 1.4)]}, {}),
        "asin": ("asin", {"X": [_unif(-0.95, 0.95)]}, {}),
        "acos": ("acos", {"X": [_unif(-0.95, 0.95)]}, {}),
        "atan": ("atan", {"X": [_with(zero)]}, {}),
        "sinh": ("sinh", {"X": [_with(zero)]}, {}),
        "cosh": ("cosh", {"X": [_with(zero)]}, {}),
        "erf": ("erf", {"X": [_with(zero + [3.5, -3.5, 0.5])]}, {}),
        "logsigmoid": ("logsigmoid", {"X": [_with(zero + [30.0, -30.0])]},
                       {}),
        "softplus": ("softplus", {"X": [_with(zero + [25.0, -25.0])]}, {}),
        "softsign": ("softsign", {"X": [_with(zero)]}, {}),
        "tanh_shrink": ("tanh_shrink", {"X": [_with(zero)]}, {}),
        "selu": ("selu", {"X": [_with(zero)]}, {}),
        "selu_attrs": ("selu", {"X": [_with(zero)]},
                       {"scale": 1.2, "alpha": 0.7}),
        "swish": ("swish", {"X": [_with(zero)]}, {"beta": 1.5}),
        "stanh": ("stanh", {"X": [_with(zero)]}, {}),
        "soft_relu": ("soft_relu", {"X": [_with([40.0, -40.0, 39.9,
                                                 3.0, -3.0])]},
                      {"threshold": 40.0}),
        "soft_relu_clipped": ("soft_relu", {"X": [_with([2.0, -2.0, 0.0],
                                                        scale=3.0)]},
                              {"threshold": 2.0}),
        "elu": ("elu", {"X": [_with(zero)]}, {"alpha": 1.3}),
        "softshrink": ("softshrink", {"X": [_with([0.5, -0.5, 0.0, 0.7])]},
                       {"lambda": 0.5}),
        "hard_shrink": ("hard_shrink", {"X": [_with([0.5, -0.5, 0.0])]},
                        {"threshold": 0.5}),
        # slope 0.25: slope·x + offset lands on a bound exactly with or
        # without the multiply-add XLA fuses in the jitted JAX case (with
        # 0.2, fma(0.2, -2.5, 0.5) is -7e-9, not the bound); the default
        # slope's kinks are held op by op in KINKS
        "hard_sigmoid": ("hard_sigmoid", {"X": [_with([-2.0, 2.0, 0.0])]},
                         {"slope": 0.25, "offset": 0.5}),
        "hard_swish": ("hard_swish", {"X": [_with([-3.0, 3.0, 0.0, 5.0])]},
                       {"threshold": 6.0, "scale": 6.0, "offset": 3.0}),
        "relu6": ("relu6", {"X": [_with([0.0, 6.0, -0.0, 3.0])]},
                  {"threshold": 6.0}),
        "brelu": ("brelu", {"X": [_with([1.0, 4.0, 0.0])]},
                  {"t_min": 1.0, "t_max": 4.0}),
        "leaky_relu": ("leaky_relu", {"X": [_with(zero)]}, {"alpha": 0.1}),
        "thresholded_relu": ("thresholded_relu",
                             {"X": [_with([1.0, -1.0, 0.0])]},
                             {"threshold": 1.0}),
        "maxout": ("maxout", {"X": [_maxout_x()]}, {"groups": 2}),
        "maxout_3": ("maxout", {"X": [_rand(2, 6, 2, 2, seed=4)]},
                     {"groups": 3}),
        "prelu_all": ("prelu", {"X": [_with(zero, shape=(2, 3, 2, 2))],
                                "Alpha": [np.array([0.25], np.float32)]},
                      {"mode": "all"}),
        "prelu_channel": ("prelu",
                          {"X": [_with(zero, shape=(2, 3, 2, 2))],
                           "Alpha": [np.array([0.1, 0.2, 0.3],
                                              np.float32).reshape(
                                                  1, 3, 1, 1)]},
                          {"mode": "channel"}),
        "prelu_element": ("prelu",
                          {"X": [_with(zero, shape=(2, 3, 2, 2))],
                           "Alpha": [_rand(3, 2, 2, seed=7)]},
                          {"mode": "element"}),
        "log_softmax": ("log_softmax", {"X": [_with([30.0, -30.0])]},
                        {"axis": -1}),
        "log_softmax_axis1": ("log_softmax",
                              {"X": [_rand(2, 5, 3, seed=8)]}, {"axis": 1}),
    }[name]


CASES = ("rsqrt", "reciprocal", "sin", "tan", "asin", "acos", "atan",
         "sinh", "cosh", "erf", "logsigmoid", "softplus", "softsign",
         "tanh_shrink", "selu", "selu_attrs", "swish", "stanh", "soft_relu",
         "soft_relu_clipped", "elu", "softshrink", "hard_shrink",
         "hard_sigmoid", "hard_swish", "relu6", "brelu", "leaky_relu",
         "thresholded_relu", "maxout", "maxout_3", "prelu_all",
         "prelu_channel", "prelu_element", "log_softmax",
         "log_softmax_axis1")


@pytest.mark.parametrize("case", CASES)
def test_lowering_matches_jax(case):
    op, ins, attrs = _case(case)
    check(op, ins, attrs, wrt=tuple(ins))


def test_every_activation_is_covered():
    assert {_case(c)[0] for c in CASES} == set(ACTIVATION_OPS)


def _grad_at(op, x, attrs):
    """The port's d out / d x at each element of the 1-D x (a cotangent
    of ones), and jax.vjp's, op by op (not jitted: XLA's fused
    multiply-add would move hard_sigmoid's 0.2·x + 0.5 off its bound)."""
    from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
    from paddle_tpu.ops.registry import get_lowering as jax_lowering

    def f(v):
        return jax_lowering(op)(JaxLowerContext(rng=jax.random.PRNGKey(0),
                                                platform="cpu"),
                                {"X": [v]}, dict(attrs))["Out"][0]

    xv = jnp.asarray(np.asarray(x, np.float32))
    want = np.asarray(jax.vjp(f, xv)[1](jnp.ones_like(xv))[0])
    pt = torch.tensor(np.asarray(x, np.float32), requires_grad=True)
    from paddle_tpu_torch.ops.registry import LowerContext
    from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering

    out = pt_lowering(op)(LowerContext(torch.device("cpu")), {"X": [pt]},
                          dict(attrs))["Out"][0]
    out.backward(torch.ones_like(out))
    return pt.grad.numpy(), want


KINKS = (
    # op, attrs, x on the kinks, jax.vjp's subgradient there
    ("relu6", {"threshold": 6.0}, [0.0, 6.0], [0.5, 0.5]),
    ("brelu", {"t_min": 1.0, "t_max": 4.0}, [1.0, 4.0], [0.5, 0.5]),
    ("hard_sigmoid", {"slope": 0.2, "offset": 0.5}, [-2.5, 2.5],
     [0.1, 0.1]),
    ("hard_swish", {"threshold": 6.0, "scale": 6.0, "offset": 3.0},
     [-3.0, 3.0], [-0.25, 1.25]),
    ("soft_relu", {"threshold": 2.0}, [2.0, -2.0],
     [0.5 / (1 + np.exp(-2.0)), 0.5 / (1 + np.exp(2.0))]),
    ("leaky_relu", {"alpha": 0.1}, [0.0], [1.0]),
    ("elu", {"alpha": 1.3}, [0.0], [1.0]),
    ("selu", {}, [0.0], [1.0507009873554805]),
    ("hard_shrink", {"threshold": 0.5}, [0.5, -0.5], [0.0, 0.0]),
    ("softshrink", {"lambda": 0.5}, [0.5, -0.5], [0.0, 0.0]),
    ("thresholded_relu", {"threshold": 1.0}, [1.0], [0.0]),
)


@pytest.mark.parametrize("kink", KINKS, ids=[k[0] for k in KINKS])
def test_kink_subgradients_are_jax_s(kink):
    op, attrs, x, expect = kink
    got, want = _grad_at(op, x, attrs)
    np.testing.assert_allclose(want, expect, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_maxout_splits_the_gradient_among_ties():
    x = np.zeros((1, 4, 1, 1), np.float32)
    x[0, :, 0, 0] = [2.0, 5.0, 2.0, -1.0]      # groups of 2: (2, 2) tie
    got, ggot = check("maxout", {"X": [x]}, {"groups": 2}, wrt=("X",))
    pt = torch.from_numpy(x).requires_grad_()
    from paddle_tpu_torch.ops.registry import LowerContext
    from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering

    out = pt_lowering("maxout")(LowerContext(torch.device("cpu")),
                                {"X": [pt]}, {"groups": 2})["Out"][0]
    out.sum().backward()
    np.testing.assert_array_equal(pt.grad.numpy().reshape(-1),
                                  [0.5, 1.0, 0.5, 0.0])


def _all_layers(fl):
    L = fl.layers
    x = fl.data(name="x", shape=[None, 3, 4, 4], dtype="float32")
    outs = [getattr(L, n)(x) for n in (
        "acos", "asin", "atan", "cosh", "sin", "sinh", "tan", "erf",
        "rsqrt", "reciprocal", "logsigmoid", "softplus", "softsign",
        "tanh_shrink", "relu", "selu", "relu6", "hard_sigmoid",
        "hard_swish", "swish", "brelu", "leaky_relu", "soft_relu", "elu",
        "stanh")]
    outs += [L.softshrink(x, alpha=0.3), L.hard_shrink(x, threshold=0.2),
             L.thresholded_relu(x, threshold=0.7),
             L.selu(x, scale=1.1, alpha=1.5), L.relu6(x, threshold=5.0),
             L.hard_sigmoid(x, slope=0.3, offset=0.4),
             L.hard_swish(x, threshold=5.0, scale=5.0, offset=2.0),
             L.swish(x, beta=2.0), L.brelu(x, t_min=1.0, t_max=3.0),
             L.leaky_relu(x, alpha=0.2), L.soft_relu(x, threshold=10.0),
             L.elu(x, alpha=0.5), L.stanh(x, scale_a=0.5, scale_b=2.0),
             L.maxout(x, groups=3)]
    outs += [L.prelu(x, mode) for mode in ("all", "channel", "element")]
    outs.append(L.prelu(x, "channel", param_attr=fl.ParamAttr(name="pa")))
    return outs


def test_every_layer_builds_the_reference_s_program():
    progs = []
    for fl, un in ((jfluid, jax_unique_name), (fluid, pt_unique_name)):
        un.switch()
        main, start = fl.Program(), fl.Program()
        with fl.program_guard(main, start):
            outs = _all_layers(fl)
        progs.append((main, start, [(o.name, o.shape) for o in outs]))
    (jm, js, jo), (pm, ps, po) = progs
    assert json.loads(pm.to_json()) == json.loads(jm.to_json())
    assert json.loads(ps.to_json()) == json.loads(js.to_json())
    assert po == jo
    called = {op.type for op in pm.global_block().ops}
    assert set(ACTIVATION_OPS) - {"log_softmax"} <= called | {"relu"}


def test_prelu_layers_run_like_the_jax_package():
    """The three prelu modes as programs: the same outputs and the same
    Alpha gradients from the same Alpha values."""
    rng = np.random.default_rng(3)
    xv = rng.normal(size=(2, 3, 4, 4)).astype(np.float32)
    xv[0, 0, 0, :2] = 0.0
    res = []
    for fl, un in ((jfluid, jax_unique_name), (fluid, pt_unique_name)):
        un.switch()
        main, start = fl.Program(), fl.Program()
        with fl.program_guard(main, start):
            x = fl.data(name="x", shape=[None, 3, 4, 4], dtype="float32")
            ys = [fl.layers.prelu(x, m) for m in ("all", "channel",
                                                  "element")]
            loss = fl.layers.mean(fl.layers.sums([fl.layers.reduce_sum(
                y * y) for y in ys]))
            grads = fl.backward.append_backward(loss)
        exe = fl.Executor(fl.CPUPlace())
        scope = fl.Scope()
        exe.run(start, scope=scope)
        for i, p in enumerate(main.all_parameters()):
            scope.set(p.name, np.full(p.shape, 0.1 * (i + 1), np.float32)
                      if fl is jfluid else torch.full(
                          tuple(p.shape), 0.1 * (i + 1)))
        out = exe.run(main, feed={"x": xv}, scope=scope,
                      fetch_list=ys + [g for _, g in grads])
        res.append([np.asarray(o) for o in out])
    for a, w in zip(res[1], res[0]):
        assert_close(a, w, FWD_TOL)
