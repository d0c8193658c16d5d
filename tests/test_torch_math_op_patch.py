"""Variable's arithmetic operators of the port against the JAX package, on
the CPU.

- Every operator (``+ - * / ** // %``, unary ``-``) with a Variable, a
  float, an int and the reflected forms builds the same Program JSON in
  both packages, op for op and name for name: a scalar goes through
  ``scale`` on the unreflected side of ``+ - *`` and unary ``-``, and
  through ``fill_constant([1])`` and the elementwise op otherwise.
- Run on the same numpy inputs, both packages give the same values:
  exactly, except where a ``scale`` has a bias, which is held to 1e-6
  relative (XLA on the CPU fuses ``x·scale + bias`` into one fused
  multiply-add; ROADMAP "Schedules round apart"), and where a Variable
  is divided by a float: XLA folds the ``fill_constant`` into the jitted
  step and multiplies by the divisor's rounded reciprocal, one ulp off
  true division in some elements, so that is held to 1e-6 relative too,
  and the port's quotient to numpy's ``x / 3.0`` exactly.
- ``==`` stays Python equality: no op is appended, and Variables keep
  working in lists, sets and dicts.
"""
import json

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name

LAST_BIT_RTOL = 1e-6


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


# name -> (expression of x and y, why the values may differ in a last bit:
# None, "bias" (a scale with a bias) or "reciprocal" (/ a float))
CASES = {
    "add": (lambda x, y: x + y, None),
    "add_float": (lambda x, y: x + 2.5, "bias"),
    "add_int": (lambda x, y: x + 3, "bias"),
    "radd": (lambda x, y: 2.5 + x, None),
    "sub": (lambda x, y: x - y, None),
    "sub_float": (lambda x, y: x - 0.75, "bias"),
    "rsub": (lambda x, y: 4.0 - x, None),
    "mul": (lambda x, y: x * y, None),
    "mul_float": (lambda x, y: x * 1.7, None),
    "mul_int": (lambda x, y: x * 3, None),
    "rmul": (lambda x, y: 1.7 * x, None),
    "div": (lambda x, y: x / y, None),
    "div_float": (lambda x, y: x / 3.0, "reciprocal"),
    "rdiv": (lambda x, y: 3.0 / x, None),
    "pow": (lambda x, y: x ** y, None),
    "pow_float": (lambda x, y: x ** 2.0, None),
    "rpow": (lambda x, y: 2.0 ** x, None),
    "floordiv": (lambda x, y: x // y, None),
    "floordiv_float": (lambda x, y: x // 0.7, None),
    "mod": (lambda x, y: x % y, None),
    "mod_float": (lambda x, y: x % 0.7, None),
    "neg": (lambda x, y: -x, None),
    "chain": (lambda x, y: x * 2.0 + 1.0, "bias"),
    "mixed": (lambda x, y: (3.0 - x / y) ** 2.0 * -(y - 1.5) + 0.5, "bias"),
}


def _build(pkg, un, fn):
    un.switch()
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.layers.data("x", [4])
        y = pkg.layers.data("y", [4])
        out = fn(x, y)
    return main, out


def _feed():
    rng = np.random.default_rng(3)
    return {"x": rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32),
            "y": rng.uniform(0.5, 2.0, (3, 4)).astype(np.float32)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_operator_program_and_values(case):
    fn, why = CASES[case]
    jmain, jout = _build(jfluid, jax_unique_name, fn)
    pmain, pout = _build(fluid, pt_unique_name, fn)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert pout.name == jout.name
    feed = _feed()
    want, = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed=feed, fetch_list=[jout], scope=jfluid.Scope())
    got, = fluid.Executor(fluid.CPUPlace()).run(
        pmain, feed=feed, fetch_list=[pout], scope=fluid.Scope())
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if why is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=LAST_BIT_RTOL, atol=0)
    if why == "reciprocal":
        np.testing.assert_array_equal(got, feed["x"] / np.float32(3.0))


def test_scalar_routes():
    """A scalar on the unreflected side of + - * and unary - is one
    ``scale`` op; otherwise a [1] ``fill_constant`` and the elementwise
    op; the acceptance example ``data("x", [4]) * 2.0 + 1.0`` is two
    scales and equals the JAX package's program."""
    def types(fn):
        main, _ = _build(fluid, pt_unique_name, fn)
        return [op.type for op in main.global_block().ops]

    assert types(lambda x, y: x * 2.0 + 1.0) == ["scale", "scale"]
    assert types(lambda x, y: -x) == ["scale"]
    assert types(lambda x, y: 2.0 - x) == ["fill_constant",
                                           "elementwise_sub"]
    assert types(lambda x, y: x / 2.0) == ["fill_constant",
                                           "elementwise_div"]
    main, out = _build(fluid, pt_unique_name, lambda x, y: x * 2.0 + 1.0)
    fill = _build(fluid, pt_unique_name, lambda x, y: 2.0 - x)[0]
    op = fill.global_block().ops[0]
    assert op.attrs["shape"] == [1] and op.attrs["value"] == 2.0
    got, = fluid.Executor(fluid.CPUPlace()).run(
        main, feed={"x": np.arange(8, dtype=np.float32).reshape(2, 4)},
        fetch_list=[out], scope=fluid.Scope())
    np.testing.assert_array_equal(
        got, np.arange(8, dtype=np.float32).reshape(2, 4) * 2 + 1)


def test_equality_stays_python_equality():
    x = fluid.layers.data("x", [4])
    y = fluid.layers.data("y", [4])
    n_ops = len(fluid.default_main_program().global_block().ops)
    assert (x == x) is True and (x == y) is False and (x != y) is True
    assert x in [y, x] and y not in [x]
    assert len({x, y, x}) == 2 and {x: 1, y: 2}[y] == 2
    assert len(fluid.default_main_program().global_block().ops) == n_ops
    with pytest.raises(TypeError):
        x < y   # noqa: B015  (the comparisons stay unpatched)
