"""Switch-MoE FFN and expert parallelism in the port
(paddle_tpu_torch/parallel/moe.py) against the JAX package, on the CPU:
counterparts of tests/test_moe.py, the Program JSON of ``switch_ffn``,
and ``moe_ep_rules``.

The ep = 2 run is 2 gloo ranks on a FileStore (tests/torch_ranks.py),
one spawn for the file, its job in tests/torch_pipeline_ranks.py; the
JAX side runs here.
"""
import json

import numpy as np
import pytest
from scipy.special import erf

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import executor as jexecutor
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique_name
from paddle_tpu.parallel import moe as jmoe

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import framework
from paddle_tpu_torch.fluid import unique_name
from paddle_tpu_torch.parallel import moe
import torch_pipeline_ranks as tpr
import torch_ranks as tr

STEPS = 3


@pytest.fixture(autouse=True)
def _fresh():
    tr.fresh_port_state()


def _build(B, T, H, E, F, cap=8.0, seed=3, name="moe"):
    fluid.default_startup_program().random_seed = seed
    fluid.default_main_program().random_seed = seed
    x = fluid.data("moe_x", shape=[B, T, H], dtype="float32")
    y, aux = moe.switch_ffn(x, E, F, capacity_factor=cap, name=name)
    return x, y, aux


def _scope_np(name):
    return fluid.global_scope()[name].numpy()


def test_switch_ffn_matches_numpy_oracle():
    """tests/test_moe.py's oracle: top-1 routing, the expert FFN with
    gelu, scaled by the winning probability, and the aux loss."""
    B, T, H, E, F = 2, 4, 6, 3, 8
    _, y, aux = _build(B, T, H, E, F, cap=100.0)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    xv = np.random.default_rng(0).standard_normal((B, T, H)).astype(
        "float32")
    got_y, got_aux = exe.run(feed={"moe_x": xv}, fetch_list=[y, aux])
    gw = _scope_np("moe.gate.w")
    w1, b1 = _scope_np("moe.w1"), _scope_np("moe.b1")
    w2, b2 = _scope_np("moe.w2"), _scope_np("moe.b2")
    xs = xv.reshape(-1, H)
    logits = xs @ gw
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    idx = p.argmax(-1)
    want = np.zeros_like(xs)
    for s in range(xs.shape[0]):
        e = idx[s]
        h1 = xs[s] @ w1[e] + b1[e, 0]
        h1 = 0.5 * h1 * (1.0 + erf(h1 / np.sqrt(2.0)))
        want[s] = (h1 @ w2[e] + b2[e, 0]) * p[s, e]
    np.testing.assert_allclose(got_y.reshape(-1, H), want, rtol=2e-4,
                               atol=2e-5)
    onehot = np.eye(E)[idx]
    want_aux = E * float((onehot.mean(0) * p.mean(0)).sum())
    assert abs(float(np.asarray(got_aux)) - want_aux) < 1e-4


@pytest.mark.parametrize("tokens", ["random", "alike"])
def test_switch_ffn_drops_overflow_tokens(tokens):
    """Capacity max(4, ceil(8 / 2 * 0.1)) = 4 a expert: every token past
    slot 4 of its expert comes back exactly zero (tests/test_moe.py's
    random tokens; and 8 alike tokens, all routed to one expert, of
    which 4 must drop)."""
    B, T, H, E, F = 1, 8, 4, 2, 4
    _, y, _ = _build(B, T, H, E, F, cap=0.1)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    xv = np.random.default_rng(1).standard_normal((B, T, H)).astype(
        "float32")
    if tokens == "alike":
        xv[:] = xv[:, :1]
    out = exe.run(feed={"moe_x": xv}, fetch_list=[y])[0]
    idx = (xv.reshape(-1, H) @ _scope_np("moe.gate.w")).argmax(-1)
    pos = {e: 0 for e in range(E)}
    flat = out.reshape(-1, H)
    dropped = 0
    for s, e in enumerate(idx):
        if pos[e] >= 4:
            np.testing.assert_array_equal(flat[s], np.zeros(H))
            dropped += 1
        pos[e] += 1
    assert dropped == (4 if tokens == "alike" else 0)


def _jax_program(name="moe_ep"):
    main, start = jframework.Program(), jframework.Program()
    main.random_seed = start.random_seed = 3
    with jfluid.program_guard(main, start), junique_name.guard():
        loss = tpr.moe_model(jfluid, name=name)
    return main, start, loss


def test_switch_ffn_program_parity():
    """The same layer calls give the same Program JSON in both packages,
    main (the Adam-trained model) and startup."""
    jmain, jstart, _ = _jax_program()
    main, start = framework.Program(), framework.Program()
    main.random_seed = start.random_seed = 3
    with fluid.program_guard(main, start), unique_name.guard():
        tpr.moe_model(fluid)
    assert json.loads(main.to_json()) == json.loads(jmain.to_json())
    assert json.loads(start.to_json()) == json.loads(jstart.to_json())
    ops = {op.type for op in main.global_block().ops}
    assert {"cumsum", "one_hot", "matmul", "softmax"} <= ops


def test_moe_ep_rules_are_the_jax_packages():
    got = moe.moe_ep_rules("moe_ep")
    want = jmoe.moe_ep_rules("moe_ep")
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [tuple(s) for _, s in got] == [tuple(s) for _, s in want]
    assert [tuple(s) for _, s in got] == [("ep", None, None)] * 4
    import re

    for pattern, _ in got:
        assert not re.search(pattern, "moe_ep.gate.w")


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """The JAX package's replicated run (its startup values and 3 Adam
    losses), and the port's from those values: replicated (the plain
    Executor on each rank) and at ep = 2 (2 experts a rank), one
    spawn."""
    main, start, loss = _jax_program()
    scope = jexecutor.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope[n]) for n in scope.keys()}
    feed = tpr.moe_feed()
    base = [float(np.asarray(exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)[0])) for _ in range(STEPS)]
    jobs = [dict(fn="moe_run", params=init, steps=STEPS, axes=None),
            dict(fn="moe_run", params=init, steps=STEPS, axes={"ep": 2})]
    got = tr.run_ranks(tpr.pipeline_jobs, 2, tmp_path_factory.mktemp("moe"),
                       args=(jobs,), timeout=180)
    return base, {"repl": [g[0] for g in got], "ep": [g[1] for g in got]}


def test_switch_ffn_trains_and_tracks_the_replicated_run_at_ep2(moe_runs):
    """tests/test_moe.py's bar: the ep-split run tracks the replicated
    one to rtol 5e-2 (top-1 routing is discrete) and trains; here it
    tracks the port's replicated run to 1e-5 too."""
    base, port = moe_runs
    assert base[-1] < base[0]
    for rank in range(2):
        ep, repl = port["ep"][rank], port["repl"][rank]
        np.testing.assert_allclose(ep["losses"], base, rtol=5e-2)
        np.testing.assert_allclose(repl["losses"], base, rtol=1e-5)
        np.testing.assert_allclose(ep["losses"], repl["losses"], rtol=1e-5)
        assert ep["losses"][-1] < ep["losses"][0]
        for name, want in repl["state"].items():
            if name.startswith("moe_ep"):
                np.testing.assert_allclose(
                    ep["state"][name], want, rtol=0,
                    atol=1e-5 * max(float(np.abs(want).max()), 1e-30),
                    err_msg=name)


def test_each_rank_holds_its_experts_and_nothing_gathers_them(moe_runs):
    """At ep = 2 each rank keeps 2 of the 4 experts' weights (the gate
    stays whole), and the layouts take no fallback that gathers an
    expert weight: the one fallback a step reduces the partial combined
    output (B, T, H) over ep where the loss reads it."""
    _, port = moe_runs
    E = tpr.MOE_SHAPE["E"]
    for got in port["ep"]:
        for n in ("moe_ep.w1", "moe_ep.b1", "moe_ep.w2", "moe_ep.b2"):
            assert got["shapes"][n][0] == E // 2, n
        assert got["shapes"]["moe_ep.gate.w"] == (tpr.MOE_SHAPE["H"], E)
        assert got["reshards"] == {("square_error_cost", "ep"): STEPS}
    for got in port["repl"]:
        assert got["reshards"] == {}
        assert got["shapes"]["moe_ep.w1"][0] == E
