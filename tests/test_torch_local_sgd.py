"""LocalSGD in the port (paddle_tpu_torch/parallel/local_sgd.py, fleet's
``use_local_sgd``) against the JAX package, on the CPU: the cases of
tests/test_local_sgd.py that apply to ranks as processes.

Ranks are 2 gloo processes on a FileStore (tests/torch_ranks.py), one
spawn for the file, jobs in tests/torch_pipeline_ranks.py. The JAX side
runs here: its ``LocalSGDProgram`` and ``DistributedProgram`` over 2 of
the 8 virtual devices tests/conftest.py sets up, from the same startup
values (``fluid.io.params_from_numpy``), dropout-free.

- k = 1 and k = 4: losses within 1e-6 relative and each rank's
  parameters within 1e-5 of max of the JAX package's LocalSGDProgram at
  dp 2 (rank r against row r of its stacked state);
- k = 1 with SGD equals plain dp (the port's DistributedProgram through
  fleet) within 1e-6 of max|param|;
- k = 4: the ranks' parameters differ between syncs and are bit for bit
  alike after each sync; a step that does not average issues no
  parameter collective;
- the int8 delta sync within pmax|delta| / 254 per element of the exact
  average, its anchors in the scope and never saved;
- the refusals, and ``fleet.save_persistables`` writing the average of
  the ranks' parameters while the live scope keeps its own.
"""
import re

import numpy as np
import pytest

import jax

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import executor as jexecutor
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique_name
from paddle_tpu.parallel.local_sgd import LocalSGDProgram as JaxLocalSGD
from paddle_tpu.parallel.mesh import build_mesh as jbuild_mesh
import torch_pipeline_ranks as tpr
import torch_ranks as tr

STEPS = 8
K = 4


def _jax_run(k):
    """The JAX package's LocalSGDProgram at dp 2, k steps, SGD(0.1):
    (startup values, losses, the stacked parameters after every step)."""
    main, start = jframework.Program(), jframework.Program()
    main.random_seed = start.random_seed = 11
    with jfluid.program_guard(main, start), junique_name.guard():
        loss = tpr.lsgd_model(jfluid)
        jfluid.optimizer.SGD(0.1).minimize(loss)
    scope = jexecutor.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope[n]) for n in scope.keys()}
    prog = JaxLocalSGD(main, jbuild_mesh({"dp": 2},
                                         devices=jax.devices()[:2]),
                       k_steps=k)
    names = sorted(p.name for p in main.all_parameters())
    losses, params = [], []
    for _ in range(STEPS):
        losses.append(float(np.asarray(exe.run(
            prog, feed=tpr.lsgd_data(), fetch_list=[loss],
            scope=scope)[0])))
        params.append({n: np.asarray(scope[n]) for n in names})
    return init, losses, params


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jax_ref = {1: _jax_run(1), K: _jax_run(K)}
    init = jax_ref[1][0]
    local = {"use_local_sgd": True}
    jobs = [
        dict(fn="lsgd_run", params=init, steps=STEPS,
             strategy=dict(local, local_sgd_k_steps=1)),
        dict(fn="lsgd_run", params=init, steps=STEPS,
             strategy=dict(local, local_sgd_k_steps=K)),
        dict(fn="lsgd_run", params=init, steps=STEPS,
             strategy=dict(local, local_sgd_k_steps=K,
                           local_sgd_quantized_sync=True),
             save_dir=str(tmp_path_factory.mktemp("lsgd_save"))),
        dict(fn="lsgd_run", params=init, steps=STEPS, strategy={}),
        dict(fn="lsgd_run", params=init, steps=3,
             strategy=dict(local, local_sgd_k_steps=K),
             save_dir=str(tmp_path_factory.mktemp("lsgd_mid"))),
        dict(fn="lsgd_refusals"),
    ]
    got = tr.run_ranks(tpr.pipeline_jobs, 2, tmp_path_factory.mktemp(
        "lsgd"), args=(jobs,), timeout=180)
    names = ["k1", "k4", "int8", "plain", "mid", "refusals"]
    return jax_ref, {n: [g[i] for g in got] for i, n in enumerate(names)}


def _close_params(got, want, tol):
    for n, w in want.items():
        np.testing.assert_allclose(
            got[n], w, rtol=0, atol=tol * float(np.abs(w).max()),
            err_msg=n)


@pytest.mark.parametrize("k", [1, K])
def test_losses_and_parameters_match_the_jax_local_sgd(runs, k):
    """Each rank's parameters after every step are row `rank` of the JAX
    package's stacked state; the losses (the mean over the ranks) its
    losses."""
    jax_ref, port = runs
    _, jlosses, jparams = jax_ref[k]
    for rank, got in enumerate(port["k%d" % k]):
        np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-6)
        for step in range(STEPS):
            _close_params(got["params"][step],
                          {n: v[rank] for n, v in jparams[step].items()},
                          1e-5)


def test_k1_with_sgd_is_plain_dp(runs):
    """k = 1 averages the ranks' SGD updates every step: plain dp's update
    from the averaged gradient, in exact arithmetic."""
    _, port = runs
    for got, plain in zip(port["k1"], port["plain"]):
        for step in range(STEPS):
            _close_params(got["params"][step], plain["params"][step], 1e-6)
        np.testing.assert_allclose(got["losses"], plain["losses"],
                                   rtol=1e-6)
    assert port["k1"][0]["losses"][-1] < port["k1"][0]["losses"][0]


def test_k4_ranks_drift_between_syncs_and_agree_after(runs):
    _, port = runs
    a, b = port["k4"]
    for step in range(STEPS):
        synced = (step + 1) % K == 0
        for n in a["params"][step]:
            same = np.array_equal(a["params"][step][n], b["params"][step][n])
            assert same == synced, (step, n)
    assert a["losses"][-1] < a["losses"][0] * 0.7, a["losses"]


def test_steps_that_do_not_average_issue_no_parameter_collective(runs):
    """k = 4: one all-reduce (every float32 parameter in one buffer) on
    steps 4 and 8 and none on the others; k = 1: one every step; int8:
    one pmean_int8 per parameter on the sync steps only."""
    _, port = runs
    n_params = len(port["k4"][0]["params"][0])
    for rank in range(2):
        assert port["k4"][rank]["syncs"] == [0, 0, 0, 1] * 2
        assert port["k1"][rank]["syncs"] == [1] * STEPS
        assert port["int8"][rank]["syncs"] == [0, 0, 0, n_params] * 2
        assert port["plain"][rank]["syncs"] == [None] * STEPS


def test_int8_delta_sync_stays_within_its_bound(runs):
    """At each sync the int8 average of the deltas since the last sync
    is within pmax|delta| / 254 per element of the exact average, plus
    float slack (2·eps·|value|: the roundings of anchor + mean), and both
    ranks take the same bits."""
    _, port = runs
    a, b = port["int8"]
    anchor = {n: v.copy() for n, v in tpr_init(runs).items()}
    for i, step in enumerate((K - 1, 2 * K - 1)):
        pre = [a["pre_sync"][i], b["pre_sync"][i]]
        for n in anchor:
            deltas = [p[n] - anchor[n] for p in pre]
            exact = anchor[n] + (deltas[0] + deltas[1]) / 2
            bound = max(float(np.abs(d).max()) for d in deltas) / 254
            got = a["params"][step][n]
            np.testing.assert_array_equal(got, b["params"][step][n])
            # float slack: the two roundings of anchor + mean
            slack = 2 * np.finfo(np.float32).eps * np.abs(exact)
            assert (np.abs(got - exact) <= bound * (1 + 1e-5) + slack).all(), (
                n, float(np.abs(got - exact).max()), bound)
            anchor[n] = got.copy()
    assert a["anchors"] == sorted(n + "@LSGD_ANCHOR" for n in anchor)


def tpr_init(runs):
    jax_ref, port = runs
    names = port["k4"][0]["params"][0]
    return {n: jax_ref[1][0][n] for n in names}


def test_saves_write_the_average_and_keep_the_live_scope(runs):
    """fleet.save_persistables mid-cycle (3 steps of k = 4): rank 0 writes
    the mean of the ranks' parameters, every rank's live scope keeps its
    own; consolidated_scope gives the same mean; int8 anchors are not
    saved."""
    _, port = runs
    a, b = port["mid"]
    assert a["kept"] and b["kept"]
    for n, v in a["params"][-1].items():
        mean = (v + b["params"][-1][n]) / 2
        assert not np.array_equal(v, b["params"][-1][n]), n
        np.testing.assert_allclose(a["saved"][n], mean, rtol=1e-6)
        np.testing.assert_allclose(a["consolidated"][n], mean, rtol=1e-6)
        np.testing.assert_array_equal(b["consolidated"][n],
                                      a["consolidated"][n])
    assert "saved" not in b
    assert not [n for n in port["int8"][0]["saved"] if "@LSGD" in n]


REFUSALS = {
    "zero": "pick one",
    "tp": "pure-dp",
    "comms": "sync disciplines exclude each other",
    "pipeline": "PipelineOptimizer",
    "feed": "LEADING",
    "no_dp": "tensor/sequence parallelism",
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals(runs, case):
    _, port = runs
    for got in port["refusals"]:
        assert got[case] is not None and re.search(REFUSALS[case],
                                                   got[case]), got[case]
