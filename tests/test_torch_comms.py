"""The gradient-communication subsystem of the port
(paddle_tpu_torch/parallel/comms) against the JAX package, on the CPU:
the mirror of tests/test_comms.py at 2 gloo ranks (tests/torch_ranks.py).

- plan_buckets: the same plan as the JAX package's GradSyncProgram for
  the same program; pack/unpack; reverse-backward order; overlap_ratio.
- quantized_allreduce_flat, exact_allreduce_flat and pmean_int8 at 2
  ranks against the JAX functions under shard_map over a 2-device dp
  mesh, within float rounding (1e-6 relative; the int8 payload each rank
  decoded, bit for bit).
- Fleet grad_sync_mode="comms" (the regression model of test_comms.py,
  the JAX package's startup values): fp32 against the gspmd mode, the
  port's and the JAX package's (2e-4, the JAX test's bound); int8 with
  error feedback converging to within the JAX test's 5e-3 of fp32;
  overlap on and off bit for bit alike; without error feedback; the
  residuals each rank's own persistables; the wire accounting and the
  comm telemetry the JAX package's.
- The refusals, the ``collective`` fault site and the collective
  deadline on every rank before any collective is issued.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import executor as jexecutor
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique_name
from paddle_tpu.parallel.comms import CommConfig as JaxCommConfig
from paddle_tpu.parallel.comms import GradSyncProgram as JaxGradSync
from paddle_tpu.parallel.comms import allreduce as jar
from paddle_tpu.parallel.sharding import DistributedProgram as JaxDist
from paddle_tpu.parallel.sharding import shard_map_manual
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.parallel import fleet as fleet_mod
from paddle_tpu_torch.parallel.comms import allreduce as ar
from paddle_tpu_torch.parallel.comms import bucketing as bk
from paddle_tpu_torch.parallel.comms import quantize as qz
from paddle_tpu_torch.parallel.comms.grad_sync import GradSyncProgram
from paddle_tpu_torch.parallel.mesh import RankGroup
import torch_ranks as tr

NDP = 2
BLOCK = 16


@pytest.fixture(autouse=True)
def _fresh_state():
    """Fresh default programs, name generators and scopes of both
    packages."""
    saved = []
    for fw, un, ex in ((pt_framework, pt_unique_name, pt_executor),
                       (jframework, junique_name, jexecutor)):
        saved.append((fw, un, ex, fw.switch_main_program(fw.Program()),
                      fw.switch_startup_program(fw.Program()), un.switch(),
                      ex._scope_stack[:]))
        ex._scope_stack[:] = [ex.Scope()]
    yield
    for fw, un, ex, main, start, gen, scopes in saved:
        fw.switch_main_program(main)
        fw.switch_startup_program(start)
        un.switch(gen)
        ex._scope_stack[:] = scopes


def _mesh():
    return Mesh(np.array(jax.devices()[:NDP]), ("dp",))


def _data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((32, 6)).astype("float32")
    y = (x @ rng.standard_normal((6, 1))).astype("float32")
    return {"cx": x, "cy": y}


def _jax_regression(cfg=None, steps=6):
    """The JAX package's regression run over 2 devices: its
    DistributedProgram (cfg None) or its GradSyncProgram with
    CommConfig(**cfg). Returns (losses, startup values, program)."""
    main, start = jframework.Program(), jframework.Program()
    main.random_seed = start.random_seed = 11
    with jfluid.program_guard(main, start), junique_name.guard():
        loss, _ = tr.regression(jfluid, tr.plain_minimize)
    scope = jexecutor.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope[n]) for n in scope.keys()}
    prog = JaxDist(main, _mesh()) if cfg is None else JaxGradSync(
        main, _mesh(), comm_config=JaxCommConfig(**cfg))
    losses = [float(np.asarray(exe.run(prog, feed=_data(), fetch_list=[loss],
                                       scope=scope)[0]))
              for _ in range(steps)]
    return losses, init, prog


def _comms(quantized=False, overlap=True, bucket_bytes=None, block=64,
           error_feedback=True):
    s = {"grad_sync_mode": "comms", "grad_quantize": quantized,
         "grad_quantize_block": block, "grad_overlap": overlap,
         "grad_error_feedback": error_feedback}
    if bucket_bytes is not None:
        s["grad_bucket_bytes"] = bucket_bytes
    return s


RUNS = {
    "gspmd": (None, 6),
    "fp32": (_comms(), 6),
    "gspmd8": (None, 8),
    "int8": (_comms(quantized=True), 8),
    "lap": (_comms(quantized=True, bucket_bytes=64), 6),
    "sync": (_comms(quantized=True, overlap=False, bucket_bytes=64), 6),
    "no_ef": (_comms(quantized=True, error_feedback=False), 6),
}


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    """The JAX references here and the port's 2-rank runs, one spawn."""
    _, init, _ = _jax_regression(steps=0)
    xs = np.random.default_rng(11).standard_normal(
        (NDP, NDP * BLOCK * 3)).astype(np.float32)
    jobs = [dict(model="regression", params=init, feeds=[_data()] * steps,
                 **({"entry": "dist"} if strategy is None else
                    {"entry": "fleet", "strategy": strategy}))
            for strategy, steps in RUNS.values()]
    got = tr.run_ranks(tr.comms_suite, NDP, tmp_path_factory.mktemp("comms"),
                       args=(xs, BLOCK, jobs, _data(),
                             str(tmp_path_factory.mktemp("saves"))),
                       timeout=180)
    runs = {name: [got[r]["jobs"][i] for r in range(NDP)]
            for i, name in enumerate(RUNS)}
    return xs, got, runs


def _losses(run):
    return [float(f[0]) for f in run["fetches"]]


# -- quantize / bucketing (host) --------------------------------------------
def test_error_feedback_residual_bounded():
    rng = np.random.default_rng(5)
    flat = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
    residual = torch.zeros_like(flat)
    for _ in range(4):
        send = qz.error_feedback_apply(flat, residual)
        p, s = qz.quantize_blocks(send, 64, "int8")
        residual = qz.error_feedback_update(
            send, qz.dequantize_blocks(p, s, 64))
        assert float(residual.abs().max()) <= float(s.max()) / 2 + 1e-6


def test_bucket_plan_deterministic_reverse_backward_order():
    named = [("w0", (64, 64)), ("b0", (64,)), ("w1", (64, 64)),
             ("b1", (64,)), ("w2", (512, 512)), ("b2", (512,))]
    from paddle_tpu.parallel.comms import bucketing as jbk

    a = bk.plan_buckets(named, 64 * 64 * 4)
    assert a.to_dict() == bk.plan_buckets(named, 64 * 64 * 4).to_dict()
    assert a.to_dict() == jbk.plan_buckets(named, 64 * 64 * 4).to_dict()
    flat_names = [n for bucket in a.buckets for n in bucket.names]
    assert flat_names == [n for n, _ in reversed(named)]
    assert any(bucket.names[-1] == "w2" for bucket in a.buckets)


def test_overlap_ratio_semantics():
    one = bk.plan_buckets([("w", (8, 8))], 1 << 20)
    assert one.overlap_ratio() == 0.0
    many = bk.plan_buckets(
        [("a", (64, 64)), ("b", (64, 64)), ("c", (64, 64))], 64 * 64 * 4)
    assert len(many.buckets) >= 2
    assert many.overlap_ratio(overlap=False) == 0.0
    assert many.overlap_ratio() == pytest.approx(
        1.0 - many.buckets[-1].n_elements / many.total_elements)


def test_pack_unpack_roundtrip():
    plan = bk.plan_buckets([("p", (3, 5)), ("q", (7,))], 1 << 20)
    bucket = plan.buckets[0]
    rng = np.random.default_rng(0)
    grads = {"p": torch.from_numpy(rng.standard_normal((3, 5))).float(),
             "q": torch.from_numpy(rng.standard_normal((7,))).float()}
    padded = bk.bucket_padded_len(bucket, 8, 16)
    flat = bk.pack_bucket(bucket, grads, padded)
    assert flat.shape == (padded,)
    assert bool((flat[bucket.n_elements:] == 0).all())
    out = bk.unpack_bucket(bucket, flat, grads)
    for n in ("p", "q"):
        assert torch.equal(out[n], grads[n])


@pytest.mark.parametrize("bucket_bytes", [64, 4 << 20])
def test_plan_buckets_equal_the_jax_plan(bucket_bytes):
    """GradSyncProgram's bucket plans (and residual names, wire
    accounting) for the same program are the JAX package's."""
    cfg = dict(quantized=True, block_size=64, bucket_bytes=bucket_bytes)
    _, _, jprog = _jax_regression(cfg, steps=0)
    loss, _ = tr.regression(fluid, tr.plain_minimize)
    prog = GradSyncProgram(
        fluid.default_main_program(),
        RankGroup(range(NDP), 0, None, "gloo", "cpu"),
        comm_config=ar.CommConfig(**cfg))
    assert [p.to_dict() for p in prog._plans] == [
        p.to_dict() for p in jprog._plans]
    assert prog._residual_names == jprog._residual_names
    assert prog._wire_stats == pytest.approx(jprog._wire_stats)


def test_allreduce_wire_bytes_accounting():
    for n, shards, q in ((8192, 8, False), (8192, 8, True), (8192, 1, False),
                         (110_000_000, 2, True)):
        assert ar.allreduce_wire_bytes(n, shards, quantized=q) == \
            jar.allreduce_wire_bytes(n, shards, quantized=q)


# -- the allreduces at 2 ranks ------------------------------------------------
def _jax_flat(xs, fn):
    f = shard_map_manual(lambda v: tuple(o[None] for o in fn(v[0])),
                         _mesh(), in_specs=JP("dp"), out_specs=JP("dp"))
    return [np.asarray(o) for o in jax.jit(f)(jnp.asarray(xs))]


@pytest.mark.parametrize("mean", [True, False])
def test_flat_allreduces_match_the_jax_functions(suite, mean):
    xs, got, _ = suite
    q, local = _jax_flat(xs, lambda v: jar.quantized_allreduce_flat(
        v, "dp", BLOCK, mean=mean))
    e, _ = _jax_flat(xs, lambda v: jar.exact_allreduce_flat(v, "dp",
                                                            mean=mean))
    for rank in range(NDP):
        pq, plocal, pe, same = got[rank]["flat"][mean]
        np.testing.assert_array_equal(plocal, local[rank])
        np.testing.assert_allclose(pq, q[rank], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(pe, e[rank], rtol=1e-6, atol=1e-6)
        assert same
    # every rank decodes the same bytes
    np.testing.assert_array_equal(got[0]["flat"][mean][0],
                                  got[1]["flat"][mean][0])
    want = xs.mean(axis=0) if mean else xs.sum(axis=0)
    tol = (1 if mean else NDP) * np.abs(xs).max() / 127.0 + 1e-6
    assert np.abs(got[0]["flat"][mean][0] - want).max() <= tol


def test_pmean_int8_matches_the_jax_function(suite):
    xs, got, _ = suite
    (want,) = _jax_flat(xs, lambda v: (jar.pmean_int8(v.reshape(-1, 8),
                                                      "dp"),))
    for rank in range(NDP):
        np.testing.assert_allclose(got[rank]["flat"]["pmean_int8"],
                                   want[rank], rtol=1e-6, atol=1e-7)


# -- the fleet comms mode at 2 ranks ----------------------------------------
def test_comms_fp32_matches_gspmd(suite):
    _, _, runs = suite
    jgspmd, _, _ = _jax_regression(steps=6)
    exact = _losses(runs["fp32"][0])
    np.testing.assert_allclose(exact, _losses(runs["gspmd"][0]), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(exact, jgspmd, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(_losses(runs["gspmd"][0]), jgspmd, rtol=1e-5,
                               atol=1e-6)


def test_comms_quantized_ef_converges_to_fp32(suite):
    _, _, runs = suite
    plain, quant = _losses(runs["gspmd8"][0]), _losses(runs["int8"][0])
    assert quant[-1] < quant[0] * 0.5          # it actually trains
    assert abs(quant[-1] - plain[-1]) < 5e-3
    jquant, _, _ = _jax_regression(_comms_cfg(quantized=True), steps=8)
    np.testing.assert_allclose(quant, jquant, rtol=1e-4, atol=1e-5)


def _comms_cfg(**kw):
    cfg = dict(quantized=False, block_size=64, overlap=True,
               error_feedback=True)
    cfg.update(kw)
    return cfg


def test_overlap_vs_sync_bit_identical(suite):
    _, got, runs = suite
    assert _losses(runs["lap"][0]) == _losses(runs["sync"][0])
    for a, b in zip(runs["lap"][0]["states"], runs["sync"][0]["states"]):
        for n in a:
            np.testing.assert_array_equal(a[n], b[n])
    assert got[0]["drills"]["n_buckets"] > 1


def test_quantized_comms_without_error_feedback_still_runs(suite):
    _, _, runs = suite
    losses = _losses(runs["no_ef"][0])
    assert losses[-1] < losses[0]
    assert not any(n.startswith("comm_ef_residual")
                   for n in runs["no_ef"][0]["states"][-1])


@pytest.mark.parametrize("run", ["fp32", "int8", "lap"])
def test_comms_ranks_keep_parameters_alike(suite, run):
    """The quantized all-gather leg decodes the same bytes on every rank,
    so the parameters stay bit for bit alike; the residuals are each
    rank's own."""
    _, _, runs = suite
    a, b = runs[run]
    for sa, sb in zip(a["states"], b["states"]):
        for n in sa:
            if not n.startswith("comm_ef_residual"):
                np.testing.assert_array_equal(sa[n], sb[n], err_msg=n)


def test_residuals_persist_in_scope(suite):
    _, got, _ = suite
    res = [got[r]["drills"]["residuals"] for r in range(NDP)]
    assert res[0] and sorted(res[0]) == sorted(res[1])
    for n in res[0]:
        assert res[0][n].ndim == 1 and res[0][n].shape[0] % (NDP * 64) == 0
        assert np.any(res[0][n] != 0.0)
        assert not np.array_equal(res[0][n], res[1][n])   # each rank's own
    # the consolidated copy averages them (and keeps the alike params)
    cons = got[0]["drills"]["consolidated"]
    for n in res[0]:
        np.testing.assert_allclose(cons[n], (res[0][n] + res[1][n]) / 2,
                                   rtol=1e-6, atol=1e-7)
    for n, v in got[0]["drills"]["local"].items():
        if not n.startswith("comm_ef_residual"):
            np.testing.assert_array_equal(cons[n], v)


def test_comm_metrics_and_wire_stats(suite):
    _, got, _ = suite
    d = got[0]["drills"]
    tel, stats = d["telemetry"], d["wire_stats"]
    assert tel["compression_ratio"] == pytest.approx(
        stats["bytes_fp32"] / stats["bytes_sent"])
    assert stats["bytes_fp32"] / stats["bytes_sent"] == pytest.approx(
        4.0 / (1.0 + 4.0 / 64))
    assert tel["compression_ratio"] >= 3.5
    assert tel["overlap_ratio"] > 0.0
    assert tel["bytes_sent"] == int(stats["bytes_sent"]) > 0
    assert tel["bytes_saved"] == int(stats["bytes_fp32"]
                                     - stats["bytes_sent"]) > 0
    assert tel["dispatch"] == 1


@pytest.mark.faults
def test_grad_sync_respects_collective_deadline(suite):
    _, got, _ = suite
    for rank in range(NDP):
        d = got[rank]["drills"]
        assert d["deadline"] is not None and "grad_sync" in d["deadline"]
        assert np.isfinite(d["after_deadline"])


@pytest.mark.faults
def test_grad_sync_fault_site_drill(suite):
    _, got, _ = suite
    for rank in range(NDP):
        d = got[rank]["drills"]
        assert d["fault"] is not None and "injected fault" in d["fault"]
        assert np.isfinite(d["after_fault"])
        assert d["after_fault"] < d["first"]


def test_fleet_barrier_worker_and_its_deadline(suite):
    _, got, _ = suite
    for rank in range(NDP):
        d = got[rank]["drills"]
        assert d["worker"] == (NDP, rank, rank == 0)
        assert d["barrier_deadline"] is not None
        assert "Fleet.barrier_worker" in d["barrier_deadline"]


def test_fleet_saves_from_rank_0_only(suite):
    """Rank 0 writes the persistables (the per-rank state averaged
    first, a collective every rank joins) and the inference model; the
    other rank writes nothing."""
    _, got, _ = suite
    assert got[0]["drills"]["saved"] == ["model", "persistables"]
    assert got[1]["drills"]["saved"] == []


# -- refusals and the shim ------------------------------------------------------
def _build(strategy):
    fl = fleet_mod.Fleet().init()
    loss, _ = tr.regression(fluid, lambda opt, loss: fl.distributed_optimizer(
        opt, strategy=strategy).minimize(loss))
    return fl, loss


def test_local_sgd_plus_comms_mode_rejected():
    s = fleet_mod.DistributedStrategy()
    s.use_local_sgd = True
    s.grad_sync_mode = "comms"
    with pytest.raises(NotImplementedError, match="comms"):
        _build(s)


def test_unknown_grad_sync_mode_rejected():
    s = fleet_mod.DistributedStrategy()
    s.grad_sync_mode = "carrier-pigeon"
    with pytest.raises(NotImplementedError):
        _build(s)


def test_comms_with_zero_or_tp_rejected():
    for attr in ("sharding_degree", "tensor_parallel_degree"):
        s = fleet_mod.DistributedStrategy()
        s.grad_sync_mode = "comms"
        setattr(s, attr, 2)
        with pytest.raises(NotImplementedError, match="comms"):
            _build(s)


def test_quantized_collectives_shim_reexports():
    from paddle_tpu_torch.parallel import quantized_collectives as shim

    assert shim.pmean_int8 is ar.pmean_int8
    assert shim.__all__ == ["pmean_int8"]


def test_c_allreduce_quant_op_registered():
    from paddle_tpu_torch.ops import registry

    assert registry.has_lowering("c_allreduce_quant")
