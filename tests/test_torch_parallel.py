"""Data parallel in the port (paddle_tpu_torch/parallel) against the JAX
package, on the CPU.

Ranks are gloo processes on a FileStore (tests/torch_ranks.py); the JAX
side runs here, on the 8 virtual devices tests/conftest.py sets up.

- The 19 collective op types at 2 and 4 ranks, each rank's output
  against the JAX lowering's shard under shard_map over a dp mesh of
  the same size with ring 0 bound to it: exact for the integer,
  max/min/prod, gather, scatter and permute cases, 1e-6 relative for the
  float sums (the JAX package's psum may add the shards in another
  order), and at world size 1 (no axis bound) the identity, the mirror
  of test_distributed.py::test_collective_layer_ops_single_rank_identity.
- Data parallel at 2 ranks: test_distributed.py::_train_once's MLP
  through DistributedProgram, CompiledProgram.with_data_parallel,
  ParallelExecutor and fleet (gspmd and comms), 3 SGD steps on the
  global batch of 8, against the JAX package's DistributedProgram over 2
  devices (losses, parameters and the gathered logits within 1e-5, the
  JAX test's own tolerance); a conv + batch-norm net whose moving
  statistics are the global batch's (the JAX dp run's within 1e-5), and
  in the comms mode each rank's own (the JAX GradSyncProgram's rows); a
  2-layer BERT (hidden 64), gspmd and comms, against the JAX package's
  single-device run within 1e-4; the two ranks' scopes bit for bit alike
  after every step; dropout masks that differ between ranks and a
  static-shape draw that does not.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as JP

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.fluid import executor as jexecutor
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique_name
from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
from paddle_tpu.ops.registry import get_lowering as jax_lowering
from paddle_tpu.parallel.comms import GradSyncProgram as JaxGradSync
from paddle_tpu.parallel.sharding import DistributedProgram as JaxDist
from paddle_tpu.parallel.sharding import shard_map_manual
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.ops.registry import LOWERINGS
import torch_ranks as tr

COLLECTIVES = sorted([
    "c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_allgather", "c_broadcast", "c_reducescatter",
    "c_concat", "c_identity", "c_split", "c_sync_calc_stream",
    "c_sync_comm_stream", "c_comm_init", "c_comm_init_all",
    "c_gen_nccl_id", "barrier", "ppermute", "all_to_all",
    "c_allreduce_quant"])
STEPS = 3
BATCH = 8


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


# ---------------------------------------------------------------------------
# the 19 collective op types
# ---------------------------------------------------------------------------
def _cases(world):
    """(op type, {slot: [per-rank stacked arrays]}, attrs, exact) for every
    collective at `world` ranks."""
    rng = np.random.default_rng(world)

    def f32(*shape):
        return rng.standard_normal((world,) + shape).astype(np.float32)

    def i32(*shape):
        return rng.integers(-50, 50, (world,) + shape).astype(np.int32)

    small = rng.integers(-3, 4, (world, 3, 4)).astype(np.float32)
    cases = [
        ("c_allreduce_sum", {"X": [f32(6, 5)]}, {}, False),
        ("c_allreduce_sum", {"X": [i32(6, 5)]}, {}, True),
        ("c_allreduce_max", {"X": [f32(6, 5)]}, {}, True),
        ("c_allreduce_max", {"X": [i32(7)]}, {}, True),
        ("c_allreduce_min", {"X": [f32(6, 5)]}, {}, True),
        ("c_allreduce_min", {"X": [i32(7)]}, {}, True),
        ("c_allreduce_prod", {"X": [small]}, {}, True),
        ("c_allreduce_prod", {"X": [i32(2, 3) % 7]}, {}, True),
        ("c_allgather", {"X": [f32(3, 4)]}, {"nranks": world}, True),
        ("c_broadcast", {"X": [f32(3, 4)]}, {"root": 1}, True),
        ("c_broadcast", {"X": [i32(5)]}, {"root": 0}, True),
        ("c_reducescatter", {"X": [i32(2 * world, 3)]},
         {"nranks": world}, True),
        ("c_reducescatter", {"X": [f32(2 * world, 3)]},
         {"nranks": world}, False),
        ("c_concat", {"X": [f32(2, 3)]}, {"nranks": world}, True),
        ("c_identity", {"X": [f32(2, 3)]}, {}, True),
        ("c_split", {"X": [f32(2 * world, 3)]}, {}, True),
        ("c_sync_calc_stream", {"X": [f32(4)]}, {}, True),
        ("c_sync_comm_stream", {"X": [f32(4)]}, {}, True),
        ("c_comm_init", {}, {"nranks": world}, True),
        ("c_comm_init_all", {}, {}, True),
        ("c_gen_nccl_id", {}, {}, True),
        ("barrier", {"X": [f32(3)]}, {}, True),
        ("barrier", {}, {}, True),
        ("ppermute", {"X": [f32(2, 3)]}, {"shift": 1}, True),
        ("ppermute", {"X": [i32(4)]}, {"shift": -1}, True),
        ("all_to_all", {"X": [f32(2 * world, 3)]},
         {"split_axis": 0, "concat_axis": 1}, True),
        ("all_to_all", {"X": [f32(3, 2 * world)]},
         {"split_axis": 1, "concat_axis": 0}, True),
        ("c_allreduce_quant", {"X": [f32(6, 10)]},
         {"block_size": 16}, False),
        ("c_allreduce_quant", {"X": [f32(5, 7)]},
         {"block_size": 8, "op": "sum"}, False),
        ("c_allreduce_quant", {"X": [i32(6)]}, {}, True),
    ]
    return cases


def _jax_case(world, op_type, ins, attrs):
    """The JAX lowering of one case under shard_map over a dp mesh of
    `world` devices with ring 0 bound: per-rank {slot: [arrays]}."""
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    slots = sorted(ins)
    flat = [a for s in slots for a in ins[s]]
    counts = [len(ins[s]) for s in slots]
    shapes = {}

    def body(*xs):
        args, i = {}, 0
        for s, c in zip(slots, counts):
            args[s] = [x[0] for x in xs[i:i + c]]
            i += c
        ctx = JaxLowerContext(mesh_axes={0: "dp"}, platform="cpu")
        got = jax_lowering(op_type)(ctx, args, dict(attrs))
        keys = sorted(got)
        shapes["keys"] = [(k, len(got[k])) for k in keys]
        return tuple(v[None] for k in keys for v in got[k])

    fn = shard_map_manual(body, mesh, in_specs=tuple(JP("dp") for _ in flat),
                          out_specs=JP("dp"))
    outs = jax.jit(fn)(*[jnp.asarray(a) for a in flat])
    per_rank = [dict() for _ in range(world)]
    i = 0
    for k, c in shapes["keys"]:
        for _ in range(c):
            arr = np.asarray(outs[i])
            for r in range(world):
                per_rank[r].setdefault(k, []).append(arr[r])
            i += 1
    return per_rank


@pytest.fixture(scope="module")
def collective_results(tmp_path_factory):
    """{world: (cases, the port's per-rank outputs)} at 2 and 4 ranks; at
    4 ranks also the MLP through DistributedProgram."""
    out = {}
    for world in (2, 4):
        cases = _cases(world)
        jobs = ([dict(model="mlp", entry="dist", feeds=_mlp_feeds())]
                if world == 4 else [])
        got = tr.run_ranks(
            tr.collective_suite, world,
            tmp_path_factory.mktemp("collectives%d" % world),
            args=([(t, ins, attrs) for t, ins, attrs, _ in cases], jobs),
            timeout=120)
        out[world] = (cases, got)
    return out


def test_the_port_registers_the_jax_packages_324_op_types():
    import paddle_tpu.fluid.contrib.slim.quantization  # noqa: F401
    from paddle_tpu.ops.registry import LOWERINGS as JAX_LOWERINGS

    assert len(LOWERINGS) == len(JAX_LOWERINGS) == 324
    assert set(LOWERINGS) == set(JAX_LOWERINGS)
    assert set(COLLECTIVES) <= set(LOWERINGS)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("op_type", COLLECTIVES)
def test_collective_matches_the_jax_lowering(collective_results, world,
                                             op_type):
    cases, got = collective_results[world]
    got = [g["cases"] for g in got]
    hit = [i for i, c in enumerate(cases) if c[0] == op_type]
    assert hit
    for i in hit:
        _, ins, attrs, exact = cases[i]
        want = _jax_case(world, op_type, ins, attrs)
        for rank in range(world):
            g, w = got[rank][i], want[rank]
            assert sorted(g) == sorted(w), (op_type, attrs)
            for slot in w:
                for a, b in zip(g[slot], w[slot]):
                    assert a.shape == b.shape, (op_type, attrs, slot)
                    assert a.dtype == b.dtype, (op_type, attrs, slot)
                    if exact:
                        np.testing.assert_array_equal(a, b)
                    else:
                        np.testing.assert_allclose(
                            a, b, rtol=1e-6,
                            atol=1e-6 * float(np.abs(b).max()))


def test_groups_over_part_of_the_world(collective_results):
    """At 4 ranks: a group over ranks 1 and 3 and the world shrunk past
    rank 0 (``new_group`` on every rank); members reduce over their
    group only, the others are outside it (rank None)."""
    _, got = collective_results[4]
    for rank in range(4):
        sub = got[rank]["subgroups"]
        pair = 0 if rank == 1 else 1 if rank == 3 else None
        assert sub["pair"] == ((1, 3), pair, None if pair is None else 4.0)
        shrunk = None if rank == 0 else rank - 1
        assert sub["shrunk"] == ((1, 2, 3), shrunk,
                                 None if shrunk is None else 6.0)


def test_collective_layer_ops_single_rank_identity():
    """World-size-1 execution: the six collective layers are the
    identity, as in the JAX package (no ring bound to an axis)."""
    from paddle_tpu_torch.fluid.layers import collective as coll

    x = fluid.data("x", [4], dtype="float32")
    outs = [coll._c_allreduce(x, reduce_type="sum"),
            coll._c_allreduce(x, reduce_type="max"),
            coll._c_broadcast(x, root=0),
            coll._c_allgather(x, nranks=1),
            coll._c_reducescatter(x, nranks=1),
            coll._c_sync_calc_stream(x),
            coll._c_sync_comm_stream(x)]
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    x_np = np.array([1.0, 2.0, 3.0, 4.0], "float32")
    for v in exe.run(feed={"x": x_np}, fetch_list=outs):
        np.testing.assert_array_equal(v, x_np)


# ---------------------------------------------------------------------------
# data parallel at 2 ranks
# ---------------------------------------------------------------------------
def _mlp_feeds():
    rng = np.random.default_rng(3)
    return [{"x": rng.standard_normal((BATCH, 16)).astype("float32"),
             "y": rng.integers(0, 4, (BATCH, 1)).astype("int64")}
            for _ in range(STEPS)]


def _conv_feeds():
    rng = np.random.default_rng(5)
    # one channel's scale differs by rank half, so a rank's own batch
    # statistics are far from the global ones
    imgs = []
    for _ in range(STEPS):
        img = rng.standard_normal((BATCH, 3, 8, 8)).astype("float32")
        img[BATCH // 2:] = img[BATCH // 2:] * 3.0 + 1.0
        imgs.append({"img": img,
                     "label": rng.integers(0, 3, (BATCH, 1)).astype("int64")})
    return imgs


def _bert_feeds():
    from paddle_tpu_torch.models import bert

    cfg = tr.bert_config(bert)
    return [dict(zip(("input_ids", "mlm_labels"), bert.synthetic_batch(
        cfg, 4, tr.BERT_SEQ, seed=s))) for s in range(STEPS)]


def _jax_run(model, feeds, mesh_size, comms=False):
    """The JAX package's run of `model` on `feeds`: through its
    DistributedProgram (its GradSyncProgram when `comms`) over
    `mesh_size` devices, or the plain Executor when that is None.
    Returns (fetches per step, startup values, scope after every step)."""
    main, start = jframework.Program(), jframework.Program()
    main.random_seed = start.random_seed = 11
    with jfluid.program_guard(main, start), junique_name.guard():
        loss, extra = tr.MODELS[model](jfluid, tr.plain_minimize)
    scope = jexecutor.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope[n]) for n in scope.keys()}
    if mesh_size is None:
        prog = main
    else:
        mesh = Mesh(np.array(jax.devices()[:mesh_size]), ("dp",))
        prog = JaxGradSync(main, mesh) if comms else JaxDist(main, mesh)
    fetch = ([loss] if loss is not None else []) + extra
    fetches, states = [], []
    for feed in feeds:
        fetches.append([np.asarray(v) for v in exe.run(
            prog, feed=feed, fetch_list=fetch, scope=scope)])
        states.append({n: np.asarray(scope[n]) for n in scope.keys()})
    return fetches, init, states


@pytest.fixture(scope="module")
def dp_results(tmp_path_factory):
    """The JAX references and the port's 2-rank runs, one spawn."""
    bad = _mlp_feeds()
    bad[1]["x"][BATCH - 1, 3] = np.inf      # rank 1's half only
    feeds = {"mlp": _mlp_feeds(), "conv_bn": _conv_feeds(), "mlp_amp": bad,
             "bert_small": _bert_feeds(),
             "draws": [{"dx": np.ones((4, 64), "float32")}] * 2}
    jax_ref = {"mlp": _jax_run("mlp", feeds["mlp"], 2),
               "conv_bn": _jax_run("conv_bn", feeds["conv_bn"], 2),
               "bert_small": _jax_run("bert_small", feeds["bert_small"],
                                      None),
               "conv_bn_comms": _jax_run("conv_bn", feeds["conv_bn"], 2,
                                         comms=True)}
    jobs = {
        "dist": dict(model="mlp", entry="dist"),
        "compiled": dict(model="mlp", entry="compiled"),
        "pexe": dict(model="mlp", entry="pexe"),
        "fleet": dict(model="mlp", entry="fleet"),
        "fleet_comms": dict(model="mlp", entry="fleet",
                            strategy={"grad_sync_mode": "comms"}),
        "conv_bn": dict(model="conv_bn", entry="dist"),
        "bert_small": dict(model="bert_small", entry="compiled"),
        "bert_small_comms": dict(model="bert_small", entry="fleet",
                                 strategy={"grad_sync_mode": "comms"}),
        "conv_bn_comms": dict(model="conv_bn", entry="fleet",
                              strategy={"grad_sync_mode": "comms"}),
        "draws": dict(model="draws", entry="dist"),
        "amp_skip": dict(model="mlp_amp", entry="dist"),
    }
    names = list(jobs)
    for name in names:
        job = jobs[name]
        job["feeds"] = feeds[job["model"]]
        if job["model"] in ("conv_bn", "bert_small"):
            job["params"] = jax_ref[job["model"]][1]
    got = tr.run_ranks(tr.dp_jobs, 2, tmp_path_factory.mktemp("dp"),
                       args=([jobs[n] for n in names],), timeout=180)
    port = {n: [got[r][i] for r in range(2)] for i, n in enumerate(names)}
    return jax_ref, port


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1.0))


@pytest.mark.parametrize("entry", ["dist", "compiled", "pexe", "fleet",
                                   "fleet_comms"])
def test_mlp_two_ranks_match_the_jax_dp_run(dp_results, entry):
    """Losses, w1/w2 and the logits of the global batch within 1e-5 of the
    JAX package's DistributedProgram over 2 devices, every step, through
    each entry point."""
    (jfetch, _, jstates), port = dp_results[0]["mlp"], dp_results[1][entry]
    for rank in range(2):
        run = port[rank]
        for step in range(STEPS):
            loss, logits = run["fetches"][step]
            assert np.shape(loss) == np.shape(jfetch[step][0])
            _close(loss, jfetch[step][0], 1e-5)
            assert logits.shape == (BATCH, 4)
            _close(logits, jfetch[step][1], 1e-5)
            for name in ("w1", "w2"):
                _close(run["states"][step][name], jstates[step][name], 1e-5)


def test_mlp_four_ranks_match_the_jax_dp_run(collective_results):
    """The MLP over 4 ranks (2 rows each) against the JAX package's
    DistributedProgram over 4 devices: losses, logits and weights within
    1e-5 every step, the 4 ranks bit for bit alike."""
    jfetch, _, jstates = _jax_run("mlp", _mlp_feeds(), 4)
    runs = [g["jobs"][0] for g in collective_results[4][1]]
    for step in range(STEPS):
        _close(runs[0]["fetches"][step][0], jfetch[step][0], 1e-5)
        _close(runs[0]["fetches"][step][1], jfetch[step][1], 1e-5)
        for name in ("w1", "w2"):
            _close(runs[0]["states"][step][name], jstates[step][name], 1e-5)
        for run in runs[1:]:
            for name, v in runs[0]["states"][step].items():
                np.testing.assert_array_equal(run["states"][step][name], v)


@pytest.mark.parametrize("job", ["dist", "compiled", "pexe", "fleet",
                                 "fleet_comms", "conv_bn", "bert_small"])
def test_ranks_stay_bit_for_bit_alike(dp_results, job):
    """Every value of the two ranks' scopes (parameters, accumulators,
    batch-norm statistics) after every step."""
    a, b = dp_results[1][job]
    for sa, sb in zip(a["states"], b["states"]):
        assert sorted(sa) == sorted(sb)
        for name in sa:
            np.testing.assert_array_equal(sa[name], sb[name], err_msg=name)


def test_batch_norm_takes_the_global_batch_statistics(dp_results):
    """The moving mean and variance after each step are the JAX dp run's
    (GSPMD's global statistics), and far from what one rank's half of the
    batch would give."""
    (jfetch, init, jstates), port = (dp_results[0]["conv_bn"],
                                     dp_results[1]["conv_bn"])
    # batch_norm's w_2 and w_3: its moving mean and variance
    moving = sorted(n for n in jstates[0] if n.startswith("batch_norm")
                    and n.endswith(("w_2", "w_3")))
    assert len(moving) == 2
    for step in range(STEPS):
        _close(port[0]["fetches"][step][0], jfetch[step][0], 1e-5)
        for name in jstates[step]:
            _close(port[0]["states"][step][name], jstates[step][name], 1e-5)
    # rank 0's own half of the batch (its images unscaled) would give
    # other statistics: the JAX package's run on that half alone
    half = {k: v[:BATCH // 2] for k, v in _conv_feeds()[0].items()}
    _, _, local = _jax_run("conv_bn", [half], None)
    for name in moving:
        assert not np.allclose(port[0]["states"][0][name], local[0][name],
                               rtol=1e-2), name


@pytest.mark.parametrize("job", ["bert_small", "bert_small_comms"])
def test_bert_two_ranks_match_the_jax_single_device_run(dp_results, job):
    """BERT pretraining at 2 layers, hidden 64, from the JAX package's
    startup values: 2 ranks of batch 2 (through CompiledProgram, and
    fleet's comms mode) against the JAX package's plain Executor on the
    batch of 4, losses and parameters within 1e-4."""
    (jfetch, _, jstates), port = (dp_results[0]["bert_small"],
                                  dp_results[1][job])
    for step in range(STEPS):
        _close(port[0]["fetches"][step][0], jfetch[step][0], 1e-4)
        for name, want in jstates[step].items():
            if name in port[0]["states"][step]:
                _close(port[0]["states"][step][name], want, 1e-4)


def test_conv_bn_comms_mode_keeps_each_ranks_statistics(dp_results):
    """In the comms mode each rank takes its own batch statistics, as
    the JAX package's GradSyncProgram takes each shard's: rank r's
    moving mean and variance are row r of the JAX package's stacked
    state, its parameters the (alike) rows, losses the mean over ranks,
    all within 1e-5."""
    (jfetch, _, jstates), port = (dp_results[0]["conv_bn_comms"],
                                  dp_results[1]["conv_bn_comms"])
    for step in range(STEPS):
        _close(port[0]["fetches"][step][0], jfetch[step][0], 1e-5)
        for rank in range(2):
            got = port[rank]["states"][step]
            for name, want in jstates[step].items():
                if name in got and want.shape == (2,) + got[name].shape:
                    _close(got[name], want[rank], 1e-5)
    moving = [n for n in jstates[0] if n.startswith("batch_norm")
              and n.endswith(("w_2", "w_3"))]
    assert len(moving) == 2
    for name in moving:
        assert not np.allclose(port[0]["states"][0][name],
                               port[1]["states"][0][name])


def test_skip_gate_decides_alike_on_every_rank(dp_results):
    """Dynamic loss scaling: an inf in rank 1's half of step 1's batch
    reaches both ranks through the averaged gradients, so both skip the
    update (the parameters stay as step 0 left them) and halve the
    scale; the ranks stay bit for bit alike."""
    a, b = dp_results[1]["amp_skip"]
    for run in (a, b):
        before, bad, after = run["states"]
        scale = [n for n in bad if "loss_scaling" in n]
        assert scale
        params = [n for n in bad if n.startswith("fc_")]
        assert params
        for n in params:
            np.testing.assert_array_equal(bad[n], before[n])
            assert not np.array_equal(after[n], bad[n])
        for n in scale:
            np.testing.assert_array_equal(bad[n], before[n] * 0.5)
        assert not np.isfinite(run["fetches"][1][0])
    for sa, sb in zip(a["states"], b["states"]):
        for n in sa:
            np.testing.assert_array_equal(sa[n], sb[n], err_msg=n)


def test_dropout_masks_differ_between_ranks(dp_results):
    """The dropout over the batch draws each rank's own mask (the gathered
    halves differ; each keeps about half), the static-shape uniform draw
    is alike on both ranks, and both advance from step to step."""
    a, b = dp_results[1]["draws"]
    d0 = a["fetches"][0][0]
    assert d0.shape == (4, 64)
    np.testing.assert_array_equal(d0, b["fetches"][0][0])   # the global value
    assert not np.array_equal(d0[:2], d0[2:])
    assert 0.35 < (d0 == 0).mean() < 0.65
    assert set(np.unique(d0)) <= {0.0, 2.0}
    for step in range(2):
        np.testing.assert_array_equal(a["fetches"][step][1],
                                      b["fetches"][step][1])
    assert not np.array_equal(a["fetches"][0][1], a["fetches"][1][1])
    assert not np.array_equal(d0, a["fetches"][1][0])


def test_fetch_rule_gathers_batch_major_and_averages_scalars(dp_results):
    """The MLP's logits come back as the global batch of 8 in rank order
    (rank 0's rows first), the loss as the mean over ranks, on both
    ranks alike."""
    a, b = dp_results[1]["dist"]
    for step in range(STEPS):
        for x, y in zip(a["fetches"][step], b["fetches"][step]):
            np.testing.assert_array_equal(x, y)
    jfetch = dp_results[0]["mlp"][0]
    _close(a["fetches"][0][1][:BATCH // 2], jfetch[0][1][:BATCH // 2], 1e-5)


# ---------------------------------------------------------------------------
# the group, the refusals and the lifted refusals
# ---------------------------------------------------------------------------
def test_world_of_one_without_a_group_is_the_plain_run():
    """No torch.distributed world: the default group is one rank with no
    process group, and every entry point gives the plain run's bits."""
    from paddle_tpu_torch.parallel import fleet
    from paddle_tpu_torch.parallel.mesh import (build_mesh, dp_size,
                                                get_default_mesh)

    mesh = build_mesh()
    assert mesh.size == 1 and mesh.group is None and dp_size(mesh) == 1
    assert get_default_mesh().size == 1
    feeds = _mlp_feeds()

    def run(entry):
        tr.fresh_port_state()
        fl = fleet.Fleet().init()
        mini = tr.plain_minimize
        if entry == "fleet":
            def mini(opt, loss):
                fl.distributed_optimizer(opt).minimize(loss)
        main = fluid.default_main_program()
        loss, extra = tr.mlp(fluid, mini)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        prog = {"plain": main, "fleet": fl.main_program,
                "compiled": fluid.CompiledProgram(main).with_data_parallel(
                    loss_name=loss.name)}[entry]
        return [exe.run(prog, feed=f, fetch_list=[loss] + extra)
                for f in feeds]

    want = run("plain")
    for entry in ("fleet", "compiled"):
        for g, w in zip(run(entry), want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_group_construction_refusals(monkeypatch):
    from paddle_tpu_torch.parallel import mesh

    with pytest.raises(ValueError, match="multiply"):
        mesh.build_mesh({"dp": 1, "tp": 2})
    # the pp and ep axes are axes like the others: a one-rank world has
    # no room for 2 ranks on them
    with pytest.raises(ValueError, match="multiply"):
        mesh.build_mesh({"dp": 1, "pp": 2})
    with pytest.raises(ValueError, match="multiply"):
        mesh.build_mesh({"ep": 2})
    one = mesh.build_mesh({"dp": 1, "tp": 1, "sp": 1, "pp": 1, "ep": 1})
    assert one.shape == {"dp": 1, "tp": 1, "sp": 1, "pp": 1, "ep": 1}
    assert one.coords() == {"dp": 0, "tp": 0, "sp": 0, "pp": 0, "ep": 0}
    assert one.axis_group("tp").size == 1
    with pytest.raises(NotImplementedError, match="pure-dp"):
        mesh.shrink_mesh(mesh.RankGroup([0, 1], 0, None, "gloo", "cpu",
                                        {"dp": 1, "tp": 2}), dead=[1])
    with pytest.raises(ValueError, match="multiply"):
        mesh.build_mesh({"dp": 2})
    with pytest.raises(ValueError, match="nccl backend needs a card"):
        mesh.init_group(rank=0, world_size=1, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="outside"):
        mesh.init_group(rank=2, world_size=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        mesh.init_group(rank=0, world_size=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fluid.Executor()
    assert mesh.require_dp_axis(mesh.RankGroup([0, 1], 0, None, "gloo",
                                               "cpu")) == 2
    with pytest.raises(ValueError, match="dp mesh axis"):
        mesh.require_dp_axis(mesh.build_mesh())


def test_nccl_ranks_sharing_a_card_raise(monkeypatch):
    from paddle_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="no card of its own"):
        mesh.init_group(rank=1, world_size=2, backend="nccl")


def test_factorizations_is_the_jax_packages():
    from paddle_tpu.parallel.mesh import factorizations as jf
    from paddle_tpu_torch.parallel.mesh import factorizations

    for n in (1, 2, 6, 8, 12):
        assert factorizations(n) == jf(n)
        assert factorizations(n, ("dp", "tp")) == jf(n, ("dp", "tp"))


def test_fleet_refusals_name_their_items():
    from paddle_tpu_torch.parallel import fleet

    def build(**kw):
        tr.fresh_port_state()
        fl = fleet.Fleet().init()
        s = fleet.DistributedStrategy()
        for k, v in kw.items():
            setattr(s, k, v)
        x = fluid.data("x", [None, 4], dtype="float32")
        loss = fluid.layers.reduce_mean(fluid.layers.fc(x, 2))
        fl.distributed_optimizer(fluid.optimizer.SGD(0.1), s).minimize(loss)
        return fl

    # a one-rank world has no room for tp = 2, as the JAX package's mesh
    # of one device has none
    with pytest.raises(ValueError, match="multiply"):
        build(tensor_parallel_degree=2)
    # LocalSGD needs a dp axis of more than one rank, as in the JAX
    # package
    with pytest.raises(ValueError, match="dp mesh axis of size > 1"):
        build(use_local_sgd=True)
    with pytest.raises(NotImplementedError, match="use_dgc"):
        build(use_dgc=True)
    with pytest.raises(NotImplementedError, match="pipeline"):
        build(pipeline_parallel_degree=2)
    with pytest.raises(NotImplementedError, match="pick one"):
        build(use_local_sgd=True, sharding_degree=2)
    with pytest.raises(ValueError, match="dp mesh axis of size > 1"):
        build(grad_sync_mode="comms")
    with pytest.warns(UserWarning, match="no effect"):
        build(sharding_degree=2)
    from paddle_tpu_torch.parallel.sharding import (DistributedProgram,
                                                    ShardingRule)
    from paddle_tpu_torch.parallel.mesh import build_mesh

    # a tp rule on a mesh of one tp rank keeps the parameter whole: the
    # program runs as the plain one
    build()
    main = fluid.default_main_program()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    w = [p.name for p in main.all_parameters() if p.name.endswith(".w_0")]
    dp = DistributedProgram(main, build_mesh({"dp": 1, "tp": 1}),
                            param_rules=[ShardingRule(w[0], (None, "tp"))],
                            opt_state_rules=[ShardingRule(".*", ("dp",))])
    assert dp.param_sharding(w[0], (4, 2)) == (None, "tp")
    feed = {"x": np.ones((3, 4), "float32")}
    got = exe.run(dp, feed=feed, fetch_list=[main.global_block().ops[-1]
                                               .output_arg_names[0]])
    assert np.isfinite(got[0]).all()


def test_strategy_from_plan_is_the_jax_packages():
    from paddle_tpu.parallel.fleet import DistributedStrategy as JS
    from paddle_tpu_torch.parallel.fleet import DistributedStrategy as PS

    plan = {"mesh": {"dp": 4, "tp": 2}, "grad_sync_mode": "comms",
            "grad_quantize": True, "grad_bucket_bytes": 1 << 20}
    assert vars(PS.from_plan(plan)) == vars(JS.from_plan(plan))
    assert vars(PS()) == vars(JS())
    with pytest.raises(NotImplementedError, match="pp"):
        PS.from_plan({"mesh": {"dp": 2, "pp": 2}})


def test_trainer_parallel_builds_a_compiled_program():
    """Trainer(parallel=True) trains through
    CompiledProgram.with_data_parallel: on a world of one rank, the
    losses of the plain Trainer."""
    def train_func():
        x = fluid.data("tx", [None, 4], dtype="float32")
        y = fluid.data("ty", [None, 1], dtype="float32")
        p = fluid.layers.fc(x, 1, param_attr=fluid.ParamAttr(
            name="tw", initializer=fluid.initializer.Constant(0.1)))
        return fluid.layers.reduce_mean(fluid.layers.square_error_cost(p, y))

    rng = np.random.default_rng(0)
    data = [(rng.standard_normal(4).astype("float32"),
             rng.standard_normal(1).astype("float32")) for _ in range(8)]

    def losses(parallel):
        seen = []
        t = fluid.contrib.Trainer(train_func, lambda: fluid.optimizer.SGD(0.1),
                                  place=fluid.CPUPlace(), parallel=parallel)
        if parallel:
            assert isinstance(t._run_program, fluid.CompiledProgram)

        def handler(ev):
            if isinstance(ev, fluid.contrib.EndStepEvent):
                seen.append(float(np.asarray(ev.metrics[0])))

        t.train(1, handler, reader=lambda: iter([data[:4], data[4:]]),
                feed_order=["tx", "ty"])
        return seen

    assert losses(True) == losses(False)


def test_graph_wrapper_compile_for_parallel():
    g = fluid.contrib.slim.GraphWrapper(fluid.default_main_program())
    compiled = g.compile()
    assert isinstance(compiled, fluid.CompiledProgram)
    assert compiled._program is g.program
