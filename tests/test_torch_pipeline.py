"""Pipeline parallelism in the port (paddle_tpu_torch/parallel/pipeline.py,
fluid/pipeline_executor.py, ``fluid.optimizer.PipelineOptimizer``)
against the JAX package, on the CPU.

Ranks are gloo processes on a FileStore (tests/torch_ranks.py), one a
stage: one spawn of 2 ranks and one of 4 for the whole file, jobs in
tests/torch_pipeline_ranks.py. The JAX side runs here, on the 8 virtual
devices tests/conftest.py sets up; its startup values are copied into
the port's scope (``fluid.io.params_from_numpy``).

- test_round2_fixes.py::TestPipelineFluid's MLP at pp = 2, 4
  microbatches, 4 SGD steps, against the JAX package's PipelineOptimizer
  and against sequential training (the JAX package's and the port's);
- examples/composed_parallelism.py's model at dp 2 x pp 2 with ZeRO-1
  Adam moments on 4 ranks, against the JAX package's composed run;
- ``gpipe_sharded`` at pp = 4 (test_distributed.py's four tanh stages)
  and ``gpipe_composed`` at dp 2 x pp 2: outputs and gradients against
  sequential application, and 4 SGD steps of ``gpipe_composed`` against
  the JAX package's;
- every refusal of the JAX package's pipeline executor, with its words;
- BERT pretraining at 2 layers, width 64, cut after layer 0 (both stages
  run attention and LayerNorm: their plain versions, on the CPU),
  against the JAX package's single-device run;
- per-microbatch dropout masks, and the bytes the ring moves.

Losses within 1e-6 relative, parameters within 1e-5 of their max.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import executor as jexecutor
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique_name
from paddle_tpu.models import bert as jbert
from paddle_tpu.parallel.mesh import build_mesh as jbuild_mesh
from paddle_tpu.parallel.sharding import ShardingRule as JaxRule
import torch_pipeline_ranks as tpr
import torch_ranks as tr

LOSS_TOL = 1e-6
PARAM_TOL = 1e-5
BERT_STEPS = 3


def _close(got, want, tol):
    np.testing.assert_allclose(
        got, want, rtol=tol, atol=tol * max(float(np.abs(want).max()), 1.0))


def _params_close(got, want, tol=PARAM_TOL):
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        np.testing.assert_allclose(
            g, w, rtol=0, atol=tol * max(float(np.abs(w).max()), 1e-30),
            err_msg=name)


def _jax_run(model, feeds, pipeline, mesh=None, dp_feeds=(), zero=False):
    """The JAX package's run of `model`: through its PipelineOptimizer
    (over `mesh`, {axis: size}, on the first devices) or plain. Returns
    (losses, startup values, the parameters after every step)."""
    main, start = jframework.Program(), jframework.Program()
    main.random_seed = start.random_seed = 5
    jmesh = None
    if mesh:
        jmesh = jbuild_mesh(mesh, devices=jax.devices()[
            :int(np.prod(list(mesh.values())))])

    def make_opt(opt, cuts):
        if not pipeline:
            return opt
        return jfluid.optimizer.PipelineOptimizer(
            opt, cut_list=cuts, num_microbatches=4, mesh=jmesh,
            feed_specs={k: JP("dp", None) for k in dp_feeds} or None,
            opt_state_rules=([JaxRule(r"moment", JP("dp"))] if zero
                             else None))

    with jfluid.program_guard(main, start), junique_name.guard():
        loss = tpr.PP_MODELS[model](jfluid, make_opt)
    scope = jexecutor.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(start, scope=scope)
    init = {n: np.asarray(scope[n]) for n in scope.keys()}
    losses, states = [], []
    for feed in feeds:
        losses.append(float(np.asarray(exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope)[0])))
        states.append({p.name: np.asarray(scope[p.name])
                       for p in main.all_parameters()})
    return losses, init, states


def _bert_feeds():
    cfg = tr.bert_config(jbert)
    return [dict(zip(("input_ids", "mlm_labels"), jbert.synthetic_batch(
        cfg, 8, tr.BERT_SEQ, seed=s))) for s in range(BERT_STEPS)]


def _stacked(n, d, bias, seed):
    rng = np.random.default_rng(seed)
    ws = np.stack([rng.standard_normal((d, d)).astype("float32") * 0.3
                   for _ in range(n)])
    bs = ((rng.standard_normal((n, d)) * 0.1).astype("float32")
          if bias else None)
    return ws, bs, rng


def _sequential(ws, bs, x):
    """Sequential stage application and its vjp, in jax."""
    def f(w, b, h):
        for s in range(ws.shape[0]):
            h = jnp.tanh(h @ w[s] + (0.0 if b is None else b[s]))
        return h
    return f


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    """The JAX references and the port's runs: one spawn of 2 ranks (the
    MLP, BERT, the refusals) and one of 4 (dp x pp, the gpipe entries)."""
    mlp_feeds = [tpr.mlp_feed()] * tpr.MLP_STEPS
    comp_feeds = [tpr.composed_feed()] * 5
    jax_ref = {
        "mlp_pp": _jax_run("mlp", mlp_feeds, True),
        "mlp_seq": _jax_run("mlp", mlp_feeds, False),
        "bert_seq": _jax_run("bert", _bert_feeds(), False),
        "comp_pp": _jax_run("composed", comp_feeds, True,
                            mesh={"dp": 2, "pp": 2}, dp_feeds=("px", "py"),
                            zero=True),
        "comp_seq": _jax_run("composed", comp_feeds, False),
    }
    init = {k: v[1] for k, v in jax_ref.items()}
    two = [
        dict(fn="pp_run", model="mlp", feeds=mlp_feeds,
             params=init["mlp_pp"]),
        dict(fn="pp_run", model="mlp", feeds=mlp_feeds,
             params=init["mlp_pp"], pipeline=False),
        dict(fn="pp_run", model="bert", feeds=_bert_feeds(),
             params=init["bert_seq"]),
        dict(fn="pp_refusals"),
        dict(fn="pp_dropout"),
        dict(fn="pp_run", model="mlp", feeds=mlp_feeds,
             params=init["mlp_pp"], mesh={"pp": 2}, p2p=True),
    ]
    ws, _, rng = _stacked(4, 8, False, 5)
    x = rng.standard_normal((16, 8)).astype("float32")
    cw, cb, crng = _stacked(2, 16, True, 0)
    cx = crng.standard_normal((8, 16)).astype("float32")
    dout = np.random.default_rng(7).standard_normal((16, 8)).astype(
        "float32")
    cdout = np.random.default_rng(8).standard_normal((8, 16)).astype(
        "float32")
    ctgt = (np.tanh(cx) * 0.5).astype("float32")
    four = [
        dict(fn="pp_run", model="composed", feeds=comp_feeds,
             params=init["comp_pp"], mesh={"dp": 2, "pp": 2},
             dp_feeds=("px", "py"), zero=True),
        dict(fn="gpipe_run", ws=ws, bs=None, x=x, dout=dout,
             axes={"pp": 4}, n_micro=4, entry="gpipe_sharded"),
        dict(fn="gpipe_run", ws=cw, bs=cb, x=cx, dout=cdout,
             axes={"dp": 2, "pp": 2}, n_micro=4, entry="gpipe_composed"),
        dict(fn="gpipe_train", ws=cw, bs=cb, x=cx, tgt=ctgt,
             axes={"dp": 2, "pp": 2}, steps=4, lr=0.2),
        dict(fn="gpipe_run", ws=ws, bs=None, x=x, dout=dout,
             axes={"pp": 4}, n_micro=4, entry="gpipe_sharded", p2p=True),
        dict(fn="gpipe_run", ws=ws, bs=None, x=x, dout=dout,
             axes={"pp": 4}, n_micro=4, entry="gpipe"),
    ]
    got2 = tr.run_ranks(tpr.pipeline_jobs, 2, tmp_path_factory.mktemp(
        "pp2"), args=(two,), timeout=240)
    got4 = tr.run_ranks(tpr.pipeline_jobs, 4, tmp_path_factory.mktemp(
        "pp4"), args=(four,), timeout=240)
    names2 = ["mlp_pp", "mlp_seq", "bert_pp", "refusals", "dropout",
              "mlp_p2p"]
    names4 = ["comp_pp", "gpipe_sharded", "gpipe_composed", "composed_train",
              "gpipe_p2p", "gpipe"]
    port = {n: [g[i] for g in got2] for i, n in enumerate(names2)}
    port.update({n: [g[i] for g in got4] for i, n in enumerate(names4)})
    inputs = dict(ws=ws, x=x, dout=dout, cw=cw, cb=cb, cx=cx, cdout=cdout,
                  ctgt=ctgt)
    return jax_ref, port, inputs


def test_mlp_two_stages_match_the_jax_pipeline(pp_runs):
    """Losses and every parameter after every step, on both ranks,
    against the JAX package's PipelineOptimizer over 2 devices."""
    jax_ref, port, _ = pp_runs
    jlosses, _, jstates = jax_ref["mlp_pp"]
    for run in port["mlp_pp"]:
        _close(run["losses"], jlosses, LOSS_TOL)
        for step in range(tpr.MLP_STEPS):
            _params_close(run["states"][step], jstates[step])


def test_mlp_two_stages_match_sequential_training(pp_runs):
    """The same against sequential training: the JAX package's plain run
    and the port's; and the loss falls."""
    jax_ref, port, _ = pp_runs
    jlosses, _, jstates = jax_ref["mlp_seq"]
    seq = port["mlp_seq"][0]
    for run in port["mlp_pp"]:
        _close(run["losses"], jlosses, LOSS_TOL)
        _close(run["losses"], seq["losses"], LOSS_TOL)
        for step in range(tpr.MLP_STEPS):
            _params_close(run["states"][step], jstates[step])
            _params_close(run["states"][step], seq["states"][step])
        assert run["losses"][-1] < run["losses"][0]


def test_stages_end_each_step_with_the_same_parameters(pp_runs):
    """Every rank's scope, after every step, bit for bit: the gradients
    summed over the pp line and the updates run on every rank."""
    _, port, _ = pp_runs
    for job in ("mlp_pp", "bert_pp", "comp_pp"):
        first = port[job][0]["states"]
        for run in port[job][1:]:
            for a, b in zip(first, run["states"]):
                assert sorted(a) == sorted(b)
                for name in a:
                    np.testing.assert_array_equal(a[name], b[name],
                                                  err_msg=(job, name))


def test_the_ring_moves_only_the_boundary_activation(pp_runs):
    """Stage 0 hands on the cut var (2 rows x 32 floats a microbatch)
    and stage 1 hands back its gradient: 4 x 256 bytes each way."""
    _, port, _ = pp_runs
    for rank in range(2):
        ring = port["mlp_pp"][rank]["ring"]
        assert ring["stage"] == rank and ring["microbatches"] == 4
        assert ring["ring_bytes"] == 4 * 2 * 32 * 4


def test_the_point_to_point_route_moves_the_same_bits(pp_runs):
    """The route nccl takes (batch_isend_irecv between neighbours, run by
    gloo on the CPU) gives the all-gather route's results bit for bit:
    the MLP's losses and state at pp = 2, gpipe_sharded's output and
    gradients at pp = 4."""
    _, port, _ = pp_runs
    for a, b in zip(port["mlp_p2p"], port["mlp_pp"]):
        assert a["losses"] == b["losses"]
        for sa, sb in zip(a["states"], b["states"]):
            for name in sb:
                np.testing.assert_array_equal(sa[name], sb[name])
        assert a["ring"]["ring_bytes"] == b["ring"]["ring_bytes"]
    for a, b in zip(port["gpipe_p2p"], port["gpipe_sharded"]):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_composed_dp2_pp2_zero_matches_the_jax_run(pp_runs):
    """examples/composed_parallelism.py's dp x pp model at dp 2 x pp 2,
    the batch split over dp, Adam moments split over dp (ZeRO-1): every
    rank's losses and parameters against the JAX package's composed run
    over 4 devices and its sequential run; each rank holds half of every
    moment whose leading dim 2 divides."""
    jax_ref, port, _ = pp_runs
    jlosses, _, jstates = jax_ref["comp_pp"]
    slosses = jax_ref["comp_seq"][0]
    for run in port["comp_pp"]:
        _close(run["losses"], jlosses, LOSS_TOL)
        _close(run["losses"], slosses, LOSS_TOL)
        for step in range(5):
            _params_close(run["states"][step], jstates[step])
        assert run["losses"][-1] < run["losses"][0]
        moments = [n for n in run["local_shapes"] if "moment" in n]
        assert len(moments) == 8
        for n in moments:
            whole = run["states"][-1][n].shape
            # a dim that 2 does not divide stays whole, as in the JAX
            # package (the (1,) bias of stage2)
            want = (whole if whole[0] % 2 else
                    (whole[0] // 2,) + whole[1:])
            assert run["local_shapes"][n] == want, n


def test_gpipe_sharded_matches_sequential(pp_runs):
    """test_distributed.py's four tanh stages at pp = 4, 4 microbatches:
    the output, and the gradients of sum(out * dout) w.r.t. the stacked
    weights and the input, on every rank, against sequential
    application (jax.vjp)."""
    _, port, inp = pp_runs
    f = _sequential(inp["ws"], None, inp["x"])
    want, vjp = jax.vjp(lambda w, h: f(w, None, h), jnp.asarray(inp["ws"]),
                        jnp.asarray(inp["x"]))
    dw, dx = vjp(jnp.asarray(inp["dout"]))
    for got in port["gpipe_sharded"]:
        _close(got["out"], np.asarray(want), LOSS_TOL)
        _close(got["dw"], np.asarray(dw), PARAM_TOL)
        _close(got["dx"], np.asarray(dx), PARAM_TOL)


def test_gpipe_runs_this_ranks_stage(pp_runs):
    """gpipe on each rank's own stage weights and the microbatches: the
    outputs whole on every rank, each rank's weights their own stage's
    gradient, the input the whole pipeline's, against sequential
    application."""
    _, port, inp = pp_runs
    f = _sequential(inp["ws"], None, inp["x"])
    want, vjp = jax.vjp(lambda w, h: f(w, None, h), jnp.asarray(inp["ws"]),
                        jnp.asarray(inp["x"]))
    dw, dx = vjp(jnp.asarray(inp["dout"]))
    for rank, got in enumerate(port["gpipe"]):
        _close(got["out"], np.asarray(want), LOSS_TOL)
        _close(got["dw"], np.asarray(dw)[rank], PARAM_TOL)
        _close(got["dx"], np.asarray(dx), PARAM_TOL)


def test_gpipe_composed_dp2_pp2_matches_sequential(pp_runs):
    """gpipe_composed at dp 2 x pp 2 (each dp line on half the batch):
    the output gathered whole and the gradients summed over dp, against
    sequential application."""
    _, port, inp = pp_runs
    f = _sequential(inp["cw"], inp["cb"], inp["cx"])
    want, vjp = jax.vjp(f, jnp.asarray(inp["cw"]), jnp.asarray(inp["cb"]),
                        jnp.asarray(inp["cx"]))
    dw, db, dx = vjp(jnp.asarray(inp["cdout"]))
    for got in port["gpipe_composed"]:
        _close(got["out"], np.asarray(want), LOSS_TOL)
        _close(got["dw"], np.asarray(dw), PARAM_TOL)
        _close(got["db"], np.asarray(db), PARAM_TOL)
        _close(got["dx"], np.asarray(dx), PARAM_TOL)


def test_gpipe_composed_trains_like_the_jax_package(pp_runs):
    """4 SGD(0.2) steps of mean((out - tgt)^2) through gpipe_composed at
    dp 2 x pp 2, against the JAX package's gpipe_composed on a dp 2 x
    pp 2 mesh of 4 devices."""
    from paddle_tpu.parallel.pipeline import gpipe_composed

    _, port, inp = pp_runs
    mesh = jbuild_mesh({"dp": 2, "pp": 2}, devices=jax.devices()[:4])
    ps = {"w": jax.device_put(inp["cw"], NamedSharding(mesh, JP("pp"))),
          "b": jax.device_put(inp["cb"], NamedSharding(mesh, JP("pp")))}
    xs = jax.device_put(inp["cx"], NamedSharding(mesh, JP("dp", None)))
    tgt = jax.device_put(inp["ctgt"], NamedSharding(mesh, JP("dp", None)))

    def loss_fn(q):
        out = gpipe_composed(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), q,
                             xs, mesh, n_microbatches=4)
        return jnp.mean((out - tgt) ** 2)

    @jax.jit
    def step(q):
        loss, g = jax.value_and_grad(loss_fn)(q)
        return loss, jax.tree_util.tree_map(lambda p, gg: p - 0.2 * gg,
                                            q, g)

    losses = []
    for _ in range(4):
        loss, ps = step(ps)
        losses.append(float(loss))
    for got in port["composed_train"]:
        _close(got["losses"], losses, LOSS_TOL)
        _params_close(got, {"w": np.asarray(ps["w"]),
                            "b": np.asarray(ps["b"])})
    assert losses[-1] < losses[0]


def test_gpipe_composed_refuses_tensor_parallelism():
    from paddle_tpu_torch.parallel.mesh import RankGroup
    from paddle_tpu_torch.parallel.pipeline import gpipe_composed

    mesh = RankGroup(range(8), 0, None, "gloo", "cpu",
                     {"dp": 2, "tp": 2, "pp": 2})
    with pytest.raises(NotImplementedError, match="tp"):
        gpipe_composed(lambda p, h: h, {"w": np.zeros((2, 4, 4))},
                       np.zeros((8, 4)), mesh)


# the JAX package's words for each refusal
REFUSALS = {
    "no_backward": "needs a backward op",
    "one_stage": r"cut_list produced 1 stage\(s\)",
    "too_few_ranks": "needs one device per stage: 3 stages",
    "mid_pipeline_fetch": "produced mid-pipeline",
    "param_rules": "gpipe_composed",
    "mesh_without_pp": "must carry a 'pp' axis",
    "pp_size": "'pp' axis has size 1 but cut_list produced 2 stages",
    "unknown_feed_spec": "match no feed",
    "indivisible_batch": "feed batch 6 not divisible by 4 microbatches",
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_pipeline_refusals_keep_the_jax_packages_words(pp_runs, case):
    import re

    _, port, _ = pp_runs
    for got in port["refusals"]:
        assert got["runs"] is None
        assert got[case] is not None and re.search(REFUSALS[case],
                                                   got[case]), got[case]


def test_bert_two_stages_match_the_jax_single_device_run(pp_runs):
    """BERT pretraining at 2 layers, hidden 64, batch 8 in 4
    microbatches, cut after layer 0, SGD(0.5) from the JAX package's
    startup values: losses and every parameter after each of 3 steps, on
    both stages, against the JAX package's plain run on the whole
    batch."""
    jax_ref, port, _ = pp_runs
    jlosses, _, jstates = jax_ref["bert_seq"]
    for run in port["bert_pp"]:
        _close(run["losses"], jlosses, LOSS_TOL)
        for step in range(BERT_STEPS):
            _params_close(run["states"][step], jstates[step])


def test_microbatches_draw_their_own_dropout_masks(pp_runs):
    """dropout(1) at rate 0.5 on the last stage, fetched as the mean over
    4 microbatches of 2 rows: one mask reused would give only 0 and 2;
    distinct masks give the values between, at a keep rate near 0.5."""
    _, port, _ = pp_runs
    for got in port["dropout"]:
        keep = got["keep"]
        assert keep.shape == (2, 32)
        assert set(np.unique(keep)) - {0.0, 2.0}, np.unique(keep)
        assert abs(float(keep.mean()) / 2.0 - 0.5) < 0.1
        np.testing.assert_array_equal(keep, port["dropout"][0]["keep"])
