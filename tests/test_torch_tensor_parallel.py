"""Tensor parallelism and ZeRO-1 in the port (paddle_tpu_torch/parallel:
the layouts of tensor_parallel.py, the rules beside the lowerings, the
tp and ZeRO paths of sharding.py and fleet.py) against the JAX package,
on the CPU.

Ranks are gloo processes on a FileStore (tests/torch_ranks.py): one spawn
of 2 ranks and one of 4 for the whole file. The JAX side runs here, on
the 8 virtual devices tests/conftest.py sets up.

- The column-parallel fc of test_distributed.py::
  test_tp_sharded_matmul_matches_replicated at tp = 2 against the JAX
  package's plain and tp DistributedProgram runs (rtol 1e-5, atol 1e-6).
- GPT-tiny (vocab 96) under dp2 x tp2 with ``gpt.tp_rules`` over 4
  ranks, 6 Adam steps, against the JAX package's unsharded and
  DistributedProgram runs (rtol 2e-4, atol 2e-5, as test_gpt.py).
- BERT-tiny (2 layers, hidden 64, 4 heads, vocab 128) at tp = 2 with
  ``bert.tp_rules``: step-1 gradients and the parameters after 5 SGD
  steps within 1e-4 of max against the JAX package's single-device run;
  with dropout 0.1, the port's tp run equals the port's one-rank run
  (the generator shared by the tp ranks and the attention's head offset
  draw the one-rank masks); the reference's fleet lane
  (``tensor_parallel_degree``, ``tensor_parallel_rules``).
- ``param_sharding`` against the JAX package's spec for every BERT and
  GPT parameter and moment, with ZeRO's merge onto the tp layout.
- ``sharding_degree=2`` on 2 ranks (BERT-tiny, Adam): each rank's
  moments hold half the rows, and the parameters equal the plain dp
  run's within 1e-6 of max.
- The vocab-parallel embedding lookup and cross-entropy against the
  whole ones; ``dropout_keep_mask`` with a head offset; fetches and
  ``save_persistables`` of split state giving global values; each
  fallback path with its counter.
"""
import numpy as np
import pytest

import jax
from jax.sharding import Mesh, PartitionSpec as JP

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import executor as jexecutor
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique_name
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.parallel.sharding import DistributedProgram as JaxDist
from paddle_tpu.parallel.sharding import ShardingRule as JaxRule
import torch_ranks as tr

BERT_STEPS = 5
GPT_STEPS = 6


def _rules(rules):
    return [(p, tuple(s)) for p, s in rules]


def _bert_feeds():
    cfg = tr.bert_tiny_config(jbert)
    return [dict(zip(("input_ids", "mlm_labels"), jbert.synthetic_batch(
        cfg, 4, tr.BERT_SEQ, seed=s))) for s in range(BERT_STEPS)]


def _gpt_feeds():
    cfg = jgpt.gpt_tiny(vocab=96, max_len=32)
    ids, labels = jgpt.synthetic_lm_batch(cfg, 16, tr.GPT_SEQ)
    return [{"gpt_ids": ids, "gpt_labels": labels}] * GPT_STEPS


def _vocab_feeds():
    rng = np.random.default_rng(4)
    lab = rng.integers(0, 32, (4, 6, 1)).astype("int64")
    lab[0, :2] = -1                          # ignored rows
    return [{"ids": rng.integers(0, 32, (4, 6)).astype("int64"),
             "lab": lab} for _ in range(3)]


def _fallback_feeds():
    rng = np.random.default_rng(6)
    return [{"fx": rng.standard_normal((4, 8)).astype("float32")}
            for _ in range(2)]


def _amp_feeds():
    """The MLP's feeds, an inf in the second step's batch: its loss-scaling
    skip gate must skip that update."""
    rng = np.random.default_rng(3)
    feeds = [{"x": rng.standard_normal((8, 16)).astype("float32"),
              "y": rng.integers(0, 4, (8, 1)).astype("int64")}
             for _ in range(3)]
    feeds[1]["x"][5, 3] = np.inf
    return feeds


def _grad_names(model):
    main, start = jframework.Program(), jframework.Program()
    with jfluid.program_guard(main, start), junique_name.guard():
        tr.MODELS[model](jfluid, tr.plain_minimize)
    return [n for op in main.global_block().ops if op.type == "backward"
            for n in op.output("Grads")]


def _jax_run(model, feeds, seed=11, mesh=None, rules=(), fetch=(),
             params=None):
    """The JAX package's run of `model`: the plain Executor, or its
    DistributedProgram over `mesh` ({axis: size}) with `rules`. Returns
    (fetches per step, startup values, scope after every step)."""
    main, start = jframework.Program(), jframework.Program()
    main.random_seed = start.random_seed = seed
    with jfluid.program_guard(main, start), junique_name.guard():
        loss, extra = tr.MODELS[model](jfluid, tr.plain_minimize)
    scope = jexecutor.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(start, scope=scope)
    for n, v in (params or {}).items():
        scope.set(n, v)
    init = {n: np.asarray(scope[n]) for n in scope.keys()}
    prog = main
    if mesh is not None:
        n = int(np.prod(list(mesh.values())))
        jmesh = Mesh(np.array(jax.devices()[:n]).reshape(
            tuple(mesh.values())), tuple(mesh))
        prog = JaxDist(main, jmesh, feed_axis="dp" if "dp" in mesh else None,
                       param_rules=[JaxRule(p, JP(*s)) for p, s in rules])
    fetch_list = ([loss] if loss is not None else []) + extra + list(fetch)
    fetches, states = [], []
    for feed in feeds:
        fetches.append([np.asarray(v) for v in exe.run(
            prog, feed=feed, fetch_list=fetch_list, scope=scope)])
        states.append({n: np.asarray(scope[n]) for n in scope.keys()})
    return fetches, init, states


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and the port's runs: one spawn of 2 ranks and
    one of 4."""
    from paddle_tpu_torch.models import bert, gpt

    brules = _rules(bert.tp_rules())
    grules = _rules(gpt.tp_rules())
    bfeeds = _bert_feeds()
    bgrads = _grad_names("bert_tiny")
    jax_ref = {
        "tp_fc": _jax_run("tp_fc", [{"x": np.random.default_rng(0)
                                     .standard_normal((4, 16))
                                     .astype("float32")}]),
        "bert": _jax_run("bert_tiny", bfeeds, fetch=bgrads),
    }
    x = [{"x": np.random.default_rng(0).standard_normal((4, 16))
          .astype("float32")}]
    jax_ref["tp_fc_dist"] = _jax_run("tp_fc", x, mesh={"tp": 8},
                                     rules=[("wt", (None, "tp"))])
    binit = jax_ref["bert"][1]
    save = tmp_path_factory.mktemp("saved")
    jobs = {
        "tp_fc": dict(model="tp_fc", feeds=x, mesh={"tp": 2},
                      rules=[("wt", (None, "tp"))]),
        "bert_tp": dict(model="bert_tiny", feeds=bfeeds, params=binit,
                        mesh={"dp": 1, "tp": 2}, rules=brules, fetch=bgrads,
                        save_dir=str(save)),
        "bert_fleet": dict(model="bert_tiny", feeds=bfeeds[:2], params=binit,
                           strategy={"tensor_parallel_degree": 2,
                                     "tensor_parallel_rules": brules}),
        "drop_plain": dict(model="bert_tiny_drop", feeds=bfeeds[:3]),
        "drop_tp": dict(model="bert_tiny_drop", feeds=bfeeds[:3],
                        mesh={"dp": 1, "tp": 2}, rules=brules),
        "adam_dp": dict(model="bert_tiny_adam", feeds=bfeeds[:3],
                        strategy={}),
        "adam_zero": dict(model="bert_tiny_adam", feeds=bfeeds[:3],
                          strategy={"sharding_degree": 2}),
        "vocab_plain": dict(model="vocab_ce", feeds=_vocab_feeds()),
        "vocab_tp": dict(model="vocab_ce", feeds=_vocab_feeds(),
                         mesh={"tp": 2}, rules=[("vemb", ("tp", None))]),
        "resume": dict(fn="tp_resume", feeds=bfeeds[:3], rules=brules,
                       save_dir=str(tmp_path_factory.mktemp("resume"))),
        "amp_plain": dict(model="mlp_amp", feeds=_amp_feeds()),
        "amp_tp": dict(model="mlp_amp", feeds=_amp_feeds(), mesh={"tp": 2},
                       rules=[("fc_0.w_0", (None, "tp")),
                              ("fc_1.w_0", ("tp", None))]),
        "fb_plain": dict(model="fallbacks", feeds=_fallback_feeds()),
        "fb_tp": dict(model="fallbacks", feeds=_fallback_feeds(),
                      mesh={"tp": 2}, rules=[("col.w", (None, "tp")),
                                             ("row.w", ("tp", None))]),
    }
    names = list(jobs)
    got = tr.run_ranks(tr.layout_jobs, 2, tmp_path_factory.mktemp("tp2"),
                       args=([jobs[n] for n in names],), timeout=240)
    port = {n: [got[r][i] for r in range(2)] for i, n in enumerate(names)}

    gfeeds = _gpt_feeds()
    jax_ref["gpt"] = _jax_run("gpt_lm", gfeeds, seed=9)
    jax_ref["gpt_dist"] = _jax_run("gpt_lm", gfeeds, seed=9,
                                   mesh={"dp": 4, "tp": 2}, rules=grules)
    gjobs = [dict(model="gpt_lm", feeds=gfeeds, params=jax_ref["gpt"][1],
                  mesh={"dp": 2, "tp": 2}, rules=grules, seed=9)]
    got4 = tr.run_ranks(tr.layout_jobs, 4, tmp_path_factory.mktemp("tp4"),
                        args=(gjobs,), timeout=240)
    port["gpt"] = [g[0] for g in got4]
    return jax_ref, port


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()), 1.0))


def _close_max(got, want, tol):
    """Within `tol` of the value's own max |.|."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()) + 1e-12)


def test_tp_fc_matches_the_jax_runs(runs):
    jax_ref, port = runs
    for rank in port["tp_fc"]:
        out = rank["fetches"][0][0]
        np.testing.assert_allclose(out, jax_ref["tp_fc"][0][0][0],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out, jax_ref["tp_fc_dist"][0][0][0],
                                   rtol=1e-5, atol=1e-6)
        # each rank holds the half of the weight's columns
        assert rank["local_shapes"]["wt"] == (16, 16)


def test_gpt_dp2_tp2_matches_the_jax_runs(runs):
    """test_gpt.py::test_gpt_trains_sharded_dp_tp on the port over 4
    ranks: losses fall and match the JAX package's unsharded and
    DistributedProgram runs over 6 Adam steps."""
    jax_ref, port = runs
    plain = [float(f[0]) for f in jax_ref["gpt"][0]]
    dist = [float(f[0]) for f in jax_ref["gpt_dist"][0]]
    for rank in port["gpt"]:
        shard = [float(f[0]) for f in rank["fetches"]]
        assert shard[-1] < shard[0]
        np.testing.assert_allclose(shard, plain, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(shard, dist, rtol=2e-4, atol=2e-5)
    # the tp ranks of one dp row hold different column halves
    q = "gpt0.self.q.w"
    assert port["gpt"][0]["local_shapes"][q] == (32, 16)
    assert port["gpt"][0]["local_shapes"]["gpt_out.w"] == (32, 48)


def test_bert_tp2_gradients_and_parameters_match_the_jax_run(runs):
    jax_ref, port = runs
    jfetch, _, jstates = jax_ref["bert"]
    grads = _grad_names("bert_tiny")
    for rank in port["bert_tp"]:
        got = rank["fetches"][0]
        for i, name in enumerate(grads):
            _close_max(got[1 + i], jfetch[0][1 + i], 1e-4)
        for step in range(BERT_STEPS):
            np.testing.assert_allclose(rank["fetches"][step][0],
                                       jfetch[step][0], rtol=1e-4)
        for name, want in jstates[-1].items():
            _close_max(rank["states"][-1][name], want, 1e-4)
    # the rules split what they name: qkv and ffn1 by columns, attnout
    # and ffn2 by rows, the word embedding by vocabulary rows
    local = port["bert_tp"][0]["local_shapes"]
    assert local["enc_l0_qkv.w"] == (64, 96)
    assert local["enc_l0_qkv.b"] == (96,)
    assert local["enc_l1_attnout.w"] == (32, 64)
    assert local["enc_l0_ffn2.w"] == (64, 64)
    assert local["word_emb"] == (64, 64)
    assert local["emb_ln.w"] == (64,)


def test_bert_through_fleets_tp_lane(runs):
    """bench.py's lane: fleet.distributed_optimizer with
    tensor_parallel_degree and bert.tp_rules(): the tp DistributedProgram's
    losses and parameters."""
    _, port = runs
    for rank in port["bert_fleet"]:
        for step in range(2):
            np.testing.assert_array_equal(rank["fetches"][step][0],
                                          port["bert_tp"][0]
                                          ["fetches"][step][0])
        assert rank["local_shapes"]["enc_l0_qkv.w"] == (64, 96)


def test_tp_dropout_draws_the_one_rank_masks(runs):
    """With dropout 0.1 (the attention's flash dropout and the layers'),
    the tp run's losses and parameters are the one-rank run's: every
    draw comes from the generator the tp ranks share, a split value's
    mask is the whole mask's block, and the attention hashes its global
    heads."""
    _, port = runs
    plain = port["drop_plain"][0]
    for rank in port["drop_tp"]:
        for step in range(3):
            np.testing.assert_allclose(rank["fetches"][step][0],
                                       plain["fetches"][step][0], rtol=1e-5)
        for name, want in plain["states"][-1].items():
            _close_max(rank["states"][-1][name], want, 1e-4)


def test_zero1_halves_the_moments_and_matches_plain_dp(runs):
    """sharding_degree=2 on 2 ranks: each rank holds half the rows of
    every moment that divides (the beta powers stay whole), and the
    parameters equal the plain dp run's within 1e-6 of max."""
    _, port = runs
    for r in range(2):
        zero, plain = port["adam_zero"][r], port["adam_dp"][r]
        for step in range(3):
            np.testing.assert_allclose(zero["fetches"][step][0],
                                       plain["fetches"][step][0],
                                       rtol=1e-6)
        halved = 0
        for name, shape in plain["local_shapes"].items():
            if "moment" in name:
                got = zero["local_shapes"][name]
                assert got[0] * 2 == shape[0], (name, got, shape)
                halved += 1
            elif "pow_acc" in name:
                assert zero["local_shapes"][name] == shape
        assert halved >= 20
        for name, want in plain["states"][-1].items():
            _close_max(zero["states"][-1][name], want, 1e-6)


def test_param_sharding_is_the_jax_packages():
    """Every BERT and GPT parameter and moment: the port's spec is the JAX
    package's, with and without ZeRO, on dp2 x tp4 and tp8 meshes; ZeRO's
    moments of a tp-split weight gain dp on a free dim (test_distributed.
    py::test_zero_merges_with_tp_layout)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import bert, gpt
    from paddle_tpu_torch.parallel.mesh import P, RankGroup
    from paddle_tpu_torch.parallel.sharding import (DistributedProgram,
                                                    ShardingRule)

    for build, rules in ((lambda f: tr.MODELS["bert_tiny_adam"](
            f, tr.plain_minimize), bert.tp_rules()),
            (lambda f: tr.MODELS["gpt_lm"](f, tr.plain_minimize),
             gpt.tp_rules())):
        progs = []
        for f, fw, un in ((fluid, fluid.framework, fluid.unique_name),
                          (jfluid, jframework, junique_name)):
            main, start = fw.Program(), fw.Program()
            with f.program_guard(main, start), un.guard():
                build(f)
            progs.append(main)
        for axes in ({"dp": 2, "tp": 4}, {"tp": 8}):
            pmesh = RankGroup(range(8), 0, None, "gloo", "cpu", axes)
            jmesh = Mesh(np.array(jax.devices()).reshape(
                tuple(axes.values())), tuple(axes))
            for zero in (False, True):
                pd = DistributedProgram(
                    progs[0], pmesh,
                    param_rules=[ShardingRule(p, s) for p, s in rules],
                    opt_state_rules=[ShardingRule(".*", P("dp"))]
                    if zero and "dp" in axes else None)
                jd = JaxDist(
                    progs[1], jmesh,
                    param_rules=[JaxRule(p, JP(*s)) for p, s in rules],
                    opt_state_rules=[JaxRule(".*", JP("dp"))]
                    if zero and "dp" in axes else None)
                n = 0
                for v in progs[1].global_block().vars.values():
                    if not v.persistable or v.shape is None:
                        continue
                    shape = tuple(v.shape)
                    want = tuple(jd.param_sharding(v.name, shape).spec)
                    got = tuple(pd.param_sharding(v.name, shape))
                    want = want + (None,) * (len(got) - len(want))
                    got = got + (None,) * (len(want) - len(got))
                    assert got == want, (v.name, axes, zero, got, want)
                    n += 1
                assert n > 30
    mesh = RankGroup(range(8), 0, None, "gloo", "cpu", {"dp": 2, "tp": 4})
    prog = fluid.framework.Program()
    blk = prog.global_block()
    blk.create_var(name="w", shape=(16, 8), dtype="float32")
    m = blk.create_var(name="w_moment1_0", shape=(16, 8), dtype="float32")
    m.belong_to_optimizer = True
    d = DistributedProgram(prog, mesh,
                           param_rules=[ShardingRule(r"^w", P(None, "tp"))],
                           opt_state_rules=[ShardingRule(r".*", P("dp"))])
    assert tuple(d.param_sharding("w_moment1_0", (16, 8))) == ("dp", "tp")
    assert tuple(d.param_sharding("w", (16, 8))) == (None, "tp")


def test_vocab_parallel_lookup_and_cross_entropy(runs):
    """The table split by vocabulary rows over tp = 2: the masked lookups
    summed, and the cross-entropy from the all-reduced max, sum and
    target logit (the logits never gathered: no fallback), equal the
    whole run's losses, logits and parameters."""
    _, port = runs
    plain = port["vocab_plain"][0]
    for rank in port["vocab_tp"]:
        assert rank["reshards"] == {}
        assert rank["local_shapes"]["vemb"] == (16, 8)
        for step in range(3):
            np.testing.assert_allclose(rank["fetches"][step][0],
                                       plain["fetches"][step][0],
                                       rtol=1e-5)
            _close_max(rank["fetches"][step][1], plain["fetches"][step][1],
                       1e-5)
        _close_max(rank["states"][-1]["vemb"], plain["states"][-1]["vemb"],
                   1e-5)


def test_dropout_keep_mask_with_a_head_offset():
    from paddle_tpu_torch.ops import cuda_attention as ca

    whole = ca.dropout_keep_mask(1234, 2, 12, 128, 128, 0.1)
    for off, n in ((0, 6), (6, 6), (3, 3), (8, 4)):
        part = ca.dropout_keep_mask(1234, 2, n, 128, 128, 0.1,
                                    head_offset=off, total_heads=12)
        assert bool((part == whole[:, off:off + n]).all())
    # the plain forward with the heads' offset is the whole run's heads
    import torch

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 16, 8, generator=g) for _ in range(3))
    out, _ = ca.flash_attention(q, k, v, seed=7, dropout_p=0.3)
    half, _ = ca.flash_attention(q[:, 2:].contiguous(), k[:, 2:].contiguous(),
                                 v[:, 2:].contiguous(), seed=7,
                                 dropout_p=0.3, heads=(2, 4))
    assert torch.equal(half, out[:, 2:])


def test_fetches_and_saves_of_split_state_are_global(runs):
    """A fetched gradient of a split weight and the saved persistables
    are the whole values: save_persistables writes the reference's file
    with every value at its program shape, and the two ranks write the
    same bytes."""
    _, port = runs
    a, b = port["bert_tp"]
    for name, saved in a["saved"].items():
        np.testing.assert_array_equal(saved, b["saved"][name])
        np.testing.assert_array_equal(saved, a["states"][-1][name])
    assert a["saved"]["enc_l0_qkv.w"].shape == (64, 192)
    assert a["saved"]["word_emb"].shape == (128, 64)
    grads = _grad_names("bert_tiny")
    i = grads.index("enc_l0_ffn1.w@GRAD")
    assert a["fetches"][0][1 + i].shape == (64, 128)


@pytest.mark.parametrize("op_type,axis", [("softmax", "tp"),
                                          ("cumsum", "tp"),
                                          ("slice", "tp")])
def test_each_fallback_path_is_exact_and_counted(runs, op_type, axis):
    """A split value into an op that reads its split dim whole (softmax:
    gathered), a partial value into an op without a rule (cumsum after the
    row-split fc: reduced), and BERT's q/k/v slices across the fused qkv
    blocks (gathered): each counted once a run under
    ``parallel.reshard_total``, and the results the whole run's."""
    _, port = runs
    if op_type == "slice":
        # three slices a layer, two layers, five steps
        assert port["bert_tp"][0]["reshards"][(op_type, axis)] == 30
        return
    plain = port["fb_plain"][0]
    for rank in port["fb_tp"]:
        assert rank["reshards"][(op_type, axis)] == 2     # two steps
        for step in range(2):
            for got, want in zip(rank["fetches"][step],
                                 plain["fetches"][step]):
                _close_max(got, want, 1e-5)
        for name, want in plain["states"][-1].items():
            _close_max(rank["states"][-1][name], want, 1e-5)


def test_sharding_spec_annotations_are_exact_name_rules():
    """A program's ``_sharding_spec`` (as DistributeTranspiler leaves it)
    becomes an exact-name rule: ``emb`` is split, ``src_emb`` is not, as
    in the JAX package."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.parallel.mesh import P, RankGroup
    from paddle_tpu_torch.parallel.sharding import DistributedProgram

    progs = []
    for f in (fluid.framework, jframework):
        prog = f.Program()
        for n in ("emb", "src_emb"):
            prog.global_block().create_var(name=n, shape=(8, 4),
                                           dtype="float32", persistable=True)
        prog._sharding_spec = [("emb", ("tp", None))]
        progs.append(prog)
    mesh = RankGroup(range(2), 0, None, "gloo", "cpu", {"tp": 2})
    d = DistributedProgram(progs[0], mesh)
    jd = JaxDist(progs[1], Mesh(np.array(jax.devices()[:2]), ("tp",)))
    for n in ("emb", "src_emb"):
        want = tuple(jd.param_sharding(n, (8, 4)).spec)
        got = tuple(d.param_sharding(n, (8, 4)))
        assert got[:len(want)] == want and not any(got[len(want):]), n
    assert tuple(d.param_sharding("emb", (8, 4))) == ("tp", None)
    assert d.param_sharding("src_emb", (8, 4)) == P()


def test_stacked_programs_refuse_tp_and_zero():
    """The comms mode keeps whole per-rank copies: a tp mesh or rule and
    ZeRO rules raise, as the reference's fleet refuses them."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.parallel.comms import GradSyncProgram
    from paddle_tpu_torch.parallel.mesh import P, RankGroup
    from paddle_tpu_torch.parallel.sharding import ShardingRule

    prog = fluid.framework.Program()
    dp_tp = RankGroup(range(4), 0, None, "gloo", "cpu", {"dp": 2, "tp": 2})
    dp = RankGroup(range(2), 0, None, "gloo", "cpu", {"dp": 2})
    with pytest.raises(NotImplementedError, match="pure-dp"):
        GradSyncProgram(prog, dp_tp)
    with pytest.raises(NotImplementedError, match="pure-dp"):
        GradSyncProgram(prog, dp, param_rules=[ShardingRule("w", P(None,
                                                                   "tp"))])
    with pytest.raises(NotImplementedError, match="pick one"):
        GradSyncProgram(prog, dp, opt_state_rules=[ShardingRule(".*",
                                                                P("dp"))])


def test_saved_split_state_loads_and_is_cut_again(runs):
    """save_persistables of a tp run writes whole values;
    load_persistables puts them back whole and the next run cuts each
    rank's block again: the resumed step's loss is the uninterrupted
    one's."""
    _, port = runs
    for rank in port["resume"]:
        assert rank["loaded_shapes"] == {"enc_l0_qkv.w": (64, 192),
                                         "word_emb": (128, 64)}
        assert rank["resumed"] == rank["on"]


def test_amp_skip_gate_under_tp(runs):
    """Dynamic loss scaling on a tp-split MLP: the finiteness flag is
    reduced over the tp ranks (isfinite's rule), so the step with an inf
    is skipped on every rank and the states and losses are the one-rank
    run's."""
    _, port = runs
    plain = port["amp_plain"][0]
    for rank in port["amp_tp"]:
        for step in range(3):
            a, b = rank["fetches"][step][0], plain["fetches"][step][0]
            assert np.isfinite(a) == np.isfinite(b)
            if np.isfinite(b):
                np.testing.assert_allclose(a, b, rtol=1e-6)
        for name, want in plain["states"][-1].items():
            _close_max(rank["states"][-1][name], want, 1e-6)
