"""Rank-side jobs of the pipeline, MoE and LocalSGD tests of
``paddle_tpu_torch`` (tests/test_torch_pipeline.py, test_torch_moe.py,
test_torch_local_sgd.py), run on gloo ranks by
:func:`torch_ranks.run_ranks`. Like torch_ranks.py it imports torch and
the port only; the model builders take either package's ``fluid``, so the
tests build the JAX package's side from the same functions.
"""
import os

import numpy as np
import torch

import torch_ranks as tr

MLP_STEPS = 4
BERT_LAYERS = 2


# ---------------------------------------------------------------------------
# models, built with either package's fluid: `make_opt(opt, cuts)` gives
# the optimizer that minimizes (a PipelineOptimizer over `cuts`, or `opt`)
# ---------------------------------------------------------------------------
def pp_mlp(fluid, make_opt):
    """test_round2_fixes.py::TestPipelineFluid's MLP, SGD(0.05), cut after
    its first layer."""
    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h1 = fluid.layers.fc(x, size=32, act="relu", name="s1")
    h2 = fluid.layers.fc(h1, size=32, act="relu", name="s2")
    pred = fluid.layers.fc(h2, size=1, name="s3")
    loss = fluid.layers.reduce_mean(fluid.layers.square(pred - y))
    make_opt(fluid.optimizer.SGD(0.05), [h1]).minimize(loss)
    return loss


def pp_composed(fluid, make_opt):
    """examples/composed_parallelism.py's dp x pp model, Adam(0.02)."""
    x = fluid.layers.data(name="px", shape=[16], dtype="float32")
    y = fluid.layers.data(name="py", shape=[1], dtype="float32")
    h1 = fluid.layers.fc(x, size=32, act="relu", name="stage1")
    pred = fluid.layers.fc(h1, size=1, name="stage2")
    loss = fluid.layers.reduce_mean(fluid.layers.square_error_cost(pred, y))
    make_opt(fluid.optimizer.Adam(0.02), [h1]).minimize(loss)
    return loss


def layer_out(program, i):
    """The name of BERT encoder layer i's output (its second LayerNorm's
    Y): the cut of a pipeline after layer i."""
    for op in program.global_block().ops:
        if op.type == "layer_norm" and op.input("Scale") == [
                "enc_l%d_ln2.w" % i]:
            return op.output("Y")[0]
    raise KeyError("no encoder layer %d" % i)


def pp_bert(fluid, make_opt):
    """BERT pretraining at 2 layers, hidden 64, dropout 0, SGD(0.5), cut
    after layer 0: both stages run attention and LayerNorm."""
    import importlib

    bert = importlib.import_module(
        fluid.__name__.split(".")[0] + ".models.bert")
    io = bert.build_bert_pretrain(tr.bert_config(bert), tr.BERT_SEQ)
    cut = layer_out(fluid.default_main_program(), 0)
    make_opt(fluid.optimizer.SGD(learning_rate=0.5), [cut]).minimize(
        io["loss"])
    return io["loss"]


PP_MODELS = {"mlp": pp_mlp, "composed": pp_composed, "bert": pp_bert}


def mlp_feed():
    rs = np.random.RandomState(3)
    return {"x": rs.randn(8, 16).astype("float32"),
            "y": rs.randn(8, 1).astype("float32")}


def composed_feed():
    rs = np.random.default_rng(5)
    xv = rs.normal(size=(16, 16)).astype(np.float32)
    return {"px": xv,
            "py": (xv.sum(1, keepdims=True) * 0.1).astype(np.float32)}


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------
def pp_run(rank, world, model, feeds, params, pipeline=True, mesh=None,
           dp_feeds=(), zero=False, n_micro=4, p2p=False):
    """Build `model` in the port (through PipelineOptimizer over `mesh`
    ({axis: size}, default the first ranks of the world) when
    `pipeline`), run its startup on the CPU, set `params`, and run one
    step per feed. Returns the losses, the global state after every step,
    this rank's own state shapes and the last step's ring figures. With
    `p2p` the pp line takes the point-to-point route nccl takes
    (``batch_isend_irecv``, which gloo runs on the CPU)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import params_from_numpy
    from paddle_tpu_torch.parallel.mesh import P, build_mesh
    from paddle_tpu_torch.parallel.sharding import ShardingRule

    tr.fresh_port_state()
    main = fluid.default_main_program()
    main.random_seed = fluid.default_startup_program().random_seed = 5
    group = build_mesh(mesh) if mesh else None
    if p2p:
        group.axis_group("pp").backend = "nccl"

    def make_opt(opt, cuts):
        if not pipeline:
            return opt
        return fluid.optimizer.PipelineOptimizer(
            opt, cut_list=cuts, num_microbatches=n_micro, mesh=group,
            feed_specs={k: P("dp", None) for k in dp_feeds} or None,
            opt_state_rules=([ShardingRule(r"moment", P("dp"))] if zero
                             else None))

    loss = PP_MODELS[model](fluid, make_opt)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.global_scope()
    exe.run(fluid.default_startup_program())
    for n, t in params_from_numpy(params, "cpu").items():
        scope.set(n, t)
    out = {"losses": [], "states": []}
    for feed in feeds:
        out["losses"].append(float(exe.run(feed=feed,
                                           fetch_list=[loss])[0]))
        runner = getattr(main, "_parallel_info", {}).get("_runner")
        snap = (runner.consolidated_scope(scope) if runner is not None
                else scope)
        out["states"].append(tr.scope_state(snap))
    out["local_shapes"] = {n: tuple(scope[n].shape) for n in scope.keys()
                           if isinstance(scope[n], torch.Tensor)}
    runner = getattr(main, "_parallel_info", {}).get("_runner")
    out["ring"] = dict(runner.last_step) if runner is not None else None
    return out


def gpipe_run(rank, world, ws, bs, x, dout, axes, n_micro, entry,
              p2p=False):
    """The tanh stages of the stacked weights `ws` (and biases `bs`, or
    None) over `axes` of the world through `entry`: gpipe_sharded or
    gpipe_composed (every rank given the whole stack and batch), or gpipe
    (this rank given its own stage's weights and the microbatches). The
    output, and the gradients of sum(out * dout) w.r.t. the weights and
    the input. With `p2p` the pp line takes the point-to-point route (as
    pp_run)."""
    from paddle_tpu_torch.parallel import pipeline
    from paddle_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(axes)
    if p2p:
        mesh.axis_group("pp").backend = "nccl"
    stacked = {"w": ws} if bs is None else {"w": ws, "b": bs}
    if entry == "gpipe":
        stacked = {k: v[rank] for k, v in stacked.items()}
    params = {k: torch.from_numpy(v.copy()).requires_grad_()
              for k, v in stacked.items()}
    xt = torch.from_numpy(x.copy()).requires_grad_()

    def stage(p, h):
        y = h @ p["w"]
        return torch.tanh(y + p["b"] if "b" in p else y)

    if entry == "gpipe":
        xm = xt.reshape((n_micro, x.shape[0] // n_micro) + x.shape[1:])
        out = pipeline.gpipe(stage, params, xm, "pp", mesh).reshape(x.shape)
    else:
        out = getattr(pipeline, entry)(stage, params, xt, mesh,
                                       n_microbatches=n_micro)
    (out * torch.from_numpy(dout)).sum().backward()
    got = {"out": out.detach().numpy(), "dx": xt.grad.numpy()}
    got.update({"d" + k: v.grad.numpy() for k, v in params.items()})
    return got


def gpipe_train(rank, world, ws, bs, x, tgt, axes, steps, lr):
    """gpipe_composed trained by hand: mean((out - tgt)^2), SGD(`lr`),
    `steps` steps. The losses and the final weights."""
    from paddle_tpu_torch.parallel import pipeline
    from paddle_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh(axes)
    w, b = torch.from_numpy(ws.copy()), torch.from_numpy(bs.copy())
    xt, tt = torch.from_numpy(x), torch.from_numpy(tgt)
    losses = []
    for _ in range(steps):
        p = {"w": w.requires_grad_(), "b": b.requires_grad_()}
        out = pipeline.gpipe_composed(
            lambda q, h: torch.tanh(h @ q["w"] + q["b"]), p, xt, mesh,
            n_microbatches=4)
        loss = ((out - tt) ** 2).mean()
        gw, gb = torch.autograd.grad(loss, [p["w"], p["b"]])
        losses.append(float(loss))
        w, b = (w - lr * gw).detach(), (b - lr * gb).detach()
    return {"losses": losses, "w": w.numpy(), "b": b.numpy()}


def _refusal(build):
    """The message of the OpLoweringError `build()`'s first run raises,
    or None when it runs."""
    from paddle_tpu_torch.fluid.lowering import OpLoweringError

    try:
        build()
    except (OpLoweringError, NotImplementedError) as e:
        return str(e)
    return None


def pp_refusals(rank, world):
    """Each refusal of the JAX package's pipeline executor, on `world`
    ranks: {case: message}."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.parallel.mesh import P, build_mesh
    from paddle_tpu_torch.parallel.sharding import ShardingRule

    def case(cuts=1, micro=2, fetch="loss", batch=4, mesh=None,
             rules=None, specs=None, minimize=True):
        def run():
            tr.fresh_port_state()
            x = fluid.layers.data(name="x", shape=[4], dtype="float32")
            h1 = fluid.layers.fc(x, size=4, act="relu")
            h2 = fluid.layers.fc(h1, size=4, act="relu")
            pred = fluid.layers.fc(h2, size=1)
            loss = fluid.layers.reduce_mean(fluid.layers.square(pred))
            opt = fluid.optimizer.PipelineOptimizer(
                fluid.optimizer.SGD(0.1), cut_list=[h1, h2][:cuts],
                num_microbatches=micro,
                mesh=build_mesh(mesh) if mesh else None,
                param_rules=rules, feed_specs=specs)
            if minimize:
                opt.minimize(loss)
            else:           # the annotation without the backward op
                fluid.default_main_program()._parallel_info = {
                    "mode": "pipeline", "cut_list": [h1]}
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(fluid.default_startup_program())
            exe.run(feed={"x": np.zeros((batch, 4), "float32")},
                    fetch_list=[{"loss": loss, "h1": h1}[fetch]])
        return _refusal(run)

    return {
        "no_backward": case(minimize=False),
        "one_stage": case(cuts=0),
        "too_few_ranks": case(cuts=2),
        "mid_pipeline_fetch": case(fetch="h1"),
        "param_rules": case(rules=[ShardingRule(r"fc_0\.w_0",
                                                P(None, "tp"))]),
        "mesh_without_pp": case(mesh={"dp": world}),
        "pp_size": case(mesh={"dp": world, "pp": 1}),
        "unknown_feed_spec": case(specs={"nope": P("dp", None)}),
        "indivisible_batch": case(batch=6, micro=4),
        "runs": case(),
    }


def pp_dropout(rank, world):
    """A last stage that returns dropout(1) at rate 0.5, 4 microbatches
    of 2 rows: its fetch (the microbatch mean) shows whether the
    microbatches drew distinct masks."""
    import paddle_tpu_torch.fluid as fluid

    tr.fresh_port_state()
    x = fluid.layers.data(name="dx", shape=[16], dtype="float32")
    h1 = fluid.layers.fc(x, size=32, act="relu")
    keep = fluid.layers.dropout(
        fluid.layers.fill_constant_batch_size_like(h1, [-1, 32], "float32",
                                                   1.0),
        0.5, dropout_implementation="upscale_in_train")
    loss = fluid.layers.reduce_mean(fluid.layers.elementwise_mul(h1, keep))
    fluid.optimizer.PipelineOptimizer(
        fluid.optimizer.SGD(0.1), cut_list=[h1],
        num_microbatches=4).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    got = exe.run(feed={"dx": np.ones((8, 16), "float32")},
                  fetch_list=[keep])
    return {"keep": got[0]}


def pipeline_jobs(rank, world, jobs):
    """Each job of `jobs` ({"fn": name, ...kwargs}) in order."""
    out = []
    for job in jobs:
        job = dict(job)
        out.append(globals()[job.pop("fn")](rank, world, **job))
    return out


# ---------------------------------------------------------------------------
# MoE (tests/test_torch_moe.py)
# ---------------------------------------------------------------------------
MOE_SHAPE = dict(B=8, T=4, H=16, E=4, F=32)


def moe_model(fluid, name="moe_ep", cap=8.0):
    """tests/test_moe.py::test_switch_ffn_trains_and_shards_over_ep's
    model: switch_ffn, MSE to a fixed target + 0.01 aux, Adam(5e-3)."""
    import importlib

    moe = importlib.import_module(
        fluid.__name__.split(".")[0] + ".parallel.moe")
    s = MOE_SHAPE
    x = fluid.data("moe_x", shape=[s["B"], s["T"], s["H"]], dtype="float32")
    y, aux = moe.switch_ffn(x, s["E"], s["F"], capacity_factor=cap,
                            name=name)
    lbl = fluid.data("moe_lbl", shape=[s["B"], s["T"], s["H"]],
                     dtype="float32")
    loss = fluid.layers.elementwise_add(
        fluid.layers.reduce_mean(fluid.layers.square_error_cost(y, lbl)),
        fluid.layers.scale(aux, scale=0.01))
    fluid.optimizer.Adam(5e-3).minimize(loss)
    return loss


def moe_feed():
    s = MOE_SHAPE
    xv = np.random.default_rng(0).standard_normal(
        (s["B"], s["T"], s["H"])).astype("float32")
    return {"moe_x": xv, "moe_lbl": np.tanh(xv)[:, :, ::-1].copy()}


def moe_run(rank, world, params, steps, axes):
    """moe_model from `params`, `steps` Adam steps through a
    DistributedProgram over `axes` with moe_ep_rules (the plain Executor
    when `axes` is None): the losses, the
    global state, this rank's shapes of the expert weights, and the
    fallbacks and collectives the layouts took."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import params_from_numpy
    from paddle_tpu_torch.parallel import moe
    from paddle_tpu_torch.parallel import tensor_parallel as tpl
    from paddle_tpu_torch.parallel.mesh import build_mesh
    from paddle_tpu_torch.parallel.sharding import (DistributedProgram,
                                                    ShardingRule)

    tr.fresh_port_state()
    tpl.reset_counts()
    loss = moe_model(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.global_scope()
    exe.run(fluid.default_startup_program())
    for n, t in params_from_numpy(params, "cpu").items():
        scope.set(n, t)
    prog = fluid.default_main_program()
    if axes:
        prog = DistributedProgram(
            prog, build_mesh(axes), param_rules=[
                ShardingRule(p, s) for p, s in moe.moe_ep_rules("moe_ep")])
    feed = moe_feed()
    losses = [float(exe.run(prog, feed=feed, fetch_list=[loss])[0])
              for _ in range(steps)]
    snap = prog.consolidated_scope(scope) if axes else scope
    return {"losses": losses, "state": tr.scope_state(snap),
            "shapes": {n: tuple(scope[n].shape) for n in
                       ("moe_ep.w1", "moe_ep.b1", "moe_ep.w2", "moe_ep.b2",
                        "moe_ep.gate.w")},
            "reshards": dict(tpl.RESHARDS),
            "collectives": {k: list(v) for k, v in
                            tpl.COLLECTIVES.items()}}


# ---------------------------------------------------------------------------
# LocalSGD (tests/test_torch_local_sgd.py)
# ---------------------------------------------------------------------------
def lsgd_model(fluid):
    """tests/test_local_sgd.py's regression model."""
    x = fluid.data("lsx", shape=[None, 6], dtype="float32")
    y = fluid.data("lsy", shape=[None, 1], dtype="float32")
    h = fluid.layers.fc(x, 12, act="tanh")
    p = fluid.layers.fc(h, 1)
    return fluid.layers.reduce_mean(fluid.layers.square_error_cost(p, y))


def lsgd_data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 6)).astype("float32")
    y = (x @ rng.standard_normal((6, 1))).astype("float32")
    return {"lsx": x, "lsy": y}


def lsgd_run(rank, world, params, strategy, steps, lr=0.1, save_dir=None):
    """The regression model through fleet with the DistributedStrategy
    attrs `strategy`, SGD(`lr`), from `params`: losses, this rank's own
    parameters after every step and right before each average, the
    parameter collectives of each step, and with `save_dir` what
    fleet.save_persistables wrote and whether the live scope kept its
    values."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import params_from_numpy
    from paddle_tpu_torch.parallel import fleet as fleet_mod

    tr.fresh_port_state()
    main = fluid.default_main_program()
    main.random_seed = fluid.default_startup_program().random_seed = 11
    fl = fleet_mod.Fleet().init(
        fleet_mod.UserDefinedRoleMaker(rank, worker_num=world))
    s = fleet_mod.DistributedStrategy()
    for k, v in strategy.items():
        setattr(s, k, v)
    loss = lsgd_model(fluid)
    fl.distributed_optimizer(fluid.optimizer.SGD(lr), s).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.global_scope()
    exe.run(fluid.default_startup_program())
    for n, t in params_from_numpy(params, "cpu").items():
        scope.set(n, t)
    prog = fl.main_program
    out = {"losses": [], "params": [], "syncs": [], "pre_sync": []}
    names = sorted(p.name for p in main.all_parameters())
    average = getattr(prog, "_average", None)
    if average is not None:
        def spy(sc):
            out["pre_sync"].append({n: sc[n].numpy().copy()
                                    for n in names})
            average(sc)

        prog._average = spy
    for _ in range(steps):
        out["losses"].append(float(exe.run(prog, feed=lsgd_data(),
                                           fetch_list=[loss])[0]))
        out["params"].append({n: scope[n].numpy().copy() for n in names})
        out["syncs"].append(getattr(prog, "param_collectives", None))
    out["anchors"] = sorted(n for n in scope.keys() if "@LSGD_ANCHOR" in n)
    if save_dir is not None:
        before = {n: scope[n].numpy().copy() for n in names}
        fl.save_persistables(exe, os.path.join(save_dir, "persist"))
        out["kept"] = all(np.array_equal(before[n], scope[n].numpy())
                          for n in names)
        path = os.path.join(save_dir, "persist", "__persistables__.npz")
        if rank == 0:
            with np.load(path) as f:
                out["saved"] = {n: f[n].copy() for n in f.files}
        snap = prog.consolidated_scope(scope)
        out["consolidated"] = {n: snap[n].numpy().copy() for n in names}
    return out


def lsgd_refusals(rank, world):
    """fleet's LocalSGD refusals and LocalSGDProgram's feed rule:
    {case: message}."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.parallel import fleet as fleet_mod
    from paddle_tpu_torch.parallel.local_sgd import LocalSGDProgram
    from paddle_tpu_torch.parallel.mesh import P, build_mesh

    def build(**kw):
        tr.fresh_port_state()
        fl = fleet_mod.Fleet().init(
            fleet_mod.UserDefinedRoleMaker(rank, worker_num=world))
        s = fleet_mod.DistributedStrategy()
        s.use_local_sgd = True
        for k, v in kw.items():
            setattr(s, k, v)
        loss = lsgd_model(fluid)
        try:
            fl.distributed_optimizer(fluid.optimizer.SGD(0.1),
                                     s).minimize(loss)
        except (NotImplementedError, ValueError) as e:
            return str(e)
        return None

    out = {"zero": build(sharding_degree=2),
           "tp": build(tensor_parallel_degree=2),
           "comms": build(grad_sync_mode="comms"),
           "pipeline": build(pipeline_parallel_degree=2)}
    tr.fresh_port_state()
    loss = lsgd_model(fluid)
    fluid.optimizer.SGD(0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    bad = LocalSGDProgram(fluid.default_main_program(),
                          build_mesh({"dp": world}), k_steps=1,
                          feed_specs={"lsx": P(None, "dp"), "lsy": P()})
    try:
        exe.run(bad, feed=lsgd_data(), fetch_list=[loss])
        out["feed"] = None
    except NotImplementedError as e:
        out["feed"] = str(e)
    try:
        LocalSGDProgram(fluid.default_main_program(),
                        build_mesh({"tp": world}), k_steps=2)
        out["no_dp"] = None
    except (NotImplementedError, ValueError) as e:
        out["no_dp"] = str(e)
    return out
