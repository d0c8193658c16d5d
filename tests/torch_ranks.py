"""Run a function on W gloo ranks of the port, each its own process.

Imported by the data-parallel tests of ``paddle_tpu_torch``
(tests/test_torch_parallel.py, tests/test_torch_comms.py); it imports
torch and the port only, never jax, so a rank starts quickly.

:func:`run_ranks` spawns W processes (``multiprocessing`` ``spawn``),
each of which joins a gloo world on a ``FileStore`` under the caller's
directory (no TCP port: the suite runs under xdist), computes on the
CPU, calls ``fn(rank, world, *args)`` and pickles what it returns. The
caller joins them with its own time limit and kills every rank on a
timeout, so a hung collective cannot hang the suite; a rank's exception
is raised in the caller with its traceback.
"""
import datetime
import multiprocessing as mp
import os
import pickle
import time
import traceback

import torch
import torch.distributed as dist


def run_ranks(fn, world, workdir, args=(), timeout=120.0):
    """[fn(0, world, *args), ..., fn(world-1, world, *args)], each
    computed on its own gloo rank; `workdir` must be a fresh directory."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world, workdir, args, timeout),
                         daemon=True)
             for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors = []
    for rank in range(world):
        err = os.path.join(workdir, "rank%d.err" % rank)
        if os.path.exists(err):
            with open(err) as f:
                errors.append("rank %d:\n%s" % (rank, f.read()))
    if errors:
        raise RuntimeError("\n".join(errors))
    if hung:
        raise TimeoutError("ranks %s still running after %.0f s: killed"
                           % (hung, timeout))
    bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
    if bad:
        raise RuntimeError("ranks exited with %s" % bad)
    out = []
    for rank in range(world):
        with open(os.path.join(workdir, "rank%d.pkl" % rank), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(fn, rank, world, workdir, args, timeout):
    torch.set_num_threads(1)
    try:
        from paddle_tpu_torch.parallel import mesh

        store = dist.FileStore(os.path.join(workdir, "store"), world)
        mesh.init_group(rank=rank, world_size=world, backend="gloo",
                        device="cpu", store=store,
                        timeout=datetime.timedelta(seconds=timeout))
        result = fn(rank, world, *args)
        with open(os.path.join(workdir, "rank%d.pkl" % rank), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(workdir, "rank%d.err" % rank), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def fresh_port_state():
    """New default programs, name generator and scope of the port."""
    from paddle_tpu_torch.fluid import executor, framework, unique_name

    framework.switch_main_program(framework.Program())
    framework.switch_startup_program(framework.Program())
    unique_name.switch()
    executor._scope_stack[:] = [executor.Scope()]


# ---------------------------------------------------------------------------
# models, built with either package's fluid (the JAX package's or the
# port's): `minimize(optimizer, loss)` applies the optimizer
# ---------------------------------------------------------------------------
def plain_minimize(opt, loss):
    opt.minimize(loss)


def mlp(fluid, minimize):
    """test_distributed.py::_train_once's MLP classifier, SGD(0.5)."""
    x = fluid.data("x", [None, 16], dtype="float32")
    y = fluid.data("y", [None, 1], dtype="int64")
    h = fluid.layers.fc(
        x, size=32, act="relu",
        param_attr=fluid.ParamAttr(
            name="w1", initializer=fluid.initializer.Constant(0.05)))
    logits = fluid.layers.fc(
        h, size=4,
        param_attr=fluid.ParamAttr(
            name="w2", initializer=fluid.initializer.Constant(0.02)))
    loss = fluid.layers.reduce_mean(
        fluid.layers.softmax_with_cross_entropy(logits, y))
    minimize(fluid.optimizer.SGD(learning_rate=0.5), loss)
    return loss, [logits]


def regression(fluid, minimize):
    """test_comms.py's two-layer regression, SGD(0.1)."""
    x = fluid.data("cx", shape=[None, 6], dtype="float32")
    y = fluid.data("cy", shape=[None, 1], dtype="float32")
    h = fluid.layers.fc(x, 12, act="tanh")
    p = fluid.layers.fc(h, 1)
    loss = fluid.layers.reduce_mean(fluid.layers.square_error_cost(p, y))
    minimize(fluid.optimizer.SGD(0.1), loss)
    return loss, []


def conv_bn(fluid, minimize):
    """conv2d + batch_norm + global average pool + fc, Momentum."""
    img = fluid.data("img", [None, 3, 8, 8], dtype="float32")
    label = fluid.data("label", [None, 1], dtype="int64")
    c = fluid.layers.conv2d(img, num_filters=4, filter_size=3, padding=1,
                            bias_attr=False)
    b = fluid.layers.batch_norm(c, act="relu")
    p = fluid.layers.pool2d(b, pool_type="avg", global_pooling=True)
    logits = fluid.layers.fc(p, size=3)
    loss = fluid.layers.reduce_mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))
    minimize(fluid.optimizer.Momentum(0.1, 0.9), loss)
    return loss, []


BERT_SEQ = 16


def bert_config(bert):
    return bert.BertConfig(vocab_size=128, hidden=64, num_layers=2, heads=4,
                           ffn=128, max_seq=BERT_SEQ, dropout=0.0)


def bert_small(fluid, minimize):
    """BERT pretraining at 2 layers, hidden 64, dropout 0, SGD(0.5)."""
    import importlib

    bert = importlib.import_module(
        fluid.__name__.split(".")[0] + ".models.bert")
    io = bert.build_bert_pretrain(bert_config(bert), BERT_SEQ)
    minimize(fluid.optimizer.SGD(learning_rate=0.5), io["loss"])
    return io["loss"], []


def mlp_amp(fluid, minimize):
    """The MLP under dynamic loss scaling (fp32 compute), a bad step
    halving the scale: its SkipGate must decide alike on every rank."""
    x = fluid.data("x", [None, 16], dtype="float32")
    y = fluid.data("y", [None, 1], dtype="int64")
    logits = fluid.layers.fc(fluid.layers.fc(x, 32, act="relu"), 4)
    loss = fluid.layers.reduce_mean(
        fluid.layers.softmax_with_cross_entropy(logits, y))
    minimize(fluid.contrib.mixed_precision.decorate(
        fluid.optimizer.SGD(0.5), use_bf16=False, init_loss_scaling=2.0 ** 10,
        decr_every_n_nan_or_inf=1, decr_ratio=0.5), loss)
    return loss, []


def draws(fluid, minimize):
    """A dropout over the batch and a uniform draw of a static shape kept
    in a persistable (no training)."""
    x = fluid.data("dx", [None, 64], dtype="float32")
    d = fluid.layers.dropout(x, 0.5,
                             dropout_implementation="upscale_in_train")
    u = fluid.layers.uniform_random([4, 4], min=0.0, max=1.0)
    keep = fluid.layers.create_global_var(
        shape=[4, 4], value=0.0, dtype="float32", persistable=True,
        name="u_keep")
    fluid.layers.assign(u, output=keep)
    return None, [d, keep]


MODELS = {"mlp": mlp, "regression": regression, "conv_bn": conv_bn,
          "bert_small": bert_small, "draws": draws, "mlp_amp": mlp_amp}


# ---------------------------------------------------------------------------
# rank-side runs
# ---------------------------------------------------------------------------
def collective_cases(rank, world, cases):
    """Each (op type, {slot: [stacked per-rank arrays]}, attrs) through the
    port's lowering with ring 0 bound to the dp axis of the world; this
    rank's outputs as {slot: [arrays]}."""
    from paddle_tpu_torch.ops.registry import LowerContext, get_lowering
    from paddle_tpu_torch.parallel.mesh import get_default_mesh

    group = get_default_mesh()
    out = []
    for op_type, ins, attrs in cases:
        ctx = LowerContext(torch.device("cpu"), mesh_axes={0: "dp"},
                           mesh=group)
        got = get_lowering(op_type)(
            ctx, {k: [torch.from_numpy(a[rank].copy()) for a in v]
                  for k, v in ins.items()}, dict(attrs))
        out.append({k: [t.numpy() for t in v] for k, v in got.items()})
    return out


def subgroups(rank, world):
    """Groups over part of the world: ranks 1 and 3 (``build_mesh(ranks=
    ...)``), and the world shrunk past rank 0 (``shrink_mesh``); every
    rank makes both, members sum their ranks over them."""
    from paddle_tpu_torch.parallel.mesh import (build_mesh,
                                                get_default_mesh,
                                                shrink_mesh)

    out = {}
    for tag, group in (("pair", build_mesh({"dp": 2}, ranks=[1, 3])),
                       ("shrunk", shrink_mesh(get_default_mesh(),
                                              dead=[0]))):
        total = None
        if group.rank is not None:
            total = float(group.all_reduce(torch.tensor([float(rank)])))
        out[tag] = (group.ranks, group.rank, total)
    return out


def collective_suite(rank, world, cases, jobs=()):
    """collective_cases, at 4 ranks the subgroups, and dp_jobs."""
    out = {"cases": collective_cases(rank, world, cases),
           "jobs": dp_jobs(rank, world, jobs)}
    if world == 4:
        out["subgroups"] = subgroups(rank, world)
    return out


def scope_state(scope):
    return {n: scope[n].numpy().copy() for n in sorted(scope.keys())
            if isinstance(scope[n], torch.Tensor)}


def dp_run(rank, world, model, entry, feeds, params=None, strategy=None):
    """Build `model` in the port, run its startup on the CPU (then set
    `params`, {name: array}, when given) and run one step per feed
    through `entry`: "dist" (DistributedProgram over the world),
    "compiled" (CompiledProgram.with_data_parallel), "pexe"
    (ParallelExecutor), "fleet" (fleet.distributed_optimizer with the
    DistributedStrategy attrs `strategy`). Returns the fetches and this
    rank's scope after every step."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import params_from_numpy
    from paddle_tpu_torch.parallel import fleet as fleet_mod
    from paddle_tpu_torch.parallel.mesh import build_mesh
    from paddle_tpu_torch.parallel.sharding import DistributedProgram

    fresh_port_state()
    main = fluid.default_main_program()
    main.random_seed = fluid.default_startup_program().random_seed = 11
    minimize, fl = plain_minimize, None
    if entry == "fleet":
        fl = fleet_mod.Fleet().init(
            fleet_mod.UserDefinedRoleMaker(rank, worker_num=world))
        s = fleet_mod.DistributedStrategy()
        for k, v in (strategy or {}).items():
            setattr(s, k, v)

        def minimize(opt, loss):
            fl.distributed_optimizer(opt, s).minimize(loss)

    loss, extra = MODELS[model](fluid, minimize)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.global_scope()
    exe.run(fluid.default_startup_program())
    for n, t in params_from_numpy(params or {}, "cpu").items():
        scope.set(n, t)
    fetch = ([loss] if loss is not None else []) + extra
    if entry == "pexe":
        pexe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                                      main_program=main)
        run = lambda feed: pexe.run(fetch, feed=feed)  # noqa: E731
    else:
        prog = {"dist": lambda: DistributedProgram(main, build_mesh(
                    {"dp": world})),
                "compiled": lambda: fluid.CompiledProgram(
                    main).with_data_parallel(loss_name=loss.name),
                "fleet": lambda: fl.main_program}[entry]()
        run = lambda feed: exe.run(prog, feed=feed,  # noqa: E731
                                   fetch_list=fetch)
    fetches, states = [], []
    for feed in feeds:
        fetches.append(run(feed))
        states.append(scope_state(scope))
    return {"fetches": fetches, "states": states}


def dp_jobs(rank, world, jobs):
    """dp_run for each kwargs dict of `jobs`, in order."""
    return [dp_run(rank, world, **job) for job in jobs]


def flat_allreduces(rank, world, xs, block):
    """This rank's row of `xs` through the quantized and the exact
    allreduce (mean and sum) and pmean_int8 over the world."""
    from paddle_tpu_torch.parallel.comms import allreduce as ar
    from paddle_tpu_torch.parallel.mesh import get_default_mesh

    group = get_default_mesh()
    x = torch.from_numpy(xs[rank].copy())
    out = {}
    for mean in (True, False):
        q, local = ar.quantized_allreduce_flat(x, group, block, mean=mean)
        e, same = ar.exact_allreduce_flat(x, group, mean=mean)
        out[mean] = (q.numpy(), local.numpy(), e.numpy(),
                     bool(same is x))
    out["pmean_int8"] = ar.pmean_int8(x.reshape(-1, 8), group).numpy()
    return out


def comms_drills(rank, world, feed, save_dir):
    """GradSync (int8) at `world` ranks: a step, a step under an expired
    collective deadline (it must raise on every rank before any
    collective), a step under an injected fault at the ``collective``
    site, then a step again; the comm telemetry after each; the fleet's
    barrier, with and without an expired deadline; the fleet's saves
    into this rank's directory under `save_dir`."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.fluid import resilience as R
    from paddle_tpu_torch.parallel import fleet as fleet_mod

    fresh_port_state()
    obs.reset()
    fl = fleet_mod.Fleet().init(
        fleet_mod.UserDefinedRoleMaker(rank, worker_num=world))
    s = fleet_mod.DistributedStrategy()
    s.grad_sync_mode, s.grad_quantize, s.grad_bucket_bytes = "comms", True, 64
    s.grad_quantize_block = 64

    def minimize(opt, loss):
        fl.distributed_optimizer(opt, s).minimize(loss)

    loss, _ = regression(fluid, minimize)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    prog = fl.main_program

    def step():
        return float(exe.run(prog, feed=feed, fetch_list=[loss])[0])

    out = {"first": step()}
    out["telemetry"] = {
        "bytes_sent": obs.counter("comm.bytes_sent"),
        "bytes_saved": obs.counter("comm.bytes_saved"),
        "compression_ratio": obs.gauge("comm.compression_ratio"),
        "overlap_ratio": obs.gauge("comm.overlap_ratio"),
        "dispatch": obs.counter("collective.dispatch.grad_sync")}
    out["wire_stats"] = dict(prog._wire_stats)
    out["n_buckets"] = sum(len(p.buckets) for p in prog._plans)
    try:
        with R.collective_deadline(0):
            step()
        out["deadline"] = None
    except R.CollectiveTimeoutError as e:
        out["deadline"] = str(e)
    out["after_deadline"] = step()
    R.FaultInjector.install("collective:at=1:RuntimeError")
    try:
        step()
        out["fault"] = None
    except RuntimeError as e:
        out["fault"] = str(e)
    finally:
        R.FaultInjector.uninstall()
    out["after_fault"] = step()
    fl.barrier_worker()
    try:
        with R.collective_deadline(0):
            fl.barrier_worker()
        out["barrier_deadline"] = None
    except R.CollectiveTimeoutError as e:
        out["barrier_deadline"] = str(e)
    out["worker"] = (fl.worker_num(), fl.worker_index(),
                     fl.is_first_worker())
    # rank 0 writes (after the consolidation, a collective of every rank)
    mine = os.path.join(save_dir, "rank%d" % rank)
    fl.save_persistables(exe, os.path.join(mine, "persistables"))
    fl.save_inference_model(exe, os.path.join(mine, "model"), ["cx"],
                            [loss], main_program=prog._program)
    out["saved"] = sorted(os.listdir(mine)) if os.path.isdir(mine) else []
    out["residuals"] = {n: fluid.global_scope()[n].numpy().copy()
                        for n in prog._residual_names}
    snap = prog.consolidated_scope(fluid.global_scope())
    out["consolidated"] = scope_state(snap)
    out["local"] = scope_state(fluid.global_scope())
    return out


def comms_suite(rank, world, xs, block, jobs, feed, save_dir):
    """flat_allreduces, dp_jobs and comms_drills in one world."""
    return {"flat": flat_allreduces(rank, world, xs, block),
            "jobs": dp_jobs(rank, world, jobs),
            "drills": comms_drills(rank, world, feed, save_dir)}
