"""Run a function on W gloo ranks of the port, each its own process.

Imported by the multi-rank tests of ``paddle_tpu_torch``
(tests/test_torch_parallel.py, test_torch_comms.py,
test_torch_tensor_parallel.py, test_torch_ring_attention.py and, through
tests/torch_pipeline_ranks.py, the pipeline, MoE and LocalSGD tests); it
imports torch and the port only, never jax, so a rank starts quickly.

:func:`run_ranks` spawns W processes (``multiprocessing`` ``spawn``),
each of which joins a gloo world on a ``FileStore`` under the caller's
directory (no TCP port: the suite runs under xdist), computes on the
CPU, calls ``fn(rank, world, *args)`` and pickles what it returns. The
caller joins them with its own time limit and kills every rank on a
timeout, so a hung collective cannot hang the suite; a rank's exception
is raised in the caller with its traceback, and a rank that exits with
any code but 0 fails the call. A rank whose function returned tears its
process groups down only after every rank has returned (:func:`_leave`).
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
    store, done = None, False
    try:
        from paddle_tpu_torch.parallel import mesh

        store = dist.FileStore(os.path.join(workdir, "store"), world)
        mesh.init_group(rank=rank, world_size=world, backend="gloo",
                        device="cpu", store=store,
                        timeout=datetime.timedelta(seconds=timeout))
        result = fn(rank, world, *args)
        with open(os.path.join(workdir, "rank%d.pkl" % rank), "wb") as f:
            pickle.dump(result, f)
        done = True
    except BaseException:
        with open(os.path.join(workdir, "rank%d.err" % rank), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            _leave(store, world, done, timeout)


def _leave(store, world, done, timeout):
    """Tear this rank's process groups down only once no rank can still
    be inside a collective or a ``new_group``: a rank that closes its
    gloo pairs while a peer is still using them makes the peer fail (a
    "Connection closed by peer" in its next group), or aborts itself in
    teardown (exit -6). A rank whose `fn` finished meets the others on
    the store (files, no sockets); then its subgroups go, then the
    world; and no rank exits before every rank has destroyed its groups.
    A rank whose `fn` raised tears down at once: its peers fail in their
    next collective, and the caller reports the error."""
    wait = datetime.timedelta(seconds=timeout)

    def meet(tag):
        if store is None or not done:
            return
        if store.add("teardown/" + tag, 1) == world:
            store.set("teardown/%s/all" % tag, "1")
        store.wait(["teardown/%s/all" % tag], wait)

    meet("finished")
    world_pg = dist.group.WORLD
    for pg in list(dist.distributed_c10d._world.pg_map):
        if pg is not world_pg:
            dist.destroy_process_group(pg)
    dist.destroy_process_group()
    meet("destroyed")


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


def leave_at_once(rank, world):
    """A group over ranks 1 and 3 and the world shrunk past rank 0, made
    on every rank, then straight back: rank 0, outside the shrunk group,
    is done before the others have connected theirs."""
    from paddle_tpu_torch.parallel.mesh import (build_mesh,
                                                get_default_mesh,
                                                shrink_mesh)

    pair = build_mesh({"dp": 2}, ranks=[1, 3])
    shrunk = shrink_mesh(get_default_mesh(), dead=[0])
    return pair.rank, shrunk.rank


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


# ---------------------------------------------------------------------------
# tensor and sequence parallel, ZeRO-1 (tests/test_torch_tensor_parallel.py,
# tests/test_torch_ring_attention.py)
# ---------------------------------------------------------------------------
def tp_fc(fluid, minimize):
    """test_distributed.py::test_tp_sharded_matmul_matches_replicated's
    column-parallel fc (no training)."""
    x = fluid.data("x", [None, 16], dtype="float32")
    y = fluid.layers.fc(
        x, size=32, param_attr=fluid.ParamAttr(
            name="wt", initializer=fluid.initializer.Constant(0.03)),
        bias_attr=False)
    return None, [y]


def zero_fc(fluid, minimize):
    """test_distributed.py::test_fleet_zero_shards_optimizer_state's fc,
    Adam(0.01)."""
    x = fluid.data("zx", [None, 16], dtype="float32")
    y = fluid.layers.fc(x, size=8)
    loss = fluid.layers.reduce_mean(y)
    minimize(fluid.optimizer.Adam(learning_rate=0.01), loss)
    return loss, []


def bert_tiny_config(bert, dropout=0.0):
    return bert.BertConfig(vocab_size=128, hidden=64, num_layers=2, heads=4,
                           ffn=128, max_seq=BERT_SEQ, dropout=dropout)


def _bert(dropout, adam):
    def build(fluid, minimize):
        """BERT pretraining at 2 layers, hidden 64, 4 heads, vocab 128:
        SGD(0.5), or Adam(1e-3) (the ZeRO runs)."""
        import importlib

        bert = importlib.import_module(
            fluid.__name__.split(".")[0] + ".models.bert")
        io = bert.build_bert_pretrain(bert_tiny_config(bert, dropout),
                                      BERT_SEQ)
        opt = (fluid.optimizer.Adam(learning_rate=1e-3) if adam
               else fluid.optimizer.SGD(learning_rate=0.5))
        minimize(opt, io["loss"])
        return io["loss"], []

    return build


GPT_SEQ = 16


def gpt_lm(fluid, minimize):
    """test_gpt.py::test_gpt_trains_sharded_dp_tp's GPT (gpt_tiny, vocab
    96), Adam(5e-3)."""
    import importlib

    gpt = importlib.import_module(
        fluid.__name__.split(".")[0] + ".models.gpt")
    cfg = gpt.gpt_tiny(vocab=96, max_len=32)
    vs = gpt.build_gpt_lm(cfg, GPT_SEQ)
    minimize(fluid.optimizer.Adam(5e-3), vs["loss"])
    return vs["loss"], []


ATTN = (2, 2, 16, 8)


def attn(fluid, minimize):
    """test_distributed.py::test_fused_attention_rides_ring_under_sp_mesh's
    causal fused attention (no training)."""
    q = fluid.data("aq", list(ATTN), dtype="float32")
    k = fluid.data("ak", list(ATTN), dtype="float32")
    v = fluid.data("av", list(ATTN), dtype="float32")
    return None, [fluid.layers.fused_multihead_attention(q, k, v,
                                                         causal=True)]


def vocab_ce(fluid, minimize):
    """An embedding lookup and a tied vocabulary projection into
    softmax_with_cross_entropy (ignore_index -1), SGD(0.5): the
    vocab-parallel lookup and cross-entropy under a tp rule on the
    table."""
    ids = fluid.data("ids", [None, 6], dtype="int64")
    lab = fluid.data("lab", [None, 6, 1], dtype="int64")
    emb = fluid.layers.embedding(ids, size=[32, 8],
                                 param_attr=fluid.ParamAttr(name="vemb"))
    table = fluid.default_main_program().global_block().var("vemb")
    logits = fluid.layers.matmul(emb, table, transpose_y=True)
    loss = fluid.layers.mean(fluid.layers.softmax_with_cross_entropy(
        logits, lab, ignore_index=-1))
    minimize(fluid.optimizer.SGD(0.5), loss)
    return loss, [logits]


def fallbacks(fluid, minimize):
    """The fallback's two paths behind a column-split fc (``col.w``) and a
    row-split one (``row.w``): a value split on the dim an op reads whole
    (``softmax`` over the split columns: gathered), and a partial value
    into an op without a rule (``cumsum`` of the row-split fc's output:
    reduced). ``relu`` of the partial value reduces it in its own rule."""
    x = fluid.data("fx", [None, 8], dtype="float32")
    h = fluid.layers.fc(x, 8, bias_attr=False,
                        param_attr=fluid.ParamAttr(name="col.w"))
    s = fluid.layers.softmax(h)
    r = fluid.layers.fc(h, 8, bias_attr=False,
                        param_attr=fluid.ParamAttr(name="row.w"))
    a = fluid.layers.relu(r)
    c = fluid.layers.cumsum(r, axis=1)
    loss = fluid.layers.elementwise_add(
        fluid.layers.elementwise_add(fluid.layers.mean(s),
                                     fluid.layers.mean(a)),
        fluid.layers.mean(c))
    minimize(fluid.optimizer.SGD(0.1), loss)
    return loss, [s, a, c]


MODELS.update({"tp_fc": tp_fc, "zero_fc": zero_fc,
               "bert_tiny": _bert(0.0, False),
               "bert_tiny_drop": _bert(0.1, False),
               "bert_tiny_adam": _bert(0.0, True),
               "gpt_lm": gpt_lm, "attn": attn, "vocab_ce": vocab_ce,
               "fallbacks": fallbacks})


def layout_run(rank, world, model, feeds, params=None, mesh=None,
               rules=(), zero=False, feed_specs=None, strategy=None,
               fetch=(), save_dir=None, seed=11):
    """Build `model` in the port, run its startup on the CPU (then set
    `params`), and run one step per feed: through a DistributedProgram
    over `mesh` ({axis: size}) with the tp `rules` [(pattern, spec)], the
    ZeRO rule when `zero` and `feed_specs`; through fleet with the
    DistributedStrategy attrs `strategy`; or, with neither, the plain
    Executor (every rank alike). Returns the fetches (with the names in
    `fetch` after the model's), the global state after every step
    (``consolidated_scope``), this rank's own state shapes, the fallback
    and collective counts, and with `save_dir` the names and shapes
    ``fluid.io.save_persistables`` wrote."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import params_from_numpy
    from paddle_tpu_torch.parallel import fleet as fleet_mod
    from paddle_tpu_torch.parallel import tensor_parallel as tpl
    from paddle_tpu_torch.parallel.mesh import P, build_mesh
    from paddle_tpu_torch.parallel.sharding import (DistributedProgram,
                                                    ShardingRule)

    fresh_port_state()
    tpl.reset_counts()
    main = fluid.default_main_program()
    main.random_seed = fluid.default_startup_program().random_seed = seed
    minimize, fl = plain_minimize, None
    if strategy is not None:
        fl = fleet_mod.Fleet().init(
            fleet_mod.UserDefinedRoleMaker(rank, worker_num=world))
        s = fleet_mod.DistributedStrategy()
        for k, v in strategy.items():
            setattr(s, k, v)

        def minimize(opt, loss):
            fl.distributed_optimizer(opt, s).minimize(loss)

    loss, extra = MODELS[model](fluid, minimize)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.global_scope()
    exe.run(fluid.default_startup_program())
    for n, t in params_from_numpy(params or {}, "cpu").items():
        scope.set(n, t)
    if fl is not None:
        prog = fl.main_program
    elif mesh is not None:
        prog = DistributedProgram(
            main, build_mesh(mesh),
            param_rules=[ShardingRule(p, P(*s)) for p, s in rules],
            opt_state_rules=[ShardingRule(".*", P("dp"))] if zero else None,
            feed_specs={k: P(*v) for k, v in (feed_specs or {}).items()})
    else:
        prog = main
    fetch_list = ([loss] if loss is not None else []) + extra + list(fetch)
    out = {"fetches": [], "states": []}
    for feed in feeds:
        out["fetches"].append(exe.run(prog, feed=feed,
                                      fetch_list=fetch_list))
        snap = (prog.consolidated_scope(scope)
                if hasattr(prog, "consolidated_scope") else scope)
        out["states"].append(scope_state(snap))
    out["local_shapes"] = {n: tuple(scope[n].shape) for n in scope.keys()
                           if isinstance(scope[n], torch.Tensor)}
    out["reshards"] = dict(tpl.RESHARDS)
    out["collectives"] = {k: list(v) for k, v in tpl.COLLECTIVES.items()}
    if save_dir is not None:
        import numpy as np

        mine = os.path.join(save_dir, "rank%d" % rank)
        fluid.io.save_persistables(exe, mine, prog)
        with np.load(os.path.join(mine, "__persistables__.npz")) as f:
            out["saved"] = {n: f[n].copy() for n in f.files}
    return out


def tp_resume(rank, world, feeds, rules, save_dir):
    """BERT-tiny at tp = `world` with `rules`: one step per feed but the
    last, ``save_persistables`` (the global values), the last step; then
    a fresh scope from the startup program, ``load_persistables`` (whole
    values, cut again on the next run) and the last step through a new
    DistributedProgram. Returns both last losses and the saved shapes."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.parallel.mesh import P, build_mesh
    from paddle_tpu_torch.parallel.sharding import DistributedProgram
    from paddle_tpu_torch.parallel.sharding import ShardingRule

    fresh_port_state()
    main = fluid.default_main_program()
    main.random_seed = fluid.default_startup_program().random_seed = 11
    loss, _ = MODELS["bert_tiny"](fluid, plain_minimize)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    mesh = build_mesh({"tp": world})

    def program():
        return DistributedProgram(main, mesh, param_rules=[
            ShardingRule(p, P(*s)) for p, s in rules])

    prog = program()
    for feed in feeds[:-1]:
        exe.run(prog, feed=feed, fetch_list=[loss])
    mine = os.path.join(save_dir, "rank%d" % rank)
    fluid.io.save_persistables(exe, mine, prog)
    on = float(exe.run(prog, feed=feeds[-1], fetch_list=[loss])[0])
    fluid.executor._scope_stack[:] = [fluid.executor.Scope()]
    exe.run(fluid.default_startup_program())
    fluid.io.load_persistables(exe, mine, main)
    shapes = {n: tuple(fluid.global_scope()[n].shape)
              for n in ("enc_l0_qkv.w", "word_emb")}
    resumed = float(exe.run(program(), feed=feeds[-1],
                            fetch_list=[loss])[0])
    return {"on": on, "resumed": resumed, "loaded_shapes": shapes}


def layout_jobs(rank, world, jobs):
    """layout_run (or the function a job names under "fn") for each
    kwargs dict of `jobs`, in order."""
    out = []
    for job in jobs:
        job = dict(job)
        fn = globals()[job.pop("fn", "layout_run")]
        out.append(fn(rank, world, **job))
    return out


def ring_cases(rank, world, q, k, v, dout):
    """ring_attention_sharded over an sp axis of the whole world, causal
    and not: (out, dq, dk, dv) of sum(out * dout) for each, and whether
    the plain ring ran (it is the CPU path)."""
    from paddle_tpu_torch.parallel import ring_attention as ra
    from paddle_tpu_torch.parallel.mesh import build_mesh

    mesh = build_mesh({"sp": world})
    out = {}
    for causal in (False, True):
        leaves = [torch.from_numpy(a.copy()).requires_grad_()
                  for a in (q, k, v)]
        got = ra.ring_attention_sharded(*leaves, mesh, causal=causal)
        (got * torch.from_numpy(dout)).sum().backward()
        out[causal] = [got.detach().numpy()] + [t.grad.numpy()
                                                for t in leaves]
    return out


def ring_suite(rank, world, q, k, v, dout, jobs):
    """ring_cases, then layout_jobs with the fused attention's ring calls
    counted (a spy on ``ring_attention``)."""
    from paddle_tpu_torch.parallel import ring_attention as ra

    out = {"ring": ring_cases(rank, world, q, k, v, dout)}
    calls = []
    orig = ra.ring_attention

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    ra.ring_attention = spy
    try:
        out["jobs"] = []
        for job in jobs:
            del calls[:]
            got = layout_run(rank, world, **job)
            got["ring_calls"] = len(calls)
            out["jobs"].append(got)
    finally:
        ra.ring_attention = orig
    return out
