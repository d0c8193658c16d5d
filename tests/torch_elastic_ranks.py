"""Gloo ranks of the port that lose one of their number for real.

Imported by tests/test_torch_elastic_guard.py. It imports torch and the
port only, never jax, so a rank starts quickly.

:func:`run_with_a_victim` spawns W processes (``multiprocessing``
``spawn``) on a gloo world over a ``FileStore`` under the caller's
directory, as tests/torch_ranks.py does, but one rank, the victim, ends
its process in the middle of ``fn`` (``os._exit``: no teardown, no
goodbye). Its peers cannot meet it at teardown, and a gloo collective
over the old world would wait for it, so every rank here ends with
``os._exit`` too, after the survivors have met on the store: nothing
destroys a group that still names the dead rank. The caller joins the
processes with its own time limit and kills every rank on a timeout.
"""
import datetime
import multiprocessing as mp
import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

VICTIM_EXIT = 17


def run_with_a_victim(fn, world, victim, workdir, args=(), timeout=120.0):
    """({rank: fn(rank, world, victim, *args)} of the survivors, the
    victim's exit code). `workdir` must be a fresh directory."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, rank, world, victim, workdir, args,
                               timeout), daemon=True)
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
    bad = [(r, p.exitcode) for r, p in enumerate(procs)
           if r != victim and p.exitcode]
    if bad:
        raise RuntimeError("ranks exited with %s" % bad)
    out = {}
    for rank in range(world):
        if rank == victim:
            continue
        with open(os.path.join(workdir, "rank%d.pkl" % rank), "rb") as f:
            out[rank] = pickle.load(f)
    return out, procs[victim].exitcode


def _rank_main(fn, rank, world, victim, workdir, args, timeout):
    torch.set_num_threads(1)
    code = 1
    try:
        from paddle_tpu_torch.parallel import mesh

        store = dist.FileStore(os.path.join(workdir, "store"), world)
        mesh.init_group(rank=rank, world_size=world, backend="gloo",
                        device="cpu", store=store,
                        timeout=datetime.timedelta(seconds=timeout))
        result = fn(rank, world, victim, workdir, *args)
        with open(os.path.join(workdir, "rank%d.pkl" % rank), "wb") as f:
            pickle.dump(result, f)
        # the survivors meet here; then no one uses a group again
        n = world - 1
        if store.add("survivors/done", 1) == n:
            store.set("survivors/all", "1")
        store.wait(["survivors/all"], datetime.timedelta(seconds=timeout))
        code = 0
    except BaseException:
        with open(os.path.join(workdir, "rank%d.err" % rank), "w") as f:
            f.write(traceback.format_exc())
    finally:
        os._exit(code)


def lsgd_shrink(rank, world, victim, workdir, feeds, steps_before):
    """LocalSGD (k = 1) over every rank for `steps_before` steps, each
    rank beating on a heartbeat FileStore; then the victim's process
    ends. The survivors see it die (missed beats), check the refusals
    of ``shrink_dp``, shrink the program's rank group to themselves and
    take one step on ``feeds[-1]``, split over the survivors alone."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.parallel import elastic as E
    from paddle_tpu_torch.parallel import fleet as fleet_mod

    import torch_ranks as tr

    tr.fresh_port_state()
    main = fluid.default_main_program()
    main.random_seed = fluid.default_startup_program().random_seed = 11
    fl = fleet_mod.Fleet().init(
        fleet_mod.UserDefinedRoleMaker(rank, worker_num=world))
    s = fleet_mod.DistributedStrategy()
    s.use_local_sgd = True
    s.local_sgd_k_steps = 1

    def minimize(opt, loss):
        fl.distributed_optimizer(opt, s).minimize(loss)

    loss, _ = tr.regression(fluid, minimize)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.global_scope()
    exe.run(fluid.default_startup_program())
    prog = fl.main_program
    cfg = E.ElasticConfig(heartbeat_interval=0.05, miss_threshold=4,
                          startup_grace=60.0)
    mon = E.HeartbeatMonitor(E.FileStore(os.path.join(workdir, "hb")),
                             rank, world, config=cfg)
    losses = []
    for i in range(steps_before):
        mon.beat(i + 1)
        losses.append(float(exe.run(prog, feed=feeds[i],
                                    fetch_list=[loss])[0]))
    mon.beat(steps_before)
    if rank == victim:
        os._exit(VICTIM_EXIT)
    deadline = time.monotonic() + 60.0
    while victim not in mon.dead_peers():
        if time.monotonic() > deadline:
            raise TimeoutError("the victim never went silent")
        mon.keepalive()
        time.sleep(cfg.heartbeat_interval / 2)
    refusals = []
    for keep in ([0], [0, 11]):
        try:
            prog.shrink_dp(scope, keep)
        except ValueError as e:
            refusals.append(str(e))
    size_after_refusals = prog._mesh.size
    keep = [r for r in range(world) if r != victim]
    group = prog.shrink_dp(scope, keep)
    before = tr.scope_state(scope)
    last = exe.run(prog, feed=feeds[-1], fetch_list=[loss])[0]
    return {"losses": losses, "refusals": refusals,
            "size_after_refusals": size_after_refusals,
            "group": (group.ranks, group.rank, group.size),
            "sum_of_ones": float(group.all_reduce(torch.ones(1))[0]),
            "before": before, "after": tr.scope_state(scope),
            "last_loss": float(np.asarray(last))}


def _recording(guard, losses):
    """Have `guard` (a TrainGuard or a FleetGuard) append each step's
    loss to `losses`."""
    run = guard.guard.run

    def rec(*a, **kw):
        report = run(*a, **kw)
        losses.append(float(np.asarray(report[0])))
        return report

    guard.guard.run = rec
    return guard


def guard_resume(rank, world, case, workdir, steps=5):
    """BERT-tiny (Adam, dropout 0) over a DistributedProgram of the whole
    world with split state: case "tp" (tp = `world`, the model's tp
    rules) or "zero" (dp = `world`, ZeRO-1 moments). From one set of
    startup values: run U, ``steps`` steps under a TrainGuard with no
    checkpoints; run C, a TrainGuard with ``save_every=2`` whose second
    save fails (an injected OSError on every rank) in the directory the
    ranks share, then a second TrainGuard on C's executor and scope that
    resumes; run F, the same crash and resume under a one-member
    FleetGuard in a directory of the rank's own. Returns each run's
    losses, the consolidated state after each run, what the shared
    directory holds and the shapes of its first step, and the refusal of
    a two-member FleetGuard's shrink (the program's group cannot be
    rebuilt without the dead rank). Case "stacked"
    (a GradSyncProgram, whose ranks keep state of their own) returns the
    refusal of a TrainGuard with a checkpoint directory."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import resilience as R
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import checkpoint as ckpt
    from paddle_tpu_torch.parallel import elastic as E
    from paddle_tpu_torch.parallel.comms.grad_sync import GradSyncProgram
    from paddle_tpu_torch.parallel.mesh import P, build_mesh
    from paddle_tpu_torch.parallel.sharding import (DistributedProgram,
                                                    ShardingRule)

    import torch_ranks as tr

    tr.fresh_port_state()
    main = fluid.default_main_program()
    main.random_seed = fluid.default_startup_program().random_seed = 11
    loss, _ = tr.MODELS["bert_tiny_adam"](fluid, tr.plain_minimize)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    init = tr.scope_state(fluid.global_scope())
    cfg = tr.bert_tiny_config(bert)
    feeds = [dict(zip(("input_ids", "mlm_labels"), bert.synthetic_batch(
        cfg, 4, tr.BERT_SEQ, seed=s))) for s in range(steps)]

    def feed_fn(step, guard=None):
        return feeds[step - 1]

    def fresh():
        scope = fluid.Scope()
        for n, v in init.items():
            scope.set(n, torch.from_numpy(v.copy()))
        if case == "tp":
            prog = DistributedProgram(
                main, build_mesh({"tp": world}),
                param_rules=[ShardingRule(p, s) for p, s in bert.tp_rules()])
        elif case == "zero":
            prog = DistributedProgram(
                main, build_mesh({"dp": world}),
                opt_state_rules=[ShardingRule(".*", P("dp"))])
        else:
            prog = GradSyncProgram(main, build_mesh({"dp": world}))
        return prog, scope

    def guard(prog, scope, ckpt_dir, losses):
        return _recording(R.TrainGuard(
            exe, program=prog, ckpt_dir=ckpt_dir, fetch_list=[loss],
            feed_fn=feed_fn, save_every=2, scope=scope), losses)

    shared = os.path.join(workdir, "shared")
    if case == "stacked":
        prog, scope = fresh()
        try:
            guard(prog, scope, shared, []).train(steps)
        except NotImplementedError as e:
            return {"refusal": str(e), "wrote": os.path.exists(shared)}
        return {"refusal": None}

    out = {"U_losses": []}
    prog, scope = fresh()
    guard(prog, scope, None, out["U_losses"]).train(steps)
    out["U_state"] = tr.scope_state(prog.consolidated_scope(scope))

    prog, scope = fresh()
    out["C_losses"] = losses_c = []
    R.FaultInjector.install("save:at=2:OSError")
    try:
        guard(prog, scope, shared, losses_c).train(steps)
        out["C_error"] = None
    except OSError as e:
        out["C_error"] = str(e)
    finally:
        R.FaultInjector.uninstall()
    out["C_latest"] = ckpt.latest_step(shared)
    out["C_listing"] = sorted(os.listdir(shared))
    out["C_step2_shapes"] = {
        n: tuple(v.shape)
        for n, v in ckpt.load_checkpoint(shared, step=2).items()}
    out["R_losses"] = losses_r = []
    summary = guard(prog, scope, shared, losses_r).train(steps)
    out["R"] = (summary["resumed_from"], summary["first_step"],
                summary["final_step"])
    out["R_state"] = tr.scope_state(prog.consolidated_scope(scope))
    out["split"] = sorted(
        n for n in scope.keys() if isinstance(scope[n], torch.Tensor)
        and tuple(scope[n].shape) != out["U_state"][n].shape)

    own = os.path.join(workdir, "fleet%d" % rank)
    prog, scope = fresh()
    out["F_losses"] = losses_f = []

    def fleet_guard():
        return _recording(E.FleetGuard(
            exe, program=prog, worker_index=0, world_size=1,
            ckpt_dir=own, fetch_list=[loss], feed_fn=feed_fn, scope=scope,
            save_every=2), losses_f)

    R.FaultInjector.install("save:at=2:OSError")
    try:
        fleet_guard().train(steps)
        out["F_error"] = None
    except OSError as e:
        out["F_error"] = str(e)
    finally:
        R.FaultInjector.uninstall()
    out["F_step2_shapes"] = {
        n: tuple(v.shape) for n, v in ckpt.load_checkpoint(
            ckpt.worker_dir(own, 0), step=2).items()}
    summary = fleet_guard().train(steps)
    out["F"] = (summary["resumed_from"], summary["final_step"])
    out["F_state"] = tr.scope_state(prog.consolidated_scope(scope))
    two = E.FleetGuard(exe, program=prog, worker_index=0, world_size=2,
                       scope=scope)
    try:
        two.shrink({1})
        out["shrink_refusal"] = None
    except RuntimeError as e:
        out["shrink_refusal"] = (str(e), two.generation,
                                 sorted(two.members))
    return out
