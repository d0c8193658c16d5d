"""Data, tensor and sequence parallel training over NCCL across every
card of one host.

    python3 chip_dp_cards.py

Starts one worker process per visible card with the reference's
environment (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, the
rendezvous at ``MASTER_ADDR=127.0.0.1`` and a free ``MASTER_PORT``), so
that ``fleet.init()`` joins the world over nccl on ``cuda:<rank>`` as a
user's launch would. The kernels are built once, by this process, before
any rank starts. Each rank trains bench.py:518's BERT-base step (vocab
30522, hidden 768, 12 layers, seq 128, ``Adam(1e-4)``, f32, dropout 0)
on its 8 rows of a global batch of 8 per card, 3 checked steps and 10
timed ones in each of ``grad_sync_mode="gspmd"`` (an all-reduce a
gradient) and ``"comms"`` int8 (4 MB buckets, error feedback). Rank 0
first runs the same steps alone on the whole global batch.

Gates: every rank's parameters bit for bit rank 0's after every step
(a broadcast over nccl); the gspmd losses within 1e-3 relative and its
parameters within 1e-3·max|param| of the one-card run; the int8 run's
last loss within 5e-3 of the gspmd run's; 12/12/12/25/25 kernel
launches a step on every rank. Prints the card stamp, each run's
median and p90 step over the timed steps (host clock, the fetch waits
for the card) and the gradient sync's median and share of the median
step, and exits non-zero on a failed gate. Needs two cards or more.

Then, on four cards, the layouts of tensor and sequence parallelism
(paddle_tpu_torch/parallel/tensor_parallel.py) in the same ranks, each
run against rank 0's one-card run of the same program (:func:`layouts`):

- BERT-base at tp = 4 with ``bert.tp_rules()`` (dropout 0.1, batch 8):
  ``word_emb`` stays whole, because 30522 % 4 != 0, as the reference's
  ``_spec_fits`` decides; losses within 1e-4 relative and parameters
  within 1e-4 of max|param| (max|a - b| over all of them, against the
  largest |value| of any);
- dp2 x tp2 with ``sharding_degree=2`` (dropout 0, 8 rows a dp rank):
  the dp gate above (1e-3);
- GPT-2-small (``GPTConfig()``) at tp = 4, seq 256, batch 8, Adam(1e-4),
  the vocab-parallel cross-entropy: 1e-4 as BERT's;
- the fused attention's ring at sp = 4 (B 1, H 12, T 8192, D 64, causal,
  f32): the output and the q/k/v gradients within 1e-4 of max of the
  one-card kernels.

Then, on four cards, item 8.5's runs (:func:`pipeline_moe`), each
against rank 0's one-card run: BERT-base through ``PipelineOptimizer``
at pp = 4 (3 layers a stage, 4 microbatches of the batch of 8) and at
dp 2 x pp 2 with ZeRO-1 moments (the batch of 16 split over dp), losses
within 1e-6 relative and parameters within 1e-4 of max|param|, each
stage launching its own layers' kernels once a microbatch; and
Switch-Base-8's expert layer (B 8, T 128, H 768, F 3072, E 8, capacity
1.25) at ep = 4, 2 experts a card, within 5e-2 of the replicated run.

Each prints its step median and p90 (the ring: forward and backward of
the program), the share of one more step spent in the collectives (each
synchronized before and after, so a rank's wait for the others counts),
and the peak memory a rank against one card's.

    python3 chip_dp_cards.py [dp] [layouts] [pp]

runs the named parts (default all three; the layouts and item 8.5's
runs need four cards).
"""
import datetime
import json
import multiprocessing
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEQ = 128
SEED = 1234
STEPS = 3                     # checked steps
TIMED = 10                    # timed steps after them
ROWS = 8                      # a rank's rows of the global batch
TOL = 1e-3
EF_GAP = 5e-3
BUCKET_BYTES = 4 << 20
WAIT = 600                    # s: the ranks' join, and a rank's collectives
PER_STEP = {"flash_attn_fwd": 12, "flash_attn_bwd_dq": 12,
            "flash_attn_bwd_dkdv": 12, "layer_norm_fwd": 25,
            "layer_norm_bwd": 25}
PARTS = ("dp", "layouts", "pp")


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.splitlines()[0]


def counters():
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_layernorm as cl

    return {"flash_attn_fwd": ca.flash_attention,
            "flash_attn_bwd_dq": ca.flash_attention_dq,
            "flash_attn_bwd_dkdv": ca.flash_attention_dkdv,
            "layer_norm_fwd": cl.layer_norm_fwd,
            "layer_norm_bwd": cl.layer_norm_bwd}


def program(fluid, cfg, seq, minimize=None):
    from paddle_tpu_torch.fluid import unique_name
    from paddle_tpu_torch.models import bert

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        io = bert.build_bert_pretrain(cfg, seq)
        opt = fluid.optimizer.Adam(learning_rate=1e-4)
        if minimize is None:
            opt.minimize(io["loss"])
        else:
            minimize(opt, io["loss"])
    main.random_seed = startup.random_seed = SEED
    return main, startup, io["loss"]


def steps(fluid, prog, feed, loss, scope, params, device, timed=0):
    """STEPS runs, then `timed` more; returns (the STEPS losses, the
    walls in s of the `timed` steps, the parameters after each of the
    STEPS)."""
    exe = fluid.Executor(fluid.CUDAPlace(device.index)
                         if device.type == "cuda" else fluid.CPUPlace())
    losses, walls, after = [], [], []
    for i in range(STEPS + timed):
        sync(device)
        t0 = time.monotonic()
        out = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        if i < STEPS:
            losses.append(float(out[0]))
            after.append({n: scope[n].clone() for n in params})
        else:
            walls.append(time.monotonic() - t0)   # the fetch waits
    return losses, walls, after


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_sync(prog, device, walls):
    """Wrap the program's gradient hook to time it (synchronized)."""
    make = prog._grad_comm

    def timed():
        hook = make()

        def run(grads):
            sync(device)
            t0 = time.monotonic()
            out = hook(grads)
            sync(device)
            walls.append(time.monotonic() - t0)
            return out
        return run

    prog._grad_comm = timed


def rank_main(rank, world, port, out_dir, cfg_kw, seq, backend, parts):
    """One rank: joins through the reference's environment and
    fleet.init(), runs the checks of `parts` ("dp", "layouts", "pp"),
    writes rank<r>.json and exits non-zero on a failed gate."""
    os.environ.update(PADDLE_TRAINER_ID=str(rank),
                      PADDLE_TRAINERS_NUM=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.distributed as dist
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import fleet, mesh

    report = {"rank": rank, "failures": []}
    try:
        if backend == "nccl":
            fl = fleet.Fleet().init()
        else:   # the CPU rehearsal: gloo ranks on the CPU
            mesh.init_group(backend="gloo", device="cpu",
                            timeout=datetime.timedelta(seconds=WAIT))
            fl = fleet.Fleet().init()
        group = mesh.get_default_mesh()
        device = group.device
        report["group"] = repr(group)
        if "dp" in parts:
            dp_runs(rank, world, fl, fleet, fluid, bert, group, device,
                    cfg_kw, seq, report)
        if "layouts" in parts and backend == "nccl" and world == 4:
            layouts(rank, world, fl, fleet, fluid, device, report)
        if "pp" in parts and world == 4:
            pipeline_moe(rank, world, fl, fleet, fluid, device, report,
                         cfg_kw, seq)
    except Exception as e:  # noqa: BLE001 — reported by the parent
        import traceback

        report["failures"].append("%s: %s\n%s" % (
            type(e).__name__, e, traceback.format_exc()))
    finally:
        with open(os.path.join(out_dir, "rank%d.json" % rank), "w") as f:
            json.dump(report, f)
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.exit(1 if report["failures"] else 0)


def dp_runs(rank, world, fl, fleet, fluid, bert, group, device, cfg_kw,
            seq, report):
    """The data-parallel runs (module docstring) in this rank."""
    cfg = bert.BertConfig(dropout=0.0, **cfg_kw)
    main, startup, loss = program(fluid, cfg, seq)
    params = sorted(p.name for p in main.all_parameters())
    init = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(device.index) if device.type == "cuda"
                   else fluid.CPUPlace()).run(startup, scope=init)
    ids, labels = bert.synthetic_batch(cfg, ROWS * world, seq, seed=SEED)
    feed = {"input_ids": ids, "mlm_labels": labels}

    def fresh():
        scope = fluid.Scope()
        for n, t in init.items():
            scope.set(n, t.clone())
        return scope

    ref = None
    if rank == 0:
        ref = steps(fluid, main, feed, loss, fresh(), params, device,
                    timed=TIMED)
        report["one_card"] = {
            "losses": ref[0], "median_ms": 1e3 * statistics.median(
                ref[1])}
    runs = {}
    for mode, strategy in (("gspmd", {}),
                           ("comms int8", {
                               "grad_sync_mode": "comms",
                               "grad_quantize": True,
                               "grad_bucket_bytes": BUCKET_BYTES})):
        s = fleet.DistributedStrategy()
        for k, v in strategy.items():
            setattr(s, k, v)
        _, _, floss = program(fluid, cfg, seq, lambda o, lo: (
            fl.distributed_optimizer(o, s).minimize(lo)))
        prog = fl.main_program
        comm = []
        timed_sync(prog, device, comm)
        fns = counters()
        for fn in fns.values():
            fn.launches = 0
        losses, walls, after = steps(fluid, prog, feed, floss, fresh(),
                                     params, device, timed=TIMED)
        launches = {n: fn.launches for n, fn in fns.items()}
        comm = comm[STEPS:]
        for i, a in enumerate(after):
            flat = torch.cat([a[n].reshape(-1) for n in params])
            if not torch.equal(flat, group.broadcast(flat, root=0)):
                report["failures"].append(
                    "%s: rank %d's parameters differ from rank 0's "
                    "after step %d" % (mode, rank, i))
        if device.type == "cuda" and any(
                launches[n] != PER_STEP[n] * (STEPS + TIMED)
                for n in PER_STEP):
            report["failures"].append("%s: launches %s, want %s a step"
                                      % (mode, launches, PER_STEP))
        med = statistics.median(walls)
        report[mode] = {"losses": losses,
                        "median_ms": 1e3 * med,
                        "p90_ms": 1e3 * sorted(walls)[
                            int(0.9 * (len(walls) - 1))],
                        "sync_median_ms": 1e3 * statistics.median(comm),
                        "sync_share": statistics.median(comm) / med,
                        "launches": launches}
        runs[mode] = (losses, after[-1])
    if rank == 0:
        g_losses, g_after = runs["gspmd"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(g_losses, ref[0]))
        far = max(float((g_after[n] - ref[2][-1][n]).abs().max())
                  / max(float(ref[2][-1][n].abs().max()), 1e-30)
                  for n in params)
        gap = abs(runs["comms int8"][0][-1] - g_losses[-1])
        report.update(loss_rel=rel, param_dist=far, int8_gap=gap)
        if rel > TOL or far > TOL:
            report["failures"].append(
                "gspmd vs one card: losses rel %.3e, parameters %.3e "
                "of max (bound %g)" % (rel, far, TOL))
        if gap > EF_GAP:
            report["failures"].append(
                "comms int8's last loss %.3e from gspmd's (bound %g)"
                % (gap, EF_GAP))


TP_TOL = 1e-4
GPT_SEQ = 256
RING = (1, 12, 8192, 64)


def collective_share(run_step, device):
    """(the step's wall in s, the wall spent in collectives) over one step
    whose every collective of the rank group, and every pass of the
    ring, is synchronized before and after: the time a rank waits in
    them, the other ranks' lateness included."""
    from paddle_tpu_torch.parallel import ring_attention as ra
    from paddle_tpu_torch.parallel.mesh import RankGroup

    spent = [0.0]
    depth = [0]

    def timed(fn):
        def run(*a, **kw):
            if depth[0]:        # inside a timed collective already
                return fn(*a, **kw)
            depth[0] += 1
            sync(device)
            t0 = time.monotonic()
            try:
                return fn(*a, **kw)
            finally:
                sync(device)
                spent[0] += time.monotonic() - t0
                depth[0] -= 1
        return run

    from paddle_tpu_torch.parallel.pipeline import Ring

    # all_gather and ppermute go through stack
    names = ("all_reduce", "stack", "broadcast", "reduce_scatter",
             "all_to_all")
    saved = {n: getattr(RankGroup, n) for n in names}
    saved_pass, saved_move = ra.ring_pass, Ring._move
    for n in names:
        setattr(RankGroup, n, timed(saved[n]))
    ra.ring_pass = timed(saved_pass)
    Ring._move = timed(saved_move)
    try:
        sync(device)
        t0 = time.monotonic()
        run_step()
        sync(device)
        wall = time.monotonic() - t0
    finally:
        for n in names:
            setattr(RankGroup, n, saved[n])
        ra.ring_pass, Ring._move = saved_pass, saved_move
    return wall, spent[0]


def far(after, ref, params):
    """(max over `params` of max|a - b| over the largest |value| of any of
    them, i.e. "within x of max|param|"; the worst parameter by parameter
    of max|a - b| / max|b|, and where)."""
    diff = top = 0.0
    worst = (-1.0, "")
    for n in params:
        d = float((after[n].float() - ref[n].float()).abs().max())
        m = float(ref[n].float().abs().max())
        diff, top = max(diff, d), max(top, m)
        worst = max(worst, (d / max(m, 1e-30), n))
    return diff / top, worst


def measure(fluid, device, prog, startup, loss, feed, params):
    """STEPS checked steps then TIMED timed ones and one more whose
    collectives are timed, from `startup`'s values; returns (losses, the
    parameters after the checked steps (global), the record)."""
    from paddle_tpu_torch.parallel import tensor_parallel as tpl

    place = fluid.CUDAPlace(device.index) if device.type == "cuda" \
        else fluid.CPUPlace()
    scope = fluid.Scope()
    fluid.Executor(place).run(startup, scope=scope)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tpl.reset_counts()
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    exe = fluid.Executor(place)
    losses, walls = [], []
    for i in range(STEPS + TIMED):
        sync(device)
        t0 = time.monotonic()
        out = exe.run(prog, feed=feed, fetch_list=[loss], scope=scope)
        if i >= STEPS:
            walls.append(time.monotonic() - t0)
            continue
        losses.append(float(out[0]))
        if i == STEPS - 1:      # the parameters after the checked steps
            # a PipelineOptimizer program keeps its rank's runner on it
            holder = getattr(prog, "_parallel_info", {}).get(
                "_runner") or prog
            snap = (holder.consolidated_scope(scope)
                    if hasattr(holder, "consolidated_scope") else scope)
            after = {n: snap[n].clone() for n in params}
            del snap
    wall, coll = collective_share(lambda: exe.run(
        prog, feed=feed, fetch_list=[loss], scope=scope), device)
    rec = {"losses": losses,
           "median_ms": 1e3 * statistics.median(walls),
           "p90_ms": 1e3 * sorted(walls)[int(0.9 * (len(walls) - 1))],
           "synced_step_ms": 1e3 * wall, "collectives_ms": 1e3 * coll,
           "collective_share": coll / wall,
           "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                        if device.type == "cuda" else 0.0),
           "launches": {n: fn.launches for n, fn in fns.items()},
           "fallbacks": {"%s/%s" % k: v
                         for k, v in sorted(tpl.RESHARDS.items())},
           "word_emb_rows": tuple(scope["word_emb"].shape)[0]
           if "word_emb" in scope.keys() else None}
    return losses, after, rec


def layouts(rank, world, fl, fleet, fluid, device, report):
    """The four-card layout runs (module docstring) in this rank."""
    from paddle_tpu_torch.models import bert, gpt
    from paddle_tpu_torch.parallel import ring_attention as ra
    from paddle_tpu_torch.parallel.mesh import build_mesh
    from paddle_tpu_torch.parallel.sharding import DistributedProgram

    place = fluid.CUDAPlace(device.index)

    def bert_prog(dropout, minimize=None):
        cfg = bert.BertConfig(dropout=dropout)
        main, startup, loss = program(fluid, cfg, SEQ, minimize)
        return main, startup, loss

    def gpt_prog(minimize=None):
        from paddle_tpu_torch.fluid import unique_name

        main, startup = fluid.Program(), fluid.Program()
        with unique_name.guard(), fluid.program_guard(main, startup):
            vs = gpt.build_gpt_lm(gpt.GPTConfig(), GPT_SEQ)
            opt = fluid.optimizer.Adam(learning_rate=1e-4)
            if minimize is None:
                opt.minimize(vs["loss"])
            else:
                minimize(opt, vs["loss"])
        main.random_seed = startup.random_seed = SEED
        return main, startup, vs["loss"]

    def fleet_run(tag, build, feed, strategy):
        s = fleet.DistributedStrategy()
        for k, v in strategy.items():
            setattr(s, k, v)
        main, startup, loss = build(lambda o, lo: (
            fl.distributed_optimizer(o, s).minimize(lo)))
        params = sorted(p.name for p in main.all_parameters())
        return measure(fluid, device, fl.main_program, startup, loss,
                       feed, params)

    def one_card(build, feed):
        if rank != 0:
            return None
        main, startup, loss = build()
        params = sorted(p.name for p in main.all_parameters())
        return measure(fluid, device, main, startup, loss, feed, params)

    def gate(tag, got, ref, tol):
        rec = got[2]
        report[tag] = rec
        if rank != 0:
            return
        rel = max(abs(a - b) / abs(b) for a, b in zip(got[0], ref[0]))
        dist_p, (own, at) = far(got[1], ref[1], sorted(ref[1]))
        rec.update(one_card=ref[2], loss_rel=rel, param_dist=dist_p,
                   param_own_worst=own, param_own_worst_at=at,
                   peak_vs_one_card=rec["peak_gib"] / ref[2]["peak_gib"])
        if rel > tol or dist_p > tol:
            report["failures"].append(
                "%s vs one card: losses rel %.3e, parameters %.3e of "
                "max|param| (bound %g)" % (tag, rel, dist_p, tol))

    brules = list(bert.tp_rules())
    cfg = bert.BertConfig()
    ids, labels = bert.synthetic_batch(cfg, ROWS, SEQ, seed=SEED)
    feed = {"input_ids": ids, "mlm_labels": labels}
    ref = one_card(lambda m=None: bert_prog(0.1, m), feed)
    got = fleet_run("bert tp=4", lambda m: bert_prog(0.1, m), feed,
                    {"tensor_parallel_degree": world,
                     "tensor_parallel_rules": brules})
    gate("bert tp=4", got, ref, TP_TOL)
    if got[2]["word_emb_rows"] != cfg.vocab_size:
        report["failures"].append("bert tp=4: word_emb split")

    ids, labels = bert.synthetic_batch(cfg, ROWS * 2, SEQ, seed=SEED)
    feed = {"input_ids": ids, "mlm_labels": labels}
    ref = one_card(lambda m=None: bert_prog(0.0, m), feed)
    got = fleet_run("bert dp2 x tp2 + ZeRO-1", lambda m: bert_prog(0.0, m),
                    feed, {"tensor_parallel_degree": 2,
                           "tensor_parallel_rules": brules,
                           "sharding_degree": 2})
    gate("bert dp2 x tp2 + ZeRO-1", got, ref, TOL)

    gcfg = gpt.GPTConfig()
    ids, labels = gpt.synthetic_lm_batch(gcfg, ROWS, GPT_SEQ, seed=SEED)
    feed = {"gpt_ids": ids, "gpt_labels": labels}
    ref = one_card(gpt_prog, feed)
    got = fleet_run("gpt-2-small tp=4", gpt_prog, feed,
                    {"tensor_parallel_degree": world,
                     "tensor_parallel_rules": list(gpt.tp_rules())})
    gate("gpt-2-small tp=4", got, ref, TP_TOL)

    # the ring: q/k/v parameters, loss sum(out * dout)
    from paddle_tpu_torch.fluid import unique_name

    main, startup = fluid.Program(), fluid.Program()
    with unique_name.guard(), fluid.program_guard(main, startup):
        q, k, v = (fluid.layers.create_parameter(list(RING), "float32",
                                                 name=n)
                   for n in ("rq", "rk", "rv"))
        dout = fluid.data("rdout", list(RING), dtype="float32")
        out = fluid.layers.fused_multihead_attention(q, k, v, causal=True)
        loss = fluid.layers.reduce_sum(fluid.layers.elementwise_mul(out,
                                                                    dout))
        grads = [g for _, g in fluid.backward.append_backward(loss)]
    gen = torch.Generator(device=device).manual_seed(SEED)
    vals = {n: torch.randn(RING, device=device, generator=gen)
            for n in ("rq", "rk", "rv", "rdout")}

    def ring_run(prog):
        scope = fluid.Scope()
        for n in ("rq", "rk", "rv"):
            scope.set(n, vals[n].clone())
        exe = fluid.Executor(place)
        torch.cuda.reset_peak_memory_stats(device)
        walls, got = [], None
        for i in range(STEPS + TIMED):
            sync(device)
            t0 = time.monotonic()
            got = exe.run(prog, feed={"rdout": vals["rdout"]},
                          fetch_list=[out] + grads, scope=scope,
                          return_numpy=False)
            sync(device)
            if i >= STEPS:
                walls.append(time.monotonic() - t0)
        wall, coll = collective_share(lambda: exe.run(
            prog, feed={"rdout": vals["rdout"]}, fetch_list=[out] + grads,
            scope=scope, return_numpy=False), device)
        return got, {"median_ms": 1e3 * statistics.median(walls),
                     "p90_ms": 1e3 * sorted(walls)[
                         int(0.9 * (len(walls) - 1))],
                     "synced_step_ms": 1e3 * wall,
                     "collectives_ms": 1e3 * coll,
                     "collective_share": coll / wall,
                     "peak_gib": torch.cuda.max_memory_allocated(device)
                     / 2 ** 30}

    want = ring_run(main) if rank == 0 else None
    before = ra.RingFlash.launches
    got, rec = ring_run(DistributedProgram(main, build_mesh({"sp": world})))
    rec["ring_runs"] = ra.RingFlash.launches - before
    report["ring sp=4"] = rec
    if rec["ring_runs"] != STEPS + TIMED + 1:
        report["failures"].append("ring sp=4: the ring ran %d times"
                                  % rec["ring_runs"])
    if rank == 0:
        errs = [float((a - b).abs().max()) / float(b.abs().max())
                for a, b in zip(got, want[0])]
        rec.update(one_card=want[1], errs=errs,
                   peak_vs_one_card=rec["peak_gib"] / want[1]["peak_gib"])
        if max(errs) > TP_TOL:
            report["failures"].append(
                "ring sp=4: out and grads %s of max (bound %g)"
                % (errs, TP_TOL))


PP_TOL = 1e-6              # losses relative, pipeline against one card
MOE = dict(B=8, T=128, H=768, F=3072, E=8)     # Switch-Base-8's expert layer
MOE_CAP = 1.25
MOE_RTOL = 5e-2            # ep against the replicated run (test_moe.py)


def layer_out(program, i):
    """The name of BERT encoder layer i's output: a pipeline cut."""
    for op in program.global_block().ops:
        if op.type == "layer_norm" and op.input("Scale") == [
                "enc_l%d_ln2.w" % i]:
            return op.output("Y")[0]
    raise KeyError("no encoder layer %d" % i)


def pipeline_moe(rank, world, fl, fleet, fluid, device, report, cfg_kw,
                 seq):
    """The four-card runs of item 8.5 in this rank, each against rank 0's
    one-card run: BERT-base through PipelineOptimizer at pp = 4 (3 layers
    a stage, 4 microbatches of the batch of 8) and at dp 2 x pp 2 with
    ZeRO-1 moments (the batch of 16 split over dp), losses within 1e-6
    relative and parameters within 1e-4 of max|param|, each stage's
    launches its own layers' kernels once a microbatch; and Switch-Base-8's
    expert layer at ep = 4 (2 experts a card) within 5e-2 relative of the
    replicated run."""
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel import moe
    from paddle_tpu_torch.parallel.mesh import P, build_mesh
    from paddle_tpu_torch.parallel.sharding import (DistributedProgram,
                                                    ShardingRule)

    cfg = bert.BertConfig(dropout=0.0, **cfg_kw)

    def one_card(build, feed):
        if rank != 0:
            return None
        main, startup, loss = build()
        params = sorted(p.name for p in main.all_parameters())
        return measure(fluid, device, main, startup, loss, feed, params)

    def stage_launches(main, steps):
        runner = main._parallel_info["_runner"]
        plan = runner._stage_plan()
        lo, hi = plan["spans"][runner._pp.rank]
        types = [op.type for op in plan["region"][lo:hi]]
        micro = main._parallel_info["n_microbatches"]
        att = types.count("fused_multihead_attention") * micro * steps
        ln = types.count("layer_norm") * micro * steps
        return {"flash_attn_fwd": att, "flash_attn_bwd_dq": att,
                "flash_attn_bwd_dkdv": att, "layer_norm_fwd": ln,
                "layer_norm_bwd": ln}

    def pipeline(tag, cuts, rows, mesh=None, dp=False):
        ids, labels = bert.synthetic_batch(cfg, rows, seq, seed=SEED)
        feed = {"input_ids": ids, "mlm_labels": labels}

        def minimize(opt, loss):
            main = loss.block.program
            fluid.optimizer.PipelineOptimizer(
                opt, cut_list=[layer_out(main, i) for i in cuts],
                num_microbatches=4, mesh=mesh,
                feed_specs=({k: P("dp", None) for k in feed} if dp
                            else None),
                opt_state_rules=([ShardingRule(r"moment", P("dp"))] if dp
                                 else None)).minimize(loss)

        ref = one_card(lambda: program(fluid, cfg, seq), feed)
        main, startup, loss = program(fluid, cfg, seq, minimize)
        params = sorted(p.name for p in main.all_parameters())
        got = measure(fluid, device, main, startup, loss, feed, params)
        rec = got[2]
        rec["ring_bytes_a_step"] = main._parallel_info[
            "_runner"].last_step["ring_bytes"]
        report[tag] = rec
        want = stage_launches(main, STEPS + TIMED + 1)
        if device.type == "cuda" and rec["launches"] != want:
            report["failures"].append("%s: launches %s, want %s" % (
                tag, rec["launches"], want))
        if rank == 0:
            rel = max(abs(a - b) / abs(b) for a, b in zip(got[0], ref[0]))
            dist_p, (own, at) = far(got[1], ref[1], params)
            rec.update(one_card=ref[2], loss_rel=rel, param_dist=dist_p,
                       param_own_worst=own, param_own_worst_at=at,
                       peak_vs_one_card=(rec["peak_gib"] /
                                         max(ref[2]["peak_gib"], 1e-30)))
            if rel > PP_TOL or dist_p > TP_TOL:
                report["failures"].append(
                    "%s vs one card: losses rel %.3e (bound %g), parameters "
                    "%.3e of max|param| (bound %g)" % (
                        tag, rel, PP_TOL, dist_p, TP_TOL))

    pipeline("bert pp=4", (2, 5, 8), ROWS)
    pipeline("bert dp2 x pp2 + ZeRO-1", (5,), ROWS * 2,
             mesh=build_mesh({"dp": 2, "pp": 2}), dp=True)

    shape = MOE if not cfg_kw else dict(B=2, T=16, H=cfg.hidden, F=128, E=8)

    def moe_prog():
        from paddle_tpu_torch.fluid import unique_name

        main, startup = fluid.Program(), fluid.Program()
        with unique_name.guard(), fluid.program_guard(main, startup):
            x = fluid.data("moe_x", [shape["B"], shape["T"], shape["H"]],
                           dtype="float32")
            y, aux = moe.switch_ffn(x, shape["E"], shape["F"],
                                    capacity_factor=MOE_CAP, name="moe")
            lbl = fluid.data("moe_lbl", [shape["B"], shape["T"],
                                         shape["H"]], dtype="float32")
            loss = fluid.layers.elementwise_add(
                fluid.layers.reduce_mean(
                    fluid.layers.square_error_cost(y, lbl)),
                fluid.layers.scale(aux, scale=0.01))
            fluid.optimizer.Adam(5e-3).minimize(loss)
        main.random_seed = startup.random_seed = SEED
        return main, startup, loss

    xv = np.random.default_rng(SEED).standard_normal(
        (shape["B"], shape["T"], shape["H"])).astype("float32")
    feed = {"moe_x": xv, "moe_lbl": np.tanh(xv)[:, :, ::-1].copy()}
    ref = one_card(moe_prog, feed)
    main, startup, loss = moe_prog()
    params = sorted(p.name for p in main.all_parameters())
    prog = DistributedProgram(main, build_mesh({"ep": world}), param_rules=[
        ShardingRule(p, s) for p, s in moe.moe_ep_rules("moe")])
    got = measure(fluid, device, prog, startup, loss, feed, params)
    rec = got[2]
    report["switch-base-8 ep=4"] = rec
    if any(rec["launches"].values()):
        report["failures"].append("ep=4: kernel launches %s" % rec[
            "launches"])
    if rank == 0:
        rel = max(abs(a - b) / abs(b) for a, b in zip(got[0], ref[0]))
        rec.update(one_card=ref[2], loss_rel=rel,
                   peak_vs_one_card=(rec["peak_gib"] /
                                     max(ref[2]["peak_gib"], 1e-30)))
        if rel > MOE_RTOL:
            report["failures"].append(
                "switch-base-8 ep=4 vs replicated: losses rel %.3e (bound "
                "%g)" % (rel, MOE_RTOL))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(world, backend="nccl", cfg_kw=None, seq=SEQ, parts=PARTS):
    """Spawn `world` ranks (BERT-base, or BertConfig(**cfg_kw) at `seq`
    for a rehearsal on the CPU over gloo) for the runs of `parts`;
    returns their reports in rank order."""
    out_dir = tempfile.mkdtemp()
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(
        rank, world, port, out_dir, cfg_kw or {}, seq, backend, parts))
        for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + WAIT
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(30)
    reports = []
    for rank in range(world):
        path = os.path.join(out_dir, "rank%d.json" % rank)
        reports.append(json.load(open(path)) if os.path.exists(path)
                       else {"rank": rank, "failures": ["no report"]})
    if hung:
        reports[0]["failures"].append("ranks %s hung: killed" % hung)
    return reports


def main():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("FAIL: this run needs two CUDA cards or more")
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.ops import cuda_build

    world = torch.cuda.device_count()
    parts = tuple(sys.argv[1:]) or PARTS
    card = card_line()
    print("torch %s, CUDA %s; %d x %s" % (torch.__version__,
                                         torch.version.cuda, world, card))
    t0 = time.monotonic()
    cuda_build.build_all()
    print("kernels built in %.1f s" % (time.monotonic() - t0), flush=True)
    t0 = time.monotonic()
    reports = run(world, parts=parts)
    for r in reports:
        print(json.dumps(r))
    failures = [f for r in reports for f in r["failures"]]
    print("%d ranks over nccl [%s] took %.1f s" % (
        world, card, time.monotonic() - t0))
    if failures:
        print("FAIL: " + "; ".join(failures))
        sys.exit(1)
    print("ok")


if __name__ == "__main__":
    main()
