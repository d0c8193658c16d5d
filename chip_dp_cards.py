"""Data-parallel BERT-base over NCCL across every card of one host.

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


def rank_main(rank, world, port, out_dir, cfg_kw, seq, backend):
    """One rank: joins through the reference's environment and
    fleet.init(), runs the checks, writes rank<r>.json and exits non-zero
    on a failed gate."""
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


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(world, backend="nccl", cfg_kw=None, seq=SEQ):
    """Spawn `world` ranks (BERT-base, or BertConfig(**cfg_kw) at `seq`
    for a rehearsal on the CPU over gloo); returns their reports in rank
    order."""
    out_dir = tempfile.mkdtemp()
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=rank_main, args=(
        rank, world, port, out_dir, cfg_kw or {}, seq, backend))
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
    card = card_line()
    print("torch %s, CUDA %s; %d x %s" % (torch.__version__,
                                         torch.version.cuda, world, card))
    t0 = time.monotonic()
    cuda_build.build_all()
    print("kernels built in %.1f s" % (time.monotonic() - t0), flush=True)
    t0 = time.monotonic()
    reports = run(world)
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
