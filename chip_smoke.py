"""Smoke run of paddle_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device stamp: torch/CUDA/nvcc versions, card name and power limit;
2. build every CUDA kernel of the port from ``paddle_tpu_torch/csrc``
   (one nvcc per source, all at once); print each kernel's registers and
   spills from ptxas, and the three attention kernels' blocks per SM;
3. each kernel against its plain torch version on the card, f32 and bf16,
   within the stated bounds, at the serving and training paths' shapes:
   attention (8, 12, 128, 64) plain, causal, with a key-padding mask (and
   its gradient), T = 131 and dropout p = 0.1, then head dims 128 and 40
   and Tq = 128 with Tk = 96 and a mask, forward and backward (the bf16
   forward also against the plain version on the same bf16 inputs, which
   rounds P before P·V as the kernel does); LayerNorm forward at
   (1024, 768) and (1000, 768); LayerNorm backward at those, h = 770
   (no 16-byte loads), no gamma, bf16 x with f32 gamma, n = 1,
   (8192, 1024), (256, 4096) and (4, 30000), each launched twice and
   required to give the same bits;
4. the serving slice at full width: BERT-base (seq 128, random weights
   from a seed) saved, reloaded through ``Predictor.from_model`` and served
   by ``ServingEngine`` to 16 requests from 4 threads, in f32 and in the
   bfloat16 policy; the launch counters must show every dispatch went
   through both forward kernels (12 attention and 25 LayerNorm launches
   per forward), rows must match solo runs, and logits must match the same
   port run on the CPU;
5. the training slice: BERT-base width at depth 2 (batch 2, dropout 0)
   trained 3 Adam steps on the card and on the CPU from the same
   parameters (losses and step-1 gradients must agree); then full
   BERT-base (12 layers, dropout 0.1, batch 8, seq 128, Adam 1e-4) trained
   23 steps through ``Executor.run`` on one fixed batch: finite, falling
   loss, and 12 attention forward, 12 dQ, 12 dK/dV, 25 LayerNorm forward
   and 25 LayerNorm backward launches per step; step time, tokens/s,
   peak memory and a profile of one step;
   The profiles of one serving forward and one training step come after
   every timed phase: a torch.profiler session leaves the host slower for
   the rest of the process;
6. times: each kernel, its plain version and the PyTorch library call
   (timed here only, never used by the port) with CUDA events, the least
   time the card could take, and serving requests/s and latency; then the
   device kernels the library's attention backward runs (torch.profiler).

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 1234
SEQ = 128
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense
# attention's products at f32 accuracy on the tensor cores: 3xTF32, three
# TF32 passes at 495 TFLOP/s; bf16 at the bf16 rate
ATTN_PEAK_FLOPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}
ATOL_FA_F32 = 2e-5
ATOL_LN_F32 = 1e-5
# f32 backward kernels vs their plain versions: 3xTF32 products (about
# f32's accuracy; one TF32 pass would not hold this) summed in other orders
RTOL_FA_BWD_F32 = 1e-4          # max|d| <= 1e-4 * max|grad|
ATOL_LN_BWD_F32 = 1e-3
BF16_ATOL, BF16_RTOL = 2e-2, 1e-2
TRAIN_STEPS, TRAIN_WARMUP = 20, 3


def fail(msg):
    print("FAIL: " + msg, flush=True)
    sys.exit(1)


def sh(cmd):
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    if r.returncode != 0:
        fail("%s exited %d: %s" % (cmd[0], r.returncode, r.stderr.strip()))
    return r.stdout.strip()


def device_ms(fn, iters=25, warmup=3):
    """Median device time of one call of `fn` in ms: CUDA events around the
    call, with the stream held busy by a sleep kernel first so the host's
    launch overhead does not show as device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs(a, b):
    return (a.float() - b.float()).abs().max().item()


def within_bf16(got, ref):
    err = (got.float() - ref.float()).abs()
    return bool((err <= BF16_ATOL + BF16_RTOL * ref.float().abs()).all())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_kernels(ca, cl):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    errs = {}
    # (label, Tq, Tk, D, options), the backward kernels' cases: D = 128 and
    # D = 40 take the kernel's other head-dim instance and the zero padding
    # of D
    fa_cases = [
        ("plain", 128, 128, 64, dict()),
        ("causal", 128, 128, 64, dict(causal=True)),
        ("kpm", 128, 128, 64, dict(kpm=True)),
        ("T=131", 131, 131, 64, dict(kpm=True, causal=True)),
        ("dropout p=0.1 seed=7", 128, 128, 64, dict(dropout_p=0.1, seed=7)),
        ("D=128", 128, 128, 128, dict()),
        ("D=40", 128, 128, 40, dict()),
        ("Tq=128 Tk=96 kpm", 128, 96, 64, dict(kpm=True)),
    ]
    for label, tq, tk, d, kw in fa_cases:
        q, k, v = rnd(8, 12, tq, d), rnd(8, 12, tk, d), rnd(8, 12, tk, d)
        kpm = None
        if kw.pop("kpm", False):
            kpm = torch.where(torch.rand(8, tk, generator=gen, device="cuda")
                              < 0.2, -1e30, 0.0)
        for dt in (torch.float32, torch.bfloat16):
            qd, kd, vd = q.to(dt), k.to(dt), v.to(dt)
            out, lse = ca.flash_attention(qd, kd, vd, kpm, **kw)
            ref, ref_lse = ca.flash_attention_plain(
                qd.float(), kd.float(), vd.float(), kpm, **kw)
            torch.cuda.synchronize()
            err = max_abs(out, ref)
            lse_err = max_abs(lse, ref_lse)
            if dt == torch.float32:
                ok = err <= ATOL_FA_F32 and lse_err <= ATOL_FA_F32
                bound = "max|d| <= %g" % ATOL_FA_F32
                same = ""
            else:
                # also against the plain version on the same bf16 inputs,
                # which rounds P before P·V where the kernel does
                ref_bf, _ = ca.flash_attention_plain(qd, kd, vd, kpm, **kw)
                ok = within_bf16(out, ref) and within_bf16(out, ref_bf)
                bound = "|d| <= %g + %g|ref|" % (BF16_ATOL, BF16_RTOL)
                same = " (bf16 plain %.3e)" % max_abs(out, ref_bf)
            print("flash_attn_fwd %-22s %-8s max|d| %.3e%s (lse %.3e) bound "
                  "%s %s" % (label, str(dt)[6:], err, same, lse_err, bound,
                             "ok" if ok else "EXCEEDED"), flush=True)
            if not ok:
                fail("flash_attn_fwd %s %s outside its bound" % (label, dt))
            if label == "plain" and dt == torch.float32:
                errs["flash_attn_fwd"] = err
    for n in (1024, 1000):
        x = rnd(n, 768) * 2 + 0.5
        g, b = rnd(768), rnd(768)
        for dt in (torch.float32, torch.bfloat16):
            xd, gd, bd = x.to(dt), g.to(dt), b.to(dt)
            y, mean, rstd = cl.layer_norm_fwd(xd, gd, bd, 1e-5)
            ry, rmean, rrstd = cl.layer_norm_plain(
                xd.float(), gd.float(), bd.float(), 1e-5)
            torch.cuda.synchronize()
            err = max(max_abs(y, ry), max_abs(mean, rmean),
                      max_abs(rstd, rrstd))
            if dt == torch.float32:
                ok = err <= ATOL_LN_F32
                bound = "max|d| <= %g" % ATOL_LN_F32
            else:
                ok = (within_bf16(y, ry) and max_abs(mean, rmean) <= 1e-5
                      and max_abs(rstd, rrstd) <= 1e-4 * rrstd.abs().max())
                bound = "|d| <= %g + %g|ref|" % (BF16_ATOL, BF16_RTOL)
            print("layer_norm_fwd (%d, 768)            %-8s max|d| %.3e "
                  "bound %s %s" % (n, str(dt)[6:], err, bound,
                                   "ok" if ok else "EXCEEDED"), flush=True)
            if not ok:
                fail("layer_norm_fwd (%d, 768) %s outside its bound" % (n, dt))
            if n == 1024 and dt == torch.float32:
                errs["layer_norm_fwd"] = err
    return errs


def check_bwd_kernels(ca, cl):
    """The three backward kernels against their plain versions on the same
    card tensors (forward outputs from the forward kernels); returns the
    f32 max|d| of the plain attention and LayerNorm cases. The f32 attention
    bound, 1e-4·max|grad|, is what 3xTF32 products keep and one TF32 pass
    does not (tests/test_torch_kernels.py emulates both)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    def judge(name, label, dt, got, ref):
        err = max_abs(got, ref)
        if dt == torch.float32:
            if name == "layer_norm_bwd":
                bound = ATOL_LN_BWD_F32
            else:
                bound = RTOL_FA_BWD_F32 * ref.float().abs().max().item()
            ok = err <= bound
            text = "max|d| <= %.3e" % bound
        else:
            ok = within_bf16(got, ref)
            text = "|d| <= %g + %g|ref|" % (BF16_ATOL, BF16_RTOL)
        print("%-19s %-22s %-8s max|d| %.3e bound %s %s" % (
            name, label, str(dt)[6:], err, text, "ok" if ok else "EXCEEDED"),
            flush=True)
        if not ok:
            fail("%s %s %s outside its bound" % (name, label, dt))
        return err

    errs = {}
    # (label, Tq, Tk, D, options): D = 128 and D = 40 take the kernels'
    # other head-dim instance and the zero padding of D
    fa_cases = [
        ("plain", 128, 128, 64, dict()),
        ("causal", 128, 128, 64, dict(causal=True)),
        ("kpm", 128, 128, 64, dict(kpm=True)),
        ("T=131", 131, 131, 64, dict(kpm=True, causal=True)),
        ("dropout p=0.1 seed=7", 128, 128, 64, dict(dropout_p=0.1, seed=7)),
        ("D=128", 128, 128, 128, dict()),
        ("D=40", 128, 128, 40, dict()),
        ("Tq=128 Tk=96 kpm", 128, 96, 64, dict(kpm=True)),
    ]
    for label, tq, tk, d, kw in fa_cases:
        q, do = rnd(8, 12, tq, d), rnd(8, 12, tq, d)
        k, v = rnd(8, 12, tk, d), rnd(8, 12, tk, d)
        kpm = None
        if kw.pop("kpm", False):
            kpm = torch.where(torch.rand(8, tk, generator=gen, device="cuda")
                              < 0.2, -1e30, 0.0)
        seed = kw.pop("seed", None)
        for dt in (torch.float32, torch.bfloat16):
            qd, kd, vd, dod = q.to(dt), k.to(dt), v.to(dt), do.to(dt)
            out, lse = ca.flash_attention(qd, kd, vd, kpm, seed, **kw)
            delta = (dod.float() * out.float()).sum(-1)
            args = (qd, kd, vd, kpm, seed, dod, lse, delta)
            dq = ca.flash_attention_dq(*args, **kw)
            dk, dv, dkpm = ca.flash_attention_dkdv(*args, **kw)
            rdq, rdk, rdv, rdkpm = ca.flash_attention_bwd_plain(*args, **kw)
            torch.cuda.synchronize()
            e = judge("flash_attn_bwd_dq", label, dt, dq, rdq)
            e = max(judge("flash_attn_bwd_dkdv", label + " dK", dt, dk, rdk),
                    judge("flash_attn_bwd_dkdv", label + " dV", dt, dv, rdv))
            if kpm is not None:
                judge("flash_attn_bwd_dkdv", label + " dkpm", dt, dkpm, rdkpm)
            elif dkpm is not None:
                fail("flash_attn_bwd_dkdv gave a mask gradient without a mask")
            if label == "plain" and dt == torch.float32:
                errs["flash_attn_bwd_dq"] = max_abs(dq, rdq)
                errs["flash_attn_bwd_dkdv"] = e
    # (n, h, x dtypes, gamma: "x" = x's dtype, a dtype, or None): h = 770
    # takes the path without 16-byte loads, h = 4096 the streamed path, and
    # h = 30000 the one-warp path whose partials do not fit shared memory
    ln_cases = [
        (1024, 768, (torch.float32, torch.bfloat16), "x"),
        (1000, 768, (torch.float32, torch.bfloat16), "x"),
        (1024, 770, (torch.float32, torch.bfloat16), "x"),
        (1024, 768, (torch.float32, torch.bfloat16), None),
        (1024, 768, (torch.bfloat16,), torch.float32),
        (1, 768, (torch.float32, torch.bfloat16), "x"),
        (8192, 1024, (torch.float32, torch.bfloat16), "x"),
        (256, 4096, (torch.float32, torch.bfloat16), "x"),
        (4, 30000, (torch.float32,), "x"),
    ]
    for n, h, dts, gdt in ln_cases:
        x = rnd(n, h) * 2 + 0.5
        g, b, dy = rnd(h), rnd(h), rnd(n, h)
        for dt in dts:
            xd, dyd = x.to(dt), dy.to(dt)
            gd = None if gdt is None else g.to(dt if gdt == "x" else gdt)
            bd = None if gd is None else b.to(gd.dtype)
            _, mean, rstd = cl.layer_norm_fwd(xd, gd, bd, 1e-5)
            got = cl.layer_norm_bwd(xd, gd, mean, rstd, dyd)
            again = cl.layer_norm_bwd(xd, gd, mean, rstd, dyd)
            ref = cl.layer_norm_bwd_plain(xd, gd, mean, rstd, dyd)
            torch.cuda.synchronize()
            label = "(%d, %d)%s" % (n, h, "" if gdt == "x" else
                                    " gamma %s" % (gdt and str(gdt)[6:]))
            e = max(judge("layer_norm_bwd", "%s %s" % (label, part), dt, a, r)
                    for part, a, r in zip(("dx", "dgamma", "dbeta"), got, ref))
            want_w = torch.float32 if gd is None else gd.dtype
            if got[1].dtype != want_w or got[2].dtype != want_w:
                fail("layer_norm_bwd %s: dgamma/dbeta in %s, want %s" % (
                    label, got[1].dtype, want_w))
            # fixed-order sums, no float atomics: a second launch on the
            # same inputs gives the same bits
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                fail("layer_norm_bwd %s %s: two launches differ" % (label, dt))
            if n == 1024 and h == 768 and gdt == "x" and dt == torch.float32:
                errs["layer_norm_bwd"] = e
    print("layer_norm_bwd: every case bit-identical over two launches",
          flush=True)
    return errs


# ---------------------------------------------------------------------------
# phase 4: the serving slice
# ---------------------------------------------------------------------------
def build_bert_base(fluid, bert, dirname):
    """BERT-base (seq 128, inference, pruned to logits) built in the port,
    its startup run on the card from a seeded generator, saved."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        io = bert.build_bert_pretrain(bert.bert_base(), SEQ, is_test=True)
    startup.random_seed = SEED
    scope = fluid.Scope()
    exe = fluid.Executor()      # the card
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(dirname, ["input_ids"], [io["logits"]],
                                  exe, main_program=main, scope=scope)


def serve(engine, requests, n_threads=4):
    """Submit `requests` from `n_threads` closed-loop clients; returns
    (outputs by request index, per-request latencies s, wall s)."""
    outs = [None] * len(requests)
    lat = [None] * len(requests)
    errors = []

    def client(idx):
        for i in idx:
            t0 = time.monotonic()
            try:
                outs[i] = engine.predict({"input_ids": requests[i]},
                                         timeout=120)[0]
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append("request %d: %s: %s" % (i, type(e).__name__, e))
            lat[i] = time.monotonic() - t0

    threads = [threading.Thread(target=client,
                                args=(range(t, len(requests), n_threads),))
               for t in range(n_threads)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        fail("serving: %s" % (errors or "client threads hung"))
    return outs, lat, wall


def serving_phase(fluid, serving, ca, cl, dirname, policy, requests):
    """One full-width serving run of 16 counted requests; returns the
    predictor, the (still running) engine, the outputs by request and the
    kernels' launch counts of that run."""
    pred = fluid.Predictor.from_model(dirname, dtype_policy=policy)
    spec = serving.BucketSpec({"input_ids": (SEQ,)},
                              dtypes={"input_ids": "int64"},
                              batch_sizes=(1, 2, 4, 8))
    engine = serving.ServingEngine(pred, buckets=[spec], max_batch_size=8,
                                   max_wait_ms=5.0, queue_capacity=64)
    engine.warmup()
    torch.cuda.synchronize()
    before = engine.stats()
    ca.flash_attention.launches = 0
    cl.layer_norm_fwd.launches = 0
    outs, _, wall = serve(engine, requests)
    launches = {"flash_attn_fwd": ca.flash_attention.launches,
                "layer_norm_fwd": cl.layer_norm_fwd.launches}
    after = engine.stats()
    dispatches = after["batches"] - before["batches"]
    print("serving[%s]: %d requests answered in %.3f s over %d dispatches "
          "(%d coalesced); launches %s" % (
              policy or "float32", len(requests), wall, dispatches,
              after["coalesced"] - before["coalesced"], launches), flush=True)
    if any(o is None or o.shape != (1, SEQ, 30522) for o in outs):
        fail("serving[%s]: a request was unanswered or misshapen" % policy)
    if not all(np.isfinite(o).all() for o in outs):
        fail("serving[%s]: non-finite logits" % policy)
    if dispatches < 1 or launches["flash_attn_fwd"] != 12 * dispatches \
            or launches["layer_norm_fwd"] != 25 * dispatches:
        fail("serving[%s]: launches %s for %d dispatches, want 12 and 25 "
             "per dispatch" % (policy, launches, dispatches))
    return pred, engine, outs, launches


# ---------------------------------------------------------------------------
# phase 5: the training slice
# ---------------------------------------------------------------------------
def train_program(fluid, bert, cfg):
    """BERT pretraining + Adam(1e-4) minimize, as examples/train_bert.py
    builds it; returns (main, startup, loss var)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        io = bert.build_bert_pretrain(cfg, SEQ)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(io["loss"])
    startup.random_seed = SEED
    return main, startup, io["loss"]


def train_vs_cpu(fluid, bert):
    """BERT-base width at depth 2, batch 2, dropout 0: 3 Adam steps on the
    card and on the CPU from the same parameters."""
    cfg = bert.BertConfig(num_layers=2, dropout=0.0)
    main, startup, loss = train_program(fluid, bert, cfg)
    scope, cpu_scope = fluid.Scope(), fluid.Scope()
    exe, cpu_exe = fluid.Executor(), fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    for n, t in scope.items():
        cpu_scope.set(n, t.cpu().clone())
    ids, labels = bert.synthetic_batch(cfg, 2, SEQ, seed=SEED)
    feed = {"input_ids": ids, "mlm_labels": labels}
    grads = sorted(p.name + "@GRAD" for p in main.all_parameters())
    worst_loss, worst_grad = 0.0, ("", 0.0)
    for step in range(3):
        fetch = [loss] + (grads if step == 0 else [])
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        want = cpu_exe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
        rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        print("train[depth 2] step %d: loss card %.6f cpu %.6f (rel %.2e)"
              % (step, float(got[0]), float(want[0]), rel), flush=True)
        worst_loss = max(worst_loss, rel)
        for name, a, w in zip(grads if step == 0 else [], got[1:], want[1:]):
            r = float(np.abs(a - w).max()) / max(float(np.abs(w).max()),
                                                   1e-30)
            if not np.isfinite(a).all() or r > 1e-3:
                fail("train[depth 2]: %s on the card differs from the CPU "
                     "by %.3e of max|grad| (bound 1e-3)" % (name, r))
            worst_grad = max(worst_grad, (name, r), key=lambda x: x[1])
    print("train[depth 2] vs the port on the CPU: losses within rel %.2e "
          "(bound 1e-3); step-1 gradients of %d parameters within %.2e of "
          "max|grad| (worst %s; bound 1e-3)" % (
              worst_loss, len(grads), worst_grad[1], worst_grad[0]),
          flush=True)
    if worst_loss > 1e-3:
        fail("train[depth 2]: card losses differ from the CPU run")


PER_STEP = {"flash_attn_fwd": 12, "flash_attn_bwd_dq": 12,
            "flash_attn_bwd_dkdv": 12, "layer_norm_fwd": 25,
            "layer_norm_bwd": 25}


def counters(ca, cl):
    return {"flash_attn_fwd": ca.flash_attention,
            "flash_attn_bwd_dq": ca.flash_attention_dq,
            "flash_attn_bwd_dkdv": ca.flash_attention_dkdv,
            "layer_norm_fwd": cl.layer_norm_fwd,
            "layer_norm_bwd": cl.layer_norm_bwd}


def train_phase(fluid, bert, ca, cl):
    """Full BERT-base, batch 8, seq 128, dropout 0.1, Adam 1e-4:
    TRAIN_WARMUP + TRAIN_STEPS counted steps through Executor.run; returns
    the launch counts of that run and a function that runs one more
    step."""
    cfg = bert.bert_base()
    main, startup, loss = train_program(fluid, bert, cfg)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    ids, labels = bert.synthetic_batch(cfg, 8, SEQ, seed=SEED)
    feed = {"input_ids": ids, "mlm_labels": labels}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fns = counters(ca, cl)
    for fn in fns.values():
        fn.launches = 0
    losses, walls = [], []
    steps = TRAIN_WARMUP + TRAIN_STEPS
    for _ in range(steps):
        t0 = time.monotonic()
        out, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        walls.append(time.monotonic() - t0)  # the fetch waits for the card
        losses.append(float(out))
    launches = {n: fn.launches for n, fn in fns.items()}
    peak = torch.cuda.max_memory_allocated()
    print("train[bert_base]: %d steps, losses %s" % (
        steps, " ".join("%.4f" % x for x in losses)), flush=True)
    print("train[bert_base]: launches %s (want %s per step x %d)" % (
        launches, PER_STEP, steps), flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("train[bert_base]: loss not finite or not falling")
    if any(launches[n] != PER_STEP[n] * steps for n in PER_STEP):
        fail("train[bert_base]: launches %s, want %s per step" % (
            launches, PER_STEP))
    timed = sorted(1e3 * w for w in walls[TRAIN_WARMUP:])
    med = statistics.median(timed)
    p90 = timed[min(len(timed) - 1, int(0.9 * len(timed)))]
    print("train[bert_base] step time over %d steps: median %.3f ms, p90 "
          "%.3f ms, %.1f tokens/s; peak device memory %.3f GiB" % (
              len(timed), med, p90, 8 * SEQ / med * 1e3, peak / 2 ** 30),
          flush=True)
    return launches, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope)


def profile_train_step(step):
    """Device busy vs host wall of one training step, the device time by
    kernel, and the host time of the lowering's three ranges."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        prof_wall = (time.monotonic() - t0) * 1e3
    # device-side events only (kernels and copies), without the lowering's
    # profiler ranges, which the profiler also reports on the device
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith("paddle_tpu_torch::")]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    print("profile[train step]: device busy %.3f ms of %.3f ms host wall "
          "while profiled (idle share %.1f%%)" % (
              busy, prof_wall, 100 * max(0.0, 1 - busy / prof_wall)),
          flush=True)
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    # the 15 largest, then every kernel in an anonymous namespace wherever
    # it ranks: the port's five, and a few of PyTorch's
    ours = [e for e in ranked[15:]
            if e.key.startswith("void (anonymous namespace)::")]
    for e in ranked[:15] + ours:
        print("  %8.3f ms/step %5.1f%% x%-5d %s" % (
            e.self_device_time_total / 1e3,
            100 * e.self_device_time_total / 1e3 / busy, e.count,
            e.key[:90]))
    # host side: the lowering's three profiler ranges, and kernel launches
    host = {e.key: e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU
            and (e.key.startswith("paddle_tpu_torch::")
                 or e.key == "cudaLaunchKernel")}
    print("profile[train step] host: %s; cudaLaunchKernel x%d" % (
        ", ".join("%s %.3f ms" % (k.split("::")[1], host[k].cpu_time_total
                                  / 1e3)
                  for k in ("paddle_tpu_torch::forward",
                            "paddle_tpu_torch::backward",
                            "paddle_tpu_torch::optimizer") if k in host),
        host["cudaLaunchKernel"].count if "cudaLaunchKernel" in host else 0),
        flush=True)


# ---------------------------------------------------------------------------
# phase 6: times
# ---------------------------------------------------------------------------
def attention_bound_ms(b, h, t, d, dtype):
    nbytes = 4 * b * h * t * d * torch.finfo(dtype).bits // 8 + b * h * t * 4
    flops = 4 * b * h * t * t * d
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / ATTN_PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def layer_norm_bound_ms(n, h, dtype):
    el = torch.finfo(dtype).bits // 8
    nbytes = 2 * n * h * el + 2 * h * el + 2 * n * 4
    flops = 8 * n * h
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def kernel_times(ca, cl):
    """Times at the serving path's largest bucket: attention (8, 12, 128,
    64), LayerNorm (8·128, 768)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(8, 12, SEQ, 64, generator=gen, device="cuda",
                               dtype=torch.float32).to(dt) for _ in range(3))
        x = torch.randn(8 * SEQ, 768, generator=gen, device="cuda").to(dt)
        g = torch.randn(768, generator=gen, device="cuda").to(dt)
        b = torch.randn(768, generator=gen, device="cuda").to(dt)
        fa_bound, fa_by = attention_bound_ms(8, 12, SEQ, 64, dt)
        ln_bound, ln_by = layer_norm_bound_ms(8 * SEQ, 768, dt)
        res[("flash_attn_fwd", dt)] = dict(
            ms=device_ms(lambda: ca.flash_attention(q, k, v)),
            plain_ms=device_ms(lambda: ca.flash_attention_plain(q, k, v)),
            library_ms=device_ms(
                lambda: F.scaled_dot_product_attention(q, k, v)),
            bound_ms=fa_bound, bound_by=fa_by)
        res[("layer_norm_fwd", dt)] = dict(
            ms=device_ms(lambda: cl.layer_norm_fwd(x, g, b, 1e-5)),
            plain_ms=device_ms(lambda: cl.layer_norm_plain(x, g, b, 1e-5)),
            library_ms=device_ms(
                lambda: F.layer_norm(x, (768,), g, b, 1e-5)),
            bound_ms=ln_bound, bound_by=ln_by)
    for (name, dt), r in res.items():
        print("time %-15s %-8s kernel %.4f ms  plain %.4f ms  library %.4f "
              "ms  bound %.4f ms (%s)" % (name, str(dt)[6:], r["ms"],
                                          r["plain_ms"], r["library_ms"],
                                          r["bound_ms"], r["bound_by"]),
              flush=True)
    return res


def attention_bwd_bound_ms(b, h, t, d, dtype, products, writes):
    """dQ reads q, k, v, dO, lse, delta and writes dQ (3 T×T×D products);
    dK/dV reads the same and writes dK, dV (4 products)."""
    el = torch.finfo(dtype).bits // 8
    nbytes = (4 + writes) * b * h * t * d * el + 2 * b * h * t * 4
    flops = 2 * products * b * h * t * t * d
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / ATTN_PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def layer_norm_bwd_bound_ms(n, h, dtype):
    """Reads x, dy, gamma, mean, rstd; writes dx, dgamma, dbeta."""
    el = torch.finfo(dtype).bits // 8
    nbytes = 3 * n * h * el + 3 * h * el + 2 * n * 4
    flops = 12 * n * h
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def bwd_kernel_times(ca, cl):
    """Times at the training path's shapes: attention (8, 12, 128, 64),
    LayerNorm (8·128, 768). Each kernel's plain version computes that
    kernel's outputs only. The library yardsticks are the backward of
    scaled_dot_product_attention, which gives dQ, dK and dV in one call
    (``library_scope`` says so: compare it with the two kernels' sum), and
    of F.layer_norm, through autograd. Returns the times by (kernel,
    dtype) and the two whole attention backwards' (plain, SDPA) by
    dtype."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 3)
    res, whole = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn(8, 12, SEQ, 64, generator=gen,
                                   device="cuda").to(dt) for _ in range(4))
        out, lse = ca.flash_attention(q, k, v)
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, None, None, do, lse, delta)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        sdpa = F.scaled_dot_product_attention(*leaves)
        sdpa_bwd = device_ms(lambda: torch.autograd.grad(
            sdpa, leaves, do, retain_graph=True))
        whole[dt] = (device_ms(lambda: ca.flash_attention_bwd_plain(*args)),
                     sdpa_bwd)
        for name, fn, plain, products, writes in (
                ("flash_attn_bwd_dq", ca.flash_attention_dq,
                 ca.flash_attention_dq_plain, 3, 1),
                ("flash_attn_bwd_dkdv", ca.flash_attention_dkdv,
                 ca.flash_attention_dkdv_plain, 4, 2)):
            bound, by = attention_bwd_bound_ms(8, 12, SEQ, 64, dt, products,
                                               writes)
            res[(name, dt)] = dict(ms=device_ms(lambda: fn(*args)),
                                   plain_ms=device_ms(lambda: plain(*args)),
                                   library_ms=sdpa_bwd,
                                   library_scope="dq+dk+dv",
                                   bound_ms=bound, bound_by=by)
        x, dy = (torch.randn(8 * SEQ, 768, generator=gen, device="cuda")
                 .to(dt) for _ in range(2))
        g = torch.randn(768, generator=gen, device="cuda").to(dt)
        b = torch.randn(768, generator=gen, device="cuda").to(dt)
        _, mean, rstd = cl.layer_norm_fwd(x, g, b, 1e-5)
        lx, lg, lb = (t.clone().requires_grad_() for t in (x, g, b))
        ly = F.layer_norm(lx, (768,), lg, lb, 1e-5)
        bound, by = layer_norm_bwd_bound_ms(8 * SEQ, 768, dt)
        res[("layer_norm_bwd", dt)] = dict(
            ms=device_ms(lambda: cl.layer_norm_bwd(x, g, mean, rstd, dy)),
            plain_ms=device_ms(
                lambda: cl.layer_norm_bwd_plain(x, g, mean, rstd, dy)),
            library_ms=device_ms(lambda: torch.autograd.grad(
                ly, (lx, lg, lb), dy, retain_graph=True)),
            bound_ms=bound, bound_by=by)
    for (name, dt), r in res.items():
        print("time %-19s %-8s kernel %.4f ms  plain %.4f ms  library %.4f "
              "ms  bound %.4f ms (%s)" % (name, str(dt)[6:], r["ms"],
                                          r["plain_ms"], r["library_ms"],
                                          r["bound_ms"], r["bound_by"]),
              flush=True)
    for dt in (torch.float32, torch.bfloat16):
        print("time flash_attn_bwd (dQ + dK/dV) %-8s kernels %.4f ms  "
              "plain (P and dS once) %.4f ms  SDPA backward %.4f ms" % (
                  str(dt)[6:], res[("flash_attn_bwd_dq", dt)]["ms"]
                  + res[("flash_attn_bwd_dkdv", dt)]["ms"], *whole[dt]),
              flush=True)
    return res


def forward_breakdown(pred, requests):
    """Host wall time of one batch-8 forward and the profiler's device
    time by kernel (informational: printed, not checked)."""
    feeds = {"input_ids": np.concatenate(requests[:8])}
    pred.run(feeds)
    torch.cuda.synchronize()
    walls = []
    for _ in range(10):
        t0 = time.monotonic()
        pred.run(feeds)         # returns numpy: waits for the device
        walls.append(time.monotonic() - t0)
    print("forward[batch 8] host wall median %.3f ms" % (
        1e3 * statistics.median(walls)), flush=True)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(3):
            pred.run(feeds)
        torch.cuda.synchronize()
        prof_wall = (time.monotonic() - t0) / 3 * 1e3
    # device-side events only (kernels and copies): a CPU op's own device
    # time repeats the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in events) / 3e3
    print("profile[batch 8]: device busy %.3f ms per forward of %.3f ms "
          "host wall while profiled (idle share %.1f%%)" % (
              busy, prof_wall, 100 * max(0.0, 1 - busy / prof_wall)),
          flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        print("  %8.3f ms/forward %5.1f%% x%-4d %s" % (
            e.self_device_time_total / 3e3,
            100 * e.self_device_time_total / 3e3 / busy, e.count // 3,
            e.key[:90]))


def ptxas_summary(log):
    """(entry function, 'N registers, S B spill stores, L B spill loads')
    per kernel of one nvcc -Xptxas=-v log."""
    out, fn, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn, spill = m.group(1), ""
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = "%s B spill stores, %s B spill loads" % m.groups()
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            out.append((fn, "%s registers, %s" % (m.group(1), spill)))
            fn = None
    return out


def attention_occupancy(cuda_build):
    """Blocks per SM and dynamic shared memory of the three attention
    kernels at the training path's head dim 64 (and at 128), by
    cudaOccupancyMaxActiveBlocksPerMultiprocessor; returns them by
    (kernel, dtype) at D = 64."""
    import ctypes

    fwd = cuda_build.load("flash_attn_fwd").flash_attn_fwd_occupancy
    fwd.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    fwd.restype = ctypes.c_int
    bwd = cuda_build.load("flash_attn_bwd").flash_attn_bwd_occupancy
    bwd.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    bwd.restype = ctypes.c_int
    kernels = (("flash_attn_fwd", fwd),
               ("flash_attn_bwd_dq", lambda *a: bwd(0, *a)),
               ("flash_attn_bwd_dkdv", lambda *a: bwd(1, *a)))
    res = {}
    for name, fn in kernels:
        for dtype, dt in ((0, torch.float32), (1, torch.bfloat16)):
            for d in (64, 128):
                blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
                cuda_build.check(fn(d, dtype, ctypes.byref(blocks),
                                    ctypes.byref(smem)), name)
                print("occupancy %-19s %-8s D=%-3d %d blocks/SM, %d B shared "
                      "memory, 128 threads" % (name, str(dt)[6:], d,
                                               blocks.value, smem.value))
                if d == 64:
                    res[(name, dt)] = dict(blocks_per_sm=blocks.value,
                                           smem_bytes=smem.value)
    return res


def sdpa_kernel_names():
    """The device kernels one backward of scaled_dot_product_attention runs
    at (8, 12, 128, 64), f32 and bf16, by torch.profiler (after every timed
    phase: the profiler slows the host for the rest of the process)."""
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for dt in (torch.float32, torch.bfloat16):
        leaves = [torch.randn(8, 12, SEQ, 64, device="cuda").to(dt)
                  .requires_grad_() for _ in range(3)]
        out = F.scaled_dot_product_attention(*leaves)
        do = torch.randn_like(out)
        torch.autograd.grad(out, leaves, do, retain_graph=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.autograd.grad(out, leaves, do, retain_graph=True)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total:
                print("SDPA backward %-8s %8.4f ms x%d %s" % (
                    str(dt)[6:], e.self_device_time_total / 1e3, e.count,
                    e.key[:150]), flush=True)


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_build
    from paddle_tpu_torch.ops import cuda_layernorm as cl

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    print("torch %s, CUDA %s, python %s" % (
        torch.__version__, torch.version.cuda, sys.version.split()[0]))
    print(sh([cuda_build.nvcc_path(), "--version"]).splitlines()[-1])
    print("card: %s (%s)" % (card, torch.cuda.get_device_name(0)), flush=True)

    secs = cuda_build.build_all()
    print("built %s from %s in %.1f s" % (
        ", ".join(cuda_build.KERNELS), cuda_build.CSRC_DIR, secs))
    for name, log in sorted(cuda_build.build_logs.items()):
        for fn, info in ptxas_summary(log):
            print("  %s %s: %s" % (name, fn, info))
    occupancy = attention_occupancy(cuda_build)

    errs = check_kernels(ca, cl)
    errs.update(check_bwd_kernels(ca, cl))

    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, 30522, size=(1, SEQ), dtype=np.int64)
                for _ in range(16)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.monotonic()
        build_bert_base(fluid, bert, tmp)
        print("bert_base built, initialised on the card and saved in %.1f s"
              % (time.monotonic() - t0), flush=True)
        pred, engine, outs, launches = serving_phase(
            fluid, serving, ca, cl, tmp, None, requests)
        solo = [pred.run({"input_ids": r})[0] for r in requests]
        scale = max(float(np.abs(o).max()) for o in solo)
        row_err = max(float(np.abs(o - s).max()) for o, s in zip(outs, solo))
        same = sum(bool(np.array_equal(o, s)) for o, s in zip(outs, solo))
        print("rows vs solo runs: max|d| %.3e (%d/16 bit-identical), bound "
              "1e-4*max|logit| = %.3e" % (row_err, same, 1e-4 * scale))
        # cuBLAS picks its kernel by row count, so a coalesced row may be
        # summed in another order than the same row run alone
        if row_err > 1e-4 * scale:
            fail("coalesced rows differ from solo runs")
        cpu = fluid.Predictor.from_model(tmp, place=fluid.CPUPlace())
        cpu_err = max(float(np.abs(outs[i] - cpu.run(
            {"input_ids": requests[i]})[0]).max()) for i in (0, 1))
        print("logits vs the port on the CPU (f32, 2 requests): max|d| "
              "%.3e, bound 1e-3*max|logit| = %.3e" % (cpu_err, 1e-3 * scale))
        # f32 on both sides; cuBLAS vs MKL and kernel vs plain sum in other
        # orders, and 12 layers carry the rounding forward
        if cpu_err > 1e-3 * scale:
            fail("card logits disagree with the CPU run")
        del cpu

        # timed load: 128 requests from 4 closed-loop clients
        load = [rng.integers(0, 30522, size=(1, SEQ), dtype=np.int64)
                for _ in range(128)]
        _, lat, wall = serve(engine, load)
        lat_ms = sorted(1e3 * x for x in lat)
        print("serving[float32] load: 128 requests, 4 clients: %.2f req/s, "
              "p50 %.3f ms, p99 %.3f ms" % (
                  len(load) / wall, lat_ms[len(lat_ms) // 2],
                  lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))]))
        engine.stop()

        bpred, bengine, bouts, blaunches = serving_phase(
            fluid, serving, ca, cl, tmp, "bfloat16", requests)
        rel = max(float(np.abs(b - o).max()) for b, o in zip(bouts, outs)) \
            / scale
        print("bfloat16 vs float32 logits: max|d|/max|logit| %.3e, bound "
              "5e-2" % rel)
        if rel > 5e-2:
            fail("bfloat16 logits too far from float32")
        _, blat, bwall = serve(bengine, load)
        blat_ms = sorted(1e3 * x for x in blat)
        print("serving[bfloat16] load: 128 requests, 4 clients: %.2f req/s, "
              "p50 %.3f ms, p99 %.3f ms" % (
                  len(load) / bwall, blat_ms[len(blat_ms) // 2],
                  blat_ms[min(len(blat_ms) - 1, int(0.99 * len(blat_ms)))]))
        bengine.stop()
        del bpred

        train_vs_cpu(fluid, bert)
        train_launches, train_step = train_phase(fluid, bert, ca, cl)
        # profiles last: a torch.profiler session leaves the host slower
        # for the rest of the process, so nothing is timed after one
        forward_breakdown(pred, requests)
        profile_train_step(train_step)
        del pred, train_step

    times = kernel_times(ca, cl)
    times.update(bwd_kernel_times(ca, cl))
    sdpa_kernel_names()
    sources = {
        "flash_attn_fwd": ("paddle_tpu_torch/csrc/flash_attn_fwd.cu",
                           "paddle_tpu/ops/pallas_attention.py:93"),
        "layer_norm_fwd": ("paddle_tpu_torch/csrc/layer_norm_fwd.cu",
                           "paddle_tpu/ops/pallas_layernorm.py:26"),
        "flash_attn_bwd_dq": ("paddle_tpu_torch/csrc/flash_attn_bwd.cu",
                              "paddle_tpu/ops/pallas_attention.py:166"),
        "flash_attn_bwd_dkdv": ("paddle_tpu_torch/csrc/flash_attn_bwd.cu",
                                "paddle_tpu/ops/pallas_attention.py:212"),
        "layer_norm_bwd": ("paddle_tpu_torch/csrc/layer_norm_bwd.cu",
                           "paddle_tpu/ops/pallas_layernorm.py:39")}
    # how each kernel computes (route stays "cuda": all are CUDA C++)
    mma_design = ("mma.sync bf16 / 3xTF32 f32, cp.async double-buffered, "
                  "128 threads")
    design = {"flash_attn_fwd": mma_design,
              "layer_norm_fwd": "CUDA cores f32, warp per row",
              "flash_attn_bwd_dq": mma_design,
              "flash_attn_bwd_dkdv": mma_design,
              "layer_norm_bwd": "CUDA cores f32, one launch: warp per row "
                                "held in registers, dgamma/dbeta summed in "
                                "a fixed order by the last blocks"}
    # launches: the forward kernels' count is the f32 serving run's (and
    # launches_bf16 the bfloat16 one's), the backward kernels' the training
    # run's; launches_train is every kernel's count in the training run
    record = []
    for name, (src, replaces) in sources.items():
        entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                     launches=launches.get(name, train_launches[name]),
                     max_abs_err=errs[name], dtype="float32",
                     launches_train=train_launches[name],
                     design=design[name])
        # ms, plain_ms, bound_ms, bound_by, library_ms (and library_scope)
        entry.update(times[(name, torch.float32)])
        if name in blaunches:
            entry["launches_bf16"] = blaunches[name]
        entry["bf16"] = times[(name, torch.bfloat16)]
        if (name, torch.float32) in occupancy:
            entry["occupancy"] = occupancy[(name, torch.float32)]
            entry["bf16"]["occupancy"] = occupancy[(name, torch.bfloat16)]
        record.append(entry)
    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
