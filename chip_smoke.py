"""Smoke run of paddle_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device stamp: torch/CUDA/nvcc versions, card name and power limit;
2. build every CUDA kernel of the port from ``paddle_tpu_torch/csrc``
   (one nvcc per source, all at once);
3. each kernel against its plain torch version on the card, f32 and bf16,
   at the serving path's shapes, within the stated bounds;
4. the serving slice at full width: BERT-base (seq 128, random weights
   from a seed) saved, reloaded through ``Predictor.from_model`` and served
   by ``ServingEngine`` to 16 requests from 4 threads, in f32 and in the
   bfloat16 policy; the launch counters must show every dispatch went
   through both kernels (12 attention and 25 LayerNorm launches per
   forward), rows must match solo runs, and logits must match the same
   port run on the CPU;
5. times: each kernel, its plain version and the PyTorch library call
   (timed here only, never used by the port) with CUDA events, the least
   time the card could take, and serving requests/s and latency.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.
"""
import json
import os
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
ATOL_FA_F32 = 2e-5
ATOL_LN_F32 = 1e-5
BF16_ATOL, BF16_RTOL = 2e-2, 1e-2


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
    fa_cases = [
        ("plain", 128, dict()),
        ("causal", 128, dict(causal=True)),
        ("kpm", 128, dict(kpm=True)),
        ("T=131", 131, dict(kpm=True, causal=True)),
        ("dropout p=0.1 seed=7", 128, dict(dropout_p=0.1, seed=7)),
    ]
    for label, t, kw in fa_cases:
        q, k, v = rnd(8, 12, t, 64), rnd(8, 12, t, 64), rnd(8, 12, t, 64)
        kpm = None
        if kw.pop("kpm", False):
            kpm = torch.where(torch.rand(8, t, generator=gen, device="cuda")
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
            else:
                ok = within_bf16(out, ref)
                bound = "|d| <= %g + %g|ref|" % (BF16_ATOL, BF16_RTOL)
            print("flash_attn_fwd %-22s %-8s max|d| %.3e (lse %.3e) bound %s"
                  " %s" % (label, str(dt)[6:], err, lse_err, bound,
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
# phase 5: times
# ---------------------------------------------------------------------------
def attention_bound_ms(b, h, t, d, dtype):
    nbytes = 4 * b * h * t * d * torch.finfo(dtype).bits // 8 + b * h * t * 4
    flops = 4 * b * h * t * t * d
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
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
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        print("  %s: %s" % (name, "; ".join(regs)))

    errs = check_kernels(ca, cl)

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
        forward_breakdown(pred, requests)
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
        del pred, bpred

    times = kernel_times(ca, cl)
    sources = {"flash_attn_fwd": ("paddle_tpu_torch/csrc/flash_attn_fwd.cu",
                                  "paddle_tpu/ops/pallas_attention.py:93"),
               "layer_norm_fwd": ("paddle_tpu_torch/csrc/layer_norm_fwd.cu",
                                  "paddle_tpu/ops/pallas_layernorm.py:26")}
    record = []
    for name, (src, replaces) in sources.items():
        f32 = times[(name, torch.float32)]
        bf16 = times[(name, torch.bfloat16)]
        record.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name],
            ms=f32["ms"], plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
            bound_by=f32["bound_by"], library_ms=f32["library_ms"],
            dtype="float32", launches_bf16=blaunches[name], bf16=bf16))
    print(card)
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
