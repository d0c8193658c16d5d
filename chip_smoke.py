"""Smoke run of paddle_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device stamp: torch/CUDA/nvcc versions, card name and power limit;
2. build every CUDA kernel of the port from ``paddle_tpu_torch/csrc``
   (one nvcc per source, all at once); print each kernel's registers and
   spills from ptxas (a spill in the LayerNorm forward fails), and the
   three attention kernels' blocks per SM;
3. each kernel against its plain torch version on the card, f32 and bf16,
   within the stated bounds, at the serving and training paths' shapes:
   attention (8, 12, 128, 64) plain, causal, with a key-padding mask (and
   its gradient), T = 131 and dropout p = 0.1, then head dims 128 and 40
   and Tq = 128 with Tk = 96 and a mask, forward and backward (the bf16
   forward also against the plain version on the same bf16 inputs, which
   rounds P before P·V as the kernel does); LayerNorm forward at
   (1024, 768), (1000, 768), the serving buckets' (128, 768), (256, 768)
   and (512, 768), h = 770, no gamma and beta, gamma and beta in the other
   dtype, n = 1, (8192, 1024), (256, 4096) and (4, 30000); LayerNorm
   backward at (1024, 768), (1000, 768), h = 770
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
   5b. the training slice in bf16 AMP (``contrib.mixed_precision.decorate``,
   as bench.py and examples/train_bert.py --bf16 train): (a) BERT-base
   width at depth 2 in ``decorate(Adam(1e-4), use_bf16=True)``, 3 steps on
   the card and on the CPU from the same parameters (losses within 1e-2
   relative, step-1 gradients within 5e-2·max|grad| of each parameter),
   and the undecorated program as the control: the gradients of the
   weights read only by casts must be bfloat16 values in the AMP runs and
   not in the control;
   (b) dynamic loss scaling: a 2^15 scale gives the undecorated f32
   program's bits over 3 steps, and an overflow step leaves parameters,
   moments and beta powers bit-identical while the scale follows the
   reference's rule down to its floor of 1; (c) full BERT-base in bf16 AMP
   (dropout 0.1, batch 8, seq 128) trained 23 steps like the f32 run:
   finite, falling loss, 12/12/12/25/25 kernel launches per step, step
   time and tokens/s beside the f32 step's;
   The profiles of one serving forward and one training step of each kind
   (f32, then bf16 AMP: device busy, idle share, GEMM device time by
   dtype, the casts' launches and time) come after every timed phase: a
   torch.profiler session leaves the host slower for the rest of the
   process;
6. times: each kernel, its plain version and the PyTorch library call
   (timed here only, never used by the port) with CUDA events, the least
   time the card could take, and serving requests/s and latency; the
   LayerNorm forward and F.layer_norm also at every serving bucket's rows,
   beside the launch floor (a one-element fill_); then the device kernels
   the library's attention backward runs (torch.profiler);
7. the ResNet slice, with torch's default for cuDNN (TF32 on) restored
   first, so that the port itself must turn it off for its f32 runs:
   (a) ResNet-50 (1000 classes, every width as published) cut to batch 4
   at 64x64, Momentum(1e-3, 0.9), 3 f32 steps on the CPU and on the card,
   each card step from the CPU's state before it: losses and moving
   statistics within 1e-3, the step-1 gradients' median and all of them
   together within bounds set by the CPU's own spread (the CPU against
   itself with the image one f32 ulp up), the issue's per-parameter bound
   printed beside them; the same card steps with cuDNN TF32 left on inside
   the run, printed; (b) the same in ``decorate(Momentum(1e-3, 0.9),
   use_bf16=True)``: losses within 1e-2, all gradients together no
   farther from the CPU's than twice AMP's own distance from f32, and the
   gradients of the 54 weights read only through casts bfloat16 values on
   the card and the CPU, not in f32; (c) 7a's card-trained program saved
   pruned to the logits, served by ``Predictor.from_model`` on the card
   and the CPU (8 single requests and a batch of 8, 1e-3·max|logit|, its
   53 batch norms is_test); (d) bench.py's ResNet-50 measurement (batch
   128, 224x224, bf16 AMP, Momentum(0.1, 0.9), seed 7, the batch staged on
   the card once): 3 warm-up and 20 timed steps, step median and p90 from
   CUDA events between steps, images/s, peak memory, FLOPs per image from
   the program's shapes beside bench.py's, the share of the bf16 peak, and
   the five kernels' launches (none on this path); (e), with the other
   profiles, one profiled step of (d): busy and idle share, convolutions by
   input dtype, cuDNN's layout transforms, dtype conversions, the momentum
   updates and the elementwise rest, and cudaLaunchKernel calls;
8. GPT decode serving at the full width of ``GPTConfig()`` (vocab 32000,
   hidden 768, 12 layers, 12 heads, ffn 3072), random weights from
   startup seed 9 initialised once on the CPU: (a) a ``DecodeEngine`` on
   the card and one on the CPU from that scope (cache_len 128, bucket
   64): a 50-token prompt's prefill, then 16 steps teacher-forced with
   the card's tokens, logits and the KV rows written within
   1e-3·max of the CPU's, the card's token equal to the CPU's wherever the
   CPU's top-2 gap exceeds that bound (near-ties counted); (b) the main
   path: ``DecodeEngine(slots=8, cache_len=1024)`` with the default
   buckets serves 8 closed-loop client threads x 3 requests (prompts of
   5 / 40 / 200 / 700 tokens in turn, 64 new tokens each) with every
   counter set to 0 just before and read just after: exactly 24 LayerNorm
   forward launches per prefill and per step, no attention kernel; every
   stream bit-identical to its prompt served alone through the same
   engine; a ``barrier=True`` engine on the same load, its streams the
   same; (c) each engine serves the load again, timed: tokens/s over the
   window, time to first token and the gap between tokens (p50, p99),
   one step's host wall and its device time from CUDA events, peak device
   memory and ``kv_slot_bytes``; with the other profiles, one profiled
   step (busy, idle share, GEMMs, the cache copies); and, with phase 6's
   times, the LayerNorm forward at the step's (8, 768) and a prefill
   bucket's (64, 768) rows;
9. Transformer NMT at bench.py's width (``NMTConfig(src_vocab=32000,
   tgt_vocab=32000, hidden=512, heads=8, ffn=2048, enc_layers=4,
   dec_layers=4)``, random weights from startup seed 7 on the card) and
   GPT's solo generator: (a) beam translation (src 32, max_out 48, beam
   4) of a batch of 4 of bench.py's source rows on the card and on the
   CPU from the same scope: the encoder output within 1e-4 of its max;
   each row's per-step tokens and parent beams equal up to the first
   step where the CPU's choice among its 5 best candidates was a
   near-tie (closer than 2e-6 of their magnitude; counted), the scores
   before it and, for rows equal to the end, the final ids and scores
   within 1e-4·max|score|; 584 LayerNorm forward launches (8 + 12 x 48)
   and no attention launch; (b) the main path, bench.py's
   _measure_nmt_decode: batch 32, one warm and 8 timed translations
   fetching ids and scores, every counter zeroed just before: 584
   LayerNorm forward launches each, tokens/s, ms per batch, peak device
   memory; the same at batch 128 (6 runs), and, with the other
   profiles, one profiled b32 translation (busy, idle share, top
   kernels, the sort behind top_k, the copies, cudaLaunchKernel);
   (c) NMT training (batch 32, src and tgt 32, dropout 0, Adam 1e-4), 3
   steps on the card and on the CPU from one state: losses within 1e-3,
   step-1 gradients printed per parameter and held by their median and
   all together within 1e-3, each within 1e-3·max|grad| unless a relu
   unit on the boundary (within 1e-5 of its layer's max) is 0 in one run
   only, then within 5e-2; 20 LayerNorm forward and 20 backward
   launches a step; the median of 10 more card steps; (d)
   ``build_gpt_generate`` (greedy) at ``GPTConfig()`` on phase 8's
   weights, prompt 16, 16 new tokens, batch 2: ids equal to the CPU's up
   to the first near-tie (top-2 gap within 1e-3 of their magnitude), 24
   LayerNorm forward launches a step; and, with phase 6's times, both
   LayerNorm kernels at the NMT rows (128, 512) and (1024, 512). 9b also
   runs bench.py's translation at b32 and b128 once with the full op list
   (``lowering.live_plan`` returning None, as before the dead step outputs
   were pruned) and once with the live ops, each from a reset peak: peak
   memory above what was resident, the beams bit-identical, and, with the
   other profiles, the copy kernels of one b32 translation with the full
   op list (the profiled translation above has the live ops');
10. Wide&Deep CTR trained through ``Executor.train_from_dataset``, as
   bench.py:746 _measure_ctr runs it (``build_wide_deep()``: 26 sparse
   fields over a 100,000-row embedding of 16, 13 dense, hidden [400, 400,
   400]; Adam(1e-3); startup seed 7): (a) initialised once on the CPU,
   copied to the card and the CPU, 3 steps of batch 2048 from one shard
   with ``set_thread(1)`` on each (twice on the card, and once more as a
   ``run`` loop over the same batches): each parameter's update within
   1e-2 of its largest against the CPU's, the auc statistics' totals
   equal and at most 1% of the samples in another bin, the eval batch's
   loss within 1e-3 and AUC within 1e-5, and whether two card runs give
   the same bits; (b) the main path: 49,152 synthetic Criteo-shaped rows
   in 4 shards made as bench.py makes them, ``InMemoryDataset`` with
   ``set_thread(2)``, batch 2048, one warm-up epoch and 2 timed epochs
   with every counter zeroed just before (none of the five kernels lies on
   this path): examples/s, the step median from CUDA events, peak memory,
   the pipeline that ran (native, or the phase fails) and bench.py's
   loss_first and loss_last (finite, falling); (c) ``infer_from_dataset``
   over one epoch leaves every trainable parameter bit-identical and adds
   an epoch of samples to the auc statistics; and, with the other
   profiles, one profiled epoch (busy, idle share, top kernels, the
   embedding gradient, Adam, the host-to-device copies, cudaLaunchKernel);
11. the serving front door, after phase 10 and before the profiles: (a)
   ``fluid.core.create_paddle_predictor(fluid.core.AnalysisConfig(dir))``
   on phase 4's model runs on the card, a batch of 8 bit-identical to
   ``Predictor.from_model(dir)``, and with ``disable_gpu()`` on the CPU
   within 1e-3·max|logit| of the card; (b) the main path of
   ``:predict``: phase 4's BERT-base (seed 1234, seq 128, f32) saved
   pruned to ``encoder_out``, ``ModelRegistry.load`` with buckets (1, 2,
   4, 8) behind ``ServingServer``, 4 closed-loop urllib clients x 16
   requests of 1-4 rows with every counter at 0 just before: 12 attention
   and 25 LayerNorm forward launches per dispatch, each reply within
   1e-3·max|x| of the same rows through a solo card ``Predictor``; req/s,
   the client's p50/p99, the server's ``serving.request_seconds`` p50 from
   ``/metrics``, the share of client latency outside the engine, the
   padding waste, the coalesced batches, one reply row's JSON cost; (c)
   the main path of ``:generate``: phase 8's ``DecodeEngine(slots=8,
   cache_len=1024)`` configuration published behind the same server,
   phase 8c's chat traffic streamed over chunked HTTP with every counter
   at 0 just before: 24 LayerNorm forward launches per prefill and per
   step, every stream equal to its prompt served alone in 8b; tokens/s,
   TTFT and gap p50/p99, the ``slot_utilization`` gauge's peak sampled as
   bench.py does; one ``"stream": false`` request; a client that hangs up
   after 3 tokens (cancelled, its slot free); a ``"trace": true`` request
   whose span file holds ``http.generate``, ``decode.queue`` and
   ``decode.prefill`` under one trace id; (d) ``python -m
   paddle_tpu_torch.serving.http --model bert=DIR --port 0`` as a child:
   its ``serving bert on`` line, one ``:predict`` equal to (b)'s reply
   within (b)'s bound, ``/healthz`` and ``/metrics``, exit 0 on SIGINT;
   (e) (b)'s load and a phase-8c-sized decode load with
   ``PADDLE_TPU_TELEMETRY=off`` and ``on`` in alternation (the cost is
   printed, not gated);
12. the serving fleet, after phase 11 and before the profiles: (a) the
   main path of the router: 11b's BERT-base (encoder_out, seq 128, f32,
   seed 1234) behind ``local_fleet(n_replicas=4, per_device=True)`` with
   buckets (1, 2, 4, 8, 16), max batch 16, max wait 1 ms, queue 256 (on
   one card every replica shares cuda:0, each with its own parameters),
   and bench.py:953's load, 8 closed-loop clients x 30 requests of 1-4
   rows, driven on one replica alone and round-robin on the raw engines,
   then through the router with every counter at 0 just before (the
   main path's launches): 12 attention and 25 LayerNorm forward launches
   a dispatch, every reply within 1e-3·max|x| of the same rows through a
   solo predictor at the bucket a lone engine pads them to; req/s of the
   three, the router's own cost (``serving.dispatch_seconds``),
   failovers, live replicas, the routed requests per replica; then the
   fleet's 4 predictors without their engines in 1, 2 and 4 threads (a
   thread's CPU time a forward); (b) drills, 0 client failures and every
   reply within the bound: on a router of the same model and engine
   options whose replica 0 and warm standby 3 are held (built, not
   started: their queues fill), kill() of replica 0 (its queue replayed
   on the survivors; the time until the monitor declared it dead and the
   standby took its place), then remove_replica(3, drain=True) with the
   standby's queue filled and its engine started; on 12a's fleet, a
   rolling reload to a v3 directory whose parameter file is torn
   (RolloutError, rolled back, v1 serves), and a rolling reload to v2
   (the model saved from seed 1235) under 4 clients, every reply v1's or
   v2's; (c) two ``python -m
   paddle_tpu_torch.serving.router`` workers on the card over a FileStore
   behind a ``ServingRouter`` of ``StoreReplica``s: each worker's time to
   its first beacon, one of them SIGKILLed, the time to declare it dead,
   4 more requests answered by the survivor within the bound; (d) the
   main path of disaggregated serving at ``GPTConfig()`` (phase 8's
   weights, cache_len 1024, the default buckets) under bench.py:1232's
   mixed-tenant load (6 latency clients x 3 requests of 3/5/6 prompt
   tokens and 16 new; 2 bulk clients x 3 of 700 and 6 new), every counter
   at 0 just before each leg: (i) a colocated ``DecodeEngine(slots=4)``,
   (ii) the main path, ``disagg_fleet(2 prefill + 2 decode, slots=2,
   fp32-resident, int8 wire, tenants latency (interactive, 250 ms
   per-token SLO) and bulk (batch))`` traced, its phase breakdown, (iii)
   an 80-token canary whose decode replica is killed after 40 tokens
   (migrated, 0 failed streams, 80 tokens): 24 LayerNorm forward launches
   a prefill and a step of the leg's engines, no attention kernel;
   tokens/s, the latency tenant's per-token gaps, the
   handoff's wire bytes and compression; (e) the fp32-wire fleet's
   streams equal token for token to a colocated engine with its
   replicas' slots, cache_len and buckets; the int8-resident cache:
   slot bytes and their ratio to fp32, the first token, an int8 handoff
   adopted by an idle engine, its payload and its distance from the
   lossless handoff (scale/2
   a row), a bitflipped handoff re-prefilled with 0 failed streams, the
   int8 step's host and device ms against the fp32 step's; (f) the
   lossless fleet published behind ``ServingServer``: ``:generate`` with
   tenant and priority streams 12e's tokens, a bad priority answers 400,
   a capped tenant 429, ``/metrics?scope=fleet`` carries the ``fleet_``
   families and a ``fleet_slo_burn`` gauge for each tenant.

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
    # (label, Tq, Tk, D, options; batch 8 unless given), the backward
    # kernels' cases: D = 128 and D = 40 take the kernel's other head-dim
    # instance and the zero padding of D; B = 1 and B = 16 are the
    # smallest and largest of the fleet's buckets (phase 12a)
    fa_cases = [
        ("plain", 128, 128, 64, dict()),
        ("B=1", 128, 128, 64, dict(batch=1)),
        ("B=16", 128, 128, 64, dict(batch=16)),
        ("causal", 128, 128, 64, dict(causal=True)),
        ("kpm", 128, 128, 64, dict(kpm=True)),
        ("T=131", 131, 131, 64, dict(kpm=True, causal=True)),
        ("dropout p=0.1 seed=7", 128, 128, 64, dict(dropout_p=0.1, seed=7)),
        ("D=128", 128, 128, 128, dict()),
        ("D=40", 128, 128, 40, dict()),
        ("Tq=128 Tk=96 kpm", 128, 96, 64, dict(kpm=True)),
    ]
    for label, tq, tk, d, kw in fa_cases:
        b = kw.pop("batch", 8)
        q, k, v = rnd(b, 12, tq, d), rnd(b, 12, tk, d), rnd(b, 12, tk, d)
        kpm = None
        if kw.pop("kpm", False):
            kpm = torch.where(torch.rand(b, tk, generator=gen, device="cuda")
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
    # (n, h, x dtypes, gamma and beta: "x" = x's dtype, a dtype, or None):
    # the GPT decode step's rows (8 slots; 4 and 2 in phase 12d-12e) and
    # its 64-row prefill bucket, the serving buckets' rows (128·B; B = 16
    # in phase 12a), the NMT decode step's (B·beam = 128, 512) and its
    # encoder's (32·32, 512), h = 770 (no 16-byte loads),
    # no gamma and beta, their width other than x's, n = 1, and the
    # backward's long rows: h = 1024 (the longest held in registers), 4096
    # and 30000 (streamed)
    f32, bf16 = torch.float32, torch.bfloat16
    ln_cases = [
        (1024, 768, (f32, bf16), "x"),
        (1000, 768, (f32, bf16), "x"),
        (8, 768, (f32, bf16), "x"),
        (4, 768, (f32, bf16), "x"),
        (2, 768, (f32, bf16), "x"),
        (64, 768, (f32, bf16), "x"),
        (128, 768, (f32, bf16), "x"),
        (256, 768, (f32, bf16), "x"),
        (512, 768, (f32, bf16), "x"),
        (2048, 768, (f32, bf16), "x"),
        (128, 512, (f32, bf16), "x"),
        (1024, 512, (f32, bf16), "x"),
        (1024, 770, (f32, bf16), "x"),
        (1024, 768, (f32, bf16), None),
        (1024, 768, (bf16,), f32),
        (1024, 768, (f32,), bf16),
        (1, 768, (f32, bf16), "x"),
        (8192, 1024, (f32, bf16), "x"),
        (256, 4096, (f32, bf16), "x"),
        (4, 30000, (f32, bf16), "x"),
    ]
    for n, h, dts, wdt in ln_cases:
        x = rnd(n, h) * 2 + 0.5
        g, b = rnd(h), rnd(h)
        for dt in dts:
            xd = x.to(dt)
            gd = None if wdt is None else g.to(dt if wdt == "x" else wdt)
            bd = None if wdt is None else b.to(gd.dtype)
            y, mean, rstd = cl.layer_norm_fwd(xd, gd, bd, 1e-5)
            ry, rmean, rrstd = cl.layer_norm_plain(
                xd.float(), None if gd is None else gd.float(),
                None if bd is None else bd.float(), 1e-5)
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
            label = "(%d, %d)%s" % (n, h, "" if wdt == "x" else
                                    " gamma %s" % (wdt and str(wdt)[6:]))
            print("layer_norm_fwd %-26s %-8s max|d| %.3e bound %s %s" % (
                label, str(dt)[6:], err, bound, "ok" if ok else "EXCEEDED"),
                flush=True)
            if not ok:
                fail("layer_norm_fwd %s %s outside its bound" % (label, dt))
            if n == 1024 and h == 768 and wdt == "x" and dt == f32:
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
    # (n, h, x dtypes, gamma: "x" = x's dtype, a dtype, or None): the NMT
    # training's rows (32·32, 512) and a 128-row (128, 512), h = 770
    # takes the path without 16-byte loads, h = 4096 the streamed path, and
    # h = 30000 the one-warp path whose partials do not fit shared memory
    ln_cases = [
        (1024, 768, (torch.float32, torch.bfloat16), "x"),
        (1000, 768, (torch.float32, torch.bfloat16), "x"),
        (128, 512, (torch.float32, torch.bfloat16), "x"),
        (1024, 512, (torch.float32, torch.bfloat16), "x"),
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
def build_bert_base(fluid, bert, dirname, target="logits", cfg=None,
                    seq=SEQ, seed=SEED):
    """BERT-base (seq 128, inference, pruned to `target`: the logits, or
    phase 11's ``encoder_out``) built in the port, its startup run on the
    card from a seeded generator (phase 12b's v2 from seed 1235), saved."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        io = bert.build_bert_pretrain(cfg or bert.bert_base(), seq,
                                      is_test=True)
    startup.random_seed = seed
    scope = fluid.Scope()
    exe = fluid.Executor()      # the card
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(dirname, ["input_ids"], [io[target]],
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
def train_program(fluid, bert, cfg, amp=None):
    """BERT pretraining + Adam(1e-4) minimize, as examples/train_bert.py
    builds it, the optimizer decorated by
    ``contrib.mixed_precision.decorate(**amp)`` when `amp` is given;
    returns (main, startup, loss var)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        io = bert.build_bert_pretrain(cfg, SEQ)
        opt = fluid.optimizer.Adam(learning_rate=1e-4)
        if amp is not None:
            opt = fluid.contrib.mixed_precision.decorate(opt, **amp)
        opt.minimize(io["loss"])
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


def off_by_more_than_an_ulp(got, want):
    """(elements, of which off): elements farther from `want` than one
    bfloat16 ulp (2^-8 relative), not counting differences under 1e-3 of
    max|want| (tests/test_torch_amp.py uses the same measure)."""
    scale = float(np.abs(want).max())
    off = np.abs(got - want) > 2.0 ** -8 * np.abs(want) + 1e-3 * scale
    return off.size, int(off.sum())


def bf16_exact_share(a):
    """Share of the nonzero f32 elements of `a` that a bfloat16 holds
    exactly (low 16 bits zero): all of a gradient that came out of a
    bfloat16 product, next to none of an f32 one. Exact zeros say
    nothing (a 3x3 filter's off-centre taps over 1x1 maps get none)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    bits = bits[(bits & 0x7FFFFFFF) != 0]
    return float(((bits & 0xFFFF) == 0).mean()) if bits.size else 1.0


def cast_only_params(main):
    """The parameters the forward of `main` reads through casts only."""
    ops = main.global_block().ops
    read = {}
    for op in ops[:[op.type for op in ops].index("backward")]:
        for n in op.input_arg_names:
            read.setdefault(n, set()).add(op.type)
    return sorted(p.name for p in main.all_parameters()
                  if read.get(p.name) == {"cast"})


def amp_vs_cpu(fluid, bert):
    """Phase 5b (a): BERT-base width at depth 2, batch 2, dropout 0, in
    ``decorate(Adam(1e-4), use_bf16=True)``: 3 steps on the card and on the
    CPU from the same parameters. Losses within 1e-2 relative, step-1
    gradients within 5e-2·max|grad| of each parameter. The control, the
    undecorated program on the card from the same parameters, is printed
    against the same bounds and must fail the AMP signature: the gradients
    of the weights that reach the loss only through a cast to bfloat16 are
    bfloat16 values (the cast's backward widens a bfloat16 product) in the
    AMP runs, on the card and on the CPU, and f32 values in the control."""
    cfg = bert.BertConfig(num_layers=2, dropout=0.0)
    fluid.unique_name.switch()       # both programs: the same var names
    main, startup, loss = train_program(fluid, bert, cfg,
                                        amp=dict(use_bf16=True))
    fluid.unique_name.switch()
    f32_main, _, f32_loss = train_program(fluid, bert, cfg)
    scope, cpu_scope, f32_scope = fluid.Scope(), fluid.Scope(), fluid.Scope()
    exe, cpu_exe = fluid.Executor(), fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    for n, t in list(scope.items()):
        cpu_scope.set(n, t.cpu().clone())
        f32_scope.set(n, t.clone())
    n_cast = sum(op.type == "cast" for op in main.global_block().ops)
    params = {p.name for p in main.all_parameters()}
    # weights the forward reads through casts only (word_emb also feeds
    # the f32 lookup)
    cast_only = cast_only_params(main)
    ids, labels = bert.synthetic_batch(cfg, 2, SEQ, seed=SEED)
    feed = {"input_ids": ids, "mlm_labels": labels}
    grads = sorted(p + "@GRAD" for p in params)
    worst_loss, worst_grad, off, ctl_off, ctl_worst = 0.0, ("", 0.0), \
        [0, 0], [0, 0], ("", 0.0)
    share = {}
    for step in range(3):
        fetch = [loss] + (grads if step == 0 else [])
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        want = cpu_exe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
        rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
        print("train_amp[depth 2] step %d: loss card %.6f cpu %.6f (rel "
              "%.2e)" % (step, float(got[0]), float(want[0]), rel),
              flush=True)
        worst_loss = max(worst_loss, rel)
        if step:
            continue
        ctl = exe.run(f32_main, feed=feed, fetch_list=[f32_loss] + grads,
                      scope=f32_scope)
        for name, a, w, c in zip(grads, got[1:], want[1:], ctl[1:]):
            scale = max(float(np.abs(w).max()), 1e-30)
            r = float(np.abs(a - w).max()) / scale
            if not np.isfinite(a).all() or r > 5e-2:
                fail("train_amp[depth 2]: %s on the card differs from the "
                     "CPU by %.3e of max|grad| (bound 5e-2)" % (name, r))
            worst_grad = max(worst_grad, (name, r), key=lambda x: x[1])
            ctl_worst = max(ctl_worst, (name, float(np.abs(c - w).max())
                                        / scale), key=lambda x: x[1])
            for acc, x in ((off, a), (ctl_off, c)):
                n, k = off_by_more_than_an_ulp(x, w)
                acc[0] += n
                acc[1] += k
            if name[:-len("@GRAD")] in cast_only:
                for kind, x in (("card", a), ("cpu", w), ("f32", c)):
                    share[kind] = min(share.get(kind, 1.0),
                                      bf16_exact_share(x))
    print("train_amp[depth 2] vs the port on the CPU (%d casts): losses "
          "within rel %.2e (bound 1e-2); step-1 gradients of %d parameters "
          "within %.2e of max|grad| (worst %s; bound 5e-2); %.3f%% of "
          "elements more than a bf16 ulp off" % (
              n_cast, worst_loss, len(grads), worst_grad[1], worst_grad[0],
              100 * off[1] / off[0]), flush=True)
    print("train_amp[depth 2] control (undecorated, f32, on the card) vs "
          "the AMP run on the CPU: worst %.2e of max|grad| (%s; the AMP "
          "bound 5e-2), %.3f%% of elements more than a bf16 ulp off" % (
              ctl_worst[1], ctl_worst[0], 100 * ctl_off[1] / ctl_off[0]),
          flush=True)
    print("train_amp[depth 2] gradients of the %d weights read only by "
          "casts: least share of bfloat16 values %.4f on the card, %.4f on "
          "the CPU, %.4f in the f32 control" % (
              len(cast_only), share["card"], share["cpu"], share["f32"]),
          flush=True)
    if worst_loss > 1e-2:
        fail("train_amp[depth 2]: card losses differ from the CPU run")
    if not cast_only or share["card"] < 1.0 or share["cpu"] < 1.0:
        fail("train_amp[depth 2]: a cast weight's gradient is not a "
             "bfloat16 product's: AMP did not run as rewritten")
    if share["f32"] > 0.5:
        fail("train_amp[depth 2]: the f32 control looks like AMP: the check "
             "cannot tell AMP on from off")


def dynamic_scaling_checks(fluid, bert):
    """Phase 5b (b) on the card. A power-of-two loss scale (2^15, dynamic)
    against the undecorated f32 program from the same parameters, BERT-base
    width at depth 2, dropout 0, 3 Adam steps: every persistable value
    bit-identical (a second f32 run tells a scale effect from run-to-run
    differences). Then a small fc program with Adam(0.1) and dynamic
    scaling from 8 (decay every bad step by 0.5): a good step, then inf
    feeds; each overflow step leaves parameters, moments and beta powers
    bit-identical and halves the scale, down to its floor of 1."""
    cfg = bert.BertConfig(num_layers=2, dropout=0.0)
    ids, labels = bert.synthetic_batch(cfg, 2, SEQ, seed=SEED)
    feed = {"input_ids": ids, "mlm_labels": labels}
    exe = fluid.Executor()
    finals, start = [], None
    for amp in (None, dict(use_bf16=False, init_loss_scaling=2.0 ** 15),
                None):
        fluid.unique_name.switch()   # the same accumulator names
        main, startup, loss = train_program(fluid, bert, cfg, amp)
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if start is None:
            start = {n: t.clone() for n, t in scope.items()}
        for n, t in start.items():
            scope.set(n, t.clone())
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                                scope=scope)[0]) for _ in range(3)]
        finals.append((losses, {n: scope[n] for n in start}))
    (l0, plain), (l1, scaled), (l2, again) = finals

    def differ(a, b):
        bad = [n for n in a if not torch.equal(a[n], b[n])]
        err = max([(a[n] - b[n]).abs().max().item() for n in bad] or [0.0])
        return bad, err

    bad, err = differ(plain, scaled)
    rerun, rerun_err = differ(plain, again)
    print("dynamic scaling [depth 2]: 2^15 scale vs f32, 3 steps: losses "
          "%s vs %s; %d of %d persistable values differ (max|d| %.3e%s); a "
          "second f32 run: %d differ (max|d| %.3e%s)" % (
              " ".join("%.6f" % x for x in l1),
              " ".join("%.6f" % x for x in l0), len(bad), len(plain), err,
              (": " + ", ".join(bad[:6])) if bad else "", len(rerun),
              rerun_err, (": " + ", ".join(rerun[:6])) if rerun else ""),
          flush=True)
    # bit-identity, unless the f32 program itself differs from run to run:
    # then the scale may differ from it by no more than it differs from
    # itself
    if (bad or l0 != l1) and not (rerun and err <= rerun_err):
        fail("dynamic scaling: a 2^15 loss scale changed the f32 step's "
             "result (%d values, max|d| %.3e; the f32 program itself "
             "differs from run to run in %d, max|d| %.3e)" % (
                 len(bad), err, len(rerun), rerun_err))

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", shape=[None, 4], dtype="float32")
        y = fluid.layers.fc(fluid.layers.fc(x, size=3), size=1)
        floss = fluid.layers.mean(y)
        opt = fluid.contrib.mixed_precision.decorate(
            fluid.optimizer.Adam(learning_rate=0.1), use_bf16=False,
            init_loss_scaling=8.0, decr_every_n_nan_or_inf=1, decr_ratio=0.5)
        opt.minimize(floss)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    state = [n for n in scope.keys() if ".w_" in n or ".b_" in n
             or "moment" in n or "beta" in n]
    fetch = [opt.get_loss_scaling(), opt._good_steps, opt._bad_steps]
    ok = np.ones((2, 4), np.float32)
    got = exe.run(main, feed={"x": ok}, fetch_list=fetch, scope=scope)
    trail = [tuple(float(v[0]) for v in got)]
    for _ in range(4):
        before = {n: scope[n].clone() for n in state}
        got = exe.run(main, feed={"x": np.full((2, 4), np.inf, np.float32)},
                      fetch_list=fetch, scope=scope)
        trail.append(tuple(float(v[0]) for v in got))
        moved = [n for n in state if not torch.equal(before[n], scope[n])]
        if moved:
            fail("dynamic scaling: an overflow step moved %s" % moved)
    print("dynamic scaling [fc]: (scale, good, bad) after a good step and 4 "
          "overflow steps: %s; %d parameters, moments and beta powers "
          "bit-identical over each overflow step" % (trail, len(state)),
          flush=True)
    # the reference's rule: decay by 0.5 on every bad step, counters reset,
    # the scale floored at 1
    if trail != [(8.0, 1.0, 0.0), (4.0, 0.0, 0.0), (2.0, 0.0, 0.0),
                 (1.0, 0.0, 0.0), (1.0, 0.0, 0.0)]:
        fail("dynamic scaling: the scale did not follow the rule: %s" % trail)


PER_STEP = {"flash_attn_fwd": 12, "flash_attn_bwd_dq": 12,
            "flash_attn_bwd_dkdv": 12, "layer_norm_fwd": 25,
            "layer_norm_bwd": 25}


def counters(ca, cl):
    return {"flash_attn_fwd": ca.flash_attention,
            "flash_attn_bwd_dq": ca.flash_attention_dq,
            "flash_attn_bwd_dkdv": ca.flash_attention_dkdv,
            "layer_norm_fwd": cl.layer_norm_fwd,
            "layer_norm_bwd": cl.layer_norm_bwd}


def train_phase(fluid, bert, ca, cl, amp=None):
    """Full BERT-base, batch 8, seq 128, dropout 0.1, Adam 1e-4 (decorated
    by ``decorate(**amp)`` when `amp` is given): TRAIN_WARMUP + TRAIN_STEPS
    counted steps through Executor.run; returns the launch counts of that
    run, a function that runs one more step, and the step's numbers."""
    tag = "bert_base" if amp is None else "bert_base, bf16 AMP"
    cfg = bert.bert_base()
    main, startup, loss = train_program(fluid, bert, cfg, amp)
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
    print("train[%s]: %d steps, losses %s" % (
        tag, steps, " ".join("%.4f" % x for x in losses)), flush=True)
    print("train[%s]: launches %s (want %s per step x %d)" % (
        tag, launches, PER_STEP, steps), flush=True)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail("train[%s]: loss not finite or not falling" % tag)
    if any(launches[n] != PER_STEP[n] * steps for n in PER_STEP):
        fail("train[%s]: launches %s, want %s per step" % (
            tag, launches, PER_STEP))
    timed = sorted(1e3 * w for w in walls[TRAIN_WARMUP:])
    stats = dict(median_ms=statistics.median(timed),
                 p90_ms=timed[min(len(timed) - 1, int(0.9 * len(timed)))],
                 peak_gib=peak / 2 ** 30)
    stats["tokens_per_s"] = 8 * SEQ / stats["median_ms"] * 1e3
    print("train[%s] step time over %d steps: median %.3f ms, p90 %.3f ms, "
          "%.1f tokens/s; peak device memory %.3f GiB" % (
              tag, len(timed), stats["median_ms"], stats["p90_ms"],
              stats["tokens_per_s"], stats["peak_gib"]), flush=True)
    return launches, lambda: exe.run(main, feed=feed, fetch_list=[loss],
                                     scope=scope), stats


GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def _subtree_kernels(e):
    """Device activity launched under a profiler CPU event (kernels only:
    not memcpys or memsets), as (name, us) pairs."""
    out = [(k.name, k.duration) for k in e.kernels
           if not k.name.startswith(("Memcpy", "Memset"))]
    for c in e.cpu_children:
        out += _subtree_kernels(c)
    return out


def _input_dtypes(prof):
    """The input dtypes of each profiled CPU op by event id, from the
    profiler's own record of them (``record_shapes=True``); an empty list
    where the profiler gives none."""
    return {ev.correlation_id(): getattr(ev, "dtypes", list)()
            for ev in prof.profiler.kineto_results.events()}


def _gemm_dtype(dtypes):
    dt = str(dtypes[0]) if dtypes else "unknown"
    return {"c10::BFloat16": "bf16", "float": "f32"}.get(dt, dt)


def profile_train_step(step, tag="train step", extra=None):
    """Device busy vs host wall of one training step, the device time by
    kernel, the GEMMs' device time by input dtype, the dtype conversions'
    (``aten::_to_copy``) launches and time, and the host time of the
    lowering's three ranges; ``extra(prof, numbers)`` reads more of the
    same profile. Returns those numbers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
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
    stats = dict(busy_ms=busy, wall_ms=prof_wall,
                 idle=max(0.0, 1 - busy / prof_wall))
    print("profile[%s]: device busy %.3f ms of %.3f ms host wall while "
          "profiled (idle share %.1f%%)" % (tag, busy, prof_wall,
                                            100 * stats["idle"]), flush=True)
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
    # GEMMs by input dtype, and the dtype conversions
    gemm, gemm_names, casts = {}, {}, [0, 0.0]
    dtypes = _input_dtypes(prof)
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        if e.name in GEMM_OPS and e.kernels:
            ks = _subtree_kernels(e)
            dt = _gemm_dtype(dtypes.get(e.id))
            n, us = gemm.get(dt, (0, 0.0))
            gemm[dt] = (n + len(ks), us + sum(d for _, d in ks))
            for name, d in ks:
                key = (dt, name[:70])
                gemm_names[key] = gemm_names.get(key, 0.0) + d
        elif e.name == "aten::_to_copy":
            ks = _subtree_kernels(e)
            casts[0] += len(ks)
            casts[1] += sum(d for _, d in ks)
    stats["gemm"] = {dt: dict(launches=n, ms=us / 1e3)
                     for dt, (n, us) in gemm.items()}
    stats["casts"] = dict(launches=casts[0], ms=casts[1] / 1e3)
    print("profile[%s] GEMMs by input dtype: %s; dtype conversions "
          "(aten::_to_copy): %d launches, %.3f ms" % (
              tag, ", ".join("%s %d launches %.3f ms" % (dt, g["launches"],
                                                         g["ms"])
                             for dt, g in sorted(stats["gemm"].items())),
              casts[0], casts[1] / 1e3), flush=True)
    for dt in sorted(gemm):
        for (_, name), us in sorted(((k, v) for k, v in gemm_names.items()
                                     if k[0] == dt), key=lambda kv: -kv[1])[:3]:
            print("  GEMM %-4s %8.3f ms/step %s" % (dt, us / 1e3, name),
                  flush=True)
    # host side: the lowering's three profiler ranges, and kernel launches
    host = {e.key: e for e in prof.key_averages()
            if e.device_type == DeviceType.CPU
            and (e.key.startswith("paddle_tpu_torch::")
                 or e.key == "cudaLaunchKernel")}
    print("profile[%s] host: %s; cudaLaunchKernel x%d" % (
        tag,
        ", ".join("%s %.3f ms" % (k.split("::")[1], host[k].cpu_time_total
                                  / 1e3)
                  for k in ("paddle_tpu_torch::forward",
                            "paddle_tpu_torch::backward",
                            "paddle_tpu_torch::optimizer") if k in host),
        host["cudaLaunchKernel"].count if "cudaLaunchKernel" in host else 0),
        flush=True)
    stats["launch_calls"] = (host["cudaLaunchKernel"].count
                             if "cudaLaunchKernel" in host else 0)
    if extra is not None:
        extra(prof, stats)
    return stats


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
    64), LayerNorm (8·128, 768); the LayerNorm forward and F.layer_norm also
    at the other buckets' rows (128·B, 768), B = 1, 2, 4, at the GPT decode
    step's (8, 768) and at its 64-row prefill bucket; and the launch
    floor, the device time of a one-element fill_. Returns the times by
    (kernel, dtype), the buckets' by (rows, dtype), and the floor."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    res, buckets = {}, {}
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
        # the GPT decode step's rows (8 slots) and a prefill bucket, then
        # the serving buckets'
        for rows in (8, 64, SEQ, 2 * SEQ, 4 * SEQ):
            xb = x[:rows].clone()
            buckets[(rows, dt)] = dict(
                ms=device_ms(lambda: cl.layer_norm_fwd(xb, g, b, 1e-5)),
                library_ms=device_ms(
                    lambda: F.layer_norm(xb, (768,), g, b, 1e-5)),
                bound_ms=layer_norm_bound_ms(rows, 768, dt)[0])
        buckets[(8 * SEQ, dt)] = {key: res[("layer_norm_fwd", dt)][key]
                                  for key in ("ms", "library_ms", "bound_ms")}
    one = torch.zeros(1, device="cuda")
    floor = device_ms(lambda: one.fill_(1.0))
    for (name, dt), r in res.items():
        print("time %-15s %-8s kernel %.4f ms  plain %.4f ms  library %.4f "
              "ms  bound %.4f ms (%s)" % (name, str(dt)[6:], r["ms"],
                                          r["plain_ms"], r["library_ms"],
                                          r["bound_ms"], r["bound_by"]),
              flush=True)
    for (rows, dt), r in sorted(buckets.items(), key=lambda kv: (
            kv[0][1] != torch.float32, kv[0][0])):
        print("time layer_norm_fwd (%4d, 768) %-8s kernel %.4f ms  "
              "F.layer_norm %.4f ms  bound %.4f ms  launch floor %.4f ms" % (
                  rows, str(dt)[6:], r["ms"], r["library_ms"], r["bound_ms"],
                  floor), flush=True)
    return res, buckets, floor


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


# ---------------------------------------------------------------------------
# phase 7: the ResNet slice
# ---------------------------------------------------------------------------
# 7a-7c: ResNet-50 (1000 classes, every width as published), cut to batch 4
# at 64x64 so that its CPU side takes seconds
CHECK_IMAGE, CHECK_BATCH, CHECK_STEPS = 64, 4, 3
# 7d: bench.py's ResNet-50 measurement (bench.py:682-718)
BENCH_IMAGE, BENCH_BATCH, BENCH_SEED = 224, 128, 7
BENCH_FLOPS_PER_IMAGE = 3 * 3.86e9           # bench.py:733
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution_backward")
LAYOUT_KERNELS = re.compile(r"nchwToNhwc|nhwcToNchw|nchw2nhwc|nhwc2nchw",
                            re.I)


def resnet_program(fluid, resnet, image, lr, amp=False):
    """ResNet-50, 1000 classes, `image` x `image`, Momentum(lr, 0.9) as
    bench.py trains it, decorated by ``decorate(use_bf16=True)`` when
    `amp`; fresh names, so every build names its vars alike."""
    fluid.unique_name.switch()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        io = resnet.build_resnet_train(depth=50, class_num=1000,
                                       image_size=image)
        opt = fluid.optimizer.Momentum(lr, 0.9)
        if amp:
            opt = fluid.contrib.mixed_precision.decorate(opt, use_bf16=True)
        opt.minimize(io["loss"])
    return main, startup, io


def resnet_feed(image, batch, seed=0):
    """Synthetic images and labels as bench.py makes them (bench.py:703)."""
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((batch, 3, image, image),
                                         dtype=np.float32),
            "label": rng.integers(0, 1000, size=(batch, 1), dtype=np.int64)}


def rel_err(a, w):
    return float(np.abs(np.asarray(a, np.float64) - w).max()) / max(
        float(np.abs(w).max()), 1e-30)


def grad_dist(got, want):
    """All of `got` against all of `want`: sqrt(sum d^2) / sqrt(sum w^2)."""
    num = sum(float(((np.asarray(a, np.float64) - w) ** 2).sum())
              for a, w in zip(got, want))
    den = sum(float((np.asarray(w, np.float64) ** 2).sum()) for w in want)
    return float(np.sqrt(num / den))


def grad_summary(got, want, names):
    """(worst max|d|/max|grad| and its name, the median over parameters,
    all gradients together)."""
    rels = [(rel_err(a, w), n) for n, a, w in zip(names, got, want)]
    return (max(rels), float(np.median([r for r, _ in rels])),
            grad_dist(got, want))


def host(t):
    return t.detach().float().cpu().numpy()


def step_record(main):
    """An empty record of steps of `main`: losses, the first step's
    gradients, the moving statistics after each step."""
    return dict(losses=[], stats=[], grads=None,
                names=sorted(p.name + "@GRAD" for p in main.all_parameters()
                             if p.trainable),
                stat_names=sorted(p.name for p in main.all_parameters()
                                  if not p.trainable))


def record_step(out, exe, main, io, feed, scope):
    """Run one step of `main` on `scope` and add it to `out`."""
    first = not out["losses"]
    got = exe.run(main, feed=feed, scope=scope,
                  fetch_list=[io["loss"]] + (out["names"] if first else []))
    out["losses"].append(float(got[0]))
    if first:
        out["grads"] = got[1:]
    out["stats"].append([host(scope[n]) for n in out["stat_names"]])


def run_resnet_steps(fluid, main, io, states, feed, place=None):
    """One step of `main` from each state in `states` (name -> CPU tensor)
    on `place` (the card by default), recorded by record_step; the last
    step's scope comes back as ``scope``."""
    exe, out = fluid.Executor(place), step_record(main)
    for state in states:
        out["scope"] = fluid.Scope()
        for n, t in state.items():
            out["scope"].set(n, t.clone())
        record_step(out, exe, main, io, feed, out["scope"])
    return out


def cpu_run(fluid, main, io, start, feed, steps):
    """`steps` steps of `main` on the CPU from `start`, recorded by
    record_step, with the state before each step (name -> CPU tensor) as
    ``states``."""
    exe, out = fluid.Executor(fluid.CPUPlace()), step_record(main)
    out["states"] = []
    scope = fluid.Scope()
    for n, t in start.items():
        scope.set(n, t.clone())
    for _ in range(steps):
        out["states"].append({n: t.clone() for n, t in scope.items()})
        record_step(out, exe, main, io, feed, scope)
    return out


def compare_resnet(tag, card, cpu):
    """Card against CPU, each step from the same state: the worst loss
    error, the first step's gradients (grad_summary) and the worst moving
    statistic after any step (max|d|/max|stat|)."""
    loss = max(abs(a - w) / abs(w) for a, w in zip(card["losses"],
                                                   cpu["losses"]))
    grads = grad_summary(card["grads"], cpu["grads"], cpu["names"])
    stat = max((rel_err(a, w), n) for got, want in zip(card["stats"],
                                                      cpu["stats"])
               for n, a, w in zip(cpu["stat_names"], got, want))
    print("%s: losses card %s cpu %s (worst rel %.2e); step-1 gradients of "
          "%d parameters: worst %.2e of max|grad| (%s), median %.2e, all "
          "together %.2e; moving statistics after each step: worst %.2e of "
          "max|stat| (%s)" % (
              tag, " ".join("%.6f" % x for x in card["losses"]),
              " ".join("%.6f" % x for x in cpu["losses"]), loss,
              len(cpu["names"]), grads[0][0], grads[0][1], grads[1],
              grads[2], stat[0], stat[1]), flush=True)
    return dict(loss=loss, grad=grads[0], median=grads[1], dist=grads[2],
                stat=stat)


def resnet_vs_cpu(fluid, resnet, lowering, image=CHECK_IMAGE,
                  batch=CHECK_BATCH, steps=CHECK_STEPS):
    """Phase 7a. ResNet-50 in f32, Momentum(1e-3, 0.9), `steps` steps on
    the CPU, and on the card each step from the CPU's state before it
    (a step's gradients are too sensitive for two runs to stay together,
    see below). Bounds: losses 1e-3 relative, moving statistics after
    each step 1e-3·max|stat|. The step-1 gradients are held by the median
    over parameters of max|d|/max|grad| and by all of them together, both
    within 5e-2 and within 3x what the CPU moves itself when the image
    moves by one f32 ulp, plus 1e-3 (printed first: the issue's
    per-parameter bound, 1e-3·max|grad|, is printed beside them but not
    held: tests/test_torch_resnet_train.py measures the JAX package moving its
    own gradients by up to 32% of a parameter's max|grad| under that
    nudge). Then the same card steps with cuDNN's TF32 left on inside the
    run (printed, not held). Returns (program, io, the card's end scope,
    the start state, the card's step-1 gradients, the feed)."""
    main, startup, io = resnet_program(fluid, resnet, image, 1e-3)
    startup.random_seed = SEED
    init = fluid.Scope()
    fluid.Executor().run(startup, scope=init)
    start = {n: t.cpu().clone() for n, t in init.items()}
    feed = resnet_feed(image, batch)
    cpu = cpu_run(fluid, main, io, start, feed, steps)
    states = cpu["states"]
    nudged = run_resnet_steps(fluid, main, io, states[:1], dict(
        feed, image=np.nextafter(feed["image"], np.float32(np.inf))),
        fluid.CPUPlace())
    own = grad_summary(nudged["grads"], cpu["grads"], cpu["names"])
    print("resnet50 f32 [%dx%d, batch %d; cut so the CPU side takes "
          "seconds]: the CPU against itself with the image one f32 ulp up: "
          "step-1 gradients worst %.2e of max|grad| (%s), median %.2e, all "
          "together %.2e" % (image, image, batch, own[0][0], own[0][1],
                             own[1], own[2]), flush=True)
    card = run_resnet_steps(fluid, main, io, states, feed)
    got = compare_resnet("7a resnet50 f32 card vs cpu", card, cpu)
    bound = {k: min(5e-2, 3 * v + 1e-3) for k, v in (("median", own[1]),
                                                      ("dist", own[2]))}
    print("7a bounds: losses 1e-3, moving statistics 1e-3, gradients median "
          "%.2e, all together %.2e (issue's per-parameter bound 1e-3: "
          "worst %.2e, not held)" % (bound["median"], bound["dist"],
                                     got["grad"][0]), flush=True)
    if got["loss"] > 1e-3 or got["stat"][0] > 1e-3:
        fail("7a: card losses or moving statistics differ from the CPU run")
    if got["median"] > bound["median"] or got["dist"] > bound["dist"]:
        fail("7a: card step-1 gradients differ from the CPU run")
    # cuDNN's algorithms may sum with atomics: the same card steps again
    again = run_resnet_steps(fluid, main, io, states, feed)
    differ = [n for n, a, b in zip(card["names"], card["grads"],
                                   again["grads"]) if not np.array_equal(a, b)]
    print("7a: two card runs of the same steps: losses %s, step-1 gradients "
          "bit-identical in %d of %d parameters%s, moving statistics %s" % (
              "equal" if card["losses"] == again["losses"] else "differ",
              len(card["names"]) - len(differ), len(card["names"]),
              " (max|d| %.3e)" % max(float(np.abs(a - b).max()) for a, b in
                                      zip(card["grads"], again["grads"]))
              if differ else "",
              "equal" if all(np.array_equal(a, b) for s, t in zip(
                  card["stats"], again["stats"]) for a, b in zip(s, t))
              else "differ"), flush=True)
    cudnn = torch.backends.cudnn
    switches = lowering.precision_switches
    try:
        cudnn.allow_tf32 = True
        lowering.precision_switches = lambda: [
            s for s in switches()
            if s[0] is not cudnn.conv]
        tf32 = run_resnet_steps(fluid, main, io, states, feed)
    finally:
        lowering.precision_switches = switches
    compare_resnet("7a with cuDNN TF32 on inside the run (not held)", tf32,
                   cpu)
    return main, io, card["scope"], start, card["grads"], feed


def amp_resnet_vs_cpu(fluid, resnet, start, f32_grads, feed,
                      image=CHECK_IMAGE, steps=CHECK_STEPS):
    """Phase 7b. 7a's configuration in ``decorate(Momentum(1e-3, 0.9),
    use_bf16=True)`` from 7a's start, each card step from the CPU's state.
    Losses within 1e-2 relative. The step-1 gradients: the issue's
    per-parameter bound (5e-2·max|grad|) is printed, not held: in
    bfloat16 two correct runs round some conv outputs to neighbouring
    values and ResNet's batch norms spread each flip, so the card's and
    the CPU's AMP gradients lie about as far apart as either lies from f32
    (tests/test_torch_resnet.py, test_resnet18_bf16_amp_matches_jax). Held
    here: all gradients together no farther from the CPU's than twice the
    CPU's are from the f32 gradients of 7a (the card's, same state). At
    this configuration that distance exceeds the gradients' own norm, so
    the bound passes any gradient of a norm near the right one, a zero or
    a negated one too: the backward is held op by op instead
    (amp_backward_vs_cpu). Control: the gradients of the weights read only through casts (the 53
    conv filters and the fc weight) are bfloat16 values in every element
    on the card and on the CPU, and in next to none of the f32 run's."""
    main, _, io = resnet_program(fluid, resnet, image, 1e-3, amp=True)
    cpu = cpu_run(fluid, main, io, start, feed, steps)
    card = run_resnet_steps(fluid, main, io, cpu["states"], feed)
    got = compare_resnet("7b resnet50 bf16 AMP card vs cpu", card, cpu)
    amp_effect = grad_dist(cpu["grads"], f32_grads)
    cast = {n + "@GRAD" for n in cast_only_params(main)}
    cast_only = [i for i, n in enumerate(cpu["names"]) if n in cast]
    share = {kind: [bf16_exact_share(g[i]) for i in cast_only]
             for kind, g in (("card", card["grads"]), ("cpu", cpu["grads"]),
                             ("f32", f32_grads))}
    print("7b bounds: losses 1e-2 (worst %.2e); all gradients together "
          "%.2e from the CPU's, bound 2 x %.2e (the CPU's AMP gradients "
          "from 7a's f32 ones); issue's per-parameter bound 5e-2: worst "
          "%.2e, not held; %d weights read only through casts: least share "
          "of bfloat16 values %.4f on the card, %.4f on the CPU, most in "
          "the f32 run %.4f" % (
              got["loss"], got["dist"], amp_effect, got["grad"][0],
              len(cast_only), min(share["card"]), min(share["cpu"]),
              max(share["f32"])), flush=True)
    if got["loss"] > 1e-2:
        fail("7b: card AMP losses differ from the CPU run")
    if got["dist"] > 2 * amp_effect:
        fail("7b: card AMP gradients farther from the CPU's than AMP is "
             "from f32")
    if len(cast_only) != 54 or min(share["card"]) < 1.0 \
            or min(share["cpu"]) < 1.0:
        fail("7b: a cast weight's gradient is not a bfloat16 product's")
    if max(share["f32"]) > 0.5:
        fail("7b: the f32 run looks like AMP: the check cannot tell them "
             "apart")


def bf16_ulp_ratio(got, want):
    """max |got - want| / (one bfloat16 ulp of want + 1e-3·max|want|): at
    most 1 where `got` is `want` or its bfloat16 neighbour."""
    got, want = host(got).astype(np.float64), host(want).astype(np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                  - 7)
    return float((np.abs(got - want)
                  / (ulp + 1e-3 * np.abs(want).max())).max())


def amp_backward_shapes(fluid, resnet):
    """The distinct (op type, input shapes, attrs) of the conv2d,
    batch_norm and max pool2d ops of bench.py's decorated ResNet-50 at
    batch BENCH_BATCH, 224x224: what 7d's backward runs."""
    main, _, _ = resnet_program(fluid, resnet, BENCH_IMAGE, 0.1, amp=True)
    block, seen = main.global_block(), {}
    for op in block.ops:
        if op.type not in ("conv2d", "batch_norm", "pool2d") or (
                op.type == "pool2d" and op.attr("pooling_type") != "max"):
            continue
        slot = {"conv2d": "Input"}.get(op.type, "X")
        x = (BENCH_BATCH,) + tuple(block.var(op.input(slot)[0]).shape[1:])
        w = (tuple(block.var(op.input("Filter")[0]).shape)
             if op.type == "conv2d" else ())
        attrs = {k: v for k, v in sorted(op.attrs.items())
                 if not k.startswith("op_")}
        seen.setdefault((op.type, x, w, repr(attrs)), (op.type, x, w, attrs))
    return list(seen.values())


def amp_backward_vs_cpu(fluid, resnet, lowering):
    """Phase 7b, op by op: the backward of each distinct conv2d (dInput
    and dFilter), batch_norm (dX with bfloat16 X and f32 statistics,
    dScale, dBias) and max pool of 7d's bf16 program, at its shapes and
    batch, through the port's lowering on the card (as a run enters it,
    in f32_precision) against the port's CPU lowering in f32 on the same
    bfloat16 values, rounded once to bfloat16. Bounds: bfloat16 gradients
    within one bfloat16 ulp + 1e-3·max (the f32 sums of card and CPU are
    taken in other orders, so a value on a rounding boundary may land on
    its neighbour); f32 gradients (dScale, dBias) within 1e-3·max|grad|.
    Control: the dFilter of the convolution with the longest reduction,
    summed image by image in bfloat16 (a split-K with bfloat16 partials,
    the fault a reduced-precision weight gradient would have), must fail
    the bound."""
    from paddle_tpu_torch.ops.registry import LowerContext, get_lowering
    gen = torch.Generator().manual_seed(SEED + 70)

    def bf16(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).bfloat16()

    def run(op_type, ins, attrs, wrt, out_slot, cot, device):
        ins = {k: [t.to(device).detach().requires_grad_(k in wrt)
                   for t in v]
               for k, v in ins.items()}
        ctx = LowerContext(torch.device(device))
        out = get_lowering(op_type)(ctx, ins, dict(attrs))[out_slot][0]
        return torch.autograd.grad(out, [ins[k][0] for k in wrt],
                                   cot.to(device, out.dtype))

    t0, worst, longest = time.monotonic(), {}, None
    shapes = amp_backward_shapes(fluid, resnet)
    for op_type, xs, ws, attrs in shapes:
        x = bf16(xs)
        if op_type == "conv2d":
            ins = {"Input": [x],
                   "Filter": [bf16(ws, (2.0 / np.prod(ws[1:])) ** 0.5)]}
            wrt, out_slot, names = ("Input", "Filter"), "Output", (
                "conv dInput", "conv dFilter")
        elif op_type == "batch_norm":
            c = xs[1]
            ins = {"X": [x], "Scale": [torch.rand(c, generator=gen) + 0.5],
                   "Bias": [torch.randn(c, generator=gen)],
                   "Mean": [torch.zeros(c)], "Variance": [torch.ones(c)]}
            wrt, out_slot, names = ("X", "Scale", "Bias"), "Y", (
                "bn dX", "bn dScale", "bn dBias")
        else:
            ins, wrt, out_slot, names = {"X": [x]}, ("X",), "Out", (
                "max pool dX",)
        with torch.no_grad():
            shape = get_lowering(op_type)(
                LowerContext(torch.device("cuda")),
                {k: [t.cuda() for t in v] for k, v in ins.items()},
                dict(attrs))[out_slot][0].shape
        cot = bf16(shape)
        with lowering.f32_precision():
            card = run(op_type, ins, attrs, wrt, out_slot, cot, "cuda")
        cpu = run(op_type, {k: [t.float() for t in v]
                            for k, v in ins.items()},
                  attrs, wrt, out_slot, cot.float(), "cpu")
        for name, a, w in zip(names, card, cpu):
            if a.dtype == torch.bfloat16:
                r = bf16_ulp_ratio(a, w.bfloat16())
            else:
                r = rel_err(host(a), host(w).astype(np.float64)) / 1e-3
            if r > worst.get(name, (-1.0,))[0]:
                worst[name] = (r, "%s x%s w%s" % (op_type, xs, ws or ""))
        if op_type == "conv2d" and (longest is None or np.prod(
                shape[2:]) > np.prod(longest[0][2:])):
            longest = (shape, ins, attrs, cot, cpu[1])
        del card, cpu
    # the control: dFilter summed image by image in bfloat16
    shape, ins, attrs, cot, want = longest
    acc = None
    with lowering.f32_precision():
        for i in range(BENCH_BATCH):
            one = {"Input": [ins["Input"][0][i:i + 1]],
                   "Filter": ins["Filter"]}
            g, = run("conv2d", one, attrs, ("Filter",), "Output",
                     cot[i:i + 1], "cuda")
            acc = g if acc is None else acc + g
    control = bf16_ulp_ratio(acc, want.bfloat16())
    torch.cuda.synchronize()
    print("7b backward op by op [%s, batch %d, %dx%d, the card's bf16 "
          "lowering vs the CPU's f32 one on the same bfloat16 values, "
          "rounded once]: %d distinct shapes, %.1f s; worst error / bound "
          "(bfloat16: one ulp + 1e-3·max; f32: 1e-3·max|grad|; pass <= 1): "
          "%s; control (dFilter of %s summed image by image in bfloat16, "
          "must fail): %.2f" % (
              torch.cuda.get_device_name(0), BENCH_BATCH, BENCH_IMAGE,
              BENCH_IMAGE, len(shapes),
              time.monotonic() - t0,
              "; ".join("%s %.3f (%s)" % (n, r, where)
                        for n, (r, where) in sorted(worst.items())),
              tuple(ins["Filter"][0].shape), control), flush=True)
    if len(worst) != 6 or max(r for r, _ in worst.values()) > 1.0:
        fail("7b: a bf16 backward op on the card disagrees with the CPU")
    if control <= 1.0:
        fail("7b: a bf16-summed weight gradient passes the op-by-op bound: "
             "the check cannot tell")


def resnet_inference(fluid, main, io, scope, image=CHECK_IMAGE):
    """Phase 7c. 7a's card-trained program saved with save_inference_model
    (pruned to the logits), loaded by Predictor.from_model on the card and
    on the CPU: 8 requests of one image and a batch of 8, logits within
    1e-3·max|logit| of the CPU's; every batch_norm of the loaded program
    runs is_test."""
    rng = np.random.default_rng(SEED + 7)
    images = rng.standard_normal((8, 3, image, image), dtype=np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        fluid.io.save_inference_model(tmp, ["image"], [io["logits"]],
                                      fluid.Executor(), main_program=main,
                                      scope=scope)
        pred = fluid.Predictor.from_model(tmp)
        cpu = fluid.Predictor.from_model(tmp, place=fluid.CPUPlace())
        want, = cpu.run({"image": images})
        singles = [pred.run({"image": images[i:i + 1]})[0] for i in range(8)]
        batch, = pred.run({"image": images})
    bns = [op for op in pred.program.global_block().ops
           if op.type == "batch_norm"]
    scale = float(np.abs(want).max())
    err = max(float(np.abs(np.concatenate(singles) - want).max()),
              float(np.abs(batch - want).max()))
    print("7c resnet50 inference [%dx%d]: %d batch_norm ops, all is_test: "
          "%s; 8 single requests and a batch of 8 on the card vs the CPU: "
          "max|d| %.3e, bound 1e-3·max|logit| = %.3e" % (
              image, image, len(bns), all(op.attr("is_test") for op in bns),
              err, 1e-3 * scale), flush=True)
    if len(bns) != 53 or not all(op.attr("is_test") for op in bns):
        fail("7c: the loaded program's batch norms do not run is_test")
    if not np.isfinite(batch).all() or err > 1e-3 * scale:
        fail("7c: card logits disagree with the CPU's")


def program_flops_per_image(main):
    """Training FLOPs per image from the program's own conv2d and mul
    shapes: 2 per multiply-add, x3 for the forward and the two products
    of the backward."""
    block = main.global_block()
    macs = 0
    for op in block.ops:
        if op.type == "conv2d":
            out = block.var(op.output("Output")[0]).shape
            w = block.var(op.input("Filter")[0]).shape
            macs += int(np.prod(out[1:])) * int(np.prod(w[1:]))
        elif op.type == "mul":
            x = block.var(op.input("X")[0]).shape
            y = block.var(op.input("Y")[0]).shape
            macs += int(np.prod(x[1:])) * int(np.prod(y[1:]))
    return 3 * 2 * macs


def resnet_bench(fluid, resnet, ca, cl, card):
    """Phase 7d. bench.py's ResNet-50 measurement: 1000 classes, batch
    128, 224x224, ``decorate(Momentum(0.1, 0.9), use_bf16=True)``,
    startup seed 7, images and labels from default_rng(0) staged on the
    card once; 3 warm-up and 20 timed steps with return_numpy=False, the
    loss fetched after the last. Step times are CUDA events recorded
    between the steps (the device's timeline; the host runs ahead). The
    five kernels' counters are read around the timed steps: no kernel of
    the port lies on this path. Returns one more step as a function, and
    the numbers."""
    main, startup, io = resnet_program(fluid, resnet, BENCH_IMAGE, 0.1,
                                       amp=True)
    startup.random_seed = BENCH_SEED
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    feed = {n: torch.from_numpy(v).cuda()
            for n, v in resnet_feed(BENCH_IMAGE, BENCH_BATCH).items()}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def step():
        return exe.run(main, feed=feed, fetch_list=[io["loss"]],
                       scope=scope, return_numpy=False)

    for _ in range(TRAIN_WARMUP):
        step()
    torch.cuda.synchronize()
    fns = counters(ca, cl)
    for fn in fns.values():
        fn.launches = 0
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(TRAIN_STEPS + 1)]
    t0 = time.monotonic()
    marks[0].record()
    for i in range(TRAIN_STEPS):
        out = step()
        marks[i + 1].record()
    loss = float(out[0])                     # waits for the card
    wall = time.monotonic() - t0
    launches = {n: fn.launches for n, fn in fns.items()}
    peak = torch.cuda.max_memory_allocated()
    steps = sorted(marks[i].elapsed_time(marks[i + 1])
                   for i in range(TRAIN_STEPS))
    stats = dict(median_ms=statistics.median(steps),
                 p90_ms=steps[min(len(steps) - 1, int(0.9 * len(steps)))],
                 peak_gib=peak / 2 ** 30, resident_gib=resident / 2 ** 30,
                 loss=loss, wall_ms=1e3 * wall / TRAIN_STEPS)
    stats["window_ms"] = marks[0].elapsed_time(marks[-1])
    stats["images_per_s"] = (TRAIN_STEPS * BENCH_BATCH
                             / stats["window_ms"] * 1e3)
    flops = program_flops_per_image(main)
    stats["share"] = stats["images_per_s"] * flops / PEAK_FLOPS[
        torch.bfloat16]
    print("7d resnet50 bench [%s]: batch %d, %dx%d, bf16 AMP, Momentum(0.1, "
          "0.9): loss %.4f after %d steps; step median %.3f ms, p90 %.3f ms "
          "(CUDA events between steps; host wall %.3f ms a step); %.1f "
          "images/s (%d x %d images over the %.3f ms of the %d timed "
          "steps); peak device memory %.3f GiB (%.3f GiB resident before "
          "the phase)" % (
              card, BENCH_BATCH, BENCH_IMAGE, BENCH_IMAGE, loss,
              TRAIN_WARMUP + TRAIN_STEPS, stats["median_ms"],
              stats["p90_ms"], stats["wall_ms"], stats["images_per_s"],
              TRAIN_STEPS, BENCH_BATCH, stats["window_ms"], TRAIN_STEPS,
              stats["peak_gib"], stats["resident_gib"]), flush=True)
    print("7d FLOPs per image, counted from the program's 53 conv2d and 1 "
          "mul shapes (2 per multiply-add, x3 for training): %.4e; "
          "bench.py:733's 3 x 3.86e9 = %.4e; the share uses the counted "
          "one: %.4f of the card's bf16 dense peak (989 TFLOP/s) [%s]; "
          "kernel launches of the port's five kernels in the timed steps: "
          "%s (none lies on this path)" % (
              flops, BENCH_FLOPS_PER_IMAGE, stats["share"], card, launches),
          flush=True)
    if not np.isfinite(loss):
        fail("7d: the bench loss is not finite")
    return step, stats


def resnet_profile(step, stats, card):
    """Phase 7e. One profiled step of 7d: busy and idle share, kernels and
    GEMMs (profile_train_step), then the convolutions' device time and
    launches by input dtype, cuDNN's layout transforms around them, the
    dtype conversions, the 161 momentum updates (the optimizer range) and
    the rest (batch norm, relu, adds, pools and the loss: elementwise and
    reduction kernels)."""
    from torch.autograd import DeviceType

    def extra(prof, st):
        dtypes = _input_dtypes(prof)
        conv, layout, casts, optim = {}, [0, 0.0], [0, 0.0], [0, 0.0]
        for e in prof.events():
            if e.device_type != DeviceType.CPU:
                continue
            if e.name in CONV_OPS:
                dt = _gemm_dtype(dtypes.get(e.id))
                for name, us in _subtree_kernels(e):
                    if LAYOUT_KERNELS.search(name):
                        layout[0] += 1
                        layout[1] += us
                        continue
                    n, t = conv.get(dt, (0, 0.0))
                    conv[dt] = (n + 1, t + us)
            elif e.name == "aten::_to_copy":
                ks = _subtree_kernels(e)
                casts[0] += len(ks)
                casts[1] += sum(us for _, us in ks)
            elif e.name == "paddle_tpu_torch::optimizer":
                ks = _subtree_kernels(e)
                optim[0] += len(ks)
                optim[1] += sum(us for _, us in ks)
        conv_ms = sum(t for _, t in conv.values()) / 1e3
        rest = st["busy_ms"] - conv_ms - layout[1] / 1e3 - casts[1] / 1e3 \
            - optim[1] / 1e3
        print("7e resnet50 bench step [%s]: convolutions %s; cuDNN layout "
              "transforms (nchwToNhwc and the like) %d launches %.3f ms; "
              "dtype conversions (aten::_to_copy) %d launches %.3f ms; the "
              "161 momentum updates %d launches %.3f ms; the rest (batch "
              "norm, relu, adds, pools, loss) %.3f ms of %.3f ms busy" % (
                  card, ", ".join("%s %d launches %.3f ms" % (
                      dt, n, t / 1e3) for dt, (n, t) in sorted(conv.items())),
                  layout[0], layout[1] / 1e3, casts[0], casts[1] / 1e3,
                  optim[0], optim[1] / 1e3, rest, st["busy_ms"]),
              flush=True)
        st.update(conv_ms=conv_ms, layout_ms=layout[1] / 1e3,
                  optimizer_ms=optim[1] / 1e3, rest_ms=rest)

    stats.update(profile_train_step(step, "resnet50 bench step, bf16 AMP",
                                    extra=extra))
    print("7e resnet50 bench step: median %.3f ms (unprofiled), device busy "
          "%.3f ms of it: idle %.1f%% of the median step" % (
              stats["median_ms"], stats["busy_ms"],
              100 * max(0.0, 1 - stats["busy_ms"] / stats["median_ms"])),
          flush=True)


# ---------------------------------------------------------------------------
# phase 8: GPT decode serving
# ---------------------------------------------------------------------------
# GPTConfig() (vocab 32000, hidden 768, 12 layers, 12 heads, ffn 3072,
# max_len 1024: GPT-2 small's shape) with random weights from startup seed
# 9, initialised once on the CPU. 8a: one 50-token prompt in a bucket of 64
# (cache_len 128), then 16 steps teacher-forced with the card's tokens, on
# the card and on the CPU. 8b/8c: 8 slots, cache_len 1024, the default
# buckets, 8 closed-loop clients x 3 requests, prompts of 5 / 40 / 200 /
# 700 tokens in turn, 64 new tokens each.
GPT_SEED = 9
GPT_CHECK_CACHE, GPT_CHECK_BUCKET = 128, 64
GPT_CHECK_PROMPT, GPT_CHECK_STEPS = 50, 16
GPT_SLOTS, GPT_CACHE = 8, 1024
GPT_CLIENTS, GPT_PER_CLIENT, GPT_MAX_NEW = 8, 3, 64
GPT_PROMPT_LENS = (5, 40, 200, 700)
GPT_TOL = 1e-3
GPT_WAIT = 600.0                 # s: the bound of every wait for a stream


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def gpt_scope(fluid, gpt, cfg):
    """Every parameter of `cfg` (the LM's startup program creates all that
    the decode programs read), initialised once on the CPU from startup
    seed GPT_SEED."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        gpt.build_gpt_lm(cfg, 8, is_test=True)
    startup.random_seed = GPT_SEED
    scope = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
    return scope


def _with_logits(fluid, eng, bucket=None):
    """A predictor over one of the engine's programs (its step, or the
    prefill of `bucket`) on the engine's own parameter copy that also
    fetches the logits."""
    if bucket is None:
        prog, vs = eng._step_pred.program, eng._step_vars
    else:
        prog, vs = eng._prefill_preds[bucket].program, eng._prefill_vars[bucket]
    return fluid.Predictor(prog, vs["feed_names"],
                           [vs["next"], vs["logits"], vs["k"], vs["v"]],
                           scope=eng._params, place=eng.place)


def gpt_vs_cpu(fluid, serving, cfg, scope, cache_len=GPT_CHECK_CACHE,
               bucket=GPT_CHECK_BUCKET, plen=GPT_CHECK_PROMPT,
               steps=GPT_CHECK_STEPS, slots=GPT_SLOTS):
    """Phase 8a. A DecodeEngine on the card and one on the CPU from the
    same scope: the prefill of one prompt, then `steps` steps of slot 0
    (the other slots dead, as in the engine) teacher-forced with the
    card's tokens, each side on its own caches. Logits within
    GPT_TOL·max|logit| of the CPU's, the card's token equal to the CPU's
    wherever the CPU's top-2 gap exceeds that bound, and the KV rows
    written within GPT_TOL·max|kv|."""
    sides = {}
    for tag, place in (("card", None), ("cpu", fluid.CPUPlace())):
        eng = serving.DecodeEngine(cfg, scope, slots=slots,
                                   cache_len=cache_len,
                                   prompt_buckets=(bucket,), place=place,
                                   auto_start=False, name="gpt-8a-" + tag)
        sides[tag] = (eng, _with_logits(fluid, eng, bucket),
                      _with_logits(fluid, eng))
    rng = np.random.default_rng(GPT_SEED)
    ids = np.zeros((1, bucket), np.int64)
    ids[0, :plen] = rng.integers(0, cfg.vocab, plen)
    feed = {"gpt_prefill_ids": ids,
            "gpt_prefill_len": np.array([[plen]], np.int64)}
    state = {}
    worst = dict(logits=0.0, kv=0.0)
    near_ties = 0
    tok = None
    for t in range(steps + 1):
        outs = {}
        for tag, (eng, pre, step) in sides.items():
            if t == 0:
                nxt, logits, k, v = pre.run(feed, return_numpy=False)
                shape = (slots,) + tuple(k.shape[1:])
                kc = torch.zeros(shape, device=k.device)
                vc = torch.zeros(shape, device=v.device)
                kc[0], vc[0] = k[0], v[0]
            else:
                toks = np.zeros((slots, 1), np.int64)
                pos = np.zeros((slots, 1), np.int64)
                toks[0, 0], pos[0, 0] = tok, plen + t - 1
                kc, vc = state[tag]
                nxt, logits, kc, vc = step.run(
                    {"gpt_step_tok": toks, "gpt_step_pos": pos,
                     "gpt_step_k": kc, "gpt_step_v": vc},
                    return_numpy=False)
            state[tag] = (kc, vc)
            outs[tag] = (int(nxt.reshape(-1)[0]),
                         logits[0].detach().cpu().numpy(),
                         kc[0].cpu().numpy(), vc[0].cpu().numpy())
        (ctok, clog, ck, cv), (wtok, wlog, wk, wv) = outs["card"], outs["cpu"]
        bound = GPT_TOL * float(np.abs(wlog).max())
        err = float(np.abs(clog - wlog).max())
        top2 = np.sort(wlog)[-2:]
        gap = float(top2[1] - top2[0])
        rows = plen + t                         # rows written so far
        kv_err = max(float(np.abs(ck[:, :rows] - wk[:, :rows]).max())
                     / float(np.abs(wk[:, :rows]).max()),
                     float(np.abs(cv[:, :rows] - wv[:, :rows]).max())
                     / float(np.abs(wv[:, :rows]).max()))
        unwritten = max(float(np.abs(a[:, rows:]).max()) if rows < cache_len
                        else 0.0 for a in (ck, cv, wk, wv))
        worst["logits"] = max(worst["logits"], err / bound * GPT_TOL)
        worst["kv"] = max(worst["kv"], kv_err)
        if gap <= bound:
            near_ties += 1
        if err > bound or kv_err > GPT_TOL or unwritten != 0.0 or (
                gap > bound and ctok != wtok):
            fail("8a %s %d: logits max|d| %.3e (bound %.3e), tokens %d / %d "
                 "(cpu top-2 gap %.3e), KV %.3e of max (bound %g), "
                 "unwritten rows max %.3e" % (
                     "prefill" if t == 0 else "step", t, err, bound, ctok,
                     wtok, gap, kv_err, GPT_TOL, unwritten))
        if not np.isfinite(clog).all():
            fail("8a: non-finite logits on the card")
        tok = ctok
    print("8a gpt (GPTConfig(), cache_len %d, bucket %d, a %d-token prompt, "
          "%d steps teacher-forced with the card's tokens) card vs CPU: "
          "logits max|d|/max|logit| %.3e, KV rows max|d|/max %.3e, bound "
          "%g; %d near-ties (CPU top-2 gap within the bound) of %d tokens"
          % (cache_len, bucket, plen, steps, worst["logits"], worst["kv"],
             GPT_TOL, near_ties, steps + 1), flush=True)
    for eng, _, _ in sides.values():
        eng.stop()
    return worst, near_ties


def gpt_prompts(vocab, seed=GPT_SEED):
    """One prompt per request, client c sending requests 3c .. 3c+2 with
    lengths cycling through GPT_PROMPT_LENS."""
    rng = np.random.default_rng(seed)
    n = GPT_CLIENTS * GPT_PER_CLIENT
    return [rng.integers(0, vocab, GPT_PROMPT_LENS[i % len(GPT_PROMPT_LENS)])
            .astype(np.int64) for i in range(n)]


def decode_load(eng, prompts, max_new=GPT_MAX_NEW, n_clients=GPT_CLIENTS):
    """Closed-loop clients, each streaming its requests one after another
    (client c takes a contiguous share); returns the tokens by request,
    the time to first token by request (s), every gap between two tokens
    of a stream (s), and the wall time of the whole load (s)."""
    n = len(prompts)
    per = -(-n // n_clients)
    toks, ttft, gaps, errors = [None] * n, [None] * n, [], []

    def client(idx):
        mine = []
        for i in idx:
            t0 = time.monotonic()
            try:
                h = eng.submit(prompts[i], max_new=max_new)
                out, last = [], None
                for tok in h.tokens(timeout=GPT_WAIT):
                    now = time.monotonic()
                    if last is None:
                        ttft[i] = now - t0
                    else:
                        mine.append(now - last)
                    last = now
                    out.append(tok)
                toks[i] = out
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append("request %d: %s: %s" % (i, type(e).__name__, e))
        gaps.extend(mine)

    threads = [threading.Thread(target=client,
                                args=(range(c * per, min(n, (c + 1) * per)),))
               for c in range(n_clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=GPT_WAIT)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        fail("8b decode load: %s" % (errors or "client threads hung"))
    return toks, ttft, gaps, wall


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def gpt_serving(fluid, serving, ca, cl, cfg, scope, card,
                slots=GPT_SLOTS, cache_len=GPT_CACHE, max_new=GPT_MAX_NEW):
    """Phase 8b, then 8c's timed loads. The main path: DecodeEngine on the
    card, warmed up, then the load with every kernel counter set to 0 just
    before it and read just after (24 LayerNorm forward launches per
    prefill and per step, no attention kernel); every stream bit-identical
    to its prompt served alone through the same engine; a barrier=True
    engine on the same load, its streams the same. Then each engine serves
    the load again, timed. Returns the launches, the numbers, and one more
    decode step of the continuous engine as a function."""
    prompts = gpt_prompts(cfg.vocab)
    per_dispatch = 2 * cfg.num_layers
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng = serving.DecodeEngine(cfg, scope, slots=slots, cache_len=cache_len,
                               name="gpt")
    eng.warmup()
    _sync()
    print("8b gpt engine: %d slots, cache_len %d, buckets %s, built and "
          "warmed up (every program once) in %.1f s" % (
              slots, cache_len, eng.prompt_buckets, time.monotonic() - t0),
          flush=True)
    fns = counters(ca, cl)
    for fn in fns.values():
        fn.launches = 0
    st0 = eng.stats()
    toks, _, _, wall = decode_load(eng, prompts, max_new)
    launches = {n: fn.launches for n, fn in fns.items()}
    st1 = eng.stats()
    prefills = st1["prefills"] - st0["prefills"]
    steps = st1["steps"] - st0["steps"]
    print("8b gpt continuous batching: %d requests from %d clients (prompts "
          "%s tokens, %d new each) in %.3f s: %d prefills, %d steps; "
          "launches %s" % (len(prompts), GPT_CLIENTS,
                           "/".join(map(str, GPT_PROMPT_LENS)), max_new,
                           wall, prefills, steps, launches), flush=True)
    if prefills != len(prompts) or steps < 1:
        fail("8b: %d prefills and %d steps for %d requests" % (
            prefills, steps, len(prompts)))
    if launches["layer_norm_fwd"] != per_dispatch * (prefills + steps):
        fail("8b: %d LayerNorm forward launches for %d prefills and %d "
             "steps, want %d per dispatch" % (
                 launches["layer_norm_fwd"], prefills, steps, per_dispatch))
    if any(launches[n] for n in launches if n != "layer_norm_fwd"):
        fail("8b: a kernel off the decode path launched: %s" % launches)
    if any(len(t) != max_new or min(t) < 0 or max(t) >= cfg.vocab
           for t in toks):
        fail("8b: a stream has the wrong length or a token out of range")
    solo = []
    t0 = time.monotonic()
    for p in prompts:
        solo.append(eng.generate(p, max_new=max_new, timeout=GPT_WAIT))
    same = sum(a == b for a, b in zip(toks, solo))
    print("8b streams vs the same prompt served alone through the same "
          "engine: %d/%d bit-identical (solo runs %.1f s)" % (
              same, len(prompts), time.monotonic() - t0), flush=True)
    if same != len(prompts):
        fail("8b: a stream served among others differs from it served "
             "alone")
    # 8c, continuous: the load again, timed
    c_toks, c_ttft, c_gaps, c_wall = decode_load(eng, prompts, max_new)
    if c_toks != solo:
        fail("8c: the timed continuous load gave other tokens")
    stats = {"continuous": dict(wall=c_wall, ttft=c_ttft, gaps=c_gaps),
             "solo": solo}     # 11c holds its HTTP streams to these
    step_fn, step_stats = gpt_step_times(eng, card) if cuda else (None, {})
    stats.update(step_stats)
    if cuda:
        stats["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        stats["resident_gib"] = resident / 2 ** 30
    eng.stop()
    beng = serving.DecodeEngine(cfg, scope, slots=slots, cache_len=cache_len,
                                name="gpt-barrier", barrier=True)
    beng.warmup()
    bst0 = beng.stats()
    btoks, _, _, bwall = decode_load(beng, prompts, max_new)
    bst1 = beng.stats()
    print("8b gpt barrier scheduling, the same load: %.3f s, %d prefills, "
          "%d steps; streams equal to the solo ones: %s" % (
              bwall, bst1["prefills"] - bst0["prefills"],
              bst1["steps"] - bst0["steps"], btoks == solo), flush=True)
    if btoks != solo:
        fail("8b: barrier scheduling gave other tokens")
    b_toks, b_ttft, b_gaps, b_wall = decode_load(beng, prompts, max_new)
    if b_toks != solo:
        fail("8c: the timed barrier load gave other tokens")
    beng.stop()
    stats["barrier"] = dict(wall=b_wall, ttft=b_ttft, gaps=b_gaps)
    n_tok = len(prompts) * max_new
    for mode in ("continuous", "barrier"):
        s = stats[mode]
        s["tokens_per_s"] = n_tok / s["wall"]
        print("8c gpt %-10s [%s]: %d tokens in %.3f s: %.1f tokens/s; TTFT "
              "p50 %.3f ms, p99 %.3f ms (%d requests); per-token gap p50 "
              "%.3f ms, p99 %.3f ms (%d gaps)" % (
                  mode, card, n_tok, s["wall"], s["tokens_per_s"],
                  1e3 * _pct(s["ttft"], 0.5), 1e3 * _pct(s["ttft"], 0.99),
                  len(s["ttft"]), 1e3 * _pct(s["gaps"], 0.5),
                  1e3 * _pct(s["gaps"], 0.99), len(s["gaps"])), flush=True)
    if cuda:
        print("8c gpt memory [%s]: peak %.3f GiB during the continuous "
              "engine's runs (%.3f GiB resident before it); kv_slot_bytes "
              "%d (%.1f MB a slot, %.1f MB for %d slots)" % (
                  card, stats["peak_gib"], stats["resident_gib"],
                  serving.kv_slot_bytes(cfg, cache_len),
                  serving.kv_slot_bytes(cfg, cache_len) / 1e6,
                  slots * serving.kv_slot_bytes(cfg, cache_len) / 1e6,
                  slots), flush=True)
    stats.update(launches=launches, prefills=prefills, steps=steps)
    return launches, stats, step_fn


def gpt_step_times(eng, card, n=20, sleep_cycles=200_000_000,
                   tag="8c gpt decode step"):
    """One decode step of all the engine's slots (random tokens, each slot
    at its own position, the engine's resident caches): host wall of
    ``Predictor.run`` plus the token copy to the host, and its device time
    from CUDA events with the stream held busy by a sleep kernel first, so
    that the host's enqueueing does not show (unless the launch queue
    fills before the sleep ends). Returns the step as a function (for the
    profile) and the medians."""
    rng = np.random.default_rng(GPT_SEED + 1)
    s, t = eng.slots, eng.cache_len
    feeds = {"gpt_step_tok": torch.from_numpy(
                 rng.integers(0, eng.cfg.vocab, (s, 1))).cuda(),
             "gpt_step_pos": torch.from_numpy(
                 rng.integers(0, t, (s, 1))).cuda(),
             "gpt_step_k": eng._k, "gpt_step_v": eng._v}
    if eng.kv_dtype == "int8":     # 12e: the int8-resident step
        feeds.update(gpt_step_kscale=eng._kscale,
                     gpt_step_vscale=eng._vscale)
    pred = eng._step_pred

    def step():
        return pred.run(feeds, return_numpy=False)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    host, dev = [], []
    for _ in range(n):
        t0 = time.monotonic()
        step()[0].cpu()
        host.append(time.monotonic() - t0)
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        step()
        end.record()
        end.synchronize()
        dev.append(start.elapsed_time(end))
    stats = dict(step_host_ms=1e3 * statistics.median(host),
                 step_device_ms=statistics.median(dev))
    print("%s [%s] (%d slots, cache_len %d): host wall "
          "median %.3f ms (run + the tokens' copy to the host), device "
          "median %.3f ms (CUDA events, stream pre-filled); %d runs each" % (
              tag, card, s, t, stats["step_host_ms"],
              stats["step_device_ms"], n), flush=True)
    return step, stats


CACHE_COPY_KERNELS = re.compile(r"scatter|CatArrayBatchedCopy|copy",
                                re.IGNORECASE)


def gpt_profile(step, stats, card):
    """Phase 8c's profile of one decode step: busy and idle share, kernels
    and GEMMs (profile_train_step), then the cache copies: the scatter of
    each decode_cache_write (with the clone of its layer), the stack of
    the 12 layers (CatArrayBatchedCopy), and the other copies (the heads'
    reshapes of K and V)."""
    def extra(prof, st):
        from torch.autograd import DeviceType

        split = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA \
                    or e.self_device_time_total <= 0 \
                    or not CACHE_COPY_KERNELS.search(e.key):
                continue
            kind = ("scatter" if "scatter" in e.key.lower() else
                    "stack" if "CatArrayBatchedCopy" in e.key else "copy")
            n, us = split.get(kind, (0, 0.0))
            split[kind] = (n + e.count, us + e.self_device_time_total)
        total = sum(us for _, us in split.values()) / 1e3
        print("8c gpt decode step [%s]: cache copies %.3f ms of %.3f ms "
              "busy: %s" % (card, total, st["busy_ms"], ", ".join(
                  "%s %d launches %.3f ms" % (k, n, us / 1e3)
                  for k, (n, us) in sorted(split.items()))), flush=True)
        st["cache_copy_ms"] = total

    stats.update(profile_train_step(step, "gpt decode step", extra=extra))
    print("8c gpt decode step: host wall %.3f ms (unprofiled median), "
          "device busy %.3f ms: idle %.1f%% of it; GEMMs %s" % (
              stats["step_host_ms"], stats["busy_ms"],
              100 * max(0.0, 1 - stats["busy_ms"] / stats["step_host_ms"]),
              ", ".join("%s %.3f ms" % (dt, g["ms"])
                        for dt, g in sorted(stats["gemm"].items()))),
          flush=True)


# ---------------------------------------------------------------------------
# phase 9: Transformer NMT at bench.py's width, and GPT's solo generator
# ---------------------------------------------------------------------------
NMT_SEED = 7
NMT_BATCH, NMT_SRC, NMT_TGT, NMT_MAX_OUT, NMT_BEAM = 32, 32, 32, 48, 4
NMT_CHECK_BATCH = 4
NMT_ITERS, NMT_B128_ITERS = 8, 6
NMT_TOL = 1e-4          # 9a: encoder output and beam scores (of max)
# 9a: a step's selection is a near-tie where two of its beam + 1 best
# candidates are closer than this share of their magnitude
NMT_NEAR_TIE = 2e-6
NMT_TRAIN_TOL = 1e-3    # 9c: losses (relative) and gradients (of max)
NMT_RELU_EDGE = 1e-5    # 9c: a relu unit this close to 0 may round either way
NMT_FLIP_TOL = 5e-2     # 9c: a gradient behind such a unit (phase 7's cap)
NMT_TRAIN_STEPS, NMT_TIMED_STEPS = 3, 10
GEN_PROMPT, GEN_NEW, GEN_BATCH = 16, 16, 2


def nmt_config(nmt):
    """bench.py:821 _measure_nmt_decode's configuration."""
    return nmt.NMTConfig(src_vocab=32000, tgt_vocab=32000, hidden=512,
                         heads=8, ffn=2048, enc_layers=4, dec_layers=4,
                         max_len=max(64, NMT_MAX_OUT), dropout=0.0)


def nmt_beam_program(fluid, nmt, cfg, max_out=NMT_MAX_OUT):
    """bench.py's translation program (startup seed NMT_SEED), with the
    names of the encoder output (the last LayerNorm of the global block)
    and of the decode scan's per-step outputs (scores, token, parent
    beam, each (T, B, beam))."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        vs = nmt.build_transformer_beam_decode(cfg, NMT_SRC, max_out,
                                               NMT_BEAM)
    startup.random_seed = NMT_SEED
    ops = main.global_block().ops
    enc = [op for op in ops if op.type == "layer_norm"][-1].output("Y")[0]
    scan = next(op for op in ops if op.type == "static_rnn")
    return main, startup, vs, enc, scan.output("Out")[:3]


def nmt_ln_per_translation(cfg, max_out=NMT_MAX_OUT):
    """LayerNorm forward launches of one translation: 2 a layer in the
    encoder, 3 a layer in each decode step (8 + 12 x 48 = 584)."""
    return 2 * cfg.enc_layers + 3 * cfg.dec_layers * max_out


def nmt_src(cfg, batch, seed=0):
    """bench.py's source batch: default_rng(0), ids in [3, vocab)."""
    return np.random.default_rng(seed).integers(
        3, cfg.src_vocab, size=(batch, NMT_SRC)).astype(np.int64)


def zero_counters(ca, cl):
    fns = counters(ca, cl)
    for fn in fns.values():
        fn.launches = 0
    return fns


def check_launches(tag, fns, want):
    """Every kernel's launches since zero_counters equal `want` (0 where
    not named)."""
    got = {n: fn.launches for n, fn in fns.items()}
    print("%s: kernel launches %s" % (tag, got), flush=True)
    if any(got[n] != want.get(n, 0) for n in got):
        fail("%s: launches %s, want %s" % (tag, got, want))
    return got


class record_tops:
    """While active, the port's `op_type` lowering (top_k, or arg_max)
    records the `k` + 1 largest values of each row it selects from (k =
    the op's k; 1 for arg_max), as a (rows, k + 1) numpy array per call:
    the selection margins, and the values two runs may round apart."""

    def __init__(self, op_type):
        from paddle_tpu_torch.ops import registry

        self.lowerings, self.op_type = registry.LOWERINGS, op_type
        self.calls = []

    def __enter__(self):
        orig = self.orig = self.lowerings[self.op_type]

        def recording(ctx, ins, attrs):
            out = orig(ctx, ins, attrs)
            x = ins["X"][0].float()
            k = int(attrs.get("k", 1)) if self.op_type == "top_k" else 1
            top = torch.topk(x, k + 1, dim=-1).values
            self.calls.append(top.reshape(-1, k + 1).cpu().numpy())
            return out

        self.lowerings[self.op_type] = recording
        return self

    def __exit__(self, *exc):
        self.lowerings[self.op_type] = self.orig

    def tops(self):
        return np.stack(self.calls)                  # (calls, rows, k + 1)


def near_ties(tops, rel):
    """(calls, rows) bools: the least gap between consecutive values among
    a row's k + 1 largest (which k candidates are chosen, and in which
    order) is within `rel` of their largest magnitude; two runs whose
    values differ by that much may select differently."""
    gap = (tops[..., :-1] - tops[..., 1:]).min(-1)
    return gap <= rel * np.abs(tops).max(-1)


def first_true(mask):
    at = np.nonzero(mask)[0]
    return int(at[0]) if len(at) else len(mask)


def nmt_vs_cpu(fluid, nmt, ca, cl, cfg=None, batch=NMT_CHECK_BATCH):
    """Phase 9a. bench.py's translation program initialised on the card
    (startup seed 7), its scope copied to a CPUPlace() run; one batch of
    bench.py's source rows on both. The encoder output within NMT_TOL of
    its max; each row's per-step (token, parent) equal up to the first
    step where the CPU's selection was a near-tie (near_ties, from the
    candidates record_tops saw), the per-step scores before it and, for
    rows equal to the end, the final ids and beam scores within
    NMT_TOL·max|score|; 584 LayerNorm forward launches in the card's
    translation and no attention launch. Prints how far apart the two
    runs' candidates were while on one path."""
    cfg = cfg or nmt_config(nmt)
    main, startup, vs, enc, steps = nmt_beam_program(fluid, nmt, cfg)
    scope, cpu_scope = fluid.Scope(), fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    for n, t in scope.items():
        cpu_scope.set(n, t.cpu().clone())
    feed = {"src_ids": nmt_src(cfg, batch)}
    fetch = [enc, vs["ids"], vs["scores"]] + steps
    fns = zero_counters(ca, cl)
    with record_tops("top_k") as card_rec:
        card = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    check_launches("9a nmt translation on the card", fns, {
        "layer_norm_fwd": nmt_ln_per_translation(cfg)})
    with record_tops("top_k") as cpu_rec:
        cpu = fluid.Executor(fluid.CPUPlace()).run(
            main, feed=feed, fetch_list=fetch, scope=cpu_scope)
    tops, card_tops = cpu_rec.tops(), card_rec.tops()    # (T, B, beam + 1)
    ties = near_ties(tops, NMT_NEAR_TIE)                # (T, B)
    enc_err = float(np.abs(card[0] - cpu[0]).max()) / float(
        np.abs(cpu[0]).max())
    if enc_err > NMT_TOL or not np.isfinite(card[0]).all():
        fail("9a: encoder output %.3e of max off the CPU (bound %g)" % (
            enc_err, NMT_TOL))
    (c_sc, c_tok, c_par), (w_sc, w_tok, w_par) = card[3:], cpu[3:]
    whole, worst_step, worst_final, noise, diverged = 0, 0.0, 0.0, 0.0, []
    for b in range(batch):
        first = first_true((c_tok[:, b] != w_tok[:, b]).any(-1)
                           | (c_par[:, b] != w_par[:, b]).any(-1))
        tie = first_true(ties[:, b])
        if first < len(ties) and tie > first:
            fail("9a row %d: the card's beams leave the CPU's at step %d "
                 "with no near-tie at or before it" % (b, first))
        if first:
            err = float(np.abs(c_sc[:first, b] - w_sc[:first, b]).max()) \
                / float(np.abs(w_sc[:first, b]).max())
            worst_step = max(worst_step, err)
            # the candidates the two runs chose from, while on one path
            noise = max(noise, float(np.abs(
                card_tops[:first, b] - tops[:first, b]).max()) / float(
                np.abs(tops[:first, b]).max()))
        if first < len(ties):
            diverged.append((b, first, tie))
            continue
        whole += 1
        if not np.array_equal(card[1][b], cpu[1][b]):
            fail("9a row %d: per-step beams equal, final ids differ" % b)
        worst_final = max(worst_final, float(np.abs(
            card[2][b] - cpu[2][b]).max()) / float(np.abs(cpu[2][b]).max()))
    print("9a nmt (bench.py's NMTConfig, startup seed %d, batch %d, src %d, "
          "max_out %d, beam %d) card vs CPU: encoder output max|d|/max %.3e; "
          "per-step scores before any divergence %.3e of max; %d/%d rows "
          "equal to the end (ids equal, final scores %.3e of max|score|); "
          "bound %g; the top %d candidates of each step %.3e of their max "
          "apart; %d near-ties (CPU margin within %g of the candidates' "
          "max) in %d row-steps; rows that left the CPU's beams after a "
          "near-tie (row, step, first near-tie): %s" % (
              NMT_SEED, batch, NMT_SRC, NMT_MAX_OUT, NMT_BEAM, enc_err,
              worst_step, whole, batch, worst_final, NMT_TOL, NMT_BEAM + 1,
              noise, int(ties.sum()), NMT_NEAR_TIE, ties.size,
              diverged or "none"), flush=True)
    if worst_step > NMT_TOL or worst_final > NMT_TOL:
        fail("9a: beam scores off the CPU's beyond %g of max" % NMT_TOL)
    if not np.isfinite(card[2]).all():
        fail("9a: non-finite beam scores on the card")
    return dict(enc_err=enc_err, score_err=max(worst_step, worst_final),
                noise=noise, near_ties=int(ties.sum()), rows_equal=whole)


def nmt_bench(fluid, nmt, ca, cl, card, batch=NMT_BATCH, iters=NMT_ITERS,
              cfg=None):
    """Phase 9b, the main path: bench.py's _measure_nmt_decode on the card
    (batch, src 32, max_out 48, beam 4, startup seed 7, its source batch
    staged on the card once, fetching ids and scores): one warm run, then
    `iters` timed runs with every counter zeroed just before: 584
    LayerNorm forward launches per translation, no attention launch.
    tokens/s = iters·batch·48 / wall, ms per batch, peak device memory.
    Returns the launches, one more translation as a function (for the
    profile), and the numbers."""
    cfg = cfg or nmt_config(nmt)
    main, startup, vs, _, _ = nmt_beam_program(fluid, nmt, cfg)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    feed = {"src_ids": torch.from_numpy(nmt_src(cfg, batch)).to(exe.device)}
    fetch = [vs["ids"], vs["scores"]]

    def translate():
        return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                       return_numpy=False)

    ids, scores = translate()
    if tuple(ids.shape) != (batch, NMT_MAX_OUT, NMT_BEAM) or not bool(
            torch.isfinite(scores).all()):
        fail("9b: ids %s, scores finite %s" % (
            tuple(ids.shape), bool(torch.isfinite(scores).all())))
    _sync()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fns = zero_counters(ca, cl)
    t0 = time.monotonic()
    for _ in range(iters):
        out = translate()
    out[0].cpu()                                   # the sync, as bench.py
    wall = time.monotonic() - t0
    launches = check_launches("9b nmt b%d, %d translations" % (batch, iters),
                              fns, {"layer_norm_fwd": iters
                                    * nmt_ln_per_translation(cfg)})
    stats = dict(batch=batch, iters=iters,
                 tokens_per_s=iters * batch * NMT_MAX_OUT / wall,
                 ms_per_batch=1e3 * wall / iters,
                 peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                 resident_gib=resident / 2 ** 30)
    print("9b nmt_decode%s [%s]: batch %d, src %d, max_out %d, beam %d, %d "
          "timed translations: %.1f tokens/s, %.3f ms per batch, peak "
          "device memory %.3f GiB (%.3f GiB above the %.3f resident before)"
          % ("" if batch == NMT_BATCH else "_b%d" % batch, card, batch,
             NMT_SRC, NMT_MAX_OUT, NMT_BEAM, iters, stats["tokens_per_s"],
             stats["ms_per_batch"], stats["peak_gib"],
             stats["peak_gib"] - stats["resident_gib"],
             stats["resident_gib"]), flush=True)
    return launches, translate, stats


def nmt_repair_ab(fluid, nmt, lowering, card, cfg=None):
    """Phase 9b before and after the repair of the dead step outputs:
    bench.py's translation at b32 and b128, one run with the full op list
    (``lowering.live_plan`` returning None: every op runs and
    ``static_rnn`` stacks all 16 step outputs, as before the repair) and
    one with the live ops only, each from a reset peak: the peak device
    memory above what was resident, and the fetched ids and scores, which
    must be bit-identical. Returns the numbers and a b32 translation with
    the full op list (for its copy launches in the profile)."""
    cfg = cfg or nmt_config(nmt)
    main, startup, vs, _, _ = nmt_beam_program(fluid, nmt, cfg)
    scope = fluid.Scope()
    exe = fluid.Executor()
    exe.run(startup, scope=scope)
    fetch = [vs["ids"], vs["scores"]]
    live_plan = lowering.live_plan
    runs = {}

    def translate(feed, mode):
        lowering.live_plan = live_plan if mode == "live" else (
            lambda program, fetch_names: None)
        try:
            return exe.run(main, feed=feed, fetch_list=fetch, scope=scope,
                           return_numpy=False)
        finally:
            lowering.live_plan = live_plan

    for batch in (NMT_BATCH, 128):
        feed = {"src_ids": torch.from_numpy(nmt_src(cfg, batch)).to(
            exe.device)}
        got = {}
        for mode in ("full", "live"):
            _sync()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t0 = time.monotonic()
            ids, scores = translate(feed, mode)
            ids, scores = ids.cpu().numpy(), scores.cpu().numpy()
            wall = time.monotonic() - t0
            peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
            got[mode] = (ids, scores)
            runs[(batch, mode)] = dict(peak_above_gib=peak, wall_ms=1e3 * wall,
                                       resident_gib=resident / 2 ** 30)
        same = all(np.array_equal(a, b) for a, b in zip(got["full"],
                                                        got["live"]))
        print("9b repair [%s] nmt b%d: full op list peak %.3f GiB above the "
              "%.3f resident, %.1f ms; live ops only peak %.3f GiB above, "
              "%.1f ms; ids and scores bit-identical: %s" % (
                  card, batch, runs[(batch, "full")]["peak_above_gib"],
                  runs[(batch, "full")]["resident_gib"],
                  runs[(batch, "full")]["wall_ms"],
                  runs[(batch, "live")]["peak_above_gib"],
                  runs[(batch, "live")]["wall_ms"], same), flush=True)
        if not same:
            fail("9b: the live-op run's beams differ from the full op list's")
    feed = {"src_ids": torch.from_numpy(nmt_src(cfg, NMT_BATCH)).to(
        exe.device)}
    return runs, lambda: translate(feed, "full")


def nmt_copy_launches(translate, card):
    """With the other profiles: the copy kernels of one b32 translation
    with the full op list, classified as nmt_profile classifies them (the
    live-op translation's are nmt_profile's)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        translate()
        torch.cuda.synchronize()
    n, us, busy = 0, 0.0, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA \
                or e.self_device_time_total <= 0 \
                or e.key.startswith("paddle_tpu_torch::"):
            continue
        busy += e.self_device_time_total
        if not SORT_KERNELS.search(e.key) and (
                CACHE_COPY_KERNELS.search(e.key)
                or "index" in e.key.lower()):
            n += e.count
            us += e.self_device_time_total
    print("9b repair [%s] nmt b%d translation with the full op list: copy "
          "%d launches %.3f ms of %.3f ms busy" % (
              card, NMT_BATCH, n, us / 1e3, busy / 1e3), flush=True)
    return dict(copy_launches=n, copy_ms=us / 1e3, busy_ms=busy / 1e3)

SORT_KERNELS = re.compile(r"sort|radix|topk", re.IGNORECASE)


def nmt_profile(translate, stats, card):
    """Phase 9b's profile of one translation: busy and idle share, the
    kernels by device time and cudaLaunchKernel (profile_train_step), and
    the sort behind top_k over (B, beam·V) each step and the copies (the
    stacked step outputs, the caches' gathers and writes)."""
    def extra(prof, st):
        from torch.autograd import DeviceType

        split = {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA \
                    or e.self_device_time_total <= 0:
                continue
            kind = ("sort" if SORT_KERNELS.search(e.key) else
                    "copy" if CACHE_COPY_KERNELS.search(e.key)
                    or "index" in e.key.lower() else None)
            if kind:
                n, us = split.get(kind, (0, 0.0))
                split[kind] = (n + e.count, us + e.self_device_time_total)
        st["split"] = {k: dict(launches=n, ms=us / 1e3)
                       for k, (n, us) in split.items()}
        print("9b nmt translation [%s]: %s of %.3f ms busy" % (
            card, ", ".join("%s %d launches %.3f ms" % (k, v["launches"],
                                                        v["ms"])
                            for k, v in sorted(st["split"].items())),
            st["busy_ms"]), flush=True)

    stats.update(profile_train_step(
        translate, "nmt translation b%d" % stats["batch"], extra=extra))
    print("9b nmt translation b%d: %.3f ms per batch (unprofiled), device "
          "busy %.3f ms: idle %.1f%% of it; GEMMs %s" % (
              stats["batch"], stats["ms_per_batch"], stats["busy_ms"],
              100 * max(0.0, 1 - stats["busy_ms"] / stats["ms_per_batch"]),
              ", ".join("%s %.3f ms" % (dt, g["ms"])
                        for dt, g in sorted(stats["gemm"].items()))),
          flush=True)


def relu_flips(names, got, want):
    """Units whose relu output is 0 in one run and not in the other:
    [(var, count, the largest |output| at a flipped unit over the largest
    of the var)]."""
    flips = []
    for name, a, w in zip(names, got, want):
        m = (a > 0) != (w > 0)
        if m.any():
            flips.append((name, int(m.sum()), float(np.maximum(
                np.abs(a[m]), np.abs(w[m])).max()) / float(np.abs(w).max())))
    return flips


def nmt_train(fluid, nmt, ca, cl, cfg=None, batch=NMT_BATCH,
              timed=NMT_TIMED_STEPS):
    """Phase 9c. build_transformer_nmt at bench.py's width (batch 32, src
    and tgt 32, dropout 0), Adam(1e-4), initialised on the card (startup
    seed 7) and copied to a CPUPlace() run: 3 steps each from there,
    losses within NMT_TRAIN_TOL relative; 20 LayerNorm forward and 20
    backward launches a card step; then the median of `timed` more card
    steps.

    The step-1 gradients, printed per parameter: the median over
    parameters of max|d|/max|grad| and all of them together within
    NMT_TRAIN_TOL; the attention key biases, whose exact gradient is 0,
    within 1e-4 of the largest gradient; each other parameter within
    NMT_TRAIN_TOL·max|grad| (the issue's bound), except where a relu unit
    of the FFNs is 0 in one run and not in the other (relu_flips) at a
    value within NMT_RELU_EDGE of its layer's largest: a unit on the
    boundary, which either run may round either way, moves every
    gradient below it by far more than rounding (one such unit in 2M
    moved src_emb's by 5.7e-3 of its max on the H100); those parameters
    are held within NMT_FLIP_TOL."""
    cfg = cfg or nmt_config(nmt)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        io = nmt.build_transformer_nmt(cfg, NMT_SRC, NMT_TGT)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(io["loss"])
    startup.random_seed = NMT_SEED
    relus = [op.output("Out")[0] for op in main.global_block().ops
             if op.type == "relu"]
    scope, cpu_scope = fluid.Scope(), fluid.Scope()
    exe, cpu_exe = fluid.Executor(), fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    for n, t in scope.items():
        cpu_scope.set(n, t.cpu().clone())
    src, tgt, labels = nmt.synthetic_pair_batch(cfg, batch, NMT_SRC, NMT_TGT,
                                                seed=0)
    feed = {"src_ids": src, "tgt_ids": tgt, "tgt_labels": labels}
    grads = sorted(p.name + "@GRAD" for p in main.all_parameters())
    per_step = 2 * cfg.enc_layers + 3 * cfg.dec_layers
    fns = zero_counters(ca, cl)
    losses, worst_loss = [], 0.0
    for step in range(NMT_TRAIN_STEPS):
        fetch = [io["loss"]] + (grads + relus if step == 0 else [])
        got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        want = cpu_exe.run(main, feed=feed, fetch_list=fetch, scope=cpu_scope)
        losses.append(float(got[0]))
        worst_loss = max(worst_loss, abs(float(got[0]) - float(want[0]))
                         / abs(float(want[0])))
        if step == 0:
            ng = len(grads)
            card_grads, cpu_grads = got[1:1 + ng], want[1:1 + ng]
            flips = relu_flips(relus, got[1 + ng:], want[1 + ng:])
    launches = check_launches(
        "9c nmt training, %d card steps" % NMT_TRAIN_STEPS, fns, {
            "layer_norm_fwd": per_step * NMT_TRAIN_STEPS,
            "layer_norm_bwd": per_step * NMT_TRAIN_STEPS})
    top = max(float(np.abs(w).max()) for w in cpu_grads)
    zero_grads, rels, per_param = 0.0, {}, []
    for name, a, w in zip(grads, card_grads, cpu_grads):
        if not np.isfinite(a).all():
            fail("9c: %s not finite on the card" % name)
        if name.endswith(".k.b@GRAD"):            # exact gradient 0
            zero_grads = max(zero_grads, float(np.abs(a - w).max()) / top)
            continue
        rels[name] = rel_err(a, w)
        per_param.append("%s %.2e" % (name[:-5], rels[name]))
    print("9c step-1 gradients, max|d|/max|grad| per parameter:")
    for i in range(0, len(per_param), 4):
        print("  " + ", ".join(per_param[i:i + 4]))
    over = sorted((r, n) for n, r in rels.items() if r > NMT_TRAIN_TOL)
    edge = bool(flips) and all(f[2] <= NMT_RELU_EDGE for f in flips)
    names = [n for n in grads if n in rels]
    median = float(np.median(list(rels.values())))
    dist = grad_dist([card_grads[grads.index(n)] for n in names],
                     [cpu_grads[grads.index(n)] for n in names])
    print("9c nmt training (bench.py's width, batch %d, src %d, tgt %d, "
          "Adam 1e-4, startup seed %d) card vs CPU: losses %s within rel "
          "%.3e (bound %g); step-1 gradients: median over %d parameters "
          "%.3e, all together %.3e (bounds %g), the key biases' (exact 0) "
          "%.3e of the largest gradient (bound 1e-4); relu units 0 in one "
          "run only (var, units, largest |output| there over the var's "
          "max): %s; over %g: %s" % (
              batch, NMT_SRC, NMT_TGT, NMT_SEED,
              " ".join("%.5f" % x for x in losses), worst_loss,
              NMT_TRAIN_TOL, len(rels), median, dist, NMT_TRAIN_TOL,
              zero_grads, flips or "none", NMT_TRAIN_TOL,
              ", ".join("%s %.2e" % (n[:-5], r) for r, n in over[::-1])
              or "none"), flush=True)
    if worst_loss > NMT_TRAIN_TOL or median > NMT_TRAIN_TOL \
            or dist > NMT_TRAIN_TOL or zero_grads > 1e-4:
        fail("9c: card training differs from the CPU's")
    if over and not (edge and over[-1][0] <= NMT_FLIP_TOL):
        fail("9c: gradients beyond %g of max|grad| %s (relu units on the "
             "boundary only: %s; bound then %g)" % (
                 NMT_TRAIN_TOL, over[::-1], edge, NMT_FLIP_TOL))
    walls = []
    for _ in range(timed):
        t0 = time.monotonic()
        exe.run(main, feed=feed, fetch_list=[io["loss"]], scope=scope)
        walls.append(time.monotonic() - t0)
    stats = dict(step_ms=1e3 * statistics.median(walls))
    print("9c nmt training step: median %.3f ms over %d steps (loss fetch "
          "included), %.1f target tokens/s" % (
              stats["step_ms"], timed, batch * NMT_TGT / stats["step_ms"]
              * 1e3), flush=True)
    return launches, stats


def gpt_generate_vs_cpu(fluid, gpt, ca, cl, cfg, scope):
    """Phase 9d. build_gpt_generate (greedy), prompt 16, 16 new tokens,
    batch 2, on the GPT scope of phase 8 on the card and on the CPU: each
    row's ids equal up to the first step where the CPU's greedy choice
    was a near-tie (top-2 gap within GPT_TOL of their magnitude, as 8a);
    24 LayerNorm forward launches per step on the card."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        vs = gpt.build_gpt_generate(cfg, GEN_PROMPT, GEN_NEW)
    exe = fluid.Executor()
    card_scope = fluid.Scope()
    for n, t in scope.items():
        card_scope.set(n, torch.as_tensor(t).to(exe.device))
    prompt = np.random.default_rng(GPT_SEED).integers(
        0, cfg.vocab, (GEN_BATCH, GEN_PROMPT)).astype(np.int64)
    feed = {"gpt_prompt": prompt}
    steps = GEN_PROMPT + GEN_NEW - 1
    fns = zero_counters(ca, cl)
    card, = exe.run(main, feed=feed, fetch_list=[vs["ids"]],
                    scope=card_scope)
    launches = check_launches("9d gpt generate on the card", fns, {
        "layer_norm_fwd": 2 * cfg.num_layers * steps})
    with record_tops("arg_max") as rec:
        cpu, = fluid.Executor(fluid.CPUPlace()).run(
            main, feed=feed, fetch_list=[vs["ids"]], scope=scope)
    ties = near_ties(rec.tops(), GPT_TOL)               # (steps, B)
    diverged = []
    for b in range(GEN_BATCH):
        first = first_true(card[b] != cpu[b])
        tie = first_true(ties[:, b])
        if first < steps and tie > first:
            fail("9d row %d: the card's token at step %d differs from the "
                 "CPU's with no near-tie at or before it" % (b, first))
        if first < steps:
            diverged.append((b, first, tie))
    if not np.array_equal(card[:, :GEN_PROMPT - 1], prompt[:, 1:]):
        fail("9d: the teacher-forced positions are not the prompt")
    print("9d gpt generate (GPTConfig(), greedy, batch %d, prompt %d, %d new "
          "tokens) card vs CPU: %d/%d rows equal; %d near-ties (CPU top-2 "
          "gap within %g of their magnitude) in %d row-steps; rows that left "
          "the CPU's after a near-tie (row, step, first near-tie): %s" % (
              GEN_BATCH, GEN_PROMPT, GEN_NEW, GEN_BATCH - len(diverged),
              GEN_BATCH, int(ties.sum()), GPT_TOL, ties.size,
              diverged or "none"), flush=True)
    return launches


def nmt_ln_times(cl):
    """The LayerNorm kernels at the NMT path's rows, h = 512, f32: the
    forward at a decode step's (B·beam = 128, 512) and the encoder's and
    training's (32·32 = 1024, 512), the backward at (1024, 512); each
    beside its plain version, the library call and the bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 9)
    out = []
    for n in (128, 1024):
        x, dy = (torch.randn(n, 512, generator=gen, device="cuda")
                 for _ in range(2))
        g, b = (torch.randn(512, generator=gen, device="cuda")
                for _ in range(2))
        bound, by = layer_norm_bound_ms(n, 512, torch.float32)
        out.append(dict(
            kernel="layer_norm_fwd", rows=n, h=512, dtype="float32",
            ms=device_ms(lambda: cl.layer_norm_fwd(x, g, b, 1e-5)),
            plain_ms=device_ms(lambda: cl.layer_norm_plain(x, g, b, 1e-5)),
            library_ms=device_ms(lambda: F.layer_norm(x, (512,), g, b, 1e-5)),
            bound_ms=bound, bound_by=by))
        if n == 1024:
            _, mean, rstd = cl.layer_norm_fwd(x, g, b, 1e-5)
            lx, lg, lb = (t.clone().requires_grad_() for t in (x, g, b))
            ly = F.layer_norm(lx, (512,), lg, lb, 1e-5)
            bound, by = layer_norm_bwd_bound_ms(n, 512, torch.float32)
            out.append(dict(
                kernel="layer_norm_bwd", rows=n, h=512, dtype="float32",
                ms=device_ms(lambda: cl.layer_norm_bwd(x, g, mean, rstd, dy)),
                plain_ms=device_ms(lambda: cl.layer_norm_bwd_plain(
                    x, g, mean, rstd, dy)),
                library_ms=device_ms(lambda: torch.autograd.grad(
                    ly, (lx, lg, lb), dy, retain_graph=True)),
                bound_ms=bound, bound_by=by))
    for r in out:
        print("time %s (%4d, 512) float32 kernel %.4f ms  plain %.4f ms  "
              "library %.4f ms  bound %.5f ms (%s)" % (
                  r["kernel"], r["rows"], r["ms"], r["plain_ms"],
                  r["library_ms"], r["bound_ms"], r["bound_by"]), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 10: Wide&Deep CTR trained through train_from_dataset
# ---------------------------------------------------------------------------
CTR_SEED = 7
CTR_BATCH, CTR_ROWS, CTR_SHARDS, CTR_EPOCHS = 2048, 49152, 4, 2
CTR_CHECK_STEPS = 3
CTR_LOSS_TOL = 1e-3     # 10a: the eval batch's loss, relative
CTR_AUC_TOL = 1e-5      # 10a: the AUC
# 10a: each parameter's 3-step update against the CPU's, of its largest
# update (Adam gives an element whose gradients are rounding noise a full
# step in the noise's direction; tests/test_torch_dataset.py measures the
# same between the two packages on the CPU)
CTR_UPDATE_TOL = 1e-2
# 10a: samples whose probability fell in another auc bin on the card, of
# all (a probability a few ulps away lands across a bin edge)
CTR_MOVED_TOL = 1e-2
EMB_GRAD_KERNELS = re.compile(r"index|sort|scatter|embedding|radix",
                              re.IGNORECASE)


def write_ctr_shards(dirname, rows, shards, seed=0):
    """bench.py:768-785's synthetic Criteo-shaped MultiSlot shards (26
    sparse ids below 100,000, 13 dense, the label of a fixed direction;
    slot order dense, sparse, label)."""
    os.makedirs(dirname, exist_ok=True)
    rng = np.random.default_rng(seed)
    w = np.random.default_rng(1).standard_normal(13)
    files = []
    for s in range(shards):
        path = os.path.join(dirname, "part_%d.txt" % s)
        with open(path, "w") as f:
            for _ in range(rows // shards):
                sparse = rng.integers(0, 100000, size=26)
                dense = rng.standard_normal(13)
                label = int(dense @ w > 0)
                f.write("13 %s 26 %s 1 %d\n" % (
                    " ".join("%.4f" % x for x in dense),
                    " ".join(map(str, sparse)), label))
        files.append(path)
    return files


def ctr_program(fluid, wd):
    """bench.py's Wide&Deep: ``build_wide_deep()`` (26 fields, vocab
    100,000, emb 16, 13 dense, hidden [400, 400, 400]) + Adam(1e-3),
    startup seed 7."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = CTR_SEED
    with fluid.program_guard(main, startup):
        vs = wd.build_wide_deep()
        fluid.optimizer.Adam(1e-3).minimize(vs["loss"])
    return main, startup, vs


def ctr_dataset(fluid, vs, files, thread):
    ds = fluid.DatasetFactory().create_dataset("InMemoryDataset")
    ds.set_batch_size(CTR_BATCH)
    ds.set_thread(thread)
    ds.set_filelist(files)
    ds.set_use_var([vs["dense"], vs["sparse"], vs["label"]])
    ds.load_into_memory()
    return ds


def ctr_pipeline(ds, tag):
    """The pipeline the dataset's loader ran; fails unless native."""
    loader = ds._loader_cache[1]
    if loader.pipeline != "native":
        from paddle_tpu_torch.native import build as native_build

        fail("%s: the loader ran the %s pipeline, not the native one (%s)"
             % (tag, loader.pipeline, native_build.load_error))
    return loader.pipeline, loader.pinned


def ctr_eval_feed(wd):
    dense, sparse, label = wd.synthetic_ctr_batch(CTR_BATCH)
    return {"dense": dense, "sparse": sparse, "ctr_label": label}


def ctr_vs_cpu(fluid, wd, tmp):
    """Phase 10a. bench.py's Wide&Deep initialised once on the CPU (startup
    seed 7), copied into three card scopes and a CPU scope; 3 steps of
    train_from_dataset (set_thread(1), batch 2048, 3 x 2048 rows in one
    shard made as bench.py makes them) on the card twice and on the CPU,
    and the same batches through a ``run`` loop on the card. Each
    parameter's update within CTR_UPDATE_TOL of its largest against the
    CPU's; the auc statistics' totals equal and at most CTR_MOVED_TOL of
    the samples in another bin; then the test clone on a fixed eval batch:
    loss within CTR_LOSS_TOL and AUC within CTR_AUC_TOL of the CPU's.
    Prints whether two card runs, and train_from_dataset and the run loop,
    give the same bits."""
    main, startup, vs = ctr_program(fluid, wd)
    files = write_ctr_shards(os.path.join(tmp, "ctr_check"),
                             rows=CTR_CHECK_STEPS * CTR_BATCH, shards=1,
                             seed=1)
    ds = ctr_dataset(fluid, vs, files, thread=1)
    init = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=init)

    place = fluid.CUDAPlace(0)

    def scope_on(device):
        sc = fluid.Scope()
        for n, t in init.items():
            sc.set(n, t.to(device, copy=True))
        return sc

    cpu, card, card2, loop = (scope_on(d) for d in (
        torch.device("cpu"),) + (place.torch_device(),) * 3)
    fluid.Executor(place).train_from_dataset(main, ds, scope=card)
    pipe = ctr_pipeline(ds, "10a")
    fluid.Executor(place).train_from_dataset(main, ds, scope=card2)
    exe = fluid.Executor(place)
    feeder = fluid.DataFeeder([vs["dense"], vs["sparse"], vs["label"]],
                              place)
    for batch in ds._batch_iterator():
        exe.run(main, feed=feeder.feed(batch), scope=loop)
    fluid.Executor(fluid.CPUPlace()).train_from_dataset(main, ds,
                                                        scope=cpu)
    params = [p.name for p in main.all_parameters() if p.trainable]
    stats = [p.name for p in main.all_parameters() if not p.trainable]
    persist = params + stats + [
        v.name for v in main.global_block().vars.values()
        if v.persistable and v.name not in params + stats]

    def same_bits(a, b):
        return all(torch.equal(a[n], b[n]) for n in persist if n in a)

    worst, per = 0.0, []
    for n in params:
        start = init[n]
        du = card[n].cpu() - start
        dw = cpu[n] - start
        rel = float((du - dw).abs().max()) / max(float(dw.abs().max()),
                                                 1e-30)
        per.append("%s %.2e" % (n, rel))
        worst = max(worst, rel)
    totals, moved = [], 0.0
    for n in stats:
        a, w = card[n].cpu().numpy(), cpu[n].numpy()
        totals.append((float(a.sum()), float(w.sum())))
        moved += float(np.abs(a - w).sum()) / 2
    n_samples = CTR_CHECK_STEPS * CTR_BATCH
    twice, as_loop = same_bits(card, card2), same_bits(card, loop)
    loop_rel = 0.0 if as_loop else max(
        float((loop[n] - card[n]).abs().max()) / max(float(
            (card[n].cpu() - init[n]).abs().max()), 1e-30) for n in params)
    test = main.clone(for_test=True)
    feed = ctr_eval_feed(wd)
    got = fluid.Executor(place).run(test, feed=feed, scope=card,
                                    fetch_list=[vs["loss"], vs["auc"]])
    want = fluid.Executor(fluid.CPUPlace()).run(
        test, feed=feed, scope=cpu, fetch_list=[vs["loss"], vs["auc"]])
    loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    auc_err = abs(float(got[1]) - float(want[1]))
    print("10a ctr (bench.py's Wide&Deep, startup seed %d, %d steps of "
          "train_from_dataset, batch %d, set_thread(1), pipeline %s, pinned "
          "%s) card vs CPU: updates %.3e of the largest at worst (bound %g: "
          "%s); auc statistics totals card %s CPU %s, %.0f of %d samples "
          "in another bin (bound %g); eval batch loss %.6f vs %.6f (%.3e "
          "relative, bound %g), AUC %.7f vs %.7f (%.3e, bound %g); two "
          "card runs bit-identical: %s; train_from_dataset and a run loop "
          "on the card bit-identical: %s (%.3e of the largest update)" % (
              CTR_SEED, CTR_CHECK_STEPS, CTR_BATCH, pipe[0], pipe[1], worst,
              CTR_UPDATE_TOL, ", ".join(per), [t[0] for t in totals],
              [t[1] for t in totals], moved, n_samples, CTR_MOVED_TOL,
              float(got[0]), float(want[0]), loss_rel, CTR_LOSS_TOL,
              float(got[1]), float(want[1]), auc_err, CTR_AUC_TOL, twice,
              as_loop, loop_rel), flush=True)
    if worst > CTR_UPDATE_TOL:
        fail("10a: a parameter's update is %.3e of its largest off the "
             "CPU's" % worst)
    if any(a != w for a, w in totals) or moved > CTR_MOVED_TOL * n_samples:
        fail("10a: auc statistics off the CPU's (totals %s, %.0f moved)"
             % (totals, moved))
    if not (np.isfinite(float(got[0])) and loss_rel <= CTR_LOSS_TOL
            and auc_err <= CTR_AUC_TOL):
        fail("10a: eval loss or AUC off the CPU's")
    if loop_rel > CTR_UPDATE_TOL:
        fail("10a: train_from_dataset and a run loop differ on the card")
    ds.release_memory()
    return dict(update_rel=worst, moved=moved, loss_rel=loss_rel,
                auc_err=auc_err, twice=twice, as_loop=as_loop)


def ctr_bench(fluid, wd, ca, cl, card, tmp):
    """Phase 10b, the main path: bench.py:746 _measure_ctr on the card.
    bench.py's Wide&Deep (startup seed 7), 49,152 rows in 4 shards made as
    bench.py makes them, InMemoryDataset with set_thread(2) and batch 2048;
    loss_first from a run on synthetic_ctr_batch(2048) (which trains on
    it, as bench.py's does), one warm-up epoch, then CTR_EPOCHS timed
    epochs with every counter zeroed just before (none of the five kernels
    lies on this path), then loss_last. examples/s over the timed wall
    (ending in a synchronize); the step median from CUDA events recorded
    after each step; peak device memory above what was resident; the
    pipeline that ran (native, or the phase fails); loss_last finite and
    below loss_first. Then 10c: infer_from_dataset over one epoch leaves
    every trainable parameter bit-identical and adds an epoch of samples
    to the auc statistics. Returns the launches, one more epoch as a
    function (for the profile) and the numbers."""
    main, startup, vs = ctr_program(fluid, wd)
    exe = fluid.Executor()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    t0 = time.monotonic()
    files = write_ctr_shards(os.path.join(tmp, "ctr_bench"), CTR_ROWS,
                             CTR_SHARDS)
    t1 = time.monotonic()
    ds = ctr_dataset(fluid, vs, files, thread=2)
    t2 = time.monotonic()
    feed = ctr_eval_feed(wd)
    loss_first = float(exe.run(main, feed=feed, fetch_list=[vs["loss"]],
                               scope=scope)[0])
    t3 = time.monotonic()
    exe.train_from_dataset(program=main, dataset=ds, scope=scope)
    _sync()
    warm = time.monotonic() - t3
    marks = []
    run = exe.run

    def clocked(*args, **kwargs):
        out = run(*args, **kwargs)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return out

    exe.run = clocked
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    fns = zero_counters(ca, cl)
    t0w = time.monotonic()
    for _ in range(CTR_EPOCHS):
        exe.train_from_dataset(program=main, dataset=ds, scope=scope)
    _sync()
    wall = time.monotonic() - t0w
    del exe.run
    launches = check_launches("10b ctr, %d epochs" % CTR_EPOCHS, fns, {})
    peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    pipe = ctr_pipeline(ds, "10b")
    steps = CTR_EPOCHS * (CTR_ROWS // CTR_BATCH)
    if len(marks) != steps:
        fail("10b: %d steps ran, want %d" % (len(marks), steps))
    gaps = sorted(a.elapsed_time(b) for a, b in zip(marks, marks[1:]))
    loss_last = float(exe.run(main, feed=feed, fetch_list=[vs["loss"]],
                              scope=scope)[0])
    stats = dict(examples_per_s=steps * CTR_BATCH / wall,
                 epoch_ms=1e3 * wall / CTR_EPOCHS,
                 step_median_ms=statistics.median(gaps),
                 step_p90_ms=gaps[min(len(gaps) - 1, int(0.9 * len(gaps)))],
                 step_mean_ms=1e3 * wall / steps, peak_above_gib=peak,
                 resident_gib=resident / 2 ** 30, pipeline=pipe[0],
                 pinned=pipe[1], loss_first=loss_first, loss_last=loss_last,
                 warm_epoch_ms=1e3 * warm)
    print("10b ctr [%s] (bench.py:746 _measure_ctr: batch %d, %d rows in %d "
          "shards, InMemoryDataset, set_thread(2), %d timed epochs): %.1f "
          "examples/s, %.3f ms an epoch (warm-up epoch %.3f ms), step "
          "median %.3f ms and p90 %.3f ms between CUDA events (mean %.3f "
          "ms of host wall), peak device memory %.4f GiB above the %.4f "
          "resident, pipeline %s (pinned %s), loss_first %.4f loss_last "
          "%.4f; shards written in %.1f s, parsed into memory in %.1f s" % (
              card, CTR_BATCH, CTR_ROWS, CTR_SHARDS, CTR_EPOCHS,
              stats["examples_per_s"], stats["epoch_ms"], 1e3 * warm,
              stats["step_median_ms"], stats["step_p90_ms"],
              stats["step_mean_ms"], peak, stats["resident_gib"], pipe[0],
              pipe[1], loss_first, loss_last, t1 - t0, t2 - t1), flush=True)
    if not (np.isfinite(loss_last) and loss_last < loss_first):
        fail("10b: loss_last %.4f not finite and below loss_first %.4f" % (
            loss_last, loss_first))
    # 10c: infer_from_dataset
    before = {p.name: scope[p.name].clone() for p in main.all_parameters()}
    exe.infer_from_dataset(program=main, dataset=ds, scope=scope)
    kept = [p.name for p in main.all_parameters()
            if p.trainable and not torch.equal(scope[p.name],
                                               before[p.name])]
    added = sum(float((scope[p.name] - before[p.name]).sum())
                for p in main.all_parameters() if not p.trainable)
    print("10c ctr infer_from_dataset over one epoch: trainable parameters "
          "bit-identical: %s; auc statistics gained %.0f samples (want %d)"
          % (not kept, added, CTR_ROWS), flush=True)
    if kept or added != CTR_ROWS:
        fail("10c: infer_from_dataset changed %s or added %.0f samples" % (
            kept, added))
    return launches, lambda: exe.train_from_dataset(
        program=main, dataset=ds, scope=scope), stats


def ctr_profile(epoch, stats, card):
    """Phase 10b's profile of one epoch (24 steps): busy and idle share
    against the unprofiled epoch, the kernels by device time and
    cudaLaunchKernel (profile_train_step), the embeddings' gather and
    gradient (the index, sort and scatter kernels, by name: autograd runs
    the backward on its own device thread, outside the backward range),
    Adam (the optimizer range's kernels) and the host-to-device copies."""
    def extra(prof, st):
        from torch.autograd import DeviceType

        split = {"embedding gather and gradient": [0, 0.0],
                 "adam": [0, 0.0], "host-to-device copies": [0, 0.0]}
        for e in prof.events():
            if e.device_type == DeviceType.CPU \
                    and e.name == "paddle_tpu_torch::optimizer":
                ks = _subtree_kernels(e)
                split["adam"][0] += len(ks)
                split["adam"][1] += sum(d for _, d in ks)
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA \
                    or e.self_device_time_total <= 0:
                continue
            kind = ("host-to-device copies" if "HtoD" in e.key else
                    "embedding gather and gradient"
                    if EMB_GRAD_KERNELS.search(e.key) else None)
            if kind:
                split[kind][0] += e.count
                split[kind][1] += e.self_device_time_total
        st["split"] = {k: dict(launches=n, ms=us / 1e3)
                       for k, (n, us) in split.items()}
        print("10b ctr epoch [%s]: %s of %.3f ms busy" % (
            card, ", ".join("%s %d launches %.3f ms" % (k, v["launches"],
                                                        v["ms"])
                            for k, v in st["split"].items()),
            st["busy_ms"]), flush=True)

    stats.update(profile_train_step(epoch, "ctr epoch", extra=extra))
    print("10b ctr epoch: %.3f ms unprofiled, device busy %.3f ms: idle "
          "%.1f%% of it; %.3f ms busy a step; GEMMs %s" % (
              stats["epoch_ms"], stats["busy_ms"],
              100 * max(0.0, 1 - stats["busy_ms"] / stats["epoch_ms"]),
              stats["busy_ms"] / (CTR_ROWS // CTR_BATCH),
              ", ".join("%s %.3f ms" % (dt, g["ms"])
                        for dt, g in sorted(stats["gemm"].items()))),
          flush=True)


# ---------------------------------------------------------------------------
# phase 11: the serving front door
# ---------------------------------------------------------------------------
# 11a: AnalysisConfig / create_paddle_predictor on phase 4's model. 11b:
# BERT-base (phase 4's seed and width) pruned to encoder_out (B, 128, 768),
# behind ModelRegistry + ServingServer: 4 closed-loop urllib clients x 16
# :predict requests of 1-4 rows. 11c: phase 8's engine configuration
# published behind the same server, phase 8c's chat traffic streamed over
# chunked :generate. 11d: the standalone entry point in a child process.
# 11e: 11b's load and a phase-8c-sized load with telemetry off and on.
HTTP_CLIENTS, HTTP_PER_CLIENT, HTTP_MAX_ROWS = 4, 16, 4
HTTP_TOL = 1e-3                  # x max|x|, as phase 4 holds card vs CPU
HTTP_WAIT = 300.0                # s: the bound of every wait in phase 11
HTTP_CANCEL_AFTER = 3            # tokens a client reads before hanging up


def http_post(url, doc, timeout=HTTP_WAIT):
    """(status, parsed JSON body) of one POST; an HTTP error is an
    answer here, not an exception."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        with e:
            return e.code, json.loads(e.read() or b"{}")


def http_get(url, timeout=HTTP_WAIT):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


def reply_array(doc):
    o = doc["outputs"][0]
    return np.asarray(o["data"], dtype=o["dtype"]).reshape(o["shape"])


def prom_value(text, name):
    """The value of the sample line `name` in Prometheus text, or None."""
    for line in text.splitlines():
        if line.startswith(name + " "):
            return float(line.split()[-1])
    return None


def analysis_config_phase(fluid, dirname, requests):
    """11a: create_paddle_predictor(AnalysisConfig(dir)) on phase 4's logits
    model runs on the card, bit-identical to Predictor.from_model(dir) on a
    batch of 8; with disable_gpu() it runs on the CPU, within phase 4's
    1e-3 x max|logit| of the card."""
    batch = {"input_ids": np.concatenate(requests[:8])}
    cfg = fluid.core.AnalysisConfig(dirname)
    cfg.switch_ir_optim(True)
    pred = fluid.core.create_paddle_predictor(cfg)
    if pred.place != fluid.CUDAPlace(0) or not cfg.use_gpu():
        fail("11a: a fresh AnalysisConfig runs on %s, not the card"
             % pred.place)
    got = pred.run(batch)[0]
    ref = fluid.Predictor.from_model(dirname).run(batch)[0]
    same = bool(np.array_equal(got, ref))
    cfg.disable_gpu()
    cpu = fluid.core.create_paddle_predictor(cfg)
    if cpu.place != fluid.CPUPlace():
        fail("11a: disable_gpu() runs on %s, not the CPU" % cpu.place)
    t0 = time.monotonic()
    on_cpu = cpu.run(batch)[0]
    scale = float(np.abs(got).max())
    err = float(np.abs(on_cpu - got).max())
    print("11a AnalysisConfig: create_paddle_predictor on %s, batch 8 "
          "bit-identical to Predictor.from_model: %s; disable_gpu() on %s "
          "(%.1f s): max|d| %.3e, bound %.3e" % (
              pred.place, same, cpu.place, time.monotonic() - t0, err,
              HTTP_TOL * scale), flush=True)
    if not same:
        fail("11a: create_paddle_predictor differs from Predictor.from_model "
             "on the card")
    if not np.isfinite(got).all() or err > HTTP_TOL * scale:
        fail("11a: the CPU predictor disagrees with the card's")


def http_requests(n, vocab, seq=SEQ, seed=SEED + 11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(int(rng.integers(
        1, HTTP_MAX_ROWS + 1)), seq), dtype=np.int64) for _ in range(n)]


def http_predict_load(url, requests, n_clients=HTTP_CLIENTS):
    """Closed-loop :predict clients (client c sends requests c, c + n, ...);
    returns the replies as arrays, the latencies (s) and the wall (s)."""
    replies = [None] * len(requests)
    lat = [None] * len(requests)
    errors = []

    def client(idx):
        for i in idx:
            t0 = time.monotonic()
            try:
                code, doc = http_post(
                    url, {"feeds": {"input_ids": requests[i].tolist()}})
                if code != 200:
                    raise RuntimeError("status %d: %s" % (code, doc))
                replies[i] = reply_array(doc)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append("request %d: %s: %s" % (i, type(e).__name__, e))
            lat[i] = time.monotonic() - t0

    threads = [threading.Thread(target=client,
                                args=(range(c, len(requests), n_clients),))
               for c in range(n_clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_WAIT)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        fail("11b :predict load: %s" % (errors or "client threads hung"))
    return replies, lat, wall


def json_round_trip_ms(reply):
    """Host ms of one reply row's trip through JSON: the server's tolist +
    dumps, the client's loads + asarray (float32 comes back bit-exact)."""
    t0 = time.perf_counter()
    text = json.dumps({"outputs": [{"data": reply.tolist(),
                                    "shape": list(reply.shape),
                                    "dtype": str(reply.dtype)}]})
    t1 = time.perf_counter()
    back = reply_array(json.loads(text))
    t2 = time.perf_counter()
    if not np.array_equal(back, reply):
        fail("11b: a float32 reply did not survive its JSON round trip")
    return 1e3 * (t1 - t0), 1e3 * (t2 - t1), len(text)


def http_predict_phase(fluid, serving, ca, cl, bert, dirname, card,
                       cfg=None, seq=SEQ):
    """11b: BERT-base pruned to encoder_out behind ModelRegistry.load and
    ServingServer; 4 closed-loop clients x 16 :predict requests of 1-4 rows
    with every counter at 0 just before (12 attention and 25 LayerNorm
    forward launches per dispatch); each reply within 1e-3 x max|x| of the
    same rows through a solo card Predictor. Returns the registry, the
    server, the requests and replies, the launches and the numbers."""
    from paddle_tpu_torch import observability as obs

    cfg = cfg or bert.bert_base()
    t0 = time.monotonic()
    build_bert_base(fluid, bert, dirname, target="encoder_out", cfg=cfg,
                    seq=seq)
    reg = serving.ModelRegistry(max_batch_size=8, max_wait_ms=5.0)
    engine = reg.load("bert", dirname, buckets=[serving.BucketSpec(
        {"input_ids": (seq,)}, dtypes={"input_ids": "int64"},
        batch_sizes=(1, 2, 4, 8))])
    srv = serving.ServingServer(reg).start()
    _sync()
    print("11b bert encoder_out: built, saved, loaded and warmed up (every "
          "bucket once) behind %s in %.1f s" % (srv.url,
                                                time.monotonic() - t0),
          flush=True)
    requests = http_requests(HTTP_CLIENTS * HTTP_PER_CLIENT, cfg.vocab_size,
                             seq)
    url = srv.url + "/v1/models/bert:predict"
    st0 = engine.stats()
    obs.reset()
    fns = zero_counters(ca, cl)
    replies, lat, wall = http_predict_load(url, requests)
    launches = {n: fn.launches for n, fn in fns.items()}
    st1 = engine.stats()
    dispatches = st1["batches"] - st0["batches"]
    coalesced = st1["coalesced"] - st0["coalesced"]
    rows = sum(r.shape[0] for r in requests)
    print("11b :predict load [%s]: %d requests (%d rows) from %d clients in "
          "%.3f s over %d dispatches (%d coalesced); launches %s" % (
              card, len(requests), rows, HTTP_CLIENTS, wall, dispatches,
              coalesced, launches), flush=True)
    # per forward: one attention a layer; two LayerNorms a layer and the
    # embeddings' (12 and 25 at BERT-base)
    check_launches("11b", fns, {
        "flash_attn_fwd": cfg.num_layers * dispatches,
        "layer_norm_fwd": (2 * cfg.num_layers + 1) * dispatches})
    if dispatches < 1:
        fail("11b: no dispatch")
    solo_pred = fluid.Predictor.from_model(dirname)
    solo = [solo_pred.run({"input_ids": r})[0] for r in requests]
    scale = max(float(np.abs(s).max()) for s in solo)
    err = max(float(np.abs(a - b).max()) for a, b in zip(replies, solo))
    same = sum(bool(np.array_equal(a, b)) for a, b in zip(replies, solo))
    shapes_ok = all(a.shape == (r.shape[0], seq, cfg.hidden)
                    for a, r in zip(replies, requests))
    print("11b replies vs a solo card Predictor: max|d| %.3e (%d/%d "
          "bit-identical), bound %.3e x max|x| = %.3e" % (
              err, same, len(requests), HTTP_TOL, HTTP_TOL * scale),
          flush=True)
    # cuBLAS picks its kernel by M, so coalesced rows may be summed in
    # another order than the same rows alone
    if not shapes_ok or not all(np.isfinite(a).all() for a in replies) \
            or err > HTTP_TOL * scale:
        fail("11b: replies differ from the solo predictor's")
    os.environ["PADDLE_TPU_PROM_STYLE"] = "summary"
    try:
        _, prom = http_get(srv.url + "/metrics")
    finally:
        del os.environ["PADDLE_TPU_PROM_STYLE"]
    p50_server = prom_value(
        prom, 'paddle_tpu_serving_request_seconds{quantile="0.5"}')
    server_sum = prom_value(prom, "paddle_tpu_serving_request_seconds_sum")
    server_n = prom_value(prom, "paddle_tpu_serving_request_seconds_count")
    waste = prom_value(prom, "paddle_tpu_serving_padding_waste_sum") / \
        prom_value(prom, "paddle_tpu_serving_padding_waste_count")
    if server_n != len(requests) or p50_server is None:
        fail("11b: /metrics counts %s requests, want %d" % (
            server_n, len(requests)))
    lat_ms = sorted(1e3 * x for x in lat)
    outside = 1 - server_sum / sum(lat)
    dumps_ms, loads_ms, nbytes = json_round_trip_ms(replies[0][:1])
    stats = dict(wall=wall, req_per_s=len(requests) / wall,
                 rows_per_s=rows / wall, p50_ms=_pct(lat_ms, 0.5),
                 p99_ms=_pct(lat_ms, 0.99),
                 server_p50_ms=1e3 * p50_server, outside_share=outside,
                 padding_waste=waste, dispatches=dispatches,
                 coalesced=coalesced, json_dumps_ms=dumps_ms,
                 json_loads_ms=loads_ms, reply_row_bytes=nbytes)
    print("11b :predict [%s]: %.2f req/s (%.2f rows/s); client p50 %.3f "
          "ms, p99 %.3f ms; server serving.request_seconds p50 %.3f ms "
          "(/metrics); %.1f%% of client latency outside the engine (JSON, "
          "sockets, threads); padding waste mean %.3f; %d dispatches, %d "
          "coalesced; one reply row's JSON: server tolist+dumps %.1f ms, "
          "client loads+asarray %.1f ms, %d bytes" % (
              card, stats["req_per_s"], stats["rows_per_s"], stats["p50_ms"],
              stats["p99_ms"], stats["server_p50_ms"], 100 * outside, waste,
              dispatches, coalesced, dumps_ms, loads_ms, nbytes), flush=True)
    del solo_pred
    return reg, srv, requests, replies, launches, stats


def http_stream(url, body, timeout=GPT_WAIT):
    """One streamed :generate: (token ids, time to first token s, the gaps
    between tokens s, the done line)."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    toks, times, done = [], [], None
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for line in resp:
            doc = json.loads(line)
            if "token" in doc:
                toks.append(doc["token"])
                times.append(time.monotonic())
            else:
                done = doc
    if not times:
        raise RuntimeError("no token streamed: %s" % done)
    return (toks, times[0] - t0, [b - a for a, b in zip(times, times[1:])],
            done)


def http_generate_load(url, prompts, max_new=GPT_MAX_NEW,
                       n_clients=GPT_CLIENTS):
    """decode_load over chunked HTTP: closed-loop clients, each streaming
    its contiguous share of `prompts` one after another."""
    n = len(prompts)
    per = -(-n // n_clients)
    toks, ttft, gaps, dones, errors = [None] * n, [None] * n, [], [None] * n, []
    lock = threading.Lock()

    def client(idx):
        for i in idx:
            try:
                toks[i], ttft[i], g, dones[i] = http_stream(
                    url, {"prompt": prompts[i].tolist(),
                          "max_new_tokens": max_new})
                with lock:
                    gaps.extend(g)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append("request %d: %s: %s" % (i, type(e).__name__, e))

    threads = [threading.Thread(target=client,
                                args=(range(c * per, min(n, (c + 1) * per)),))
               for c in range(n_clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=GPT_WAIT)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        fail("11c :generate load: %s" % (errors or "client threads hung"))
    return toks, ttft, gaps, dones, wall


def gauge_peak(name):
    """Samples the hub gauge `name` every 2 ms (as bench.py:1087-1092 does)
    until the returned stop() is called; stop() gives the peak."""
    from paddle_tpu_torch import observability as obs

    peak, done = [0.0], threading.Event()

    def sample():
        while not done.is_set():
            g = obs.gauge(name)
            if g is not None:
                peak[0] = max(peak[0], g)
            time.sleep(0.002)

    t = threading.Thread(target=sample, daemon=True)
    t.start()

    def stop():
        done.set()
        t.join(timeout=10)
        return peak[0]

    return stop


def http_cancel_after(srv, path, body, n_tokens):
    """A raw client that reads `n_tokens` token chunks of a streamed
    :generate and hangs up; returns the token lines it saw."""
    import socket

    data = json.dumps(body).encode()
    raw = socket.create_connection((srv.host, srv.port), timeout=HTTP_WAIT)
    try:
        raw.sendall(b"POST %s HTTP/1.1\r\nHost: smoke\r\nContent-Type: "
                    b"application/json\r\nContent-Length: %d\r\n\r\n%s" % (
                        path.encode(), len(data), data))
        got = b""
        while got.count(b'"token"') < n_tokens:
            chunk = raw.recv(65536)
            if not chunk:
                break
            got += chunk
    finally:
        raw.close()
    return got.count(b'"token"')


def http_generate_phase(fluid, serving, ca, cl, cfg, scope, solo, reg, srv,
                        card, slots=GPT_SLOTS, cache_len=GPT_CACHE,
                        max_new=GPT_MAX_NEW):
    """11c: phase 8's engine configuration published behind the server;
    phase 8c's chat traffic over chunked :generate with every counter at 0
    just before (24 LayerNorm forward launches per prefill and per step);
    every stream equal to its prompt served alone in phase 8b. Then one
    "stream": false request, a client that hangs up after 3 tokens (the
    stream ends cancelled and its slot is free), and a "trace": true
    request whose spans land in a temporary PADDLE_TPU_TRACE_DIR. Returns
    the engine, the launches and the numbers."""
    from paddle_tpu_torch import observability as obs

    prompts = gpt_prompts(cfg.vocab)
    t0 = time.monotonic()
    eng = serving.DecodeEngine(cfg, scope, slots=slots, cache_len=cache_len,
                               name="gpt")
    eng.warmup()
    reg.publish("gpt", eng)
    _sync()
    print("11c gpt engine: %d slots, cache_len %d, built, warmed up and "
          "published in %.1f s" % (slots, cache_len, time.monotonic() - t0),
          flush=True)
    url = srv.url + "/v1/models/gpt:generate"
    st0 = eng.stats()
    fns = zero_counters(ca, cl)
    util = gauge_peak("serving.decode.slot_utilization.gpt")
    toks, ttft, gaps, dones, wall = http_generate_load(url, prompts, max_new)
    peak = util()
    launches = {n: fn.launches for n, fn in fns.items()}
    st1 = eng.stats()
    prefills = st1["prefills"] - st0["prefills"]
    steps = st1["steps"] - st0["steps"]
    print("11c :generate load [%s]: %d requests from %d clients in %.3f s: "
          "%d prefills, %d steps; launches %s" % (
              card, len(prompts), GPT_CLIENTS, wall, prefills, steps,
              launches), flush=True)
    check_launches("11c", fns, {
        "layer_norm_fwd": 2 * cfg.num_layers * (prefills + steps)})
    same = sum(a == b for a, b in zip(toks, solo))
    ends = all(d == {"done": True, "finish_reason": "length", "tokens": t,
                     "n_tokens": max_new} for d, t in zip(dones, toks))
    print("11c streams vs the same prompt served alone (phase 8b): %d/%d "
          "bit-identical; every done line's tokens equal the stream's: %s"
          % (same, len(prompts), ends), flush=True)
    if same != len(prompts) or not ends:
        fail("11c: a stream over HTTP differs from its prompt served alone")
    n_tok = len(prompts) * max_new
    stats = dict(wall=wall, tokens_per_s=n_tok / wall,
                 ttft_p50_ms=1e3 * _pct(ttft, 0.5),
                 ttft_p99_ms=1e3 * _pct(ttft, 0.99),
                 gap_p50_ms=1e3 * _pct(gaps, 0.5),
                 gap_p99_ms=1e3 * _pct(gaps, 0.99), slot_util_peak=peak,
                 prefills=prefills, steps=steps)
    print("11c :generate [%s]: %d tokens in %.3f s: %.1f tokens/s; TTFT p50 "
          "%.3f ms, p99 %.3f ms; gap p50 %.3f ms, p99 %.3f ms (%d gaps); "
          "slot_utilization peak %.3f (sampled every 2 ms)" % (
              card, n_tok, wall, stats["tokens_per_s"], stats["ttft_p50_ms"],
              stats["ttft_p99_ms"], stats["gap_p50_ms"], stats["gap_p99_ms"],
              len(gaps), peak), flush=True)
    # "stream": false: one aggregate document
    code, doc = http_post(url, {"prompt": prompts[1].tolist(),
                                "max_new_tokens": max_new, "stream": False})
    if code != 200 or doc["tokens"] != solo[1] \
            or doc["finish_reason"] != "length":
        fail("11c: the non-streamed request answered %d %s" % (
            code, {k: v for k, v in doc.items() if k != "tokens"}))
    # a client that hangs up after 3 tokens: its stream ends cancelled and
    # its slot is free at the next step
    st0 = eng.stats()
    obs.get_recorder().clear()
    seen = http_cancel_after(srv, "/v1/models/gpt:generate",
                             {"prompt": prompts[0].tolist(),
                              "max_new_tokens": max_new}, HTTP_CANCEL_AFTER)
    t_gone = time.monotonic()
    retired = []
    while time.monotonic() - t_gone < HTTP_WAIT:
        retired = obs.get_recorder().of("slot_retired")
        if retired and eng.stats()["live_slots"] == 0:
            break
        time.sleep(0.001)
    st1 = eng.stats()
    steps_after = st1["steps"] - st0["steps"]
    print("11c client hung up after %d tokens: retired %s, %d of %d tokens "
          "generated, slot free after %.1f ms, %d steps in all, cancelled "
          "%d" % (seen, [r["reason"] for r in retired],
                  retired[0]["tokens"] if retired else -1, max_new,
                  1e3 * (time.monotonic() - t_gone), steps_after,
                  st1["cancelled"] - st0["cancelled"]), flush=True)
    if seen < HTTP_CANCEL_AFTER or [r["reason"] for r in retired] != \
            ["cancelled"] or st1["cancelled"] - st0["cancelled"] != 1 \
            or st1["live_slots"] != 0 or retired[0]["tokens"] >= max_new:
        fail("11c: the hung-up stream was not cancelled and its slot freed")
    # a traced request: the span file holds http.generate and the engine's
    # decode.queue and decode.prefill under one trace id
    with tempfile.TemporaryDirectory() as trace_dir:
        os.environ["PADDLE_TPU_TRACE_DIR"] = trace_dir
        try:
            t_toks, _, _, done = http_stream(url, {
                "prompt": prompts[2].tolist(), "max_new_tokens": 4,
                "trace": True})
            t_end = time.monotonic() + HTTP_WAIT
            while time.monotonic() < t_end and "decode.stream" not in {
                    sp["name"] for sp in obs.read_spans(trace_dir)}:
                time.sleep(0.01)
            spans = obs.read_spans(trace_dir)
        finally:
            del os.environ["PADDLE_TPU_TRACE_DIR"]
    names = sorted({sp["name"] for sp in spans})
    ids = {sp["trace"] for sp in spans}
    print("11c traced request: trace %s, %d spans %s under %d trace id(s)"
          % (done.get("trace_id"), len(spans), names, len(ids)), flush=True)
    if t_toks != solo[2][:4] or ids != {done.get("trace_id")} or not {
            "http.generate", "decode.queue", "decode.prefill"} <= set(names):
        fail("11c: the traced request's spans are missing or split")
    return eng, launches, stats


def http_cli_phase(dirname, request, reply):
    """11d: python -m paddle_tpu_torch.serving.http --model bert=DIR --port 0
    in a child process: its 'serving bert on' line within HTTP_WAIT s, one
    :predict within 11b's tolerance of 11b's reply for the same rows,
    /healthz listing bert, /metrics non-empty, and exit 0 within 30 s of
    SIGINT."""
    import queue
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    # the child must see SIGINT's default action so that python installs
    # its KeyboardInterrupt handler (an ignored SIGINT would be inherited)
    old = signal.signal(signal.SIGINT, signal.default_int_handler)
    try:
        child = subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.serving.http",
             "--model", "bert=%s" % dirname, "--port", "0"],
            cwd=root, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    finally:
        signal.signal(signal.SIGINT, old)
    lines = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(x) for x in child.stdout] + [lines.put(None)],
        daemon=True)
    reader.start()
    t0 = time.monotonic()
    try:
        url, log = None, []
        while url is None and time.monotonic() - t0 < HTTP_WAIT:
            try:
                line = lines.get(timeout=1.0)
            except queue.Empty:
                continue
            if line is None:
                break
            log.append(line.rstrip())
            m = re.match(r"serving bert on (http://\S+)", line)
            if m:
                url = m.group(1)
        if url is None:
            fail("11d: no 'serving bert on' line in %.0f s: %s" % (
                time.monotonic() - t0, log[-20:]))
        t_up = time.monotonic() - t0
        code, doc = http_post(url + "/v1/models/bert:predict",
                              {"feeds": {"input_ids": request.tolist()}})
        if code != 200:
            fail("11d: :predict answered %d: %s" % (code, doc))
        got = reply_array(doc)
        scale = float(np.abs(reply).max())
        err = float(np.abs(got - reply).max())
        _, health = http_get(url + "/healthz")
        _, prom = http_get(url + "/metrics")
        models = sorted(json.loads(health)["models"])
        child.send_signal(signal.SIGINT)
        rc = child.wait(timeout=30)
        print("11d CLI: 'serving bert on %s' after %.1f s; :predict of %d "
              "rows vs 11b's reply: max|d| %.3e, bound %.3e; /healthz "
              "models %s; /metrics %d bytes; exit %d after SIGINT" % (
                  url, t_up, request.shape[0], err, HTTP_TOL * scale,
                  models, len(prom), rc), flush=True)
        if err > HTTP_TOL * scale or models != ["bert"] or not prom \
                or rc != 0:
            fail("11d: the standalone server misbehaved")
    except subprocess.TimeoutExpired:
        fail("11d: the child did not exit within 30 s of SIGINT")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=30)
        reader.join(timeout=10)


def telemetry_cost(url, requests, eng, prompts, solo, card,
                   max_new=GPT_MAX_NEW):
    """11e: 11b's :predict load and a phase-8c-sized decode load (direct to
    the engine, as 8c times it), each run twice with PADDLE_TPU_TELEMETRY
    off and on in alternation. The cost is a finding, not a gate; the
    decode load's tokens must still be the solo ones."""
    out = {}
    for mode in ("off", "on"):
        os.environ["PADDLE_TPU_TELEMETRY"] = mode
        try:
            _, _, wall = http_predict_load(url, requests)
            toks, _, _, dwall = decode_load(eng, prompts, max_new)
        finally:
            del os.environ["PADDLE_TPU_TELEMETRY"]
        if toks != solo:
            fail("11e: the decode load with telemetry %s gave other tokens"
                 % mode)
        out[mode] = dict(predict_req_per_s=len(requests) / wall,
                         decode_tokens_per_s=len(prompts) * max_new / dwall)
        print("11e telemetry %-3s [%s]: :predict load %.3f s, %.2f req/s; "
              "decode load %.3f s, %.1f tokens/s" % (
                  mode, card, wall, out[mode]["predict_req_per_s"], dwall,
                  out[mode]["decode_tokens_per_s"]), flush=True)
    for key in ("predict_req_per_s", "decode_tokens_per_s"):
        out[key + "_on_vs_off"] = out["on"][key] / out["off"][key] - 1
    print("11e telemetry on vs off: :predict req/s %+.1f%%, decode tokens/s "
          "%+.1f%% (one pair each, in this call)" % (
              100 * out["predict_req_per_s_on_vs_off"],
              100 * out["decode_tokens_per_s_on_vs_off"]), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 12: the serving fleet
# ---------------------------------------------------------------------------
# 12a: 11b's BERT-base (encoder_out, seq 128, f32, seed 1234) behind
# local_fleet(n_replicas=4, per_device=True) with bench.py:953's buckets
# and queue, and its load: 8 closed-loop clients x 30 requests of 1-4
# rows, once round-robin on the raw engines, once through the router.
# 12b: failover drills on that fleet. 12c: two worker processes over a
# FileStore, one SIGKILLed. 12d: GPT-2 small (phase 8's scope) served
# colocated and disaggregated under bench.py:1232's mixed-tenant load,
# then a decode-replica kill under an 80-token canary. 12e: the lossless
# fleet token for token against a colocated engine; the int8-resident
# cache. 12f: the lossless fleet behind the HTTP server.
FLEET_REPLICAS, FLEET_CLIENTS, FLEET_PER_CLIENT = 4, 8, 30
FLEET_ROWS, FLEET_BATCHES = (1, 2, 3, 4), (1, 2, 4, 8, 16)
FLEET_TOL = 1e-3                 # x max|x|: replies against a solo bucket
FLEET_WAIT = 300.0               # s: the bound of every wait in phase 12
DIS_LAT_CLIENTS, DIS_LAT_LENS, DIS_LAT_NEW = 6, (3, 5, 6), 16
DIS_BULK_CLIENTS, DIS_BULK_LEN, DIS_BULK_NEW = 2, 700, 6
DIS_PER_CLIENT, DIS_CANARY_NEW = 3, 80
DIS_SLO_MS = 250.0               # the latency tenant's per-token SLO


def fleet_config(**kw):
    """The fleets' heartbeat: an interval of 0.1 s (a replica beats twice
    an interval), dead after 5 intervals (0.5 s) of silence; a replica's
    beater shares the GIL with the other replicas' dispatch threads and 8
    clients."""
    from paddle_tpu_torch.parallel.elastic import ElasticConfig

    kw.setdefault("heartbeat_interval", 0.1)
    kw.setdefault("miss_threshold", 5)
    kw.setdefault("startup_grace", 300.0)
    return ElasticConfig(**kw)


def bucket_of(rows):
    return next(b for b in FLEET_BATCHES if b >= rows)


def solo_bucket(pred, ids):
    """The rows of `ids` through a solo predictor at the bucket a lone
    engine pads them to (one M: the same cuBLAS kernels)."""
    pad = np.zeros((bucket_of(ids.shape[0]), ids.shape[1]), ids.dtype)
    pad[:ids.shape[0]] = ids
    return pred.run({"input_ids": pad})[0][:ids.shape[0]]


def wait_until(cond, what, timeout=FLEET_WAIT):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            fail("12: timed out waiting for %s" % what)
        time.sleep(0.005)


def fleet_drive(predict, feeds, n_clients=FLEET_CLIENTS,
                per_client=FLEET_PER_CLIENT):
    """bench.py:953's drive: client i sends requests k = 0..per_client-1,
    feed (i + k) % len(feeds), closed loop. Returns [(feed index, reply)]
    and the wall (s); any client failure fails the phase."""
    out, errors = [], []

    def client(i):
        for k in range(per_client):
            fi = (i + k) % len(feeds)
            try:
                out.append((fi, predict(i, k, feeds[fi])[0]))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append("client %d request %d: %s: %s" % (
                    i, k, type(e).__name__, e))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(n_clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=FLEET_WAIT)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        fail("12 fleet load: %s" % (errors[:3] or "client threads hung"))
    return out, wall


def check_replies(tag, replies, refs, scale):
    """Every (feed index, reply) within FLEET_TOL x max|x| of its solo
    bucket reference; returns the largest difference."""
    err = 0.0
    for fi, out in replies:
        if out.shape != refs[fi].shape or not np.isfinite(out).all():
            fail("%s: a reply of shape %s, want %s" % (
                tag, out.shape, refs[fi].shape))
        err = max(err, float(np.abs(out - refs[fi]).max()))
    if err > FLEET_TOL * scale:
        fail("%s: a reply %.3e off its solo bucket, bound %.3e" % (
            tag, err, FLEET_TOL * scale))
    return err


def drill_replica(srouter, rid, spec, store, dirname, held=False):
    """A LocalReplica of `dirname` on cuda:0 with 12a's engine options;
    a `held` one's engine is built and warmed but not started
    (``auto_start=False``): it queues what the router sends it and
    dispatches nothing until its ``start()``."""
    factory = srouter.make_engine_factory(
        buckets=[spec], name="bert-drill", replica_id=rid,
        device=torch.device("cuda", 0), max_batch_size=16, max_wait_ms=1.0,
        queue_capacity=256, auto_start=not held)
    return srouter.LocalReplica(rid, factory, store, name="bert-drill",
                                config=fleet_config(), dirname=dirname)


def submit_until_queued(router, feeds, engine, at_least):
    """Submit through the router until `engine` (held) holds queued
    work and at least `at_least` requests are out; a held queue only
    grows, so the gate cannot race."""
    futs = []
    while len(futs) < at_least or engine.queue_depth() == 0:
        if len(futs) >= 256:
            fail("12b: 256 requests and none queued on the held replica")
        fi = len(futs) % len(feeds)
        futs.append((fi, router.submit(feeds[fi])))
    return futs


def resolve(tag, futs):
    try:
        return [(fi, f.result(timeout=FLEET_WAIT)[0]) for fi, f in futs]
    except Exception as e:  # noqa: BLE001 — a client failure fails 12b
        fail("%s: a client saw %s: %s" % (tag, type(e).__name__, e))


def fleet_contention(preds, feeds, card, forwards=20):
    """Where four in-process replicas' time goes, without their engines:
    1, 2 and 4 threads each running `forwards` forwards of its own
    predictor on `feeds`, then 4 with a 0.5 ms GIL switch interval and 4
    with a CUDA stream each. Per forward, its host wall and the CPU time
    its thread spent in it (``time.thread_time``: a forward whose wall
    grows while its CPU time does not is waiting, one whose CPU time grows
    is working harder). Returns {config: forwards/s, wall and CPU ms}."""
    def run(n, own_streams=False):
        walls, cpus = [], []

        def worker(p):
            stream = torch.cuda.Stream() if own_streams else None
            with torch.cuda.stream(stream):
                for _ in range(forwards):
                    t0, c0 = time.monotonic(), time.thread_time()
                    p.run(feeds)     # returns numpy: waits for the device
                    walls.append(time.monotonic() - t0)
                    cpus.append(time.thread_time() - c0)

        threads = [threading.Thread(target=worker, args=(preds[i],))
                   for i in range(n)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=FLEET_WAIT)
        if any(t.is_alive() for t in threads):
            fail("12a contention: a forward thread hung")
        return dict(forwards_per_s=n * forwards / (time.monotonic() - t0),
                    wall_ms=1e3 * statistics.median(walls),
                    cpu_ms=1e3 * statistics.median(cpus))

    out = {"%d threads" % n: run(n) for n in (1, 2, len(preds))}
    old = sys.getswitchinterval()
    sys.setswitchinterval(0.0005)
    try:
        out["%d threads, switch interval 0.5 ms" % len(preds)] = run(
            len(preds))
    finally:
        sys.setswitchinterval(old)
    out["%d threads, a stream each" % len(preds)] = run(len(preds), True)
    print("12a contention [%s]: the fleet's predictors without their "
          "engines, %d forwards of %d rows a thread: %s" % (
              card, forwards, feeds["input_ids"].shape[0], "; ".join(
                  "%s %.1f forwards/s, a forward's wall %.3f ms and thread "
                  "CPU %.3f ms" % (k, r["forwards_per_s"], r["wall_ms"],
                                   r["cpu_ms"]) for k, r in out.items())),
          flush=True)
    return out


def fleet_phase(fluid, serving, ca, cl, bert, enc_dir, tmp, card,
                cfg=None):
    """Phases 12a-12c on 11b's model in `enc_dir` (built from `cfg`,
    BERT-base). Returns the kernels' launches in 12a's routed load (the
    counters zeroed just before it, read just after), and the numbers."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.parallel.elastic import FileStore, InMemoryStore
    from paddle_tpu_torch.serving import router as srouter

    cfg = cfg or bert.bert_base()
    spec = serving.BucketSpec({"input_ids": (SEQ,)},
                              dtypes={"input_ids": "int64"},
                              batch_sizes=FLEET_BATCHES)
    rng = np.random.default_rng(SEED + 12)
    feeds = [{"input_ids": rng.integers(0, cfg.vocab_size, size=(r, SEQ),
                                        dtype=np.int64)}
             for r in FLEET_ROWS]
    solo = fluid.Predictor.from_model(enc_dir)
    refs = [solo_bucket(solo, f["input_ids"]) for f in feeds]
    scale = max(float(np.abs(r).max()) for r in refs)
    t0 = time.monotonic()
    obs.reset()
    router = srouter.local_fleet(
        enc_dir, n_replicas=FLEET_REPLICAS, per_device=True, buckets=[spec],
        name="bert-fleet", config=fleet_config(), max_batch_size=16,
        max_wait_ms=1.0, queue_capacity=256)
    stats = dict(build_s=time.monotonic() - t0)
    engines = [router._live[rid].engine for rid in sorted(router._live)]
    print("12a fleet: %d BERT-base replicas (encoder_out) on %s, each "
          "built from %s and warmed up (buckets %s) in %.1f s" % (
              FLEET_REPLICAS, sorted({str(e.predictor.device)
                                      for e in engines}),
              os.path.basename(enc_dir), FLEET_BATCHES, stats["build_s"]),
          flush=True)

    # -- 12a: the same warmed engines, the same load, two dispatch paths
    # (and first one replica alone: what 4 replicas in one process add);
    # the counters are zeroed before each, the routed load's are the main
    # path's
    st0 = [e.stats() for e in engines]
    fns = zero_counters(ca, cl)
    alone, a_wall = fleet_drive(
        lambda i, k, f: engines[0].predict(f, timeout=FLEET_WAIT), feeds)
    direct, d_wall = fleet_drive(
        lambda i, k, f: engines[(i + k) % len(engines)].predict(
            f, timeout=FLEET_WAIT), feeds)
    st1 = [e.stats() for e in engines]
    raw = sum(b["batches"] - a["batches"] for a, b in zip(st0, st1))
    check_launches("12a one replica and round-robin", fns, {
        "flash_attn_fwd": cfg.num_layers * raw,
        "layer_norm_fwd": (2 * cfg.num_layers + 1) * raw})
    fns = zero_counters(ca, cl)
    routed, r_wall = fleet_drive(
        lambda i, k, f: router.predict(f, timeout=FLEET_WAIT), feeds)
    st2 = [e.stats() for e in engines]
    dispatches = sum(b["batches"] - a["batches"] for a, b in zip(st1, st2))
    launches = check_launches("12a routed (the main path)", fns, {
        "flash_attn_fwd": cfg.num_layers * dispatches,
        "layer_norm_fwd": (2 * cfg.num_layers + 1) * dispatches})
    check_replies("12a one replica", alone, refs, scale)
    d_err = check_replies("12a direct", direct, refs, scale)
    r_err = check_replies("12a routed", routed, refs, scale)
    n = FLEET_CLIENTS * FLEET_PER_CLIENT
    rst = router.stats()
    spread = [b["requests"] - a["requests"] for a, b in zip(st1, st2)]
    # the router's own cost: each request's submit-to-handoff time
    disp = obs.histogram("serving.dispatch_seconds") or {}
    if not disp.get("count"):
        fail("12a: no serving.dispatch_seconds from the routed load")
    stats.update(router_requests_per_sec=n / r_wall,
                 direct_requests_per_sec=n / d_wall,
                 one_replica_requests_per_sec=n / a_wall,
                 router_dispatch_p50_ms=1e3 * disp["p50"],
                 router_dispatch_p99_ms=1e3 * disp["p99"],
                 failovers=int(rst.get("failovers", 0)),
                 replicas_live=int(rst["replicas_live"]),
                 dispatch_spread=spread, dispatches=dispatches)
    # the gap between two loads that four in-process replicas slow alike
    # (see fleet_contention): contention's spread, not the router's cost
    stats["router_overhead_pct"] = 100.0 * (
        stats["direct_requests_per_sec"] - stats["router_requests_per_sec"]
    ) / stats["direct_requests_per_sec"]
    print("12a fleet load [%s]: %d requests a path from %d clients; one "
          "replica alone %.3f s, %.2f req/s; direct round-robin over %d "
          "%.3f s, %.2f req/s; routed %.3f s, %.2f req/s; the router's "
          "cost (serving.dispatch_seconds, submit to a replica's queue) "
          "p50 %.3f ms, p99 %.3f ms over %d dispatches; router_overhead_pct "
          "%.1f%% (routed against direct req/s, both bound by the "
          "replicas' contention, not the router's cost); failovers %d, "
          "replicas_live %d; routed requests per replica %s in %d "
          "dispatches; replies vs a solo bucket: direct max|d| %.3e, "
          "routed %.3e, bound %.3e" % (
              card, n, FLEET_CLIENTS, a_wall,
              stats["one_replica_requests_per_sec"], FLEET_REPLICAS, d_wall,
              stats["direct_requests_per_sec"], r_wall,
              stats["router_requests_per_sec"],
              stats["router_dispatch_p50_ms"],
              stats["router_dispatch_p99_ms"], disp["count"],
              stats["router_overhead_pct"], stats["failovers"],
              stats["replicas_live"], spread, dispatches, d_err, r_err,
              FLEET_TOL * scale), flush=True)
    if stats["replicas_live"] != FLEET_REPLICAS or min(spread) < 1:
        fail("12a: the router did not spread over every replica: %s"
             % spread)
    stats["contention"] = fleet_contention(
        [e.predictor for e in engines], feeds[3], card)

    # -- 12b: failover drills. kill() and the drain on a router of the
    # same model and engine options: replicas 1 and 2 serve; 0 and the
    # warm standby 3 are held (built, not started), so what the router
    # sends them waits in their queues until the drill acts
    t12b = time.monotonic()
    dstore = InMemoryStore()
    reps = [drill_replica(srouter, rid, spec, dstore, enc_dir,
                          held=rid in (0, 3)) for rid in range(4)]
    victim, standby = reps[0], reps[3]
    drill = srouter.ServingRouter(
        reps[:3], store=dstore, name="bert-drill", config=fleet_config(),
        dirname=enc_dir, standby=[standby],
        scale_up_depth=1 << 30)   # no pressure scale-up of the held standby
    try:
        futs = submit_until_queued(drill, feeds, victim.engine, 16)
        queued = victim.engine.queue_depth()
        t_kill = time.monotonic()
        victim.kill()
        replies = resolve("12b kill", futs)
        wait_until(lambda: drill.replicas_live() == [1, 2, 3],
                   "the monitor to declare replica 0 dead and the standby "
                   "to take its place")
        stats["dead_after_s"] = time.monotonic() - t_kill
        err = check_replies("12b kill", replies, refs, scale)
        fo = stats["failovers_kill"] = int(drill.stats().get("failovers", 0))
        print("12b kill: replica 0 held %d queued requests of %d; all "
              "answered (max|d| %.3e), failovers %d; the monitor declared "
              "it dead and standby 3 took its place %.3f s after kill() "
              "(silence bound %.2f s); live %s" % (
                  queued, len(futs), err, fo, stats["dead_after_s"],
                  drill.config.dead_after, drill.replicas_live()),
              flush=True)
        if fo < 1:
            fail("12b: the kill replayed nothing")

        futs = submit_until_queued(drill, feeds, standby.engine, 8)
        queued = standby.engine.queue_depth()
        dead0 = drill.stats()["replica_dead"]
        standby.engine.start()
        drill.remove_replica(3, drain=True)
        err = check_replies("12b remove", resolve("12b remove", futs),
                            refs, scale)
        if drill.stats()["replica_dead"] != dead0 or \
                drill.replicas_live() != [1, 2]:
            fail("12b: the drained replica was not removed cleanly: live %s"
                 % drill.replicas_live())
        print("12b remove_replica(3, drain=True): %d queued requests "
              "drained on it, all %d answered (max|d| %.3e), no replica "
              "declared dead; live %s" % (
                  queued, len(futs), err, drill.replicas_live()),
              flush=True)
    finally:
        drill.stop(drain=False, timeout=30.0)

    # a v3 directory with a torn parameter file: the first rebuild fails
    # its health gate, the rollout rolls back, v1 keeps serving
    v3 = os.path.join(tmp, "bert_v3")
    os.makedirs(v3)
    for fn in os.listdir(enc_dir):
        with open(os.path.join(enc_dir, fn), "rb") as f:
            data = f.read()
        if fn != "__model__":
            data = data[:len(data) // 2]
        with open(os.path.join(v3, fn), "wb") as f:
            f.write(data)
    t0 = time.monotonic()
    try:
        router.rolling_reload(v3, probe_feeds=feeds[0],
                              reload_timeout=FLEET_WAIT)
        fail("12b: the rollout to a torn v3 succeeded")
    except srouter.RolloutError as e:
        rolled = str(e)
    if router.dirname != enc_dir or any(
            r.dirname != enc_dir for r in router._live.values()) \
            or obs.gauge("serving.rollout_state") != 2:
        fail("12b: the failed rollout left the fleet on %s" % [
            r.dirname for r in router._live.values()])
    err = check_replies("12b rollback", [
        (fi, router.predict(feeds[fi], timeout=FLEET_WAIT)[0])
        for fi in range(len(feeds))], refs, scale)
    print("12b rolling_reload(torn v3): RolloutError after %.1f s (%s); "
          "every replica on v1, which answers within %.3e" % (
              time.monotonic() - t0, rolled[:120], err), flush=True)

    # v2: the same model saved from seed 1235, rolled out under 4 clients
    v2 = os.path.join(tmp, "bert_v2")
    build_bert_base(fluid, bert, v2, target="encoder_out", cfg=cfg,
                    seed=SEED + 1)
    solo2 = fluid.Predictor.from_model(v2)
    refs2 = [solo_bucket(solo2, f["input_ids"]) for f in feeds]
    del solo2
    results, errors, stop = [], [], threading.Event()

    def hammer(i):
        k = 0
        while not stop.is_set():
            fi = (i + k) % len(feeds)
            k += 1
            try:
                results.append((fi, router.predict(
                    feeds[fi], timeout=FLEET_WAIT)[0]))
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append("%s: %s" % (type(e).__name__, e))
                return

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    wait_until(lambda: len(results) >= 8 or errors, "traffic before v2")
    t0 = time.monotonic()
    done = router.rolling_reload(v2, probe_feeds=feeds[0],
                                 reload_timeout=FLEET_WAIT)
    reload_s = time.monotonic() - t0
    n_at = len(results)
    wait_until(lambda: len(results) >= n_at + 8 or errors,
               "traffic after v2")
    stop.set()
    for t in threads:
        t.join(timeout=FLEET_WAIT)
    if errors:
        fail("12b rolling_reload: %s" % errors[:3])
    n_v1 = n_v2 = 0
    for fi, out in results:
        d1 = float(np.abs(out - refs[fi]).max())
        d2 = float(np.abs(out - refs2[fi]).max())
        if d1 <= FLEET_TOL * scale:
            n_v1 += 1
        elif d2 <= FLEET_TOL * scale:
            n_v2 += 1
        else:
            fail("12b: a reply matches neither v1 (%.3e) nor v2 (%.3e)"
                 % (d1, d2))
    if sorted(done) != list(range(FLEET_REPLICAS)) or router.dirname != v2:
        fail("12b: the rollout upgraded %s" % done)
    check_replies("12b v2", [
        (fi, router.predict(feeds[fi], timeout=FLEET_WAIT)[0])
        for fi in range(len(feeds))], refs2, scale)
    print("12b rolling_reload(v2) under 4 clients: %.1f s for replicas %s; "
          "%d replies, %d from v1 and %d from v2, none a blend, 0 client "
          "failures; the fleet answers as v2" % (
              reload_s, done, len(results), n_v1, n_v2), flush=True)
    stats["reload_s"] = reload_s
    stats["failovers_reload"] = int(router.stats().get("failovers", 0))
    router.stop()
    stats["drills_s"] = time.monotonic() - t12b

    # -- 12c: two worker processes on the card over a FileStore
    store_dir = os.path.join(tmp, "fleet_store")
    buckets = json.dumps([{"feeds": {"input_ids": [SEQ]},
                           "batch_sizes": list(FLEET_BATCHES),
                           "dtypes": {"input_ids": "int64"}}])
    logs = [open(os.path.join(tmp, "worker%d.log" % rid), "w")
            for rid in (0, 1)]
    t_spawn = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.router",
         "--store", store_dir, "--rid", str(rid), "--name", "bert-proc",
         "--model-dir", enc_dir, "--heartbeat-interval", "0.1",
         "--max-batch-size", "16", "--max-wait-ms", "1",
         "--buckets", buckets],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=logs[rid], stderr=subprocess.STDOUT) for rid in (0, 1)]
    prouter = None
    try:
        store = FileStore(store_dir)
        pconf = fleet_config(miss_threshold=10)
        prouter = srouter.ServingRouter(
            [srouter.StoreReplica(rid, store, name="bert-proc",
                                  config=pconf) for rid in (0, 1)],
            store=store, name="bert-proc", config=pconf, dirname=enc_dir)
        started = {}

        def up():
            table = prouter.monitor.table()
            for rid in (0, 1):
                if rid in table and rid not in started:
                    started[rid] = time.monotonic() - t_spawn
                if procs[rid].poll() is not None:
                    fail("12c: worker %d exited with %s: %s" % (
                        rid, procs[rid].returncode, log_tail(tmp, rid)))
            return len(started) == 2

        wait_until(up, "both workers' first beacons")
        replies = [(fi, prouter.predict(feeds[fi], timeout=FLEET_WAIT)[0])
                   for fi in (0, 1)]
        procs[0].kill()           # SIGKILL: no drain, no goodbye
        t_kill = time.monotonic()
        wait_until(lambda: 0 not in prouter.replicas_live(),
                   "the router to declare worker 0 dead")
        stats["proc_dead_after_s"] = time.monotonic() - t_kill
        replies += [(fi, prouter.predict(feeds[fi], timeout=FLEET_WAIT)[0])
                    for fi in (0, 1, 2, 3)]
        err = check_replies("12c", replies, refs, scale)
        stats["worker_start_s"] = [started[0], started[1]]
        print("12c process fleet: workers up (first beacon) %.1f s and "
              "%.1f s after spawn; 2 requests before and 4 after SIGKILL "
              "of worker 0 (max|d| %.3e over the FileStore's JSON); the "
              "router declared it dead %.3f s after the kill (silence "
              "bound %.2f s); live %s" % (
                  started[0], started[1], err, stats["proc_dead_after_s"],
                  pconf.dead_after, prouter.replicas_live()), flush=True)
    finally:
        if prouter is not None:
            prouter.stop(timeout=30.0)
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
        for f in logs:
            f.close()
    if procs[1].returncode != 0:
        fail("12c: worker 1 exited %s after the stop: %s" % (
            procs[1].returncode, log_tail(tmp, 1)))
    return launches, stats


def log_tail(tmp, rid):
    with open(os.path.join(tmp, "worker%d.log" % rid)) as f:
        return f.read()[-2000:]


def dis_tenants(disagg, model, capped=False):
    specs = [disagg.TenantSpec("latency", priority="interactive",
                               per_token_slo_ms=DIS_SLO_MS),
             disagg.TenantSpec("bulk", priority="batch")]
    if capped:
        specs.append(disagg.TenantSpec("capped", max_live=0))
    return disagg.TenantTable(specs=specs, model=model)


def dis_requests(vocab):
    """bench.py:1232's mixed-tenant load: per client, (tenant, prompt,
    new tokens) x 3; 6 latency clients cycle 3/5/6-token prompts, 2 bulk
    clients send 700-token prompts."""
    rng = np.random.default_rng(GPT_SEED + 12)
    clients = []
    for c in range(DIS_LAT_CLIENTS):
        clients.append([("latency", rng.integers(0, vocab, DIS_LAT_LENS[
            k % len(DIS_LAT_LENS)]).astype(np.int64), DIS_LAT_NEW)
            for k in range(DIS_PER_CLIENT)])
    for c in range(DIS_BULK_CLIENTS):
        clients.append([("bulk", rng.integers(0, vocab, DIS_BULK_LEN)
                         .astype(np.int64), DIS_BULK_NEW)
                        for _ in range(DIS_PER_CLIENT)])
    return clients


def dis_load(submit, clients):
    """Closed-loop clients streaming their requests; returns the tokens
    by (client, request), the latency tenant's gaps between tokens (s),
    every TTFT (s) and the wall (s)."""
    toks, gaps, ttft, errors = {}, [], [], []

    def client(c):
        for k, (tenant, prompt, new) in enumerate(clients[c]):
            t0 = time.monotonic()
            try:
                out, last = [], None
                for tok in submit(prompt, new, tenant).tokens(
                        timeout=FLEET_WAIT):
                    now = time.monotonic()
                    if last is None:
                        ttft.append(now - t0)
                    elif tenant == "latency":
                        gaps.append(now - last)
                    last = now
                    out.append(tok)
                toks[(c, k)] = out
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append("client %d request %d: %s: %s" % (
                    c, k, type(e).__name__, e))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(clients))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=FLEET_WAIT)
    wall = time.monotonic() - t0
    if errors or any(t.is_alive() for t in threads):
        fail("12d load: %s" % (errors[:3] or "client threads hung"))
    return toks, gaps, ttft, wall


def dis_report(tag, card, clients, toks, gaps, wall, wire=None):
    n_tok = sum(len(t) for t in toks.values())
    want = sum(new for reqs in clients for _, _, new in reqs)
    if n_tok != want:
        fail("%s: %d tokens delivered, want %d" % (tag, n_tok, want))
    out = dict(tokens_per_s=n_tok / wall, wall=wall,
               latency_gap_p50_ms=1e3 * _pct(gaps, 0.5),
               latency_gap_p99_ms=1e3 * _pct(gaps, 0.99))
    print("%s [%s]: %d tokens in %.3f s: %.1f tokens/s; latency tenant's "
          "per-token gap p50 %.3f ms, p99 %.3f ms (%d gaps)%s" % (
              tag, card, n_tok, wall, out["tokens_per_s"],
              out["latency_gap_p50_ms"], out["latency_gap_p99_ms"],
              len(gaps), wire or ""), flush=True)
    return out


def fleet_counts(engines):
    """Prefill and step dispatches over a set of engines, from stats()."""
    return sum(e.stats().get("prefills", 0) + e.stats().get("steps", 0)
               for e in engines)


def disagg_phase(fluid, serving, ca, cl, cfg, scope, card, tmp):
    """Phases 12d-12f. Returns the kernels' launches in 12d's leg (ii),
    the disaggregated load (the counters zeroed just before it, read just
    after), and the numbers."""
    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch.fluid.resilience import FaultInjector
    from paddle_tpu_torch.serving import disagg

    clients = dis_requests(cfg.vocab)
    wire_int8 = disagg.handoff_wire_bytes(cfg.num_layers, GPT_CACHE,
                                          cfg.hidden, "int8")
    wire_fp32 = disagg.handoff_wire_bytes(cfg.num_layers, GPT_CACHE,
                                          cfg.hidden, "fp32")
    ratio = disagg.handoff_compression(cfg.num_layers, GPT_CACHE,
                                       cfg.hidden, "int8")
    stats = {}
    t0 = time.monotonic()
    obs.reset()
    coloc = serving.DecodeEngine(cfg, scope, slots=4, cache_len=GPT_CACHE,
                                 name="gpt-coloc")
    coloc.warmup()
    fleet = disagg.disagg_fleet(
        cfg, scope, n_prefill=2, n_decode=2, slots=2, cache_len=GPT_CACHE,
        kv_dtype="fp32", wire_dtype="int8",
        tenants=dis_tenants(disagg, "gpt-disagg"), name="gpt-disagg",
        request_timeout_s=FLEET_WAIT, warm=True)
    _sync()
    fleet_engines = [r.engine for r in list(fleet._prefill.values())
                     + list(fleet._decode.values())]
    print("12d colocated DecodeEngine(slots=4) and disagg_fleet(2 prefill "
          "+ 2 decode, slots=2, int8 wire, fp32-resident) at cache_len %d, "
          "buckets %s: built and warmed up in %.1f s" % (
              GPT_CACHE, coloc.prompt_buckets, time.monotonic() - t0),
          flush=True)

    # every leg between zeroed counters: 24 LayerNorm forwards in each
    # prefill and step of the leg's engines; leg (ii)'s are the main path's
    def leg_launches(tag, engines, n0):
        return check_launches(tag, fns, {"layer_norm_fwd": 2 * cfg.num_layers
                                         * (fleet_counts(engines) - n0)})

    # leg (i): colocated
    fns = zero_counters(ca, cl)
    n0 = fleet_counts([coloc])
    toks_c, gaps, _, wall = dis_load(
        lambda p, new, tenant: coloc.submit(p, max_new=new, tenant=tenant),
        clients)
    leg_launches("12d leg (i)", [coloc], n0)
    stats["colocated"] = dis_report("12d leg (i) colocated", card, clients,
                                    toks_c, gaps, wall)
    # leg (ii): disaggregated, every request traced
    trace_dir = os.path.join(tmp, "trace12")
    os.environ[obs.TRACE_DIR_ENV] = trace_dir
    fns = zero_counters(ca, cl)
    n0 = fleet_counts(fleet_engines)
    try:
        toks_d, gaps, _, wall = dis_load(
            lambda p, new, tenant: fleet.submit(
                p, max_new=new, tenant=tenant,
                trace_ctx=obs.TraceContext.new()), clients)
    finally:
        del os.environ[obs.TRACE_DIR_ENV]
    launches = leg_launches("12d leg (ii) (the main path)", fleet_engines,
                            n0)
    hist = obs.histogram("serving.disagg.per_token_seconds.latency") or {}
    stats["disagg"] = dis_report(
        "12d leg (ii) disaggregated", card, clients, toks_d, gaps, wall,
        "; router's per-token p50 %s; handoff %d wire bytes (%.1f MB, "
        "fp32 %.1f MB): handoff_compression %.3f" % (
            "%.3f ms" % (1e3 * hist["p50"]) if hist.get("p50") is not None
            else "n/a", wire_int8, wire_int8 / 1e6, wire_fp32 / 1e6, ratio))
    first_same = sum(toks_d[k][0] == toks_c[k][0] for k in toks_c)
    breakdown = obs.phase_breakdown(obs.read_spans(trace_dir))
    stats["phase_breakdown_ms"] = {
        ph: dict(count=b["count"], mean_ms=1e3 * b["mean_s"],
                 max_ms=1e3 * b["max_s"], total_ms=1e3 * b["total_s"])
        for ph, b in breakdown.items()}
    print("12d leg (ii) phase_breakdown (ms, from %d traced requests): %s; "
          "first tokens equal to leg (i)'s: %d/%d" % (
              len(toks_d), ", ".join(
                  "%s n=%d mean %.3f max %.3f" % (
                      ph, b["count"], 1e3 * b["mean_s"], 1e3 * b["max_s"])
                  for ph, b in sorted(breakdown.items())),
              first_same, len(toks_c)), flush=True)
    if first_same != len(toks_c) or not {
            "queue", "prefill", "handoff", "adopt", "decode"} <= set(
                breakdown):
        fail("12d: first tokens or the phase breakdown are off: %s"
             % sorted(breakdown))
    # leg (iii): an 80-token canary; its decode replica killed at half
    st_before = fleet.stats()
    fns = zero_counters(ca, cl)
    n0 = fleet_counts(fleet_engines)
    canary_prompt = clients[0][1][1]
    t0 = time.monotonic()
    canary = fleet.submit(canary_prompt, max_new=DIS_CANARY_NEW,
                          tenant="latency")
    wait_until(lambda: len(canary.so_far()) >= DIS_CANARY_NEW // 2,
               "the canary's first half")
    with fleet._lock:
        victim = next(rid for rid, hs in fleet._sessions.items()
                      if canary in hs)
    fleet.kill_replica(victim)
    got = canary.result(FLEET_WAIT)
    wall = time.monotonic() - t0
    leg_launches("12d leg (iii)", fleet_engines, n0)
    st = fleet.stats()
    migrations = st["migrations"] - st_before["migrations"]
    stats["canary"] = dict(tokens=len(got), migrations=migrations,
                           failed_streams=st["failed_streams"],
                           tokens_per_s=len(got) / wall)
    print("12d leg (iii) [%s]: 80-token canary, decode replica %d killed "
          "after %d tokens: %d tokens in %.3f s (%.1f tokens/s), migrations "
          "%d, failed_streams %d, decode_live %d" % (
              card, victim, DIS_CANARY_NEW // 2, len(got), wall,
              len(got) / wall, migrations, st["failed_streams"],
              st["decode_live"]), flush=True)
    if len(got) != DIS_CANARY_NEW or migrations < 1 or \
            st["failed_streams"] != 0:
        fail("12d: the canary got %d tokens, %d migrations, %d failed "
             "streams" % (len(got), migrations, st["failed_streams"]))
    fleet.stop(drain=False, timeout=30.0)
    coloc.stop()
    del coloc, fleet, fleet_engines

    # -- 12e: the lossless fleet token for token; the int8 residency
    t0 = time.monotonic()
    exact = disagg.disagg_fleet(
        cfg, scope, n_prefill=2, n_decode=2, slots=2, cache_len=GPT_CACHE,
        kv_dtype="fp32", wire_dtype="fp32",
        tenants=dis_tenants(disagg, "gpt-exact", capped=True),
        name="gpt-exact", request_timeout_s=FLEET_WAIT, warm=True)
    ref = serving.DecodeEngine(cfg, scope, slots=2, cache_len=GPT_CACHE,
                               name="gpt-ref")
    ref.warmup()
    print("12e fp32-wire fleet and a colocated DecodeEngine(slots=2) built "
          "and warmed up in %.1f s" % (time.monotonic() - t0), flush=True)
    toks_x, _, _, wall_x = dis_load(
        lambda p, new, tenant: exact.submit(p, max_new=new, tenant=tenant),
        clients)
    toks_r, _, _, _ = dis_load(
        lambda p, new, tenant: ref.submit(p, max_new=new), clients)
    same = sum(toks_x[k] == toks_r[k] for k in toks_r)
    print("12e lossless fleet vs the colocated engine with its replicas' "
          "slots, cache_len and buckets: %d/%d streams equal token for token "
          "(%d tokens in %.3f s through the fleet)" % (
              same, len(toks_r), sum(map(len, toks_x.values())), wall_x),
          flush=True)
    if same != len(toks_r):
        fail("12e: a lossless-fleet stream differs from the colocated one")

    q8 = disagg.disagg_fleet(
        cfg, scope, n_prefill=1, n_decode=1, slots=2, cache_len=GPT_CACHE,
        kv_dtype="int8", wire_dtype="int8", name="gpt-q8",
        request_timeout_s=FLEET_WAIT, warm=True)
    qeng = next(iter(q8._decode.values())).engine
    qpre = next(iter(q8._prefill.values())).engine
    fp32_b = serving.kv_slot_bytes(cfg, GPT_CACHE)
    int8_b = serving.kv_slot_bytes(cfg, GPT_CACHE, "int8")
    slot_ratio = fp32_b / float(int8_b)
    if qeng.slot_bytes() != int8_b or not 3.5 < slot_ratio < 4.0 \
            or qeng._k.dtype != torch.int8:
        fail("12e: int8 slot bytes %d (%s), ratio %.3f" % (
            qeng.slot_bytes(), qeng._k.dtype, slot_ratio))
    prompt = clients[0][0][1]
    want = toks_r[(0, 0)]
    got = q8.generate(prompt, max_new=DIS_LAT_NEW, tenant="latency")
    # an idle int8 engine adopts one int8 handoff (max_new 1: the
    # handoff's own token, no step); slot 0 holds the handoff's payload,
    # within scale/2 per row of the lossless one
    idle8 = serving.DecodeEngine(cfg, scope, slots=2, cache_len=GPT_CACHE,
                                  kv_dtype="int8", role="decode",
                                  name="gpt-q8-idle")
    h32 = qpre.prefill(prompt, wire_dtype="fp32", timeout=FLEET_WAIT)
    h8 = qpre.prefill(prompt, timeout=FLEET_WAIT)
    adopted = idle8.submit_prefilled(h8, max_new=1).result(FLEET_WAIT)
    if adopted != [int(h8.next_token)] or idle8.stats()["steps"] != 0:
        fail("12e: the int8 adoption gave %s after %d steps" % (
            adopted, idle8.stats()["steps"]))
    k8 = idle8._k[0].cpu().numpy()
    s8 = idle8._kscale[0].cpu().numpy()
    k32, _ = h32.dense()
    dev = np.abs(k8.astype(np.float32) * s8 - k32)
    row_ok = bool((dev <= 0.5 * s8 + 1e-7 * np.abs(k32).max()).all())
    print("12e int8 residency [%s]: slot_bytes %d = kv_slot_bytes(cfg, %d, "
          "'int8') (fp32 %d, ratio %.3f); first token %d vs the fp32 "
          "engine's %d; adopted cache payload equal to the handoff's: %s, "
          "max|dequantized - lossless| %.3e, within scale/2 per row: %s" % (
              card, int8_b, GPT_CACHE, fp32_b, slot_ratio, got[0], want[0],
              bool((k8 == h8.k).all()), float(dev.max()), row_ok),
          flush=True)
    if got[0] != want[0] or len(got) != DIS_LAT_NEW or not row_ok \
            or not (k8 == h8.k).all():
        fail("12e: the int8-resident checks failed")
    st0 = q8.stats()
    FaultInjector.install("wire:at=1:corrupt=bitflip")
    try:
        got2 = q8.generate(prompt, max_new=DIS_LAT_NEW, tenant="latency")
    finally:
        FaultInjector.uninstall()
    st1 = q8.stats()
    print("12e corrupted handoff (wire:at=1:corrupt=bitflip) on the int8 "
          "fleet: adopt_errors +%d, migrations +%d, failed_streams %d; "
          "stream of %d tokens equal to the clean run's: %s" % (
              st1["adopt_errors"] - st0.get("adopt_errors", 0),
              st1["migrations"] - st0["migrations"], st1["failed_streams"],
              len(got2), got2 == got), flush=True)
    if st1["failed_streams"] != 0 or st1["migrations"] <= st0["migrations"] \
            or st1["adopt_errors"] - st0.get("adopt_errors", 0) != 1 \
            or len(got2) != DIS_LAT_NEW:
        fail("12e: the corrupted handoff was not re-prefilled cleanly")
    q8.stop(drain=False, timeout=30.0)
    # the int8 step against the fp32 step, 2 slots each, on idle engines
    f32 = serving.DecodeEngine(cfg, scope, slots=2, cache_len=GPT_CACHE,
                               role="decode", name="gpt-f32-idle")
    _, qt = gpt_step_times(idle8, card, tag="12e int8-resident step")
    _, ft = gpt_step_times(f32, card, tag="12e fp32 step")
    stats["int8_step"] = dict(host_ms=qt["step_host_ms"],
                              device_ms=qt["step_device_ms"],
                              fp32_host_ms=ft["step_host_ms"],
                              fp32_device_ms=ft["step_device_ms"])
    idle8.stop(drain=False)
    f32.stop(drain=False)
    del idle8, f32, q8, qeng, qpre

    # -- 12f: the lossless fleet behind the HTTP server
    reg = serving.ModelRegistry()
    reg.publish("gpt", exact)
    srv = serving.ServingServer(reg).start()
    try:
        url = srv.url + "/v1/models/gpt:generate"
        htoks, _, _, done = http_stream(url, {
            "prompt": prompt.tolist(), "max_new_tokens": DIS_LAT_NEW,
            "tenant": "latency", "priority": "interactive"})
        bad, _ = http_post(url, {"prompt": prompt.tolist(),
                                 "max_new_tokens": 2, "priority": "vip"})
        capped, _ = http_post(url, {"prompt": prompt.tolist(),
                                    "max_new_tokens": 2,
                                    "tenant": "capped"})
        for rep in list(exact._prefill.values()) + list(
                exact._decode.values()):
            rep._beat_once()      # beacons carry the load's counters
        _, prom = http_get(srv.url + "/metrics?scope=fleet")
        fams = sorted({ln.split()[2] for ln in prom.splitlines()
                       if ln.startswith("# TYPE paddle_tpu_fleet_")})
        burn = [f for f in fams if f.startswith("paddle_tpu_fleet_slo_burn")]
        tenants_burn = {t for t in ("latency", "bulk")
                        if any(f.endswith("_" + t) for f in burn)}
        print("12f HTTP: :generate (tenant latency, priority interactive) "
              "streamed %d tokens, equal to 12e's: %s (done %s); "
              "priority 'vip' -> %d; tenant 'capped' -> %d; "
              "/metrics?scope=fleet: %d fleet families (replicas %s), "
              "slo burn gauges for %s" % (
                  len(htoks), htoks == want, done.get("finish_reason"),
                  bad, capped, len(fams),
                  prom_value(prom, "paddle_tpu_fleet_replicas"),
                  sorted(tenants_burn)), flush=True)
        if htoks != want or bad != 400 or capped != 429 \
                or "paddle_tpu_fleet_replicas" not in fams \
                or tenants_burn != {"latency", "bulk"}:
            fail("12f: the HTTP statuses or the fleet exposition are off")
    finally:
        srv.stop()
        exact.stop(drain=False, timeout=30.0)
        ref.stop()
    stats.update(wire_bytes=wire_int8, handoff_compression=ratio)
    return launches, stats


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.fluid import lowering
    from paddle_tpu_torch.models import bert, gpt, resnet
    from paddle_tpu_torch.models import transformer_nmt as nmt
    from paddle_tpu_torch.models import wide_deep as wd
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
            # the LayerNorm forward holds its rows in registers: a spill
            # would put them back in memory
            if name == "layer_norm_fwd" and re.search(r"\b[1-9]\d* B spill",
                                                      info):
                fail("layer_norm_fwd %s spills: %s" % (fn, info))
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
        train_launches, train_step, f32_stats = train_phase(
            fluid, bert, ca, cl)
        amp_vs_cpu(fluid, bert)
        dynamic_scaling_checks(fluid, bert)
        amp_launches, amp_step, amp_stats = train_phase(
            fluid, bert, ca, cl, amp=dict(use_bf16=True))

        # phase 7: the ResNet slice. torch's default (cuDNN TF32 on) from
        # here: the port's own runs must turn it off for their f32 convs
        torch.backends.cudnn.allow_tf32 = True
        t7 = time.monotonic()
        main7, io7, scope7, start7, f32_grads, feed7 = resnet_vs_cpu(
            fluid, resnet, lowering)
        amp_resnet_vs_cpu(fluid, resnet, start7, f32_grads, feed7)
        amp_backward_vs_cpu(fluid, resnet, lowering)
        resnet_inference(fluid, main7, io7, scope7)
        del main7, scope7, start7, f32_grads
        bench_step, bench_stats = resnet_bench(fluid, resnet, ca, cl, card)
        secs7 = time.monotonic() - t7
        # phase 8: GPT decode serving at full width (8a, 8b, 8c's timed
        # loads and step times; its profile comes with the others)
        t8 = time.monotonic()
        gcfg = gpt.GPTConfig()
        gscope = gpt_scope(fluid, gpt, gcfg)
        print("8 gpt GPTConfig() initialised on the CPU (startup seed %d) in "
              "%.1f s" % (GPT_SEED, time.monotonic() - t8), flush=True)
        gpt_vs_cpu(fluid, serving, gcfg, gscope)
        gpt_launches, gpt_stats, gpt_step = gpt_serving(
            fluid, serving, ca, cl, gcfg, gscope, card)
        secs8 = time.monotonic() - t8
        # phase 9: Transformer NMT at bench.py's width (9a-9c) and GPT's
        # solo generator on phase 8's weights (9d); 9b's profile comes
        # with the others
        t9 = time.monotonic()
        nmt_vs_cpu(fluid, nmt, ca, cl)
        nmt_launches, nmt_translate, nmt_stats = nmt_bench(
            fluid, nmt, ca, cl, card)
        nmt_bench(fluid, nmt, ca, cl, card, batch=128, iters=NMT_B128_ITERS)
        repair_runs, repair_translate = nmt_repair_ab(fluid, nmt,
                                                      lowering, card)
        nmt_train_launches, _ = nmt_train(fluid, nmt, ca, cl)
        gen_launches = gpt_generate_vs_cpu(fluid, gpt, ca, cl, gcfg, gscope)
        secs9 = time.monotonic() - t9
        # phase 10: Wide&Deep CTR through train_from_dataset (10a-10c; the
        # profile comes with the others)
        t10 = time.monotonic()
        ctr_vs_cpu(fluid, wd, tmp)
        ctr_launches, ctr_epoch, ctr_stats = ctr_bench(fluid, wd, ca, cl,
                                                       card, tmp)
        secs10 = time.monotonic() - t10
        # phase 11: the serving front door (11a-11e) on phase 4's model and
        # phase 8's weights; its loads are timed, so before the profiles
        t11 = time.monotonic()
        analysis_config_phase(fluid, tmp, requests)
        enc_dir = os.path.join(tmp, "bert_encoder_out")
        reg11, srv11, http_reqs, http_replies, predict_launches, \
            predict_stats = http_predict_phase(fluid, serving, ca, cl, bert,
                                               enc_dir, card)
        gpt_eng11, generate_launches, generate_stats = http_generate_phase(
            fluid, serving, ca, cl, gcfg, gscope, gpt_stats["solo"], reg11,
            srv11, card)
        http_cli_phase(enc_dir, http_reqs[0], http_replies[0])
        telemetry_cost(srv11.url + "/v1/models/bert:predict", http_reqs,
                       gpt_eng11, gpt_prompts(gcfg.vocab), gpt_stats["solo"],
                       card)
        srv11.stop(close_registry=True)
        del gpt_eng11, reg11, http_replies
        # launches_http: every kernel's count in 11b's and 11c's timed loads
        http_launches = {n: predict_launches[n] + generate_launches[n]
                         for n in predict_launches}
        print("phase 11 (serving front door: 11a-11e) took %.1f s" % (
            time.monotonic() - t11), flush=True)
        # phase 12: the serving fleet (12a-12c on 11b's model, 12d-12f on
        # phase 8's weights); its loads are timed, so before the profiles
        t12 = time.monotonic()
        fleet_launches, _ = fleet_phase(fluid, serving, ca, cl, bert,
                                        enc_dir, tmp, card)
        t12d = time.monotonic()
        disagg_launches, _ = disagg_phase(fluid, serving, ca, cl, gcfg,
                                          gscope, card, tmp)
        del gscope
        print("phase 12 (serving fleet: 12a-12c %.1f s, 12d-12f %.1f s) "
              "took %.1f s" % (t12d - t12, time.monotonic() - t12d,
                               time.monotonic() - t12), flush=True)
        # profiles last: a torch.profiler session leaves the host slower
        # for the rest of the process, so nothing is timed after one
        forward_breakdown(pred, requests)
        f32_stats.update(profile_train_step(train_step, "train step, f32"))
        amp_stats.update(profile_train_step(amp_step,
                                            "train step, bf16 AMP"))
        # the second profiling session runs on a slower host (see above):
        # the idle share against the unprofiled median step compares them
        for tag, st in (("f32", f32_stats), ("bf16 AMP", amp_stats)):
            print("train step %-8s: median %.3f ms, p90 %.3f ms, %.1f "
                  "tokens/s, peak %.3f GiB; profiled: device busy %.3f ms, "
                  "idle %.1f%% of the profiled wall, %.1f%% of the median "
                  "step, GEMMs %s, dtype conversions %d launches %.3f "
                  "ms" % (
                      tag, st["median_ms"], st["p90_ms"],
                      st["tokens_per_s"], st["peak_gib"], st["busy_ms"],
                      100 * st["idle"],
                      100 * max(0.0, 1 - st["busy_ms"] / st["median_ms"]),
                      ", ".join("%s %.3f ms" % (dt, g["ms"]) for dt, g in
                                sorted(st["gemm"].items())),
                      st["casts"]["launches"], st["casts"]["ms"]),
                  flush=True)
        del pred, train_step, amp_step
        t7 = time.monotonic()
        resnet_profile(bench_step, bench_stats, card)
        del bench_step
        print("phase 7 (ResNet-50: 7a-7e) took %.1f s" % (
            secs7 + time.monotonic() - t7), flush=True)
        t8 = time.monotonic()
        gpt_profile(gpt_step, gpt_stats, card)
        del gpt_step
        print("phase 8 (GPT decode serving: 8a-8c) took %.1f s" % (
            secs8 + time.monotonic() - t8), flush=True)
        t9 = time.monotonic()
        nmt_profile(nmt_translate, nmt_stats, card)
        del nmt_translate
        nmt_copy_launches(repair_translate, card)
        del repair_translate
        print("phase 9 (Transformer NMT and GPT generate: 9a-9d) took %.1f "
              "s" % (secs9 + time.monotonic() - t9), flush=True)
        t10 = time.monotonic()
        ctr_profile(ctr_epoch, ctr_stats, card)
        del ctr_epoch
        print("phase 10 (Wide&Deep CTR: 10a-10c) took %.1f s" % (
            secs10 + time.monotonic() - t10), flush=True)

    times, ln_buckets, floor_ms = kernel_times(ca, cl)
    times.update(bwd_kernel_times(ca, cl))
    nmt_ln = nmt_ln_times(cl)
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
              "layer_norm_fwd": "CUDA cores f32: warp per row read once "
                                "into registers (16-byte loads and stores), "
                                "gamma/beta staged once per block in shared "
                                "memory, ceil(n/SMs) warps per block",
              "flash_attn_bwd_dq": mma_design,
              "flash_attn_bwd_dkdv": mma_design,
              "layer_norm_bwd": "CUDA cores f32, one cooperative launch: "
                                "warp per row held in registers, a partial "
                                "row of dgamma/dbeta per block, then after "
                                "a grid barrier each block sums its slice of "
                                "the columns in a fixed order"}
    # launches: the forward kernels' count is the f32 serving run's (and
    # launches_bf16 the bfloat16 one's), the backward kernels' the training
    # run's; launches_train is every kernel's count in the training run,
    # launches_train_amp in the bf16 AMP training run, launches_decode in
    # phase 8b's GPT decode load, launches_nmt in 9b's 8 translations,
    # launches_nmt_train in 9c's 3 card steps, launches_generate in 9d,
    # launches_ctr in 10b's timed epochs, launches_http in 11b's :predict
    # and 11c's :generate loads, launches_fleet in 12a's routed load and
    # launches_disagg in 12d's disaggregated load, leg (ii)
    record = []
    for name, (src, replaces) in sources.items():
        entry = dict(name=name, route="cuda", source=src, replaces=replaces,
                     launches=launches.get(name, train_launches[name]),
                     max_abs_err=errs[name], dtype="float32",
                     launches_train=train_launches[name],
                     launches_train_amp=amp_launches[name],
                     launches_decode=gpt_launches[name],
                     launches_nmt=nmt_launches[name],
                     launches_nmt_train=nmt_train_launches[name],
                     launches_generate=gen_launches[name],
                     launches_ctr=ctr_launches[name],
                     launches_http=http_launches[name],
                     launches_fleet=fleet_launches[name],
                     launches_disagg=disagg_launches[name],
                     design=design[name])
        # ms, plain_ms, bound_ms, bound_by, library_ms (and library_scope)
        entry.update(times[(name, torch.float32)])
        if name in blaunches:
            entry["launches_bf16"] = blaunches[name]
        entry["bf16"] = times[(name, torch.bfloat16)]
        if name == "layer_norm_fwd":
            # the serving buckets' rows (128·B, 768), f32 and bf16, and the
            # device time of a one-element fill_ on the same card
            entry["buckets"] = [dict(rows=rows, dtype=str(dt)[6:], **r)
                                for (rows, dt), r in sorted(
                                    ln_buckets.items(), key=lambda kv: (
                                        kv[0][1] != torch.float32,
                                        kv[0][0]))]
            entry["launch_floor_ms"] = floor_ms
        if name.startswith("layer_norm"):
            # the NMT path's rows at h = 512, f32
            entry["nmt_shapes"] = [r for r in nmt_ln if r["kernel"] == name]
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
