"""Serving on one NVIDIA card, this checkout against another, alternating.

    python3 chip_serving_ab.py OTHER_CHECKOUT [--pairs 4] [--loads 3]

Runs ``chip_smoke.py``'s serving phase (BERT-base, seq 128, f32, random
weights from its seed, ``ServingEngine`` with buckets 1/2/4/8) once per
process, in the order other, this, this, other, other, this, ... for
``--pairs`` pairs, so that a drift of the host over the run falls on both
sides alike. Each process builds its checkout's kernels, checks the serving
launch counts as ``chip_smoke.py`` does, then serves ``--loads`` timed
loads of 128 requests from 4 closed-loop clients and times ten batch-8
``Predictor.run`` calls (host wall, the logits copy to the host included),
then ten more split into the host's dispatch of the ops, the wait for the
device after it and the logits' copy to the host.
The other checkout needs the same ``chip_smoke.py`` functions
(``build_bert_base``, ``serving_phase``, ``serve``).

Prints one ``AB {...}`` JSON line per process, then the per-side medians
and ranges, and the card's name and power limit.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def one(tree, loads):
    """One process: the serving phase of the checkout at `tree`."""
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import serving
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.ops import cuda_attention as ca
    from paddle_tpu_torch.ops import cuda_build
    from paddle_tpu_torch.ops import cuda_layernorm as cl

    if not os.path.samefile(os.path.dirname(cs.__file__), tree):
        cs.fail("imported %s, not the checkout %s" % (cs.__file__, tree))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_build.build_all()
    rng = np.random.default_rng(cs.SEED)
    requests = [rng.integers(0, 30522, size=(1, cs.SEQ), dtype=np.int64)
                for _ in range(16)]
    load = [rng.integers(0, 30522, size=(1, cs.SEQ), dtype=np.int64)
            for _ in range(128)]
    res = {"tree": tree, "req_s": [], "p50_ms": [], "p99_ms": []}
    with tempfile.TemporaryDirectory() as tmp:
        cs.build_bert_base(fluid, bert, tmp)
        pred, engine, _, launches = cs.serving_phase(
            fluid, serving, ca, cl, tmp, None, requests)
        res["launches"] = launches
        for _ in range(loads):
            _, lat, wall = cs.serve(engine, load)
            lat_ms = sorted(1e3 * x for x in lat)
            res["req_s"].append(len(load) / wall)
            res["p50_ms"].append(lat_ms[len(lat_ms) // 2])
            res["p99_ms"].append(
                lat_ms[min(len(lat_ms) - 1, int(0.99 * len(lat_ms)))])
        engine.stop()
        feeds = {"input_ids": np.concatenate(requests[:8])}
        pred.run(feeds)
        walls = []
        for _ in range(10):
            t0 = time.monotonic()
            pred.run(feeds)         # returns numpy: waits for the device
            walls.append(1e3 * (time.monotonic() - t0))
        res["forward_ms"] = statistics.median(walls)
        # the same forward in three parts: the host's dispatch of the ops,
        # the wait for the device after it, the logits' copy to the host
        parts = {"dispatch_ms": [], "wait_ms": [], "copy_ms": []}
        for _ in range(10):
            t0 = time.monotonic()
            outs = pred.run(feeds, return_numpy=False)
            t1 = time.monotonic()
            torch.cuda.synchronize()
            t2 = time.monotonic()
            [o.cpu().numpy() for o in outs]
            t3 = time.monotonic()
            for key, a, b in (("dispatch_ms", t0, t1), ("wait_ms", t1, t2),
                              ("copy_ms", t2, t3)):
                parts[key].append(1e3 * (b - a))
        res.update({k: statistics.median(v) for k, v in parts.items()})
    print("AB " + json.dumps(res), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="the checkout to compare this one with")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--loads", type=int, default=3)
    ap.add_argument("--one", action="store_true",
                    help="run one side in this process (internal)")
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    if args.one:
        return one(other, args.loads)
    order = []
    for i in range(args.pairs):
        order += [other, HERE] if i % 2 == 0 else [HERE, other]
    runs = {other: [], HERE: []}
    for tree in order:
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), tree, "--one",
             "--loads", str(args.loads)],
            capture_output=True, text=True, timeout=900)
        sys.stdout.write(r.stdout)
        if r.returncode != 0:
            sys.stdout.write(r.stderr[-4000:])
            print("FAIL: the serving phase of %s exited %d"
                  % (tree, r.returncode), flush=True)
            sys.exit(1)
        runs[tree].append(json.loads(
            [ln for ln in r.stdout.splitlines() if ln.startswith("AB ")][-1][3:]))
    for label, tree in (("other", other), ("this", HERE)):
        per = runs[tree]
        for key in ("req_s", "p50_ms", "p99_ms"):
            vals = [statistics.median(r[key]) for r in per]
            print("%-5s %-8s per process (median of %d loads): %s; median "
                  "%.3f, range %.3f-%.3f" % (
                      label, key, args.loads,
                      " ".join("%.3f" % x for x in vals),
                      statistics.median(vals), min(vals), max(vals)))
        for key in ("forward_ms", "dispatch_ms", "wait_ms", "copy_ms"):
            vals = [r[key] for r in per]
            print("%-5s %-11s (batch 8, host clock): %s; median %.3f" % (
                label, key, " ".join("%.3f" % x for x in vals),
                statistics.median(vals)))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
