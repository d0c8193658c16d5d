"""Profiler (ref: python/paddle/fluid/profiler.py); port of
paddle_tpu/fluid/profiler.py, on ``torch.profiler``.

``start_profiler`` / ``stop_profiler`` / ``profiler`` write a Chrome trace
(``<profile_path>/paddle_tpu_torch.<pid>.<n>.pt.trace.json``, readable in
chrome://tracing or Perfetto) of the host's ops and, when the state asks
for the card ("GPU" or "All") and torch sees one, of its kernels and
copies (CUPTI). Trace start and stop land in the telemetry hub
(``paddle_tpu_torch.observability``) as the JAX package's
``profiler.trace_start`` / ``trace_stop`` / ``trace_error`` events and
``profiler.trace_seconds`` histogram.

``profile_op_stats`` runs a program op by op and times each op, as the
JAX package's debug mode does; the port always runs a program that way,
so its table is the step's own split (on the card each op is timed to
its ``torch.cuda.synchronize()``)."""
import contextlib
import os
import tempfile
import time
import warnings

from .. import observability as obs

__all__ = [
    "cuda_profiler", "reset_profiler", "profiler", "start_profiler",
    "stop_profiler", "profile_op_stats",
]

_FALLBACK_DIR = os.path.join(tempfile.gettempdir(),
                             "paddle_tpu_torch_profile")
_DEFAULT_PATH = os.path.join(tempfile.gettempdir(), "profile")

_trace_dir = None
_start_time = None
_session = None
_traces = 0


@contextlib.contextmanager
def cuda_profiler(output_file, output_mode=None, config=None):
    # the card's profiler is torch.profiler's CUPTI tracing here
    with profiler("All", profile_path=output_file):
        yield


def reset_profiler():
    pass


def _activities(state):
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if str(state).upper() in ("GPU", "ALL") and torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def start_profiler(state, tracer_option="Default",
                   profile_path=_DEFAULT_PATH):
    global _trace_dir, _start_time, _session
    import torch.profiler

    # honor the requested path: create it if missing; only an uncreatable
    # path falls back, and says so
    path = str(profile_path) if profile_path else _FALLBACK_DIR
    try:
        os.makedirs(path, exist_ok=True)
    except OSError as e:
        warnings.warn(
            "profiler: cannot create profile_path %r (%s: %s); traces "
            "go to %s" % (path, type(e).__name__, e, _FALLBACK_DIR))
        path = _FALLBACK_DIR
        os.makedirs(path, exist_ok=True)
    try:
        session = torch.profiler.profile(activities=_activities(state))
        session.start()
    except Exception as e:  # noqa: BLE001 — profiling must not kill a run
        # but it must not fail silently either: leave module state
        # consistent (no dir, no start time) and say what happened
        _trace_dir = None
        _start_time = None
        _session = None
        warnings.warn(
            "profiler: torch.profiler start_trace(%r) failed (%s: %s) — "
            "no trace is being recorded" % (path, type(e).__name__, e))
        obs.event("trace_error", source="profiler", path=path,
                  error="%s: %s" % (type(e).__name__, e))
        return
    _session = session
    _trace_dir = path
    _start_time = time.time()
    obs.event("trace_start", source="profiler", path=path)


def stop_profiler(sorted_key=None, profile_path=_DEFAULT_PATH):
    global _trace_dir, _start_time, _session, _traces

    if _trace_dir is not None:
        seconds = time.time() - (_start_time or time.time())
        _traces += 1
        out = os.path.join(_trace_dir, "paddle_tpu_torch.%d.%d.pt.trace.json"
                           % (os.getpid(), _traces))
        try:
            _session.stop()
            _session.export_chrome_trace(out)
        except Exception as e:  # noqa: BLE001 — see start_profiler
            warnings.warn(
                "profiler: torch.profiler stop_trace() failed (%s: %s) — "
                "the trace under %r may be incomplete"
                % (type(e).__name__, e, _trace_dir))
            obs.event("trace_error", source="profiler", path=_trace_dir,
                      error="%s: %s" % (type(e).__name__, e))
        else:
            # the summary line goes through the hub (flight-recorder
            # event + counter + duration histogram), not a bare print
            obs.event("trace_stop", source="profiler", path=_trace_dir,
                      seconds=round(seconds, 4))
            obs.observe("profiler.trace_seconds", seconds)
    _trace_dir = None
    _start_time = None
    _session = None


@contextlib.contextmanager
def profiler(state, sorted_key=None, profile_path=_DEFAULT_PATH,
             tracer_option="Default"):
    start_profiler(state, tracer_option, profile_path)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def profile_op_stats(program=None, feed=None, scope=None, steps=3,
                     warmup=1, sorted_key="total", print_table=True,
                     place=None):
    """Per-op timing table like the reference profiler's summary
    (ref profiler.py stop_profiler sorted_key table / C++ Event stats).

    Runs the global block op by op on `place` (default: the card), from
    the scope's values and `feed`, with autograd as ``Executor.run``
    runs it, and times each op to the end of its work (on the card, to
    a ``torch.cuda.synchronize()`` after it; the syncs make the ops
    slower than in a step, where the host runs ahead of the card). The
    ``backward`` op is timed as the replay of the region before it plus
    ``torch.autograd.grad``, through the lowering's training path.
    Nothing is written back to the scope. Returns {op_type: {calls,
    total, min, max, avg, ratio}} over ``steps`` timed runs."""
    import torch

    from . import core
    from .executor import feed_dtypes, global_scope, to_tensor
    from .framework import default_main_program
    from .lowering import (_run_training, apply_op, f32_precision,
                           persistable_names, run_ops)
    from ..ops.registry import LowerContext

    program = program or default_main_program()
    scope = scope if scope is not None else global_scope()
    place = place if place is not None else core.default_place()
    device = place.torch_device()
    on_card = device.type == "cuda"
    block = program.global_block()
    keep = set(persistable_names(program))
    feed = dict(feed or {})
    want = feed_dtypes(program, list(feed))
    records = {}

    def context(it):
        gen = torch.Generator(device=device)
        gen.manual_seed(7 + it)
        ctx = LowerContext(device, generator=gen, is_test=False,
                           program=program, run_ops=run_ops)
        ctx.keep_names = keep
        return ctx

    for it in range(warmup + steps):
        env = {}
        for v in block.vars.values():
            val = scope.find_value(v.name)
            if val is not None:
                env[v.name] = to_tensor(val, device)
        for name, value in feed.items():
            env[name] = to_tensor(value, device, want[name])
        ctx = context(it)
        env0 = dict(env)
        sums = f32_precision() if on_card else contextlib.nullcontext()
        with torch.no_grad(), sums:
            for tag, op in enumerate(list(block.ops)):
                if on_card:
                    torch.cuda.synchronize(device)
                t0 = time.perf_counter()
                if op.type == "backward":
                    # the symbolic backward op is a whole-region autograd
                    # pass; time it through the training path (its true
                    # cost is the replay plus torch.autograd.grad)
                    out_env = _run_training(list(block.ops[: tag + 1]),
                                            dict(env0), context(it))
                    for gn in op.output("Grads"):
                        env[gn] = out_env[gn]
                else:
                    apply_op(op, env, ctx)
                if on_card:
                    torch.cuda.synchronize(device)
                dt = time.perf_counter() - t0
                if it >= warmup:
                    rec = records.setdefault(op.type, [0, 0.0, float("inf"),
                                                      0.0])
                    rec[0] += 1
                    rec[1] += dt
                    rec[2] = min(rec[2], dt)
                    rec[3] = max(rec[3], dt)

    grand = sum(r[1] for r in records.values()) or 1.0
    stats = {
        t: {"calls": r[0], "total": r[1], "min": r[2], "max": r[3],
            "avg": r[1] / r[0], "ratio": r[1] / grand}
        for t, r in records.items()
    }
    if print_table:
        key = {"total": "total", "calls": "calls", "max": "max",
               "min": "min", "ave": "avg", "avg": "avg"}.get(
            sorted_key or "total", "total")
        rows = sorted(stats.items(), key=lambda kv: -kv[1][key])
        print("%-28s %7s %12s %10s %10s %10s %8s"
              % ("Event", "Calls", "Total(ms)", "Min(ms)", "Max(ms)",
                 "Ave(ms)", "Ratio"))
        for t, s in rows:
            print("%-28s %7d %12.3f %10.3f %10.3f %10.3f %7.2f%%"
                  % (t, s["calls"], 1e3 * s["total"], 1e3 * s["min"],
                     1e3 * s["max"], 1e3 * s["avg"], 100 * s["ratio"]))
        print("NOTE: each op timed alone (on the card to a synchronize "
              "after it); a step, whose host runs ahead of the card, is "
              "faster. Use profiler() for the kernels' trace.")
    return stats
