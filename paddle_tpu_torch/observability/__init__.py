"""paddle_tpu_torch.observability — unified telemetry hub + flight recorder.

Port of paddle_tpu/observability (the hub, spans, flight recorder and
distributed tracing). One import point for every instrumented layer::

    from paddle_tpu_torch import observability as obs

    obs.inc("serving.shed")
    obs.observe("serving.request_seconds", dt)
    obs.set_gauge("serving.queue_depth.bert", q.qsize())
    obs.event("shed", source="serving", model="bert")
    with obs.span("decode.prefill"):
        ...

Every helper here is gated on the live ``PADDLE_TPU_TELEMETRY`` mode
(``off`` | ``on`` | ``trace``): with ``off`` each call is a single
env-flag check and an early return — no allocation, no lock — so the
instrumentation stays in the hot paths permanently. The switches, metric
names and Prometheus names (``paddle_tpu_`` prefix) are the JAX
package's, so one dashboard reads either.

Read side: ``snapshot()`` (nested dict), ``render_prom()`` (Prometheus
text), single-metric probes ``counter(name)`` / ``gauge(name)`` /
``histogram(name)``, ``get_recorder().dump_jsonl(path)`` (the event
ring), and crash dumps written automatically on uncaught exceptions
(see ``recorder.install_excepthook``). ``reset()`` clears the hub AND
the ring — tests use it to scope assertions to a scripted session.

Well-known serving metrics (``serving.engine``):

- ``serving.queue_wait_seconds`` / ``serving.batch_size`` /
  ``serving.batch_rows`` / ``serving.padding_waste`` /
  ``serving.request_seconds`` histograms — per coalesced micro-batch
  and per request through the ServingEngine.
- ``serving.queue_depth.<model>`` gauge; flight-recorder events (source
  ``serving``) ``shed`` and ``deadline_miss`` (counted as
  ``serving.shed`` / ``serving.deadline_miss``), ``batch_error``,
  ``warmup`` and ``engine_stop``.

Well-known decode-serving metrics (``serving.decode``):

- ``serving.decode.slot_utilization.<engine>`` gauge — live slots /
  total slots after each dispatch iteration;
  ``serving.decode.cache_occupancy.<engine>`` gauge — filled KV rows /
  (slots × cache_len).
- ``serving.decode.prefill_seconds`` / ``step_seconds`` /
  ``ttft_seconds`` / ``request_seconds`` histograms.
- ``serving.decode.tokens`` / ``requests`` / ``prefills`` / ``steps``
  / ``retired`` / ``shed`` / ``deadline_miss`` / ``cancelled``
  counters — every lifecycle edge ``stats()`` reports, mirrored into
  the hub; rejects, retires and client disconnects also land in the
  flight recorder with ``engine="decode"``.

Well-known HTTP and registry events (``serving.http`` /
``serving.registry``): ``http_start``, ``client_disconnect``,
``model_load``, ``model_load_failed``, ``model_publish`` and
``model_unload`` (source ``serving``).

Well-known feed and dispatch metrics (``fluid.executor``,
``fluid.async_pipeline``, ``fluid.layers.io``, ``fluid.profiler``):

- ``span.executor.run.seconds`` / ``span.executor.feed_convert.seconds``
  histograms — every ``Executor.run`` and its feed conversion;
  ``span.executor.stage_feed.seconds`` / ``span.reader.stage_feed.seconds``
  time the staging threads of ``run_pipelined`` and of a py_reader's
  ``prefetch_to_device``.
- ``executor.overlap_ratio`` gauge — the share of staging seconds that
  ran while a step was in flight; ``staging_discard`` event (source
  ``executor``) when ``close()`` drops staged batches.
- ``reader.queue_depth`` gauge and ``reader.pop_wait_seconds``
  histogram — a py_reader's queue before each pop, and the pop's wait.
- ``profiler.trace_start`` / ``trace_stop`` / ``trace_error`` events and
  the ``profiler.trace_seconds`` histogram.

Well-known distributed-tracing metrics (``observability.distributed``):

- ``trace.spans_exported`` / ``trace.export_errors`` counters — JSONL
  span records appended to ``$PADDLE_TPU_TRACE_DIR`` (one
  ``trace-<pid>.jsonl`` per process; :func:`collect_trace` merges them
  into a Chrome trace). Tracing is opt-in per request via the
  ``TraceContext.sampled`` bit (a ``traceparent`` header or
  ``"trace": true`` in a ``:generate`` body); unsampled requests skip
  every export site. Spans exported: ``http.predict`` /
  ``http.generate``, ``serving.predict``, ``decode.queue`` /
  ``decode.prefill`` / ``decode.token`` / ``decode.stream``.
- ``fleet.*`` families and ``fleet.slo_burn_*`` gauges —
  :class:`FleetMetrics` and :class:`SLOMonitor`, fed from the fleet's
  heartbeat beacons (``DisaggRouter.fleet_metrics`` /
  ``fleet_render_prom``, served at ``/metrics?scope=fleet``).

Not ported yet (ROADMAP.md Queue 1 item 11): the executable ledger
(``ledger``), the drift table (``perf``), run health (``runhealth``) and
the ``python -m ... observability`` CLI. This facade imports none of
them, and the crash dump keeps their keys empty.

This package is stdlib-only (no torch/numpy imports at module level),
so crash-path and supervisor code can use it without device init.
"""
from . import recorder as _recorder
from . import telemetry as _telemetry
from .distributed import (  # noqa: F401
    TRACE_DIR_ENV, TRACE_PROC_ENV, TRACE_SAMPLE_ENV, FleetMetrics,
    SLOMonitor, TraceContext, chrome_trace, collect_trace, export_span,
    phase_breakdown, process_label, read_spans, replica_metrics_doc,
    sample_request, set_process_label, trace_dir,
)
from .recorder import (  # noqa: F401
    CRASH_DUMP_ENV, FlightRecorder, crash_dump_path, get_recorder,
    install_excepthook,
)
from .telemetry import (  # noqa: F401
    OFF, ON, TRACE, TELEMETRY_ENV, PROM_STYLE_ENV, Histogram,
    Telemetry, get_telemetry, mode,
)
from .tracing import active_spans, current_span, span  # noqa: F401

__all__ = [
    "Telemetry", "Histogram", "FlightRecorder", "get_telemetry",
    "get_recorder", "span", "active_spans", "current_span", "mode",
    "enabled", "trace_enabled", "inc", "observe", "set_gauge", "event",
    "counter", "gauge", "histogram",
    "snapshot", "render_prom", "reset", "install_excepthook",
    "crash_dump_path", "TELEMETRY_ENV", "CRASH_DUMP_ENV",
    "OFF", "ON", "TRACE",
    "TraceContext", "TRACE_DIR_ENV", "TRACE_PROC_ENV",
    "TRACE_SAMPLE_ENV", "trace_dir", "sample_request",
    "process_label", "set_process_label", "export_span", "read_spans",
    "chrome_trace", "collect_trace", "phase_breakdown", "FleetMetrics",
    "SLOMonitor", "replica_metrics_doc", "PROM_STYLE_ENV",
]


def enabled():
    """True unless PADDLE_TPU_TELEMETRY=off."""
    return _telemetry.mode() != OFF


def trace_enabled():
    """True only in PADDLE_TPU_TELEMETRY=trace mode."""
    return _telemetry.mode() == TRACE


# -- mode-gated write helpers (the instrumentation surface) ----------------

def inc(name, n=1):
    if _telemetry.mode() == OFF:
        return
    _telemetry._hub.inc(name, n)


def observe(name, value):
    if _telemetry.mode() == OFF:
        return
    _telemetry._hub.observe(name, value)


def set_gauge(name, value):
    if _telemetry.mode() == OFF:
        return
    _telemetry._hub.set_gauge(name, value)


def event(kind, source=None, recorder=None, count=True, **fields):
    """Record a structured event into `recorder` (the global flight
    recorder when None) and bump the ``<source>.<kind>`` counter."""
    if _telemetry.mode() == OFF:
        return None
    if count:
        _telemetry._hub.inc(
            "%s.%s" % (source, kind) if source else kind)
    rec = recorder if recorder is not None else _recorder._global
    if source is not None:
        fields.setdefault("source", source)
    return rec.record(kind, **fields)


# -- read side --------------------------------------------------------------

def counter(name):
    """Current value of one counter (0 when never bumped)."""
    return _telemetry._hub.counter(name)


def gauge(name):
    """Current value of one gauge, or None when never set."""
    return _telemetry._hub.gauge(name)


def histogram(name):
    """Summary dict of one histogram, or None when never observed."""
    return _telemetry._hub.histogram(name)


def snapshot():
    return _telemetry._hub.snapshot()


def render_prom(style=None):
    return _telemetry._hub.render_prom(style=style)


def reset():
    """Clear the hub and the global event ring (testing / session
    scoping). Does not uninstall the excepthook."""
    _telemetry._hub.reset()
    _recorder._global.clear()
