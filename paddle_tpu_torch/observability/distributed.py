"""Distributed request tracing + fleet metrics federation.

Port of paddle_tpu/observability/distributed.py, unchanged but for the
tolerant JSONL reader, of which it keeps its own copy. The spans, hub and
flight recorder are process-local; serving as a fleet (router, prefill
replicas, decode replicas) has a single ``:generate`` request cross
several processes, and no single artifact shows where its TTFT went.
This module closes that gap in three pieces:

**Trace-context propagation.** :class:`TraceContext` is a
W3C-traceparent-style triple (32-hex ``trace_id``, 16-hex ``span_id``,
sampling bit) injected at the HTTP frontend (``traceparent`` header or
``"trace": true`` in the body), carried through router dispatch, the
``KVHandoff`` wire doc, StoreReplica req-mailboxes, and DecodeEngine
slot state. The sampling bit makes tracing opt-in per request: an
unsampled context costs one attribute store per hop, and the
``PADDLE_TPU_TELEMETRY=off`` path is unchanged.

**Trace export + collection.** Every process appends finished spans as
JSONL under ``$PADDLE_TPU_TRACE_DIR`` (one ``trace-<pid>.jsonl`` per
process). :func:`collect_trace` merges
them into a Perfetto-loadable Chrome trace-event file: one track per
logical process (router / prefill-N / decode-N / worker), flow arrows
(``ph:"s"``/``"f"``) wherever a child span ran on a different track
than its parent (submit -> prefill -> handoff -> adopt -> first token),
and ``predicted_ms`` vs ``measured_ms`` args on spans whose site
attached a cost-model prediction (``analysis/costs.py``), so model
error is visible per request.

**Fleet metrics federation.** Replicas publish
:meth:`Telemetry.federation_doc` snapshots via heartbeat ``extra=``
(in-process) or the elastic FileStore (workers);
:class:`FleetMetrics` merges them — counters sum, gauges keep a
``{replica="..."}`` label, histogram reservoirs/buckets merge — and
renders behind ``/metrics?scope=fleet``. :class:`SLOMonitor` scores
observed TTFT / per-token latencies against ``TenantSpec`` targets and
publishes per-tenant burn-rate gauges (``fleet.slo_burn_*``) the
router can act on.

Stdlib-only at module level (crash-path and bench-supervisor safe).
"""
import json
import os
import threading

from . import telemetry as _t

__all__ = [
    "TraceContext", "TRACE_DIR_ENV", "TRACE_PROC_ENV",
    "TRACE_SAMPLE_ENV", "sample_request",
    "trace_dir", "process_label", "set_process_label",
    "export_span", "read_spans", "chrome_trace", "collect_trace",
    "phase_breakdown", "FleetMetrics", "SLOMonitor",
]

# when set, sampled spans append JSONL records to this directory
TRACE_DIR_ENV = "PADDLE_TPU_TRACE_DIR"
# logical process label for this process's trace track (falls back to
# a label set via set_process_label(), then to "pid<pid>")
TRACE_PROC_ENV = "PADDLE_TPU_TRACE_PROC"
# fraction of frontend requests (without a traceparent of their own)
# to trace, e.g. 1.0 for everything, 0.01 for one in a hundred
TRACE_SAMPLE_ENV = "PADDLE_TPU_TRACE_SAMPLE"

_W3C_VERSION = "00"


class TraceContext:
    """W3C-traceparent-style trace context.

    ``trace_id`` names the whole request timeline (32 hex chars),
    ``span_id`` the span the next hop should parent to (16 hex), and
    ``sampled`` is the per-request opt-in bit. ``parent`` is the local
    parent span id (not propagated on the wire — the receiving side's
    parent IS ``span_id``)."""

    __slots__ = ("trace_id", "span_id", "sampled", "parent")

    def __init__(self, trace_id, span_id, sampled=True, parent=None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)
        self.parent = parent

    @classmethod
    def new(cls, sampled=True):
        return cls(os.urandom(16).hex(), os.urandom(8).hex(), sampled)

    def child(self):
        """A new span id under the same trace, parented to this one."""
        return TraceContext(self.trace_id, os.urandom(8).hex(),
                            self.sampled, parent=self.span_id)

    # -- HTTP header form ------------------------------------------------
    def to_header(self):
        return "%s-%s-%s-%02x" % (_W3C_VERSION, self.trace_id,
                                  self.span_id, 1 if self.sampled else 0)

    @classmethod
    def from_header(cls, header):
        """Parse a ``traceparent`` header; None on anything malformed
        (a bad header must never fail the request)."""
        if not header or not isinstance(header, str):
            return None
        parts = header.strip().split("-")
        if len(parts) != 4:
            return None
        _ver, trace_id, span_id, flags = parts
        if len(trace_id) != 32 or len(span_id) != 16:
            return None
        try:
            int(trace_id, 16), int(span_id, 16)
            sampled = bool(int(flags, 16) & 1)
        except ValueError:
            return None
        return cls(trace_id, span_id, sampled)

    # -- wire-doc form (KVHandoff, StoreReplica mailboxes) --------------
    def to_doc(self):
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "sampled": self.sampled}

    @classmethod
    def from_doc(cls, doc):
        if not isinstance(doc, dict):
            return None
        trace_id = doc.get("trace_id")
        span_id = doc.get("span_id")
        if not trace_id or not span_id:
            return None
        return cls(str(trace_id), str(span_id),
                   bool(doc.get("sampled", True)))

    def __repr__(self):
        return ("TraceContext(%s, %s, sampled=%s)"
                % (self.trace_id[:8], self.span_id[:8], self.sampled))


# -- span export ---------------------------------------------------------

_proc_label = None


def set_process_label(label):
    """Name this process's trace track (e.g. ``decode-1``). Engines
    running in one OS process each pass per-span ``proc=`` fields
    instead; this sets the default for spans that don't."""
    global _proc_label
    _proc_label = str(label) if label else None


def process_label():
    return (os.environ.get(TRACE_PROC_ENV) or _proc_label
            or "pid%d" % os.getpid())


def trace_dir():
    """The live span-export directory, or None (export disabled)."""
    return os.environ.get(TRACE_DIR_ENV) or None


_writer_lock = threading.Lock()
_writer = None  # (dir, pid, open file) — re-opened after fork


def _writer_file(d):
    global _writer
    pid = os.getpid()
    w = _writer
    if w is not None and w[0] == d and w[1] == pid:
        return w[2]
    if w is not None:
        try:
            w[2].close()
        except OSError:
            pass
    try:
        os.makedirs(d, exist_ok=True)
        f = open(os.path.join(d, "trace-%d.jsonl" % pid), "a",
                 encoding="utf-8")
    except OSError:
        _writer = None
        return None
    _writer = (d, pid, f)
    return f


_sample_lock = threading.Lock()
_sample_n = 0


def sample_request():
    """Deterministic stride sampler over ``$PADDLE_TPU_TRACE_SAMPLE``
    (the fraction of frontend requests to trace): returns a fresh
    sampled :class:`TraceContext` for admitted requests, None
    otherwise. Requires a trace dir — sampling with no export sink
    would pay tracing cost for nothing. The stride is deterministic
    (every ``1/rate``-th request), not random, so lanes and tests get
    reproducible trace counts."""
    global _sample_n
    if trace_dir() is None:
        return None
    try:
        rate = float(os.environ.get(TRACE_SAMPLE_ENV) or 0.0)
    except ValueError:
        return None
    if rate <= 0.0:
        return None
    rate = min(rate, 1.0)
    with _sample_lock:
        n = _sample_n
        _sample_n += 1
    if rate < 1.0 and int((n + 1) * rate) == int(n * rate):
        return None
    return TraceContext.new()


def export_span(name, ctx, wall0, dur, fields=None):
    """Append one finished span to this process's JSONL trace file.

    No-op unless ``$PADDLE_TPU_TRACE_DIR`` is set and ``ctx`` is a
    sampled context — callers on hot paths gate on the sampling bit
    before measuring, so the unsampled cost is one ``if``."""
    d = trace_dir()
    if d is None or ctx is None or not ctx.sampled:
        return False
    fields = {k: v for k, v in (fields or {}).items() if v is not None}
    proc = fields.pop("proc", None) or process_label()
    rec = {
        "trace": ctx.trace_id,
        "span": ctx.span_id,
        "parent": ctx.parent,
        "name": name,
        "proc": proc,
        "pid": os.getpid(),
        "tid": threading.current_thread().name,
        "t0": wall0,
        "dur": dur,
    }
    if fields:
        rec["args"] = fields
    line = json.dumps(rec, default=str)
    with _writer_lock:
        f = _writer_file(d)
        if f is None:
            return False
        try:
            f.write(line + "\n")
            f.flush()
        except OSError:
            if _t.mode() != _t.OFF:
                _t.get_telemetry().inc("trace.export_errors")
            return False
    if _t.mode() != _t.OFF:
        _t.get_telemetry().inc("trace.spans_exported")
    return True


# -- collector ------------------------------------------------------------

def _read_jsonl(path):
    """Tolerantly read a JSONL file -> ``(records, dropped)`` (the JAX
    package's ``integrity.jsonl.read_jsonl``): blank lines are skipped
    uncounted, unparseable ones (a torn final line) are skipped and
    counted, and a missing or unreadable file is ``([], 0)``."""
    records, dropped = [], 0
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    dropped += 1
    except OSError:
        return [], 0
    return records, dropped


def read_spans(directory):
    """All span records under `directory` (every ``trace-*.jsonl``),
    skipping unparseable lines via the shared tolerant reader (a
    process killed mid-write leaves a torn tail — that must not sink
    the whole merge; skipped lines bump ``integrity.jsonl_dropped``)."""
    spans = []
    dropped = 0
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return spans
    for fn in names:
        if not (fn.startswith("trace-") and fn.endswith(".jsonl")):
            continue
        records, bad = _read_jsonl(os.path.join(directory, fn))
        dropped += bad
        spans.extend(r for r in records
                     if isinstance(r, dict) and "span" in r)
    if dropped:
        from . import inc as _inc

        _inc("integrity.jsonl_dropped", dropped)
    return spans


def _flow_id(trace, parent, span):
    # stable positive 31-bit id for a parent->child flow binding
    return hash((trace, parent, span)) & 0x7FFFFFFF


def chrome_trace(spans, trace_id=None):
    """Merge span records into a Chrome trace-event document
    (Perfetto-loadable): one synthetic pid per logical process track,
    one tid per thread, ``ph:"X"`` complete events, and ``ph:"s"``/
    ``"f"`` flow arrows wherever a span's parent ran on a different
    track. Spans carrying a ``predicted_s`` arg gain ``predicted_ms``
    vs ``measured_ms`` plus the cost-model error."""
    if trace_id is not None:
        spans = [s for s in spans if s.get("trace") == trace_id]
    spans = sorted(spans, key=lambda s: s.get("t0", 0.0))
    procs, tids = {}, {}
    events = []
    by_span = {}
    for s in spans:
        by_span[s.get("span")] = s

    def _pid(proc):
        if proc not in procs:
            procs[proc] = len(procs) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": procs[proc], "tid": 0,
                           "args": {"name": proc}})
        return procs[proc]

    def _tid(pid, tname):
        key = (pid, tname)
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == pid]) + 1
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": tids[key],
                           "args": {"name": tname}})
        return tids[key]

    flows = 0
    for s in spans:
        proc = str(s.get("proc", "?"))
        pid = _pid(proc)
        tid = _tid(pid, str(s.get("tid", "main")))
        args = dict(s.get("args") or {})
        args["trace_id"] = s.get("trace")
        args["span_id"] = s.get("span")
        pred = args.get("predicted_s")
        if isinstance(pred, (int, float)):
            measured = float(s.get("dur", 0.0))
            args["predicted_ms"] = round(pred * 1e3, 3)
            args["measured_ms"] = round(measured * 1e3, 3)
            if pred > 0:
                args["cost_model_error_pct"] = round(
                    (measured - pred) / pred * 100.0, 1)
        ts = float(s.get("t0", 0.0)) * 1e6
        dur = max(float(s.get("dur", 0.0)) * 1e6, 0.001)
        events.append({"ph": "X", "name": str(s.get("name", "span")),
                       "cat": "span", "pid": pid, "tid": tid,
                       "ts": ts, "dur": dur, "args": args})
        parent = by_span.get(s.get("parent"))
        if parent is not None and parent.get("proc") != s.get("proc"):
            fid = _flow_id(s.get("trace"), parent.get("span"),
                           s.get("span"))
            ppid = _pid(str(parent.get("proc", "?")))
            ptid = _tid(ppid, str(parent.get("tid", "main")))
            pts = (float(parent.get("t0", 0.0))
                   + float(parent.get("dur", 0.0))) * 1e6
            events.append({"ph": "s", "name": "request_flow",
                           "cat": "flow", "id": fid, "pid": ppid,
                           "tid": ptid, "ts": min(pts, ts)})
            events.append({"ph": "f", "bp": "e", "name": "request_flow",
                           "cat": "flow", "id": fid, "pid": pid,
                           "tid": tid, "ts": ts})
            flows += 1
    traces = sorted({s.get("trace") for s in spans if s.get("trace")})
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "spans": len(spans),
            "flows": flows,
            "processes": sorted(procs),
            "traces": traces,
        },
    }


def collect_trace(directory, out=None, trace_id=None):
    """Read every per-process JSONL under `directory`, merge into one
    Chrome trace doc, optionally write it to `out` (atomic)."""
    doc = chrome_trace(read_spans(directory), trace_id=trace_id)
    if out:
        tmp = "%s.tmp.%d" % (out, os.getpid())
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, out)
    return doc


# request phases the bench banks per-phase latency for, in timeline
# order; keys match the span names the serving stack emits
PHASES = ("queue", "prefill", "handoff", "adopt", "decode")


def phase_breakdown(spans, trace_id=None):
    """{phase: {count, total_s, mean_s, max_s}} across span records,
    classifying spans whose name ends with a known phase suffix. The
    bench uses this to bank queue/prefill/handoff/adopt/decode
    latencies instead of only end-to-end TTFT."""
    if trace_id is not None:
        spans = [s for s in spans if s.get("trace") == trace_id]
    acc = {}
    for s in spans:
        name = str(s.get("name", ""))
        leaf = name.rsplit(".", 1)[-1]
        phase = leaf if leaf in PHASES else None
        if phase is None and leaf == "token":
            phase = "decode"
        if phase is None:
            continue
        d = float(s.get("dur", 0.0))
        st = acc.setdefault(phase, {"count": 0, "total_s": 0.0,
                                    "max_s": 0.0})
        st["count"] += 1
        st["total_s"] += d
        if d > st["max_s"]:
            st["max_s"] = d
    for st in acc.values():
        st["mean_s"] = st["total_s"] / st["count"]
    return acc


# -- fleet metrics federation --------------------------------------------

class FleetMetrics:
    """Merge per-replica metric docs into one fleet view.

    Replicas publish ``{"counters": ..., "gauges": ...,
    "histograms": ...}`` docs (:meth:`Telemetry.federation_doc` for
    worker processes; engine ``stats()``-derived docs for in-process
    replicas) on their heartbeat beacons. Merging: counters sum,
    gauges keep a per-replica label, histogram docs merge via
    :meth:`Histogram.from_docs`."""

    def __init__(self):
        self._lock = threading.Lock()
        self._docs = {}  # replica label -> metrics doc

    def ingest(self, replica, doc):
        if not isinstance(doc, dict):
            return
        with self._lock:
            self._docs[str(replica)] = doc

    def ingest_beacons(self, table, key="metrics", prune=True):
        """Pull metric docs off a heartbeat ``table()`` snapshot —
        {worker: beacon} — where each beacon may carry a ``metrics``
        extra field. The table is the authoritative member set: with
        ``prune`` (the default) docs for replicas no longer in it are
        dropped, so removed/parked replicas stop emitting stale
        ``{replica=...}``-labeled gauges on ``/metrics``. A member
        whose beacon carries no metrics doc keeps its last one."""
        table = table or {}
        n = 0
        for worker, beacon in table.items():
            doc = beacon.get(key) if isinstance(beacon, dict) else None
            if doc:
                self.ingest(worker, doc)
                n += 1
        if prune:
            self.prune(table)
        return n

    def prune(self, members):
        """Drop docs whose replica label is not in ``members`` (any
        iterable of labels; matching uses the same ``str()`` form
        :meth:`ingest` stores under). Returns the dropped labels."""
        live = {str(m) for m in members}
        with self._lock:
            stale = [r for r in self._docs if r not in live]
            for r in stale:
                del self._docs[r]
        return stale

    def replicas(self):
        with self._lock:
            return sorted(self._docs)

    def merged(self):
        """One fleet-wide snapshot: summed counters, per-replica
        gauges, merged histogram summaries."""
        with self._lock:
            docs = dict(self._docs)
        counters = {}
        gauges = {}
        hist_docs = {}
        for replica in sorted(docs):
            doc = docs[replica]
            for k, v in (doc.get("counters") or {}).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    counters[k] = counters.get(k, 0) + v
            for k, v in (doc.get("gauges") or {}).items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    gauges.setdefault(k, {})[replica] = v
            for k, v in (doc.get("histograms") or {}).items():
                hist_docs.setdefault(k, []).append(v)
        hists = {k: _t.Histogram.from_docs(v) for k, v in
                 hist_docs.items()}
        return {
            "replicas": sorted(docs),
            "counters": counters,
            "gauges": gauges,
            "histograms": {k: h.summary() for k, h in hists.items()},
            "_hist_objs": hists,
        }

    def counter_totals(self):
        return self.merged()["counters"]

    def render_prom(self, style=None):
        """Prometheus exposition of the merged fleet view. Names are
        prefixed ``fleet.`` so they never collide with the serving
        process's own hub metrics on the same ``/metrics`` page."""
        if style is None:
            style = (os.environ.get(_t.PROM_STYLE_ENV, "")
                     .strip().lower() or "histogram")
        m = self.merged()
        lines = []
        pn = _t._prom_name("fleet.replicas")
        lines.append("# TYPE %s gauge" % pn)
        lines.append("%s %d" % (pn, len(m["replicas"])))
        for name in sorted(m["counters"]):
            pn = _t._prom_name("fleet." + name)
            lines.append("# TYPE %s counter" % pn)
            lines.append("%s %.9g" % (pn, m["counters"][name]))
        for name in sorted(m["gauges"]):
            pn = _t._prom_name("fleet." + name)
            lines.append("# TYPE %s gauge" % pn)
            for replica in sorted(m["gauges"][name]):
                lines.append('%s{replica="%s"} %.9g'
                             % (pn, replica, m["gauges"][name][replica]))
        for name in sorted(m["_hist_objs"]):
            pn = _t._prom_name("fleet." + name)
            hist = m["_hist_objs"][name]
            if style == "summary":
                lines.append("# TYPE %s summary" % pn)
                for q in (0.5, 0.9, 0.99):
                    val = hist.quantile(q)
                    if val is not None:
                        lines.append('%s{quantile="%s"} %.9g'
                                     % (pn, q, val))
            else:
                lines.append("# TYPE %s histogram" % pn)
                cum = 0
                for bound, n in zip(_t.DEFAULT_BUCKETS, hist._buckets):
                    cum += n
                    lines.append('%s_bucket{le="%.12g"} %d'
                                 % (pn, bound, cum))
                lines.append('%s_bucket{le="+Inf"} %d'
                             % (pn, hist.count))
            lines.append("%s_sum %.9g" % (pn, hist.sum))
            lines.append("%s_count %d" % (pn, hist.count))
        return "\n".join(lines) + ("\n" if lines else "")


def replica_metrics_doc(stats, queue_depth=None, extra_gauges=None):
    """Build the per-replica federation doc an in-process replica
    publishes on its beacon: the numeric scalars of ``engine.stats()``
    as counters plus live gauges. (Worker processes publish their
    whole hub via :meth:`Telemetry.federation_doc` instead.)"""
    counters = {}
    for k, v in (stats or {}).items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            continue
        counters[str(k)] = v
    gauges = {}
    if queue_depth is not None:
        gauges["queue_depth"] = queue_depth
    for k, v in (extra_gauges or {}).items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            gauges[str(k)] = v
    return {"counters": counters, "gauges": gauges}


# -- SLO burn rates -------------------------------------------------------

class SLOMonitor:
    """Score observed per-tenant latencies against ``TenantSpec``
    targets and publish burn-rate gauges.

    Burn rate = (fraction of recent observations over the SLO) /
    ``budget`` — the standard error-budget framing: 1.0 means the
    tenant is burning its budget exactly as fast as allowed, >1 means
    the router should start shedding or re-prioritizing. Reads the
    reservoirs of ``serving.disagg.prefill_ttft_seconds.<tenant>`` and
    ``serving.disagg.per_token_seconds.<tenant>`` (or any merged fleet
    histogram handed to :meth:`tick`)."""

    TTFT_METRIC = "serving.disagg.prefill_ttft_seconds"
    PER_TOKEN_METRIC = "serving.disagg.per_token_seconds"

    def __init__(self, tenants, hub=None, budget=0.1):
        self._tenants = tenants
        self._hub = hub or _t.get_telemetry()
        self.budget = float(budget)
        if self.budget <= 0:
            raise ValueError("budget must be positive")

    def _burn(self, values, slo_ms):
        # a tenant with no target (absent/zero/negative SLO) or no
        # traffic this window is not burning budget: 0.0, never a
        # None/NaN that poisons gauges or autopilot thresholds
        if not values or slo_ms is None or slo_ms <= 0:
            return 0.0
        over = sum(1 for v in values if v * 1e3 > slo_ms)
        return (over / len(values)) / self.budget

    def tick(self, reservoirs=None, publish=True):
        """{tenant: {"ttft_burn": x, "per_token_burn": y}} — always
        finite floats; no-target and zero-traffic legs read 0.0.

        ``reservoirs`` optionally maps metric name -> list of observed
        seconds (e.g. from a merged fleet snapshot); by default the
        local hub's reservoirs are read. ``publish=True`` also sets
        ``fleet.slo_burn_ttft.<tenant>`` /
        ``fleet.slo_burn_per_token.<tenant>`` gauges."""
        def _res(name):
            if reservoirs is not None:
                return reservoirs.get(name)
            return self._hub.reservoir(name)

        out = {}
        for spec in self._tenants.specs():
            ttft = self._burn(_res("%s.%s" % (self.TTFT_METRIC,
                                              spec.name)),
                              spec.ttft_slo_ms)
            per_tok = self._burn(_res("%s.%s" % (self.PER_TOKEN_METRIC,
                                                 spec.name)),
                                 spec.per_token_slo_ms)
            out[spec.name] = {"ttft_burn": ttft,
                              "per_token_burn": per_tok}
            if publish and _t.mode() != _t.OFF:
                hub = _t.get_telemetry()
                hub.set_gauge("fleet.slo_burn_ttft.%s" % spec.name,
                              ttft)
                hub.set_gauge(
                    "fleet.slo_burn_per_token.%s" % spec.name,
                    per_tok)
        return out
