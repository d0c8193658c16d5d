"""Process-wide telemetry hub: counters, gauges, histograms.

Port of paddle_tpu/observability/telemetry.py, unchanged: the same
environment switches, the same metric names and the same ``paddle_tpu_``
prefix in ``render_prom()``, so a dashboard or a lane that greps a
metric name reads either package.

The hub is the single metrics blackboard every layer of the stack
reports through — the executor's compile-cache hits, the resilience
layer's retries, the elastic fleet's collective waits, the reader's
queue depth. Metric names are dot-separated lowercase paths
(``executor.cache_hit``, ``checkpoint.save_seconds``); ``snapshot()``
returns them as a nested dict and ``render_prom()`` as Prometheus
text exposition (dots become underscores, ``paddle_tpu_`` prefix).

The ``PADDLE_TPU_TELEMETRY`` env switch gates EVERY write:

    off    instrumentation sites are no-ops (one env-flag check, no
           allocation) — cheap enough to leave compiled in
    on     counters/gauges/histograms + flight-recorder events (default)
    trace  additionally records span start/stop events into the flight
           recorder

The switch is read live (one ``os.environ`` lookup per check), so a
test or a calling program can flip it without restarting the process. This
module is stdlib-only — supervisor and crash-path code can import it
without pulling in torch.
"""
import bisect
import collections
import math
import os
import re
import threading

__all__ = [
    "Telemetry", "Histogram", "get_telemetry", "mode", "TELEMETRY_ENV",
    "OFF", "ON", "TRACE", "PROM_STYLE_ENV", "DEFAULT_BUCKETS",
]

TELEMETRY_ENV = "PADDLE_TPU_TELEMETRY"

# ``render_prom`` histogram style: "histogram" (default) emits proper
# Prometheus ``_bucket{le=...}`` exposition; "summary" restores the
# pre-PR-14 quantile lines for lanes/dashboards that grep them
PROM_STYLE_ENV = "PADDLE_TPU_PROM_STYLE"

OFF, ON, TRACE = 0, 1, 2

_OFF_VALUES = frozenset({"off", "0", "false", "no", "none", "disabled"})


# last (raw env value, parsed mode): the env is still read LIVE on
# every call — only the string parse is cached, keyed on the exact raw
# value, so flips (including by monkeypatch) always take effect
_mode_cache = ("", ON)


def mode():
    """Resolve the live telemetry mode from the environment. Unset (and
    any unrecognised value) means ``on``."""
    global _mode_cache
    v = os.environ.get(TELEMETRY_ENV)
    if v is None:
        return ON
    cached = _mode_cache
    if v == cached[0]:
        return cached[1]
    s = v.strip().lower()
    m = OFF if s in _OFF_VALUES else TRACE if s == "trace" else ON
    _mode_cache = (v, m)
    return m


# log-spaced ``le`` bounds tuned for latencies in seconds (0.5 ms to
# 60 s); the final implicit bucket is +Inf. Streaming bucket counts are
# exact (unlike the bounded reservoir) so the Prometheus exposition
# survives arbitrarily long runs.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


class Histogram:
    """Streaming count/sum/min/max plus exact cumulative bucket counts
    (Prometheus ``le`` semantics over :data:`DEFAULT_BUCKETS`) plus a
    bounded reservoir of the most recent observations (deterministic —
    no sampling randomness) for percentile estimates. Memory is bounded
    by ``cap`` regardless of how many values are observed."""

    __slots__ = ("count", "sum", "min", "max", "_reservoir", "_buckets")

    def __init__(self, cap=512):
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._reservoir = collections.deque(maxlen=int(cap))
        # one count per bound in DEFAULT_BUCKETS, plus the +Inf overflow
        self._buckets = [0] * (len(DEFAULT_BUCKETS) + 1)

    def observe(self, value):
        v = float(value)
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        self._reservoir.append(v)
        self._buckets[bisect.bisect_left(DEFAULT_BUCKETS, v)] += 1

    def quantile(self, q):
        vals = sorted(self._reservoir)
        if not vals:
            return None
        idx = min(len(vals) - 1, int(q * len(vals)))
        return vals[idx]

    def summary(self):
        if not self.count:
            return {"count": 0, "sum": 0.0}
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "mean": self.sum / self.count,
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
        }

    # -- federation ------------------------------------------------------
    def export(self, reservoir_cap=64):
        """JSON-safe doc a replica publishes for fleet merging: exact
        count/sum/buckets plus the tail of the reservoir (capped so a
        heartbeat beacon stays small)."""
        tail = list(self._reservoir)
        if reservoir_cap is not None:
            tail = tail[-int(reservoir_cap):]
        doc = {"count": self.count, "sum": self.sum,
               "buckets": list(self._buckets), "reservoir": tail}
        if self.count:
            doc["min"] = self.min
            doc["max"] = self.max
        return doc

    @classmethod
    def from_docs(cls, docs, cap=512):
        """Merge :meth:`export` docs from several replicas into one
        histogram: counts/sums/buckets add, reservoirs concatenate
        (bounded by ``cap``), min/max widen."""
        merged = cls(cap=cap)
        for doc in docs:
            if not doc:
                continue
            merged.count += int(doc.get("count", 0))
            merged.sum += float(doc.get("sum", 0.0))
            mn, mx = doc.get("min"), doc.get("max")
            if mn is not None and mn < merged.min:
                merged.min = mn
            if mx is not None and mx > merged.max:
                merged.max = mx
            for i, n in enumerate(doc.get("buckets", ())):
                if i < len(merged._buckets):
                    merged._buckets[i] += int(n)
            merged._reservoir.extend(doc.get("reservoir", ()))
        return merged


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_]")


def _prom_name(name):
    return "paddle_tpu_" + _PROM_BAD.sub("_", name)


class Telemetry:
    """The hub. Thread-safe; all methods are cheap enough to call from
    hot paths once the mode gate (handled by the package-level helpers
    in ``paddle_tpu_torch.observability``) has passed."""

    def __init__(self, reservoir_cap=512):
        self._lock = threading.Lock()
        self._reservoir_cap = int(reservoir_cap)
        self._counters = collections.Counter()
        self._gauges = {}
        self._hists = {}

    # -- writes ----------------------------------------------------------
    def inc(self, name, n=1):
        with self._lock:
            self._counters[name] += n

    def set_gauge(self, name, value):
        with self._lock:
            self._gauges[name] = float(value)

    def observe(self, name, value):
        with self._lock:
            hist = self._hists.get(name)
            if hist is None:
                hist = self._hists[name] = Histogram(self._reservoir_cap)
            hist.observe(value)

    # -- reads -----------------------------------------------------------
    def counter(self, name):
        with self._lock:
            return self._counters.get(name, 0)

    def gauge(self, name):
        with self._lock:
            return self._gauges.get(name)

    def histogram(self, name):
        """The histogram summary dict for `name`, or None."""
        with self._lock:
            hist = self._hists.get(name)
            return hist.summary() if hist is not None else None

    def reservoir(self, name):
        """The raw reservoir values (most recent observations) for
        `name`, or None. Used by the SLO monitor to score observed
        latencies against tenant targets."""
        with self._lock:
            hist = self._hists.get(name)
            return list(hist._reservoir) if hist is not None else None

    def snapshot(self):
        """Nested dict of everything the hub holds right now."""
        with self._lock:
            return {
                "mode": {OFF: "off", ON: "on", TRACE: "trace"}[mode()],
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    name: hist.summary()
                    for name, hist in self._hists.items()
                },
            }

    def render_prom(self, style=None):
        """Prometheus text exposition. Histograms render as proper
        ``_bucket{le=...}``/``_sum``/``_count`` exposition by default;
        ``style="summary"`` (or ``PADDLE_TPU_PROM_STYLE=summary``)
        restores the pre-PR-14 quantile lines under the same metric
        names for lanes that grep them."""
        if style is None:
            style = (os.environ.get(PROM_STYLE_ENV, "")
                     .strip().lower() or "histogram")
        lines = []
        with self._lock:
            for name in sorted(self._counters):
                pn = _prom_name(name)
                lines.append("# TYPE %s counter" % pn)
                lines.append("%s %d" % (pn, self._counters[name]))
            for name in sorted(self._gauges):
                pn = _prom_name(name)
                lines.append("# TYPE %s gauge" % pn)
                lines.append("%s %.9g" % (pn, self._gauges[name]))
            for name in sorted(self._hists):
                pn = _prom_name(name)
                hist = self._hists[name]
                if style == "summary":
                    lines.append("# TYPE %s summary" % pn)
                    for q in (0.5, 0.9, 0.99):
                        val = hist.quantile(q)
                        if val is not None:
                            lines.append(
                                '%s{quantile="%s"} %.9g' % (pn, q, val))
                else:
                    lines.append("# TYPE %s histogram" % pn)
                    cum = 0
                    for bound, n in zip(DEFAULT_BUCKETS, hist._buckets):
                        cum += n
                        lines.append('%s_bucket{le="%.12g"} %d'
                                     % (pn, bound, cum))
                    lines.append('%s_bucket{le="+Inf"} %d'
                                 % (pn, hist.count))
                lines.append("%s_sum %.9g" % (pn, hist.sum))
                lines.append("%s_count %d" % (pn, hist.count))
        return "\n".join(lines) + ("\n" if lines else "")

    def federation_doc(self, reservoir_cap=64, prefix=None):
        """The per-process payload a replica publishes for fleet
        merging (heartbeat ``extra=`` or the elastic FileStore):
        counters/gauges verbatim, histograms as :meth:`Histogram.export`
        docs. ``prefix`` filters metric names (e.g. ``"serving."``) so
        a beacon stays small."""
        def keep(name):
            return prefix is None or name.startswith(prefix)
        with self._lock:
            return {
                "counters": {k: v for k, v in self._counters.items()
                             if keep(k)},
                "gauges": {k: v for k, v in self._gauges.items()
                           if keep(k)},
                "histograms": {
                    k: h.export(reservoir_cap=reservoir_cap)
                    for k, h in self._hists.items() if keep(k)
                },
            }

    def reset(self):
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()


_hub = Telemetry()


def get_telemetry():
    """The process-wide hub singleton."""
    return _hub
