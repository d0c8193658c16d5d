"""Multi-tenant admission control for the disaggregated fleet.

Port of paddle_tpu/serving/disagg/tenancy.py, unchanged. The HTTP
frontend validates a ``:generate`` request's ``priority`` with
:func:`resolve_priority`; the fleet that schedules on the tables comes
with ROADMAP.md Queue 1 item 7.3.

A tenant is a traffic class, not a user: "interactive" chat sessions
that buy per-token p99, "batch" summarization that buys throughput.
Each :class:`TenantSpec` carries a **priority class** (0 = most
urgent — orders the prefill queue), **quotas** (max live sessions +
max queued per tenant: one tenant's burst cannot occupy every decode
slot), and **SLO targets** (TTFT for the prefill leg, per-token p99
for the decode leg) that the router scores observed latencies against.

Admission is quota-then-queue: :meth:`TenantTable.acquire` either
claims a live-session token or raises
:class:`~paddle_tpu_torch.serving.engine.ShedError` (HTTP 429 upstream, with
the tenant named so a client tier can steer). Quota rejections are
per-tenant backpressure — the fleet may be idle while one tenant is at
its cap, which is the point.

Telemetry: ``serving.disagg.tenant_live.<tenant>`` gauges,
``serving.disagg.tenant_shed`` / ``tenant_sessions`` counters, and the
per-tenant SLO miss counters the router publishes
(``serving.disagg.slo_miss_ttft`` / ``slo_miss_per_token``).
"""
import threading

from ... import observability as obs
from ..engine import ShedError

__all__ = ["PRIORITY_CLASSES", "TenantSpec", "TenantTable",
           "resolve_priority"]

# named priority classes a request may carry instead of a raw integer
PRIORITY_CLASSES = {"interactive": 0, "standard": 1, "batch": 2}
MAX_PRIORITY = 2


def resolve_priority(priority, default=1):
    """Normalize a request's priority field: None -> the tenant's
    default, a named class -> its rank, an int 0..2 -> itself;
    anything else raises ``ValueError`` (HTTP 400 upstream)."""
    if priority is None:
        return int(default)
    if isinstance(priority, str):
        if priority not in PRIORITY_CLASSES:
            raise ValueError(
                "unknown priority class %r (known: %s)"
                % (priority, sorted(PRIORITY_CLASSES)))
        return PRIORITY_CLASSES[priority]
    if isinstance(priority, bool) or not isinstance(priority, int):
        raise ValueError(
            "priority must be an int 0..%d or one of %s, got %r"
            % (MAX_PRIORITY, sorted(PRIORITY_CLASSES), priority))
    if not 0 <= priority <= MAX_PRIORITY:
        raise ValueError(
            "priority %d out of range 0..%d" % (priority, MAX_PRIORITY))
    return priority


class TenantSpec:
    """One tenant's contract with the fleet."""

    __slots__ = ("name", "priority", "max_live", "max_queued",
                 "ttft_slo_ms", "per_token_slo_ms")

    def __init__(self, name, priority=1, max_live=None, max_queued=None,
                 ttft_slo_ms=None, per_token_slo_ms=None):
        self.name = str(name)
        self.priority = resolve_priority(priority)
        self.max_live = None if max_live is None else int(max_live)
        self.max_queued = None if max_queued is None else int(max_queued)
        self.ttft_slo_ms = (None if ttft_slo_ms is None
                            else float(ttft_slo_ms))
        self.per_token_slo_ms = (None if per_token_slo_ms is None
                                 else float(per_token_slo_ms))


class TenantTable:
    """name -> :class:`TenantSpec` with live-session accounting.

    ``allow_unknown=True`` (the default) folds unlisted tenants into a
    default spec instead of rejecting them — a fleet should degrade an
    anonymous tenant to the standard class, not 403 it."""

    def __init__(self, specs=(), default_spec=None, allow_unknown=True,
                 model="default"):
        self._specs = {s.name: s for s in specs}
        self.default_spec = default_spec or TenantSpec("default")
        self.allow_unknown = bool(allow_unknown)
        self.model = str(model)
        self._lock = threading.Lock()
        self._live = {}
        self._queued = {}
        self._shed = {}

    def specs(self):
        """Every configured spec plus the default (deduped by name) —
        the set the SLO monitor scores burn rates for."""
        out = {self.default_spec.name: self.default_spec}
        out.update(self._specs)
        return list(out.values())

    def resolve(self, tenant):
        """The spec governing `tenant` (None -> the default spec)."""
        if tenant is None:
            return self.default_spec
        tenant = str(tenant)
        spec = self._specs.get(tenant)
        if spec is not None:
            return spec
        if not self.allow_unknown:
            raise ValueError("unknown tenant %r" % tenant)
        return TenantSpec(tenant, priority=self.default_spec.priority,
                          max_live=self.default_spec.max_live,
                          max_queued=self.default_spec.max_queued,
                          ttft_slo_ms=self.default_spec.ttft_slo_ms,
                          per_token_slo_ms=(
                              self.default_spec.per_token_slo_ms))

    def reweight(self, tenant, priority=None, max_live=None,
                 max_queued=None):
        """Admission re-weighting: adjust one tenant's priority class
        and/or quotas in place (None = keep). New requests see the new
        weights immediately — live sessions are untouched. Unlisted
        tenants are materialized from the default spec first, so the
        autopilot can demote an anonymous burst. Returns the updated
        spec."""
        with self._lock:
            spec = self._specs.get(str(tenant))
            if spec is None:
                spec = self.resolve(tenant)
                self._specs[spec.name] = spec
            if priority is not None:
                spec.priority = resolve_priority(
                    min(int(priority), MAX_PRIORITY)
                    if isinstance(priority, int)
                    and not isinstance(priority, bool) else priority)
            if max_live is not None:
                spec.max_live = int(max_live)
            if max_queued is not None:
                spec.max_queued = int(max_queued)
        obs.event("tenant_reweight", source="serving", model=self.model,
                  tenant=spec.name, priority=spec.priority,
                  max_live=spec.max_live, max_queued=spec.max_queued)
        return spec

    # -- quota accounting ------------------------------------------------
    def acquire(self, tenant):
        """Claim one live-session token for `tenant`; raises
        :class:`ShedError` at the quota. Returns the resolved spec."""
        spec = self.resolve(tenant)
        with self._lock:
            live = self._live.get(spec.name, 0)
            if spec.max_live is not None and live >= spec.max_live:
                self._shed[spec.name] = self._shed.get(spec.name, 0) + 1
                shed = self._shed[spec.name]
        if spec.max_live is not None and live >= spec.max_live:
            obs.inc("serving.disagg.tenant_shed")
            obs.event("tenant_shed", source="serving", model=self.model,
                      tenant=spec.name, live=live, quota=spec.max_live,
                      total_shed=shed)
            raise ShedError(
                "tenant %r at its live-session quota (%d) on model %r"
                % (spec.name, spec.max_live, self.model),
                model=self.model)
        with self._lock:
            self._live[spec.name] = self._live.get(spec.name, 0) + 1
            live = self._live[spec.name]
        obs.inc("serving.disagg.tenant_sessions")
        obs.set_gauge("serving.disagg.tenant_live.%s" % spec.name, live)
        return spec

    def release(self, tenant):
        spec = self.resolve(tenant)
        with self._lock:
            live = max(0, self._live.get(spec.name, 0) - 1)
            self._live[spec.name] = live
        obs.set_gauge("serving.disagg.tenant_live.%s" % spec.name, live)

    def live(self, tenant=None):
        with self._lock:
            if tenant is not None:
                return self._live.get(str(tenant), 0)
            return dict(self._live)

    def stats(self):
        with self._lock:
            return {"live": dict(self._live), "shed": dict(self._shed)}
