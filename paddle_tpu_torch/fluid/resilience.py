"""Fault injection for the serving fleet (port of the fault-injection half
of paddle_tpu/fluid/resilience.py).

- **FaultInjector** — deterministic, env-driven fault injection
  (``PADDLE_TPU_FAULT_SPEC``) at named runtime sites, so every recovery
  path of the fleet is testable without flaky sleeps or monkeypatching.
- **EventLog** — the bounded structured event log the heartbeat monitor
  emits into, routed through :mod:`paddle_tpu_torch.observability`.

Fault spec grammar (clauses joined by ``;`` or ``,``), the JAX package's::

    PADDLE_TPU_FAULT_SPEC="replica:at=1:RuntimeError;wire:at=1:corrupt=bitflip"

    clause   := site ":" trigger ":" action
    site     := "run" | "feed" | "save" | "fetch"
              | "collective" | "barrier" | "heartbeat"
              | "dispatch" | "replica"
              | "load" | "wire" | "mailbox"
    trigger  := "every=" N | "at=" N      (N counts checks at that site,
                                           1-based)
    action   := exception class name (builtins), "nan" (site "fetch"
                only), "slow" (sleep PADDLE_TPU_FAULT_SLOW_S seconds,
                default 0.25), "slow=" SECONDS (per-clause duration), or
                "corrupt=" MODE ("bitflip" | "truncate" | "torn", sites
                "save" | "load" | "wire" | "mailbox" only)

The sites the port fires today: ``run`` at the top of ``Executor.run``
(before a reader pop, so an injected fault consumes no batch), ``feed``
in a started py_reader's pop (``fluid/layers/io.py``), ``heartbeat`` in
the beacon writer (``parallel/elastic.py``), ``dispatch`` in the serving
router's per-attempt dispatch and in the decode engine's step,
``replica`` in a local replica's admission (``serving/router.py``),
``wire`` in the KV handoff encoder (``serving/disagg/kv_wire.py``),
``mailbox`` in the FileStore writer, ``collective`` in the collective
op lowerings (``ops/collective_ops.py``) and each gradient sync's
dispatch (``parallel/comms/grad_sync.py``), and ``barrier`` in the
``barrier`` op and ``Fleet.barrier_worker``. ``save`` and ``fetch``
parse but fire nowhere yet (they come with guarded training, item 11).

Collective deadlines, as the JAX package has them:
``collective_deadline(seconds)`` arms a wall-clock deadline on this
thread, and :func:`collective_check` — one call per collective entry
point — raises :class:`CollectiveTimeoutError` once it has expired, so
no new collective is issued after a peer is presumed lost.

With the env var unset and no injector installed, the hooks are inert
(one dict lookup per site check).

Not ported yet, each raising ``NotImplementedError`` that names ROADMAP.md
Queue 1 item 11: ``GuardedExecutor``, ``TrainGuard`` and ``run_guarded``
(guarded training: retry, watchdog, non-finite skip, auto-checkpoint).
The typed step errors come with them.
"""
import collections
import os
import re
import threading
import time

import numpy as np

from .. import observability as obs

__all__ = [
    "FaultInjector", "FaultSpecError", "GuardedExecutor", "TrainGuard",
    "EventLog", "fault_check", "run_guarded", "fault_corrupt",
    "fault_corrupt_mode", "corrupt_bytes", "corrupt_array",
    "CollectiveTimeoutError", "collective_deadline", "collective_check",
    "deadline_remaining",
]

FAULT_SPEC_ENV = "PADDLE_TPU_FAULT_SPEC"


class FaultSpecError(ValueError):
    """Malformed PADDLE_TPU_FAULT_SPEC."""


class CollectiveTimeoutError(RuntimeError):
    """A collective/barrier path exceeded its deadline. Never retried
    blindly: the peer that missed the rendezvous may be dead, and
    re-entering the same collective would hang again — the caller must
    first re-establish fleet membership."""


# ---------------------------------------------------------------------------
# collective deadlines
# ---------------------------------------------------------------------------
#
# A hung peer turns every collective into an infinite wait. The deadline
# is carried in a thread-local so each worker thread or rank process
# scopes its own budget; it is checked before each collective is issued
# (ops/collective_ops.py, the gradient sync, Fleet.barrier_worker). Once
# a collective is in flight only the backend's own timeout can end it,
# so the guarantee is "no new collective is issued after expiry".

_deadline_tls = threading.local()


class collective_deadline:
    """Context manager arming a wall-clock deadline (seconds) for every
    collective/barrier check on this thread. Nesting keeps the TIGHTER
    (earlier) deadline. ``seconds=None`` is a no-op context."""

    def __init__(self, seconds):
        self._seconds = seconds
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_deadline_tls, "at", None)
        if self._seconds is not None:
            at = time.monotonic() + float(self._seconds)
            if self._prev is not None:
                at = min(at, self._prev)
            _deadline_tls.at = at
        return self

    def __exit__(self, *exc):
        _deadline_tls.at = self._prev
        return False


def deadline_remaining():
    """Seconds left on this thread's collective deadline, or None when
    no deadline is armed. Never negative (expired == 0.0)."""
    at = getattr(_deadline_tls, "at", None)
    if at is None:
        return None
    return max(0.0, at - time.monotonic())


def collective_check(what, site="collective"):
    """One guard call per collective entry point: counts a fault-spec
    check at `site` (raising any injected fault) and raises
    :class:`CollectiveTimeoutError` when this thread's armed deadline
    has expired. `what` names the op/path for the error message."""
    fault_check(site)
    remaining = deadline_remaining()
    if remaining is not None and remaining <= 0.0:
        raise CollectiveTimeoutError(
            "collective deadline expired before %s could be issued "
            "(a peer is presumed hung/dead; re-establish fleet "
            "membership before retrying)" % (what,)
        )


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------

_NAN_ACTION = "nan"
_SLOW_ACTION = "slow"
_SLOW_S_ENV = "PADDLE_TPU_FAULT_SLOW_S"
_CORRUPT_ACTION = "corrupt"
CORRUPT_MODES = frozenset({"bitflip", "truncate", "torn"})
CORRUPT_SITES = frozenset({"save", "load", "wire", "mailbox"})


def _slow_seconds():
    try:
        return max(0.0, float(os.environ.get(_SLOW_S_ENV, 0.25)))
    except (TypeError, ValueError):
        return 0.25


_CLAUSE_RE = re.compile(
    r"^(?P<site>[a-z_]+):(?P<mode>every|at)=(?P<n>\d+)"
    r":(?P<action>\w+)(?:=(?P<arg>[A-Za-z0-9.]+))?$"
)


class _Clause:
    __slots__ = ("site", "mode", "n", "action_name", "exc", "slow_s",
                 "corrupt_mode", "checks", "fires")

    def __init__(self, site, mode, n, action_name, exc, slow_s=None,
                 corrupt_mode=None):
        self.site = site
        self.mode = mode
        self.n = n
        self.action_name = action_name
        self.exc = exc  # exception class, or None for the "nan" action
        self.slow_s = slow_s  # per-clause 'slow' duration override
        self.corrupt_mode = corrupt_mode  # bitflip | truncate | torn
        self.checks = 0
        self.fires = 0

    def poke(self):
        """Count one check at this clause's site; True when it fires."""
        self.checks += 1
        if self.mode == "every":
            hit = self.checks % self.n == 0
        else:
            hit = self.checks == self.n
        if hit:
            self.fires += 1
        return hit


def _resolve_exception(name):
    import builtins

    exc = getattr(builtins, name, None)
    if isinstance(exc, type) and issubclass(exc, BaseException):
        return exc
    raise FaultSpecError(
        "unknown fault action %r (want a builtin exception name, "
        "'slow', or 'nan' for the fetch site; the reader's "
        "EOFException comes with ROADMAP.md Queue 1 item 11)" % name
    )


class FaultInjector:
    """Deterministic fault injection at named runtime sites.

    Activated either programmatically (``FaultInjector.install(spec)``,
    paired with ``uninstall()``) or by setting ``PADDLE_TPU_FAULT_SPEC``
    in the environment. Each site check increments per-clause counters,
    so ``every=N`` fires on the Nth, 2Nth, ... check and ``at=N`` fires
    exactly once. Counters live on the injector instance: reinstalling
    (or changing the env spec) starts fresh.
    """

    SITES = frozenset({"run", "feed", "save", "fetch",
                       "collective", "barrier", "heartbeat",
                       "dispatch", "replica",
                       "load", "wire", "mailbox"})

    _installed = None   # programmatic injector, wins over the env var
    _env_cached = None  # injector parsed from the env spec, counters live

    def __init__(self, spec):
        self.spec = spec
        self.clauses = []
        by_site = collections.defaultdict(list)
        for raw in re.split(r"[;,]", spec):
            raw = raw.strip()
            if not raw:
                continue
            m = _CLAUSE_RE.match(raw)
            if m is None:
                raise FaultSpecError(
                    "bad fault clause %r (want site:every=N:Action or "
                    "site:at=N:Action)" % raw
                )
            site, mode, n, action, arg = (
                m.group("site"), m.group("mode"), int(m.group("n")),
                m.group("action"), m.group("arg"),
            )
            if site not in self.SITES:
                raise FaultSpecError(
                    "unknown fault site %r (known: %s)"
                    % (site, ", ".join(sorted(self.SITES)))
                )
            if n <= 0:
                raise FaultSpecError("fault trigger count must be >= 1")
            if arg is not None and action not in (_SLOW_ACTION,
                                                  _CORRUPT_ACTION):
                raise FaultSpecError(
                    "action argument %r only applies to 'slow' "
                    "(slow=SECONDS) or 'corrupt' (corrupt=MODE), "
                    "not %r" % (arg, action))
            slow_s = None
            corrupt_mode = None
            if action == _NAN_ACTION:
                if site != "fetch":
                    raise FaultSpecError(
                        "action 'nan' only applies to site 'fetch'")
                exc = None
            elif action == _SLOW_ACTION:
                exc = None  # sleeps instead of raising (straggler drill)
                if arg is not None:
                    try:
                        slow_s = float(arg)
                    except ValueError:
                        raise FaultSpecError(
                            "bad slow duration %r (want seconds, e.g. "
                            "dispatch:every=1:slow=0.05)" % arg)
                    if slow_s < 0:
                        raise FaultSpecError(
                            "slow duration must be >= 0, got %r" % arg)
            elif action == _CORRUPT_ACTION:
                exc = None  # mutates payload bytes instead of raising
                if site not in CORRUPT_SITES:
                    raise FaultSpecError(
                        "action 'corrupt' only applies to byte-path "
                        "sites (%s), not %r"
                        % (", ".join(sorted(CORRUPT_SITES)), site))
                if arg is None:
                    raise FaultSpecError(
                        "action 'corrupt' needs a mode "
                        "(corrupt=bitflip|truncate|torn)")
                if arg not in CORRUPT_MODES:
                    raise FaultSpecError(
                        "bad corrupt mode %r (want %s)"
                        % (arg, "|".join(sorted(CORRUPT_MODES))))
                corrupt_mode = arg
            else:
                exc = _resolve_exception(action)
            clause = _Clause(site, mode, n, action, exc, slow_s=slow_s,
                             corrupt_mode=corrupt_mode)
            self.clauses.append(clause)
            by_site[site].append(clause)
        if not self.clauses:
            raise FaultSpecError("empty fault spec %r" % spec)
        self._by_site = dict(by_site)

    # -- activation ------------------------------------------------------
    @classmethod
    def install(cls, spec):
        """Activate programmatically (tests); returns the injector."""
        inj = cls(spec) if isinstance(spec, str) else spec
        cls._installed = inj
        return inj

    @classmethod
    def uninstall(cls):
        cls._installed = None
        cls._env_cached = None

    @classmethod
    def active(cls):
        """The live injector, or None. Env activation caches per spec
        string so clause counters persist across checks."""
        if cls._installed is not None:
            return cls._installed
        spec = os.environ.get(FAULT_SPEC_ENV)
        if not spec:
            return None
        if cls._env_cached is None or cls._env_cached.spec != spec:
            cls._env_cached = cls(spec)
        return cls._env_cached

    # -- firing ----------------------------------------------------------
    def check(self, site):
        """Count a check at `site`; raise the first triggered exception
        clause, or return True if a 'nan' clause fired. A triggered
        'slow' clause sleeps in place — its per-clause ``slow=SECONDS``
        duration when given, else PADDLE_TPU_FAULT_SLOW_S — so the
        checked path stalls but survives."""
        nan_fired = False
        fire = None
        for clause in self._by_site.get(site, ()):
            if clause.action_name == _CORRUPT_ACTION:
                # corrupt clauses fire only where payload bytes flow
                # (fault_corrupt); counting them here would skew their
                # trigger schedule against the byte-path call sites.
                continue
            if clause.poke():
                if clause.action_name == _SLOW_ACTION:
                    time.sleep(clause.slow_s
                               if clause.slow_s is not None
                               else _slow_seconds())
                elif clause.exc is None:
                    nan_fired = True
                elif fire is None:
                    fire = clause
        if fire is not None:
            raise fire.exc(
                "injected fault: site=%s check=%d spec=%r"
                % (site, fire.checks, self.spec)
            )
        return nan_fired

    def corrupt_mode(self, site):
        """Count a byte-path check at `site`; the fired corrupt
        clause's mode ('bitflip' | 'truncate' | 'torn'), or None."""
        mode = None
        for clause in self._by_site.get(site, ()):
            if clause.action_name != _CORRUPT_ACTION:
                continue
            if clause.poke() and mode is None:
                mode = clause.corrupt_mode
        if mode is not None:
            obs.inc("integrity.fault_corrupt_fired")
            obs.event("fault_corrupt", source="resilience",
                      site=site, mode=mode)
        return mode

    def stats(self):
        """Per-clause counters for assertions/observability."""
        return [
            {"site": c.site, "mode": c.mode, "n": c.n,
             "action": c.action_name, "checks": c.checks, "fires": c.fires}
            for c in self.clauses
        ]


def fault_check(site):
    """Hook called from instrumented sites (the router's dispatch, a
    replica's admission, the beacon writer, the decode step). No-op
    unless an injector is active."""
    inj = FaultInjector.active()
    if inj is not None:
        inj.check(site)


def fault_corrupt_mode(site):
    """The corrupt mode fired at a byte-path `site` this check, or
    None. Callers with non-bytes payloads (in-memory KV handoffs) use
    this with :func:`corrupt_array`; byte writers use
    :func:`fault_corrupt` directly."""
    inj = FaultInjector.active()
    if inj is None:
        return None
    return inj.corrupt_mode(site)


def corrupt_bytes(mode, data):
    """Deterministically corrupt a bytes payload: 'bitflip' flips one
    bit in the middle byte, 'truncate' keeps only the first half,
    'torn' drops a short tail (a partially flushed write)."""
    data = bytes(data)
    if not data:
        return data
    if mode == "bitflip":
        buf = bytearray(data)
        buf[len(buf) // 2] ^= 0x01
        return bytes(buf)
    if mode == "truncate":
        return data[:len(data) // 2]
    if mode == "torn":
        return data[:len(data) - max(1, len(data) // 8)]
    raise ValueError("unknown corrupt mode %r" % (mode,))


def corrupt_array(mode, arr):
    """Shape-preserving array corruption for in-memory transports
    (the object must stay well-formed; the content digest still
    catches it): 'bitflip' flips one bit, 'truncate' zeroes the
    second half of the flattened payload, 'torn' zeroes a short
    tail."""
    a = np.array(np.asarray(arr), copy=True)
    if a.size == 0:
        return a
    raw = bytearray(a.tobytes())
    if mode == "bitflip":
        raw[len(raw) // 2] ^= 0x01
    elif mode == "truncate":
        half = len(raw) // 2
        raw[half:] = b"\x00" * (len(raw) - half)
    elif mode == "torn":
        tail = max(1, len(raw) // 8)
        raw[len(raw) - tail:] = b"\x00" * tail
    else:
        raise ValueError("unknown corrupt mode %r" % (mode,))
    return np.frombuffer(bytes(raw), a.dtype).reshape(a.shape)


def fault_corrupt(site, data):
    """Route a bytes payload through any armed corrupt clause at
    `site`; returns the (possibly corrupted) bytes. Inert without an
    injector — one dict lookup like every other site hook."""
    mode = fault_corrupt_mode(site)
    if mode is None:
        return data
    return corrupt_bytes(mode, data)


# ---------------------------------------------------------------------------
# event log
# ---------------------------------------------------------------------------


class EventLog:
    """Bounded structured event log + per-kind counters. Events are
    plain dicts with a 'kind' key; an optional sink callback sees each
    event as it is emitted (wire it to print/logging).

    Every emit also routes through the process-wide telemetry hub
    (``paddle_tpu_torch.observability``): the event lands in the flight
    recorder (`recorder`, the global ring when None — so resilience,
    fleet, and executor streams interleave in ONE monotonic-ordered
    JSONL dump) and bumps the ``<source>.<kind>`` counter. With
    ``PADDLE_TPU_TELEMETRY=off`` the routing is a no-op and only the
    local deque/counters fill. Pass ``_forward=False`` when re-emitting
    an event that already went through the hub at its origin (e.g. a
    GuardedExecutor retry relayed into a TrainGuard's log) so nothing
    double-counts."""

    def __init__(self, maxlen=10000, sink=None, recorder=None,
                 source=None):
        self.events = collections.deque(maxlen=maxlen)
        self.counters = collections.Counter()
        self._sink = sink
        self._recorder = recorder
        self._source = source
        self._seq = 0

    def emit(self, kind, _forward=True, **fields):
        self._seq += 1
        ev = dict(kind=kind, seq=self._seq, **fields)
        self.counters[kind] += 1
        self.events.append(ev)
        if self._sink is not None:
            self._sink(ev)
        if _forward:
            obs.event(kind, source=self._source,
                      recorder=self._recorder, **fields)
        return ev

    def last_seq(self):
        """Sequence number of the newest event (0 before any emit).
        Monotonic across ring rollover — feed it back as ``since_seq``
        to poll incrementally."""
        return self._seq

    def of(self, kind, since_seq=None):
        """Events of `kind`, oldest first. With ``since_seq`` only
        events emitted AFTER that sequence number are returned — and,
        because events land in seq order, the scan walks backwards and
        stops at the watermark instead of rescanning the whole bounded
        ring on every poll. Events that rolled off the deque before the
        watermark are gone either way (the ring is bounded); a stale
        watermark never raises, it just returns what survived."""
        if since_seq is None:
            return [ev for ev in self.events if ev["kind"] == kind]
        out = []
        for ev in reversed(self.events):
            if ev["seq"] <= since_seq:
                break
            if ev["kind"] == kind:
                out.append(ev)
        out.reverse()
        return out


# ---------------------------------------------------------------------------
# guarded execution
# ---------------------------------------------------------------------------




# ---------------------------------------------------------------------------
# guarded execution (ROADMAP.md Queue 1 item 11)
# ---------------------------------------------------------------------------


def _later(what):
    return NotImplementedError(
        "%s is not ported yet: it comes with ROADMAP.md Queue 1 item 11"
        % what)


class GuardedExecutor:
    """``Executor.run`` with retry, watchdog and a non-finite guard — not
    ported yet (ROADMAP.md Queue 1 item 11)."""

    def __init__(self, *args, **kwargs):
        raise _later("GuardedExecutor")


class TrainGuard:
    """The auto-checkpointing training loop driver — not ported yet
    (ROADMAP.md Queue 1 item 11)."""

    def __init__(self, *args, **kwargs):
        raise _later("TrainGuard")


def run_guarded(*args, **kwargs):
    raise _later("run_guarded")
