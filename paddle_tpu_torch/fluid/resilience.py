"""Resilient training runtime: fault injection, guarded execution,
auto-checkpoint/resume (port of paddle_tpu/fluid/resilience.py).

- **FaultInjector** — deterministic, env-driven fault injection
  (``PADDLE_TPU_FAULT_SPEC``) at named runtime sites, so every recovery
  path is testable without flaky sleeps or monkeypatching.
- **GuardedExecutor / run_guarded()** — ``Executor.run`` plus bounded
  retry with exponential backoff + deterministic jitter for transient
  errors, an optional wall-clock watchdog per run, and a non-finite
  fetch guard that skips NaN/Inf steps (cooperating with AMP dynamic
  loss scaling, whose skip-gate already made the update a no-op) and
  raises after N consecutive bad steps.
- **TrainGuard** — a loop driver wiring periodic auto-checkpointing
  (parallel/checkpoint.py) with crash-resume from ``latest_step``,
  py_reader feeder-thread restart, epoch rollover on EOF, and a
  structured event log (step/retry/skip/save/restore/reader_restart).
- **EventLog** — the bounded structured event log, routed through
  :mod:`paddle_tpu_torch.observability`.

Fault spec grammar (clauses joined by ``;`` or ``,``), the JAX package's::

    PADDLE_TPU_FAULT_SPEC="replica:at=1:RuntimeError;wire:at=1:corrupt=bitflip"

    clause   := site ":" trigger ":" action
    site     := "run" | "feed" | "save" | "fetch"
              | "collective" | "barrier" | "heartbeat"
              | "dispatch" | "replica"
              | "load" | "wire" | "mailbox"
    trigger  := "every=" N | "at=" N      (N counts checks at that site,
                                           1-based)
    action   := exception class name (builtins or "EOFException"),
                "nan" (site "fetch" only: corrupt the first fetched
                float into NaN), "slow" (sleep PADDLE_TPU_FAULT_SLOW_S seconds,
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
dispatch (``parallel/comms/grad_sync.py``) and the elastic store
all-reduce, ``barrier`` in the ``barrier`` op, ``Fleet.barrier_worker``
and the elastic rendezvous, ``save`` in
``parallel.checkpoint.save_checkpoint`` (before anything touches disk;
its ``corrupt=`` arm in the digest manifest's write, ``load`` in its
read) and ``fetch`` in ``GuardedExecutor.run``.

Collective deadlines, as the JAX package has them:
``collective_deadline(seconds)`` arms a wall-clock deadline on this
thread, and :func:`collective_check` — one call per collective entry
point — raises :class:`CollectiveTimeoutError` once it has expired, so
no new collective is issued after a peer is presumed lost.

With the env var unset and no injector installed, the hooks are inert
(one dict lookup per site check).

Run health (``TrainGuard(runhealth=)``, the goodput notes), the compile
cache (``TrainGuard(compile_cache=)``) and the static analyzer behind a
retry's diagnosis wait for ROADMAP.md Queue 1 item 11.
"""
import collections
import os
import random
import re
import threading
import time

import numpy as np
import torch

from . import core
from .lowering import OpLoweringError
from .. import observability as obs

__all__ = [
    "FaultInjector", "FaultSpecError", "GuardedExecutor", "TrainGuard",
    "EventLog", "StepReport", "StepTimeoutError", "NonFiniteError",
    "CollectiveTimeoutError", "collective_deadline", "collective_check",
    "deadline_remaining", "fault_check", "fault_nonfinite", "run_guarded",
    "fault_corrupt", "fault_corrupt_mode", "corrupt_bytes",
    "corrupt_array",
]

FAULT_SPEC_ENV = "PADDLE_TPU_FAULT_SPEC"


class FaultSpecError(ValueError):
    """Malformed PADDLE_TPU_FAULT_SPEC."""


class StepTimeoutError(RuntimeError):
    """A guarded run exceeded its wall-clock budget. Not retried by
    default: the abandoned run may still be writing the scope's
    tensors, so a blind re-run could race it — surface to the driver
    instead."""


class NonFiniteError(FloatingPointError):
    """Raised after N consecutive non-finite (NaN/Inf) guarded steps."""


class CollectiveTimeoutError(RuntimeError):
    """A collective/barrier path exceeded its deadline. Never retried
    blindly: the peer that missed the rendezvous may be dead, and
    re-entering the same collective would hang again — the caller
    (FleetGuard) must first re-establish fleet membership."""


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

    if name == "EOFException":
        return core.EOFException
    exc = getattr(builtins, name, None)
    if isinstance(exc, type) and issubclass(exc, BaseException):
        return exc
    raise FaultSpecError(
        "unknown fault action %r (want a builtin exception name, "
        "'EOFException', 'slow', or 'nan' for the fetch site)" % name
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
    """Hook called from instrumented sites (Executor.run, py_reader
    _next_feed, checkpoint save, the router's dispatch, the beacon
    writer). No-op unless an injector is active."""
    inj = FaultInjector.active()
    if inj is not None:
        inj.check(site)


def fault_nonfinite(site="fetch"):
    """True when a 'nan' clause fires at `site` (GuardedExecutor uses
    this to corrupt a fetched loss, testing the non-finite guard)."""
    inj = FaultInjector.active()
    return bool(inj is not None and inj.check(site))


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


class StepReport(list):
    """The fetch list returned by a guarded run, with step metadata.
    Subclasses list so existing unpack-the-fetches call sites keep
    working: ``loss, = guarded.run(...)``."""

    skipped = False      # non-finite step, update assumed skipped/ignored
    managed = False      # AMP dynamic loss scaling owned the skip
    retries = 0          # transient failures retried away for this step
    nonfinite = False


def _default_transients():
    # OSError covers ConnectionError/TimeoutError; RuntimeError is what
    # torch and CUDA raise for runtime-side failures. OpLoweringError (a
    # RuntimeError subclass) is a *graph* error and is never retried.
    return (RuntimeError, OSError)


def _later(what):
    return NotImplementedError(
        "%s is not ported yet: it comes with ROADMAP.md Queue 1 item 11"
        % what)


class GuardedExecutor:
    """``Executor.run`` with bounded retry, a wall-clock watchdog, and a
    non-finite fetch guard. Drop-in: ``run()`` takes the Executor.run
    signature and returns the fetch list (a :class:`StepReport`).

    - Transient errors (`transient_types`, default RuntimeError+OSError)
      are retried up to `max_retries` times with exponential backoff
      (`backoff_base * 2**attempt`, capped at `backoff_max`) plus
      deterministic jitter. ``core.EOFException``, ``OpLoweringError``
      and ``StepTimeoutError`` are never retried.
    - With `timeout` set, each attempt runs under a watchdog thread and
      raises :class:`StepTimeoutError` at expiry (the dispatch thread is
      abandoned — daemonized — and the error is not retried).
    - Fetched float arrays are checked for NaN/Inf. A bad step is
      counted and *skipped* (``report.skipped``) — cooperating with AMP
      dynamic loss scaling, whose in-graph skip gate already kept the
      params/optimizer state untouched — until
      `max_consecutive_nonfinite` consecutive bad steps, which raise
      :class:`NonFiniteError`. Pass ``nonfinite_action="raise"`` to
      fail on the first bad step instead.
    """

    NEVER_RETRY = (core.EOFException, core.ReaderNotStartedError,
                   OpLoweringError, StepTimeoutError, FaultSpecError,
                   CollectiveTimeoutError)

    def __init__(self, executor, max_retries=3, backoff_base=0.05,
                 backoff_max=2.0, jitter=0.25, timeout=None,
                 nonfinite_action="skip", max_consecutive_nonfinite=5,
                 transient_types=None, amp_optimizer=None, on_event=None,
                 seed=0, recorder=None):
        if nonfinite_action not in ("skip", "raise"):
            raise ValueError(
                "nonfinite_action must be 'skip' or 'raise', got %r"
                % (nonfinite_action,))
        self._exe = executor
        self._recorder = recorder
        self.max_retries = int(max_retries)
        self.backoff_base = float(backoff_base)
        self.backoff_max = float(backoff_max)
        self.jitter = float(jitter)
        self.timeout = timeout
        self.nonfinite_action = nonfinite_action
        self.max_consecutive_nonfinite = int(max_consecutive_nonfinite)
        self.transient_types = tuple(
            transient_types if transient_types is not None
            else _default_transients())
        self.amp_optimizer = amp_optimizer
        self.counters = collections.Counter()
        self._on_event = on_event
        self._consecutive_nonfinite = 0
        self._rng = random.Random(seed)

    # -- events ----------------------------------------------------------
    def _emit(self, kind, **fields):
        self.counters[kind] += 1
        # hub routing happens HERE, at the origin; relays into a
        # TrainGuard/FleetGuard EventLog re-emit with _forward=False
        obs.event(kind, source="guard", recorder=self._recorder,
                  **fields)
        if self._on_event is not None:
            self._on_event(dict(kind=kind, **fields))

    # -- pieces ----------------------------------------------------------
    def _backoff(self, attempt):
        delay = min(self.backoff_max,
                    self.backoff_base * (2.0 ** (attempt - 1)))
        return delay * (1.0 + self.jitter * self._rng.random())

    def _invoke(self, args, kwargs):
        if not self.timeout:
            return self._exe.run(*args, **kwargs)
        box = {}
        done = threading.Event()

        def _worker():
            try:
                box["result"] = self._exe.run(*args, **kwargs)
            except BaseException as e:  # relayed to the caller below
                box["error"] = e
            finally:
                done.set()

        t = threading.Thread(
            target=_worker, daemon=True, name="paddle_tpu-guarded-run")
        t.start()
        if not done.wait(self.timeout):
            self._emit("timeout", timeout=self.timeout)
            raise StepTimeoutError(
                "Executor.run exceeded %.3fs wall-clock budget (the "
                "dispatch thread was abandoned and may still be writing "
                "the scope's tensors and launching work on the card's "
                "stream — restore from the last checkpoint before "
                "re-running)" % self.timeout
            )
        if "error" in box:
            raise box["error"]
        return box["result"]

    def _analyze_failure(self, program, feed, fetch_list):
        """Extra fields for the retry event: none — the static analyzer
        that diagnoses a failed step waits for ROADMAP.md Queue 1 item
        11 (the JAX package's returns {} too with its analyzer off)."""
        return {}

    def _amp_managed(self):
        opt = self.amp_optimizer
        return bool(opt is not None
                    and getattr(opt, "get_finite_flag", None)
                    and opt.get_finite_flag() is not None)

    @staticmethod
    def _nonfinite(fetches):
        for v in fetches:
            if isinstance(v, torch.Tensor):
                # a tensor fetch (return_numpy=False): reduce where it
                # lives and transfer ONE flag, not the whole fetch
                if torch.is_floating_point(v) and \
                        not bool(torch.isfinite(v).all()):
                    return True
                continue
            arr = np.asarray(v)
            if arr.dtype.kind == "f" and not np.isfinite(arr).all():
                return True
        return False

    @staticmethod
    def _nan_like(v):
        if isinstance(v, torch.Tensor):
            return torch.full_like(
                v, float("nan"),
                dtype=v.dtype if torch.is_floating_point(v)
                else torch.float32)
        first = np.asarray(v)
        return np.full(
            first.shape, np.nan,
            dtype=first.dtype if first.dtype.kind == "f" else "float32")

    # -- the guarded run -------------------------------------------------
    def run(self, program=None, feed=None, fetch_list=None,
            return_numpy=True, **kwargs):
        """Executor.run under the guard. ``return_numpy=False`` passes
        through: the StepReport then holds the fetched tensors (no
        per-step host copy) and the non-finite guard reduces them where
        they live."""
        attempt = 0
        while True:
            try:
                fetches = self._invoke(
                    (program,), dict(feed=feed, fetch_list=fetch_list,
                                     return_numpy=return_numpy,
                                     **kwargs))
                break
            except self.NEVER_RETRY:
                raise
            except self.transient_types as e:
                attempt += 1
                if attempt > self.max_retries:
                    raise
                delay = self._backoff(attempt)
                extra = {}
                if attempt == 1:
                    extra = self._analyze_failure(program, feed,
                                                  fetch_list)
                self._emit("retry", attempt=attempt, delay=delay,
                           error="%s: %s" % (type(e).__name__, e),
                           **extra)
                # the goodput note of the backoff waits for run health
                # (ROADMAP.md Queue 1 item 11)
                time.sleep(delay)

        report = StepReport(fetches if fetches is not None else [])
        report.retries = attempt
        if fault_nonfinite("fetch") and len(report):
            # injected NaN loss: corrupt the first fetch so the guard
            # below exercises the real skip path end-to-end
            report[0] = self._nan_like(report[0])
        if self._nonfinite(report):
            report.nonfinite = True
            self._consecutive_nonfinite += 1
            bad = self._consecutive_nonfinite
            if (self.nonfinite_action == "raise"
                    or bad >= self.max_consecutive_nonfinite):
                raise NonFiniteError(
                    "non-finite fetch on %d consecutive step(s) "
                    "(threshold %d) — the run has diverged"
                    % (bad, self.max_consecutive_nonfinite)
                )
            report.skipped = True
            report.managed = self._amp_managed()
            self._emit("skip", consecutive=bad, managed=report.managed)
        else:
            self._consecutive_nonfinite = 0
        if self.amp_optimizer is not None:
            # loss-scale telemetry at the origin: one gauge read per
            # step, plus the skipped-steps counter when AMP's in-graph
            # gate owned this skip
            publish = getattr(self.amp_optimizer,
                              "publish_step_telemetry", None)
            if publish is not None:
                try:
                    publish(scope=kwargs.get("scope"),
                            skipped=report.skipped and report.managed)
                except Exception:  # noqa: BLE001 — telemetry only
                    pass
        return report

    def reset_nonfinite_streak(self):
        """Forget consecutive non-finite history (call after restoring
        state from a checkpoint — the streak belonged to the rolled-back
        trajectory)."""
        self._consecutive_nonfinite = 0


def run_guarded(executor, program=None, feed=None, fetch_list=None,
                scope=None, **guard_opts):
    """One-shot convenience: ``GuardedExecutor(executor, **opts).run(...)``."""
    guard = GuardedExecutor(executor, **guard_opts)
    kwargs = {} if scope is None else {"scope": scope}
    return guard.run(program, feed=feed, fetch_list=fetch_list, **kwargs)


# ---------------------------------------------------------------------------
# the loop driver
# ---------------------------------------------------------------------------


def _all_finite(value):
    if isinstance(value, torch.Tensor):
        return (not torch.is_floating_point(value)
                or bool(torch.isfinite(value).all()))
    a = np.asarray(value)
    return a.dtype.kind != "f" or bool(np.isfinite(a).all())


class TrainGuard:
    """Fault-tolerant training loop: guarded steps + periodic
    auto-checkpointing + crash-resume + reader restart.

    ::

        guard = TrainGuard(exe, program=prog, ckpt_dir=dirname,
                           fetch_list=[loss], feed_fn=make_feed,
                           save_every=50)
        summary = guard.train(num_steps=1000)

    Steps are 1-based; checkpoint step K means "step K completed". On
    ``train()``, if `ckpt_dir` holds checkpoints (a previous run
    crashed), state is restored from ``latest_step`` and training
    resumes at the next step — completed steps are not re-run. Batches
    come from `feed_fn(step)` or, when None, from a started py_reader
    attached to the program (pass the reader objects via `readers` so
    dead feeder threads can be restarted and EOF rolls the epoch over).

    The executor's run count seeds each step's random draws, as in the
    JAX package: a resume on the same executor has counted the steps it
    replays, so at dropout > 0 the resumed steps draw other masks than
    an uninterrupted run would (ROADMAP.md Queue 3).

    The event log records ``restore``/``step``/``retry``/``skip``/
    ``save``/``eof``/``reader_restart``/``final`` events with bounded
    memory; ``summary["counters"]`` aggregates them. ``runhealth=`` and
    ``compile_cache=`` wait for ROADMAP.md Queue 1 item 11.
    """

    def __init__(self, executor, program=None, ckpt_dir=None,
                 fetch_list=None, feed_fn=None, readers=None,
                 save_every=0, final_save=True, resume=True, scope=None,
                 reader_restarts=2, restart_on_eof=True, max_to_keep=None,
                 save_wait=True, on_event=None, log_maxlen=10000,
                 recorder=None, compile_cache=False, stage_to_device=False,
                 runhealth=None, lr_var=None, **guard_opts):
        if compile_cache:
            raise _later("TrainGuard(compile_cache=) (the persistent "
                         "compile cache)")
        if runhealth is not None:
            raise _later("TrainGuard(runhealth=) (the run-health "
                         "observatory)")
        self._exe = executor
        self._program = program
        self._ckpt_dir = ckpt_dir
        self._stage_to_device = bool(stage_to_device)
        self._fetch_list = fetch_list
        self._feed_fn = feed_fn
        self._readers = list(readers or [])
        self._save_every = int(save_every)
        self._final_save = final_save
        self._resume = resume
        self._scope = scope
        self._reader_restarts = int(reader_restarts)
        self._restart_on_eof = restart_on_eof
        self._max_to_keep = max_to_keep
        self._save_wait = save_wait
        # lr_var names the learning-rate Variable (or its name) that
        # rollback_to_last_finite's lr-cut scales in the scope
        self._lr_var = lr_var
        self.log = EventLog(maxlen=log_maxlen, sink=on_event,
                            recorder=recorder, source="resilience")
        self.guard = GuardedExecutor(
            executor, on_event=self._relay, recorder=recorder,
            **guard_opts)

    def _relay(self, ev):
        # already hub-routed by GuardedExecutor._emit at the origin
        self.log.emit(ev.pop("kind"), _forward=False, **ev)

    # -- checkpoint plumbing --------------------------------------------
    def _resolve(self):
        from .executor import global_scope
        from .framework import default_main_program

        program = self._program if self._program is not None \
            else default_main_program()
        scope = self._scope if self._scope is not None else global_scope()
        return program, scope

    def _maybe_resume(self, program, scope):
        """Restore from the newest checkpoint; returns the last
        completed step (0 when starting fresh)."""
        if not (self._resume and self._ckpt_dir):
            return 0
        from ..parallel import checkpoint as ckpt
        from .io import _agreed_step, _apply_state

        step = _agreed_step(program, ckpt.latest_step(self._ckpt_dir),
                            self._ckpt_dir)
        if step is None:
            return 0
        t0 = time.monotonic()
        state = ckpt.load_checkpoint(self._ckpt_dir, step=step)
        restored = _apply_state(program, state, scope)
        self.log.emit("restore", step=step, vars=restored,
                      dirname=self._ckpt_dir,
                      seconds=round(time.monotonic() - t0, 6))
        # warm-start invalidation: batches staged before the restore
        # belong to the pre-crash stream position — restart started
        # readers so nothing stale is consumed. Its own event kind, so
        # it never burns the reader_restarts failure budget.
        started = [r for r in self._readers
                   if getattr(r, "_started", False)]
        if started:
            for r in started:
                r.restart()
            self.log.emit("staging_invalidate", step=step,
                          reason="resume", readers=len(started))
        return int(step)

    def save(self, step, program=None, scope=None):
        """Checkpoint the program's persistable state as `step`."""
        if program is None or scope is None:
            rprogram, rscope = self._resolve()
            program = program or rprogram
            scope = scope or rscope
        from .io import _store_save

        t0 = time.monotonic()
        n = _store_save(program, scope, self._ckpt_dir, int(step),
                        max_to_keep=self._max_to_keep,
                        wait=self._save_wait)
        dt = time.monotonic() - t0
        # the checkpoint goodput note waits for run health (item 11)
        self.log.emit("save", step=int(step), vars=n,
                      seconds=round(dt, 6))

    def _restart_readers(self, step, reason):
        for r in self._readers:
            r.reset()
            r.start()
        self.log.emit("reader_restart", step=step, reason=reason,
                      readers=len(self._readers))

    # -- the loop --------------------------------------------------------
    def train(self, num_steps):
        """Run steps until `num_steps` have completed (counting steps
        finished by a previous crashed run). Returns a summary dict."""
        program, scope = self._resolve()
        if self._stage_to_device:
            # overlap host→device batch transfer with device compute
            # (layers/io.py device staging; generation-bound, so the
            # reader restarts below also invalidate staged batches)
            for r in self._readers:
                stage = getattr(r, "prefetch_to_device", None)
                if stage is not None:
                    stage(self._exe.place)
        return self._train_loop(num_steps, program, scope)

    def _train_loop(self, num_steps, program, scope):
        fetch_list = self._fetch_list
        start = self._maybe_resume(program, scope)
        completed = start
        last_saved = start if start else None
        last_eof_step = None
        step = start + 1
        while step <= num_steps:
            feed = self._feed_fn(step) if self._feed_fn else None
            try:
                report = self.guard.run(
                    program, feed=feed, fetch_list=fetch_list,
                    scope=scope)
            except core.EOFException:
                self.log.emit("eof", step=step)
                if not (self._readers and self._restart_on_eof):
                    raise
                if last_eof_step == step:
                    # two EOFs with no step in between: the reader
                    # yields nothing — restarting forever won't help
                    raise
                last_eof_step = step
                self._restart_readers(step, "eof")
                continue
            except (Exception,) as e:
                if (self._readers
                        and self.log.counters["reader_restart"]
                        < self._reader_restarts
                        and not isinstance(e, NonFiniteError)):
                    # a dead feeder thread surfaces as the producer's
                    # exception (once) or a missing-feed lowering error
                    # on the next pop — a reset()+start() rebuilds the
                    # thread and retries this step on a fresh epoch
                    self._restart_readers(
                        step, "%s: %s" % (type(e).__name__, e))
                    continue
                raise
            completed = step
            self.log.emit("step", step=step, skipped=report.skipped,
                          retries=report.retries)
            if (self._ckpt_dir and self._save_every
                    and step % self._save_every == 0):
                self.save(step, program, scope)
                last_saved = step
            step += 1
        if (self._ckpt_dir and self._final_save and completed > start
                and last_saved != completed):
            self.save(completed, program, scope)
            last_saved = completed
        self.log.emit("final", step=completed)
        return {
            "resumed_from": start if start else None,
            "first_step": start + 1,
            "final_step": completed,
            "steps_run": completed - start,
            "last_saved": last_saved,
            "counters": dict(self.log.counters),
            "events": list(self.log.events),
        }

    # -- divergence remediation -----------------------------------------
    def rollback_to_last_finite(self, lr_scale=None, program=None,
                                scope=None):
        """Restore the newest checkpoint whose float state is entirely
        finite (walking past any NaN-poisoned saves), optionally scale
        the learning-rate variable by ``lr_scale``, and reset the
        non-finite streak so the restored trajectory re-baselines.

        Returns ``{"step", "vars", "skipped_steps", "lr", "lr_scale"}``
        on success, None when no finite checkpoint exists (or there is
        no ckpt_dir). The var restore is the same scope.update walk as
        crash-resume, so the restored state is bit-identical to a clean
        ``load_checkpoint`` resume from that step."""
        if not self._ckpt_dir:
            return None
        from ..parallel import checkpoint as ckpt
        from .executor import to_numpy
        from .io import _agreed_step, _apply_state

        if program is None or scope is None:
            rprogram, rscope = self._resolve()
            program = program or rprogram
            scope = scope or rscope
        t0 = time.monotonic()
        state = None
        chosen = None
        skipped = []
        for step in ckpt.all_steps(self._ckpt_dir):
            try:
                cand = ckpt.load_checkpoint(self._ckpt_dir, step=step)
            except Exception:  # torn/corrupt save: keep walking back
                skipped.append(int(step))
                continue
            if all(_all_finite(a) for a in cand.values()):
                state, chosen = cand, int(step)
                break
            skipped.append(int(step))
        if _agreed_step(program, chosen, self._ckpt_dir) is None:
            self.log.emit("rollback_failed", reason="no finite checkpoint",
                          skipped_steps=skipped)
            return None
        restored = _apply_state(program, state, scope)
        out = {"step": chosen, "vars": restored,
               "skipped_steps": skipped, "lr": None,
               "lr_scale": lr_scale}
        if lr_scale is not None and self._lr_var is not None:
            name = getattr(self._lr_var, "name", self._lr_var)
            raw = scope.find_value(name)
            if raw is not None:
                raw = to_numpy(raw) if isinstance(raw, torch.Tensor) \
                    else np.asarray(raw)
                cut = raw.astype("float32") * float(lr_scale)
                scope.update(name, cut)
                out["lr"] = float(cut.reshape(-1)[0])
        # staged batches + failure streaks belong to the abandoned
        # trajectory
        started = [r for r in self._readers
                   if getattr(r, "_started", False)]
        for r in started:
            r.restart()
        self.guard.reset_nonfinite_streak()
        self.log.emit("rollback", step=chosen, vars=restored,
                      skipped_steps=skipped, lr_scale=lr_scale,
                      lr=out["lr"], readers=len(started),
                      seconds=round(time.monotonic() - t0, 6))
        return out
