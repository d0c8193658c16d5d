"""Nestable monotonic-clock spans with a thread-local stack.

Port of paddle_tpu/observability/tracing.py, unchanged.

``span("executor.run")`` is a context manager: entering pushes onto the
current thread's stack, exiting pops and observes the duration into the
telemetry hub as a ``span.<name>.seconds`` histogram. In ``trace`` mode
every exit additionally records a ``span`` event (name, seconds, depth,
parent) into the flight recorder so the JSONL stream carries the full
step timeline. With telemetry off the context manager is inert — no
clock read, no stack push, no allocation beyond the span object itself
(which instrumentation sites create unconditionally; it has __slots__
and a constructor that stores two attributes).

Per-thread stacks are registered in a process-wide table so the crash
dumper can report what every thread was inside when the process died
(``active_spans()``).

Spans optionally participate in **distributed traces**: pass a sampled
:class:`~paddle_tpu_torch.observability.distributed.TraceContext` as
``ctx=`` and the span derives a child span id on entry (readable as
``.ctx`` for further propagation) and appends a JSONL record to
``$PADDLE_TPU_TRACE_DIR`` on exit. With no ctx (or an unsampled one)
the extra work is a single attribute store — the per-request sampling
bit keeps tracing opt-in.
"""
import threading
import time

from . import telemetry as _t

__all__ = ["span", "active_spans", "current_span"]

_tls = threading.local()
_registry_lock = threading.Lock()
_stacks = {}  # thread ident -> (thread name, stack list)


def _stack():
    st = getattr(_tls, "stack", None)
    if st is None:
        # registered for the thread's lifetime: active_spans() filters
        # empty stacks, and an ident reused by a later thread simply
        # overwrites this entry (fresh thread -> fresh thread-local)
        st = _tls.stack = []
        t = threading.current_thread()
        with _registry_lock:
            _stacks[t.ident] = (t.name, st)
    return st


class span:
    """``with span("executor.run", program=uid): ...``

    ``ctx=`` attaches a distributed :class:`TraceContext`; when it is
    sampled the span gets its own child span id (``.ctx``) and its
    exit is exported as a JSONL trace record."""

    __slots__ = ("name", "fields", "t0", "_live", "_mode", "_ctx",
                 "_wall0")

    def __init__(self, name, ctx=None, **fields):
        self.name = name
        self.fields = fields or None
        self.t0 = None
        self._live = False
        self._mode = _t.OFF
        self._ctx = ctx
        self._wall0 = None

    @property
    def ctx(self):
        """The context to propagate downstream: this span's own child
        context once entered (so downstream spans parent to it), else
        whatever was passed in."""
        return self._ctx

    def __enter__(self):
        m = _t.mode()
        self._mode = m
        if m == _t.OFF:
            return self
        self._live = True
        _stack().append(self)
        ctx = self._ctx
        if ctx is not None and ctx.sampled:
            self._ctx = ctx.child()
            self._wall0 = time.time()
        self.t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        if not self._live:
            return False
        dt = time.monotonic() - self.t0
        self._live = False
        st = _stack()
        # pop self even if an inner span leaked (exception paths)
        while st and st.pop() is not self:
            pass
        parent = st[-1].name if st else None
        _t.get_telemetry().observe("span.%s.seconds" % self.name, dt)
        ctx = self._ctx
        if ctx is not None and ctx.sampled and self._wall0 is not None:
            from . import distributed as _dist

            fields = dict(self.fields or {})
            if exc_type is not None:
                fields["error"] = exc_type.__name__
            _dist.export_span(self.name, ctx, self._wall0, dt, fields)
        if self._mode == _t.TRACE:
            from . import recorder as _r

            fields = dict(self.fields or {})
            if exc_type is not None:
                fields["error"] = exc_type.__name__
            _r.get_recorder().record(
                "span", name=self.name, seconds=round(dt, 9),
                depth=len(st) + 1, parent=parent, **fields)
        return False

    def elapsed(self):
        """Seconds since entry (live spans only)."""
        return time.monotonic() - self.t0 if self.t0 is not None else 0.0


def current_span():
    """The innermost live span on this thread, or None."""
    st = getattr(_tls, "stack", None)
    return st[-1] if st else None


def active_spans():
    """{thread name: [(span name, seconds elapsed), ...]} for every
    thread currently inside at least one span — outermost first. Used
    by the crash dumper to answer 'what was each thread doing'."""
    out = {}
    with _registry_lock:
        items = list(_stacks.items())
    for _ident, (tname, st) in items:
        frames = [(s.name, round(s.elapsed(), 6)) for s in list(st)
                  if s._live]
        if frames:
            out[tname] = frames
    return out
