"""PrefillEngine: the prompt half of a disaggregated decode fleet (port of
paddle_tpu/serving/disagg/prefill.py).

A prefill replica runs ONLY the bucketed prefill programs — no step
program, no slot buffers, no streaming. Its product is a
:class:`~paddle_tpu_torch.serving.disagg.kv_wire.KVHandoff`: the prompt's KV
cache (int8 block-scaled per row on the wire by default) plus the
first greedy token, which a decode replica adopts via
``DecodeEngine.submit_prefilled``. Splitting the phases is what stops
a long prompt from stalling every live stream: the O(prompt²) prefill
burns a prefill replica's card while the decode replicas keep
stepping. The programs run eagerly on the card unless ``place`` says
otherwise; the cache comes back to the host as numpy and is encoded
there (the JAX package's path, ported as it is).

Scheduling is a **priority queue**, not FIFO: requests carry the
tenant's priority class (0 = interactive first), ties break by arrival
order, and a queued request whose deadline lapses is shed before any
device time is spent. TTFT is this engine's SLO: the queue-wait +
prefill time is observed as ``serving.disagg.prefill_ttft_seconds``
and scored against ``ttft_slo_ms`` (``serving.disagg.slo_miss_ttft``).

Admission mirrors the decode engine: a full queue fast-rejects with
:class:`~paddle_tpu_torch.serving.engine.ShedError` carrying a Retry-After
from the observed drain rate.

Not ported yet: the prefix pool (``prefix_pool=`` raises, naming
ROADMAP.md Queue 1 item 7.4) and the cost-model ``predicted_s`` span
annotation (item 11). The JAX engine's lock-sanitizer hooks wait for item
11 as well: the locks here are plain ``threading`` locks.
"""
import collections
import contextlib
import heapq
import threading
import time

import numpy as np

from ... import observability as obs
from ...fluid import core
from ..engine import DeadlineExceededError, EngineClosedError, ShedError
from . import kv_wire

__all__ = ["PrefillEngine", "PrefillTicket"]


class PrefillTicket:
    """Future-like handle for one queued prefill; ``result()`` blocks
    for the :class:`KVHandoff`."""

    def __init__(self, prompt_len, timeout_s):
        self.prompt_len = int(prompt_len)
        self.t_submit = time.monotonic()
        self._timeout_s = float(timeout_s)
        self._done = threading.Event()
        self._cancelled = threading.Event()
        self._result = None
        self._error = None

    @property
    def done(self):
        return self._done.is_set()

    @property
    def cancelled(self):
        return self._cancelled.is_set()

    def cancel(self):
        self._cancelled.set()

    def result(self, timeout=None):
        wait = self._timeout_s if timeout is None else float(timeout)
        if not self._done.wait(wait):
            raise TimeoutError(
                "prefill not done after %.1fs" % float(wait))
        if self._error is not None:
            raise self._error
        return self._result

    # -- engine surface --------------------------------------------------
    def _set(self, handoff):
        self._result = handoff
        self._done.set()

    def _fail(self, exc):
        self._error = exc
        self._done.set()


class _PrefillReq:
    __slots__ = ("prompt", "plen", "bucket", "priority", "tenant",
                 "deadline", "ticket", "wire_dtype", "trace", "t_wall")


class PrefillEngine:
    """Bucketed prefill-only engine producing serialized KV handoffs.

    ::

        pre = PrefillEngine(cfg, scope, cache_len=128, name="gpt-pre")
        handoff = pre.submit(prompt_ids, priority=0).result()
        stream = decode_engine.submit_prefilled(handoff, max_new=64)

    Shares the builder/param-snapshot conventions of ``DecodeEngine``:
    params are copied to the device once and shared by every bucket
    program. The engine runs on the card unless ``place`` says
    otherwise."""

    engine_kind = "prefill"

    def __init__(self, cfg, scope, cache_len=64, prompt_buckets=None,
                 queue_capacity=64, name="prefill", wire_dtype="int8",
                 ttft_slo_ms=None, request_timeout_s=60.0,
                 auto_start=True, build_prefill=None, prefix_pool=None,
                 place=None):
        from ... import fluid
        from ..decode import _later, _snapshot, default_prompt_buckets
        from ...fluid.inference import Predictor

        if prefix_pool is not None:
            raise _later("the prefix pool (prefix_pool=)", "7.4")
        if build_prefill is None:
            from ...models.gpt import build_gpt_prefill

            build_prefill = build_gpt_prefill
        self.place = place if place is not None else core.default_place()
        self.device = self.place.torch_device()
        self.cfg = cfg
        self.name = str(name)
        self.cache_len = int(cache_len)
        self.wire_dtype = str(wire_dtype)
        self.ttft_slo_ms = (None if ttft_slo_ms is None
                            else float(ttft_slo_ms))
        self.request_timeout_s = float(request_timeout_s)
        if prompt_buckets is None:
            prompt_buckets = default_prompt_buckets(self.cache_len)
        self.prompt_buckets = tuple(sorted({int(b) for b in prompt_buckets}))
        if not self.prompt_buckets or self.prompt_buckets[0] < 1:
            raise ValueError("prompt_buckets must be positive ints")
        if self.prompt_buckets[-1] > self.cache_len:
            raise ValueError(
                "largest prompt bucket (%d) exceeds cache_len (%d)"
                % (self.prompt_buckets[-1], self.cache_len))

        prefill = {}
        for b in self.prompt_buckets:
            with fluid.program_guard(fluid.Program(), fluid.Program()):
                pv = build_prefill(cfg, b, self.cache_len)
                prefill[b] = (fluid.default_main_program(), pv)
        persist = {}
        for prog, _ in prefill.values():
            for v in prog.list_vars():
                if not getattr(v, "persistable", False):
                    continue
                if v.name in persist:
                    continue
                if v.name not in scope:
                    raise KeyError(
                        "param %r required by the prefill programs is "
                        "missing from the given scope" % v.name)
                persist[v.name] = _snapshot(scope[v.name], self.device)
        self._params = persist
        self._prefill_preds = {}
        for b, (prog, pv) in prefill.items():
            self._prefill_preds[b] = Predictor(
                prog, pv["feed_names"], pv["fetch_vars"], scope=persist,
                place=self.place)

        self._capacity = int(queue_capacity)
        self._heap = []          # (priority, seq, req) — min-heap
        self._seq = 0
        # submit/stop coordination needs wait/notify
        self._cond = threading.Condition()
        self._closed = False
        self._abort = False
        self._stats_lock = threading.Lock()
        self._stats = collections.Counter()
        self._rate = collections.deque(maxlen=64)
        self._thread = None
        if auto_start:
            self.start()

    # -- lifecycle -------------------------------------------------------
    def start(self):
        if self._closed:
            raise EngineClosedError("engine %r is closed" % self.name)
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="prefill-dispatch-%s" % self.name)
            self._thread.start()
        return self

    def stop(self, drain=True, timeout=30.0):
        """Stop admitting work; ``drain=False`` fails queued requests
        with :class:`EngineClosedError`. Idempotent."""
        with self._cond:
            self._closed = True
            if not drain:
                self._abort = True
            self._cond.notify_all()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=max(0.1, float(timeout)))
        with self._cond:
            leftovers = [req for _, _, req in self._heap]
            self._heap = []
        for req in leftovers:
            req.ticket._fail(EngineClosedError(
                "engine %r stopped before prefill" % self.name))
        obs.event("engine_stop", source="serving", count=False,
                  model=self.name, engine="prefill", drained=bool(drain))

    # -- admission -------------------------------------------------------
    def _bucket_for(self, plen):
        for b in self.prompt_buckets:
            if b >= plen:
                return b
        return None

    def submit(self, prompt, priority=1, tenant=None, deadline_ms=None,
               wire_dtype=None, trace_ctx=None):
        """Enqueue one prefill; returns a :class:`PrefillTicket` whose
        ``result()`` is the :class:`KVHandoff`. Lower ``priority``
        numbers run first (ties FIFO). ``wire_dtype`` overrides the
        engine's handoff codec for this one request (e.g. ``"fp32"``
        for a lossless handoff out of an int8-wire fleet).
        ``trace_ctx`` (a sampled
        :class:`~paddle_tpu_torch.observability.TraceContext`) makes the
        queue-wait and prefill-compute spans part of the request's
        distributed trace and rides the handoff to the decode side."""
        if self._closed:
            raise EngineClosedError(
                "engine %r is draining/stopped" % self.name)
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        plen = int(prompt.shape[0])
        if plen < 1:
            raise ValueError("empty prompt")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab:
            raise ValueError(
                "prompt token out of range [0, %d)" % self.cfg.vocab)
        bucket = self._bucket_for(plen)
        if bucket is None:
            raise ValueError(
                "prompt length %d exceeds the largest prompt bucket "
                "(%d)" % (plen, self.prompt_buckets[-1]))
        req = _PrefillReq()
        req.prompt = prompt
        req.plen = plen
        req.bucket = bucket
        req.priority = int(priority)
        req.tenant = tenant
        req.deadline = (time.monotonic() + float(deadline_ms) / 1000.0
                        if deadline_ms is not None else None)
        req.wire_dtype = (str(wire_dtype) if wire_dtype is not None
                          else self.wire_dtype)
        sampled = trace_ctx is not None and trace_ctx.sampled
        req.trace = trace_ctx if sampled else None
        req.t_wall = time.time() if sampled else None
        req.ticket = PrefillTicket(plen, self.request_timeout_s)
        with self._cond:
            if self._closed:
                raise EngineClosedError(
                    "engine %r is draining/stopped" % self.name)
            if len(self._heap) >= self._capacity:
                self._bump("shed")
                obs.event("shed", source="serving", model=self.name,
                          engine="prefill", prompt_len=plen,
                          queue_capacity=self._capacity)
                raise ShedError(
                    "prefill queue full (%d) for model %r — request "
                    "shed" % (self._capacity, self.name),
                    model=self.name,
                    retry_after=self.retry_after_hint())
            self._seq += 1
            heapq.heappush(self._heap, (req.priority, self._seq, req))
            depth = len(self._heap)
            self._cond.notify()
        self._bump("requests")
        obs.set_gauge("serving.queue_depth.%s" % self.name, depth)
        return req.ticket

    def prefill(self, prompt, priority=1, tenant=None, deadline_ms=None,
                timeout=None, wire_dtype=None):
        """Synchronous submit + wait; returns the handoff."""
        t = self.submit(prompt, priority=priority, tenant=tenant,
                        deadline_ms=deadline_ms, wire_dtype=wire_dtype)
        return t.result(
            timeout if timeout is not None else self.request_timeout_s)

    # -- dispatch --------------------------------------------------------
    def _loop(self):
        while True:
            with self._cond:
                while not self._heap and not self._closed:
                    self._cond.wait(0.05)
                if not self._heap:
                    if self._closed:
                        return
                    continue
                if self._abort:
                    return  # stop() fails the leftovers
                _, _, req = heapq.heappop(self._heap)
                obs.set_gauge("serving.queue_depth.%s" % self.name,
                              len(self._heap))
            if req.ticket.cancelled:
                self._bump("cancelled")
                req.ticket._fail(EngineClosedError("prefill cancelled"))
                continue
            now = time.monotonic()
            if req.deadline is not None and now > req.deadline:
                self._bump("deadline_miss")
                waited_ms = round(1000 * (now - req.ticket.t_submit), 3)
                obs.event("deadline_miss", source="serving",
                          model=self.name, engine="prefill",
                          waited_ms=waited_ms)
                req.ticket._fail(DeadlineExceededError(
                    "deadline expired after %s ms in prefill queue "
                    "(model %r)" % (waited_ms, self.name)))
                continue
            self._run_one(req)

    def _run_one(self, req):
        t0 = time.monotonic()
        ctx = req.trace
        sp_fields = None
        if ctx is not None:
            # the queue-wait span already finished (submit -> pop);
            # export it directly, then parent the compute span to it
            ctx = ctx.child()
            obs.export_span(
                "prefill.queue", ctx, req.t_wall,
                t0 - req.ticket.t_submit,
                {"proc": "prefill:%s" % self.name, "bucket": req.bucket,
                 "plen": req.plen, "tenant": req.tenant})
            sp_fields = {"proc": "prefill:%s" % self.name,
                         "bucket": req.bucket, "plen": req.plen}
            if req.tenant is not None:
                sp_fields["tenant"] = str(req.tenant)
        try:
            cm = (obs.span("disagg.prefill", ctx=ctx, **sp_fields)
                  if ctx is not None else contextlib.nullcontext())
            with cm as sp:
                tok, k1, v1 = self._compute_kv(req)
                handoff = kv_wire.encode_kv(
                    k1, v1, tok, req.plen, req.prompt,
                    wire_dtype=req.wire_dtype,
                    trace=getattr(sp, "ctx", None))
        except Exception as e:  # noqa: BLE001 — fail the request, not the loop
            self._bump("prefill_errors")
            obs.event("prefill_error", source="serving", model=self.name,
                      engine="prefill",
                      error="%s: %s" % (type(e).__name__, str(e)[:200]))
            req.ticket._fail(e)
            return
        now = time.monotonic()
        ttft = now - req.ticket.t_submit
        obs.observe("serving.disagg.prefill_ttft_seconds", ttft)
        if req.tenant is not None:
            obs.observe(
                "serving.disagg.prefill_ttft_seconds.%s" % req.tenant,
                ttft)
        obs.observe("serving.decode.prefill_seconds", now - t0)
        if (self.ttft_slo_ms is not None
                and ttft * 1000.0 > self.ttft_slo_ms):
            self._bump("slo_miss_ttft")
            obs.inc("serving.disagg.slo_miss_ttft")
        self._bump("prefills")
        obs.inc("serving.disagg.handoffs")
        obs.set_gauge("serving.disagg.handoff_bytes.%s" % self.name,
                      handoff.wire_bytes())
        with self._stats_lock:
            self._rate.append((now, 1))
        req.ticket._set(handoff)

    def _compute_kv(self, req):
        """Produce ``(next_token, k, v)`` for one prompt through the cold
        bucket program, read back to the host (the prefix pool's full
        and partial hits come with ROADMAP.md Queue 1 item 7.4)."""
        ids = np.zeros((1, req.bucket), np.int64)
        ids[0, :req.plen] = req.prompt
        nxt, k1, v1 = self._prefill_preds[req.bucket].run(
            {"gpt_prefill_ids": ids,
             "gpt_prefill_len": np.asarray([[req.plen]], np.int64)})
        tok = int(np.asarray(nxt)[0, 0])
        self._bump("prefill_rows_computed", req.bucket)
        return tok, k1, v1

    # -- warmup / introspection ------------------------------------------
    def warmup(self):
        """Run every bucket program once (the first launch builds the
        CUDA kernels); returns the per-program report."""
        report = []
        for b in self.prompt_buckets:
            source = self._prefill_preds[b].warm({
                "gpt_prefill_ids": np.zeros((1, b), np.int64),
                "gpt_prefill_len": np.ones((1, 1), np.int64)})
            report.append({"program": "prefill", "bucket": b,
                           "source": source})
        obs.event(
            "warmup", source="serving", count=False, model=self.name,
            engine="prefill", engines=len(report),
            compiled=sum(1 for r in report if r["source"] == "compile"),
            disk_warm=sum(1 for r in report if r["source"] == "disk"))
        return report

    def _bump(self, key, n=1):
        with self._stats_lock:
            self._stats[key] += n
        obs.inc("serving.disagg.prefill_%s" % key, n)

    def stats(self):
        with self._stats_lock:
            out = dict(self._stats)
        for k in ("requests", "prefills", "shed", "deadline_miss",
                  "cancelled", "prefill_errors", "slo_miss_ttft",
                  "prefix_full_hits", "delta_prefills",
                  "prefill_rows_computed", "prefill_rows_saved"):
            out.setdefault(k, 0)
        with self._cond:
            out["queued"] = len(self._heap)
        return out

    def reuse_info(self):
        """Prefix-pool reuse snapshot (``/healthz`` + router
        aggregation) — mirrors ``DecodeEngine.reuse_info``'s shape. No
        prefix pool attaches yet (ROADMAP.md Queue 1 item 7.4)."""
        with self._stats_lock:
            st = dict(self._stats)
        computed = st.get("prefill_rows_computed", 0)
        saved = st.get("prefill_rows_saved", 0)
        return {
            "prefix_pool": None,
            "prefill_rows_computed": computed,
            "prefill_rows_saved": saved,
            "prefill_rows_saved_pct": (
                100.0 * saved / float(saved + computed)
                if (saved + computed) else None),
        }

    def queue_depth(self):
        with self._cond:
            return len(self._heap)

    def drain_rate(self):
        now = time.monotonic()
        with self._stats_lock:
            pts = [(t, n) for t, n in self._rate if now - t < 30.0]
        if not pts:
            return None
        span = max(1e-3, now - min(t for t, _ in pts))
        return sum(n for _, n in pts) / span

    def retry_after_hint(self):
        rate = self.drain_rate()
        if not rate:
            return 1.0
        return min(60.0, max(1.0, (self.queue_depth() + 1) / rate))

    @property
    def closed(self):
        return self._closed
