"""DecodeEngine: slotted KV-cache decode with continuous batching.

Port of paddle_tpu/serving/decode.py: the colocated engine, the
int8-resident cache and the decode-only role of a disaggregated fleet. The
micro-batching :class:`~paddle_tpu_torch.serving.engine.ServingEngine`
coalesces fixed-shape ``predict`` calls; autoregressive *decode* needs
more: a full-batch generator makes every request wait for the slowest
sequence in its batch and admits nothing mid-generation. This engine
removes that barrier:

- **Slotted KV cache** — ONE pre-allocated device buffer pair
  ``(slots, layers, cache_len, hidden)`` holds every live sequence's
  keys/values. A slot is a sequence's home for its whole generation;
  retiring frees the slot the same step.
- **Two programs** — a *prefill* program per declared prompt bucket
  (a parallel pass over the right-padded prompt writes a slot's cache and
  emits the first token) and ONE *step* program (one token for ALL slots
  per iteration, per-slot positions). Every program runs eagerly through a
  :class:`~paddle_tpu_torch.fluid.inference.Predictor`, and all of them
  share one device copy of the parameters.
- **Continuous batching** — a single dispatch thread interleaves the two:
  finished sequences (EOS or max-new) retire in flight and queued
  requests are prefilled into freed slots between steps; the other slots
  never stall on a barrier. The step always runs all ``slots`` rows, and
  every op is row-independent with per-slot masks, so a stream's tokens
  are bit-identical to the same prompt served alone through the same
  engine.
- **Streaming** — ``submit()`` returns a :class:`DecodeStream` whose
  ``tokens()`` generator yields each token as the step loop produces it.
  Cancelling a stream frees its slot at the next loop iteration.

Admission control mirrors the serving engine: a full queue fast-rejects
with :class:`~paddle_tpu_torch.serving.engine.ShedError` (with a
Retry-After hint from the observed retire rate), and a queued request
whose deadline expires is shed BEFORE its prefill with
:class:`~paddle_tpu_torch.serving.engine.DeadlineExceededError`.

Telemetry, under the JAX engine's names: ``serving.decode.slot_utilization``
/ ``serving.decode.cache_occupancy`` gauges,
``serving.decode.prefill_seconds`` / ``step_seconds`` /
``ttft_seconds`` / ``request_seconds`` histograms, and
``serving.decode.tokens`` / ``requests`` / ``retired`` / ``shed`` /
``deadline_miss`` / ``cancelled`` counters. A request submitted with a
sampled ``trace_ctx`` exports its ``decode.queue``, ``decode.prefill``,
per-token ``decode.token`` and ``decode.stream`` spans.

``barrier=True`` is the ablation mode benches compare against: slots are
only refilled once EVERY slot has retired — the classic full-batch
generation schedule, identical programs, no in-flight admission.

Disaggregation (:mod:`paddle_tpu_torch.serving.disagg`):

- ``kv_dtype="int8"`` keeps the resident cache as int8 payloads with one
  fp32 scale per (slot, layer, row) — ~4x the slots per device-memory
  budget — stepped by ``build_gpt_decode_step_q``, which dequantizes on
  entry and requantizes the whole cache on exit (the codec is idempotent
  on rows it did not write).
- ``role="decode"`` builds no prefill program: the replica only steps,
  and its slots are filled by :meth:`DecodeEngine.submit_prefilled` from
  a prefill replica's :class:`~paddle_tpu_torch.serving.disagg.kv_wire.
  KVHandoff`. The handoff's digest is verified before any row lands in a
  slot; an int8 handoff drops straight into int8 residency.

The ``dispatch`` fault site (``PADDLE_TPU_FAULT_SPEC``) fires in the
step, as in the JAX engine.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP.md item: the prefix pool, the session tier (``submit(session=)``)
and the speculative draft (Queue 1 item 7.4); the SDC sentinel,
``check_hbm_budget`` and ``check_ladder`` (item 11). The JAX engine's
lock-sanitizer hooks, executable-ledger feed and cost-model predictions
on spans wait for item 11 as well: the locks here are plain
``threading`` locks.
"""
import collections
import os
import queue
import threading
import time

import numpy as np
import torch

from .. import observability as obs
from ..fluid import core
from ..fluid import resilience as R
from .engine import DeadlineExceededError, EngineClosedError, ShedError

__all__ = ["DecodeEngine", "DecodeStream", "default_prompt_buckets",
           "kv_slot_bytes"]


def _later(what, item):
    return NotImplementedError(
        "%s is not ported yet: it comes with ROADMAP.md Queue 1 item %s"
        % (what, item))


def kv_slot_bytes(cfg, cache_len, kv_dtype="fp32"):
    """Device bytes ONE decode slot's KV cache pair occupies: int8
    residency pays 1 byte/element plus one fp32 scale per (layer, row)
    instead of 4 bytes/element."""
    if kv_dtype not in ("fp32", "int8"):
        raise ValueError("kv_dtype must be 'fp32' or 'int8', got %r"
                         % (kv_dtype,))
    n = int(cfg.num_layers) * int(cache_len) * int(cfg.hidden)
    if kv_dtype == "int8":
        rows = int(cfg.num_layers) * int(cache_len)
        return 2 * (n + rows * 4)
    return 2 * n * 4


def default_prompt_buckets(cache_len, smallest=8):
    """Pow2 prompt-length ladder up to ``cache_len`` (always at least
    one bucket)."""
    buckets = []
    b = min(int(smallest), int(cache_len))
    while b < cache_len:
        buckets.append(b)
        b *= 2
    buckets.append(int(cache_len))
    return tuple(sorted(set(buckets)))


class DecodeStream:
    """Streaming handle for one generation request.

    The dispatch thread feeds it; the caller either iterates
    :meth:`tokens` (per-token streaming) or blocks on :meth:`result` for
    the full list. ``finish_reason`` is ``"eos"`` / ``"length"`` /
    ``"cancelled"`` / ``"error"`` once done. :meth:`cancel` (idempotent,
    thread-safe) frees the request's slot at the dispatch loop's next
    iteration — or drops it from the queue if it never reached a slot."""

    # distributed-trace context of a sampled request (None otherwise)
    trace = None

    def __init__(self, prompt_len, max_new, stall_timeout_s=60.0):
        self.prompt_len = int(prompt_len)
        self.max_new = int(max_new)
        self.stall_timeout_s = float(stall_timeout_s)
        self.finish_reason = None
        self.t_submit = time.monotonic()
        self._q = queue.Queue()
        self._tokens = []
        self._done = threading.Event()
        self._cancelled = threading.Event()
        self._error = None

    # -- caller surface --------------------------------------------------
    @property
    def cancelled(self):
        return self._cancelled.is_set()

    @property
    def done(self):
        return self._done.is_set()

    def cancel(self):
        """Stop generating for this request (client went away)."""
        self._cancelled.set()

    def tokens(self, timeout=None):
        """Generator yielding token ids as the engine produces them.
        ``timeout`` bounds the wait for EACH token (default: the engine's
        request timeout); a stalled engine raises ``TimeoutError``, a
        failed request raises its error."""
        wait = self.stall_timeout_s if timeout is None else float(timeout)
        while True:
            try:
                kind, val = self._q.get(timeout=wait)
            except queue.Empty:
                raise TimeoutError(
                    "no token for %.1fs (generated %d so far)"
                    % (wait, len(self._tokens)))
            if kind == "tok":
                yield val
            elif kind == "err":
                raise val
            else:  # done
                return

    def result(self, timeout=None):
        """Block until generation finishes; returns the full token list
        (raises the request's error if it failed)."""
        wait = self.stall_timeout_s if timeout is None else timeout
        if not self._done.wait(wait):
            raise TimeoutError(
                "generation not done after %.1fs" % float(wait))
        if self._error is not None:
            raise self._error
        return list(self._tokens)

    def so_far(self):
        """Tokens generated so far (snapshot, no wait)."""
        return list(self._tokens)

    # -- engine surface --------------------------------------------------
    def _emit(self, tok):
        self._tokens.append(tok)
        self._q.put(("tok", tok))

    def _finish(self, reason):
        self.finish_reason = reason
        self._done.set()
        self._q.put(("done", reason))

    def _fail(self, exc):
        self._error = exc
        self.finish_reason = "error"
        self._done.set()
        self._q.put(("err", exc))


class _Request:
    __slots__ = ("prompt", "plen", "bucket", "max_new", "eos_id",
                 "deadline", "handle", "tenant", "priority", "trace",
                 "t_wall", "handoff")


class _Slot:
    __slots__ = ("handle", "remaining", "eos_id", "t_prefill", "trace",
                 "t_wall", "t_last")

    def __init__(self, handle, remaining, eos_id, trace=None):
        self.handle = handle
        self.remaining = remaining
        self.eos_id = eos_id
        self.t_prefill = time.monotonic()
        # sampled TraceContext of the span that filled this slot; the
        # per-token spans and the retire summary parent to it
        self.trace = trace
        self.t_wall = time.time() if trace is not None else None
        self.t_last = self.t_prefill


class DecodeEngine:
    """Continuous-batching decode engine over the GPT prefill and
    decode-step programs.

    ::

        eng = DecodeEngine(cfg, scope=trained_scope, slots=8,
                           cache_len=128, eos_id=2, name="gpt")
        eng.warmup()
        for tok in eng.submit(prompt_ids, max_new=64).tokens():
            ...

    ``scope`` is any name->value mapping holding the trained params (a
    ``fluid.Scope``, ``global_scope()`` after training, or a plain dict of
    arrays or tensors); :meth:`from_dir` loads a ``save_persistables`` /
    ``save_inference_model`` directory. The params are copied to the
    device ONCE (a snapshot: later training of the scope does not reach a
    running engine) and that one copy is shared by every program. The
    engine runs on the card unless ``place`` says otherwise."""

    engine_kind = "decode"

    def __init__(self, cfg, scope, slots=4, cache_len=64,
                 prompt_buckets=None, eos_id=None, queue_capacity=64,
                 default_max_new=32, default_deadline_ms=None,
                 request_timeout_s=60.0, name="default",
                 barrier=False, auto_start=True,
                 kv_dtype="fp32", role="colocated",
                 draft=None, prefix_pool=None, session_tier=None,
                 place=None):
        from .. import fluid
        from ..fluid.inference import Predictor
        from ..models.gpt import (build_gpt_decode_step,
                                  build_gpt_decode_step_q, build_gpt_prefill)

        if kv_dtype not in ("fp32", "int8"):
            raise ValueError("kv_dtype must be 'fp32' or 'int8', got %r"
                             % (kv_dtype,))
        if role not in ("colocated", "decode"):
            raise ValueError("role must be 'colocated' or 'decode', "
                             "got %r" % (role,))
        if draft is not None:
            raise _later("speculative decoding (draft=)", "7.4")
        if prefix_pool is not None:
            raise _later("the prefix pool (prefix_pool=)", "7.4")
        if session_tier is not None:
            raise _later("the session tier (session_tier=)", "7.4")
        self.cfg = cfg
        self.name = str(name)
        self.slots = int(slots)
        self.cache_len = int(cache_len)
        self.kv_dtype = str(kv_dtype)
        self.role = str(role)
        self.eos_id = eos_id
        self.default_max_new = int(default_max_new)
        self._default_deadline_ms = default_deadline_ms
        self.request_timeout_s = float(request_timeout_s)
        self.barrier = bool(barrier)
        self.place = place if place is not None else core.default_place()
        self.device = self.place.torch_device()
        if prompt_buckets is None:
            prompt_buckets = default_prompt_buckets(self.cache_len)
        self.prompt_buckets = tuple(sorted({int(b) for b in prompt_buckets}))
        if not self.prompt_buckets or self.prompt_buckets[0] < 1:
            raise ValueError("prompt_buckets must be positive ints")
        if self.prompt_buckets[-1] > self.cache_len:
            raise ValueError(
                "largest prompt bucket (%d) exceeds cache_len (%d)"
                % (self.prompt_buckets[-1], self.cache_len))

        # -- build the program pair (never touching the caller's
        # default_main_program) and share ONE device param set ---------
        build_step = (build_gpt_decode_step_q if self.kv_dtype == "int8"
                      else build_gpt_decode_step)
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            step_vars = build_step(cfg, self.cache_len)
            step_prog = fluid.default_main_program()
        prefill = {}
        if self.role != "decode":  # a pure decode replica never prefills
            for b in self.prompt_buckets:
                with fluid.program_guard(fluid.Program(), fluid.Program()):
                    pv = build_gpt_prefill(cfg, b, self.cache_len)
                    prefill[b] = (fluid.default_main_program(), pv)
        persist = {}
        for prog in [step_prog] + [p for p, _ in prefill.values()]:
            for v in prog.list_vars():
                if not getattr(v, "persistable", False) or v.name in persist:
                    continue
                if v.name not in scope:
                    raise KeyError(
                        "param %r required by the decode programs is "
                        "missing from the given scope — train the model "
                        "or load its persistables first" % v.name)
                persist[v.name] = _snapshot(scope[v.name], self.device)
        self._params = persist
        self._step_vars = step_vars
        self._step_pred = Predictor(
            step_prog, step_vars["feed_names"], step_vars["fetch_vars"],
            scope=persist, place=self.place)
        self._prefill_preds = {}
        self._prefill_vars = {}
        for b, (prog, pv) in prefill.items():
            self._prefill_preds[b] = Predictor(
                prog, pv["feed_names"], pv["fetch_vars"], scope=persist,
                place=self.place)
            self._prefill_vars[b] = pv

        # -- the persistent slot buffer pair + host-side slot state ----
        shape = (self.slots, cfg.num_layers, self.cache_len, cfg.hidden)
        cache_dtype = torch.int8 if self.kv_dtype == "int8" else torch.float32
        self._k = torch.zeros(shape, dtype=cache_dtype, device=self.device)
        self._v = torch.zeros(shape, dtype=cache_dtype, device=self.device)
        self._kscale = self._vscale = None
        if self.kv_dtype == "int8":
            sshape = shape[:-1] + (1,)
            self._kscale = torch.zeros(sshape, dtype=torch.float32,
                                       device=self.device)
            self._vscale = torch.zeros(sshape, dtype=torch.float32,
                                       device=self.device)
        self._tok = np.zeros((self.slots, 1), np.int64)
        self._pos = np.zeros((self.slots, 1), np.int64)
        self._slots = [None] * self.slots

        self._q = queue.Queue(maxsize=int(queue_capacity))
        self._stop_event = threading.Event()
        self._abort = False
        self._closed = False
        self._admit_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = collections.Counter()
        self._rate = collections.deque(maxlen=64)  # (t_done, 1) retires
        self._thread = None
        if auto_start:
            self.start()

    def attach_sentinel(self, sentinel, replica=None):
        raise _later("the SDC sentinel (attach_sentinel)", "11")

    # -- construction helpers -------------------------------------------
    @classmethod
    def from_dir(cls, cfg, dirname, filename=None, **kw):
        """Build from a ``save_persistables`` / ``save_params`` /
        ``save_inference_model`` directory (the ``.npz`` payload those
        writers produce, by either package)."""
        candidates = ([filename] if filename else
                      ["__persistables__.npz", "__params__.npz",
                       "__vars__.npz"])
        for fn in candidates:
            path = os.path.join(str(dirname), fn)
            if os.path.exists(path):
                with np.load(path, allow_pickle=False) as data:
                    params = {n: data[n] for n in data.files}
                return cls(cfg, params, **kw)
        raise FileNotFoundError(
            "no params payload (%s) under %r" % (", ".join(candidates),
                                                 dirname))

    # -- lifecycle -------------------------------------------------------
    def start(self):
        if self._closed:
            raise EngineClosedError("engine %r is closed" % self.name)
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="decode-dispatch-%s" % self.name)
            self._thread.start()
        return self

    def stop(self, drain=True, timeout=30.0):
        """Stop admitting work. ``drain=True`` finishes every live slot
        and queued request first; ``drain=False`` fails them with
        :class:`EngineClosedError`. Idempotent."""
        with self._admit_lock:
            self._closed = True
        if not drain:
            self._abort = True
        self._stop_event.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=max(0.1, float(timeout)))
        while True:  # no thread (or it died): fail leftovers loudly
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.handle._fail(EngineClosedError(
                "engine %r stopped before prefill" % self.name))
        for i, s in enumerate(self._slots):
            if s is not None:
                self._slots[i] = None
                s.handle._fail(EngineClosedError(
                    "engine %r stopped mid-generation" % self.name))
        obs.event("engine_stop", source="serving", count=False,
                  model=self.name, engine="decode", drained=bool(drain))

    # -- admission -------------------------------------------------------
    def _bucket_for(self, plen):
        for b in self.prompt_buckets:
            if b >= plen:
                return b
        return None

    def submit(self, prompt, max_new=None, eos_id=None, deadline_ms=None,
               tenant=None, priority=None, trace_ctx=None, session=None):
        """Enqueue one generation request; returns a
        :class:`DecodeStream`. Raises :class:`ShedError` when the queue
        is full, :class:`EngineClosedError` after ``stop()``, and
        ``ValueError`` for prompts that cannot fit the ladder.
        ``tenant``/``priority`` are carried for observability — the
        disagg router schedules on them; a lone engine records them.
        A sampled ``trace_ctx`` puts this request's queue/prefill/
        per-token spans into its distributed trace. ``session`` (a
        resumable conversation) comes with the session tier."""
        if self._closed:
            raise EngineClosedError(
                "engine %r is draining/stopped" % self.name)
        if self.role == "decode":
            raise RuntimeError(
                "engine %r is a decode-role (step-only) replica: it "
                "builds no prefill programs — hand it a prefilled KV "
                "cache via submit_prefilled()" % self.name)
        if session is not None:
            raise _later("resumable sessions (submit(session=))", "7.4")
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
                "(%d) — raise cache_len/prompt_buckets"
                % (plen, self.prompt_buckets[-1]))
        max_new = self.default_max_new if max_new is None else int(max_new)
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if plen + max_new - 1 > self.cache_len:
            raise ValueError(
                "context %d + max_new %d - 1 exceeds cache_len %d"
                % (plen, max_new, self.cache_len))
        req = _Request()
        req.prompt = prompt
        req.plen = plen
        req.bucket = bucket
        req.max_new = max_new
        req.eos_id = self.eos_id if eos_id is None else eos_id
        req.handoff = None
        return self._enqueue(req, deadline_ms, tenant, priority, trace_ctx)

    def _enqueue(self, req, deadline_ms, tenant, priority, trace_ctx):
        """Stamp the admission fields of a validated request and put it
        on the queue (shedding when it is full); returns its stream."""
        handoff = req.handoff is not None
        req.tenant = tenant
        req.priority = priority
        if deadline_ms is None:
            deadline_ms = self._default_deadline_ms
        req.deadline = (time.monotonic() + float(deadline_ms) / 1000.0
                        if deadline_ms is not None else None)
        sampled = trace_ctx is not None and trace_ctx.sampled
        req.trace = trace_ctx if sampled else None
        req.t_wall = time.time() if sampled else None
        req.handle = DecodeStream(
            req.plen, req.max_new, stall_timeout_s=self.request_timeout_s)
        req.handle.tenant = tenant
        req.handle.priority = priority
        req.handle.trace = req.trace
        try:
            with self._admit_lock:
                if self._closed:
                    raise EngineClosedError(
                        "engine %r is draining/stopped" % self.name)
                self._q.put_nowait(req)
        except queue.Full:
            self._bump("shed")
            obs.event("shed", source="serving", model=self.name,
                      engine="decode", prompt_len=req.plen,
                      queue_capacity=self._q.maxsize,
                      **({"handoff": True} if handoff else {}))
            raise ShedError(
                "decode queue full (%d) for model %r — %s shed"
                % (self._q.maxsize, self.name,
                   "handoff" if handoff else "request"),
                model=self.name, retry_after=self.retry_after_hint())
        self._bump("requests")
        obs.set_gauge("serving.queue_depth.%s" % self.name,
                      self._q.qsize())
        return req.handle

    def generate(self, prompt, max_new=None, eos_id=None,
                 deadline_ms=None, timeout=None):
        """Synchronous submit + wait; returns the full token list."""
        h = self.submit(prompt, max_new=max_new, eos_id=eos_id,
                        deadline_ms=deadline_ms)
        return h.result(
            timeout if timeout is not None else self.request_timeout_s)

    def submit_prefilled(self, handoff, max_new=None, eos_id=None,
                         deadline_ms=None, tenant=None, priority=None,
                         trace_ctx=None, session=None):
        """Enqueue a generation whose prefill already happened on
        another replica: ``handoff`` is a
        :class:`~paddle_tpu_torch.serving.disagg.kv_wire.KVHandoff` whose
        KV pair is adopted into a free slot (no prefill program runs here
        — works on ``role="decode"`` replicas). The stream's first token
        is the handoff's ``next_token``; ``max_new`` counts it, matching
        :meth:`submit` semantics, so a handoff at ``plen`` with
        ``max_new`` N delivers N tokens total. ``session`` comes with the
        session tier (ROADMAP.md Queue 1 item 7.4)."""
        if self._closed:
            raise EngineClosedError(
                "engine %r is draining/stopped" % self.name)
        if session is not None:
            raise _later("resumable sessions (submit_prefilled(session=))",
                         "7.4")
        expect = (self.cfg.num_layers, self.cache_len, self.cfg.hidden)
        if tuple(handoff.shape) != expect:
            raise ValueError(
                "handoff cache shape %r does not match this engine's "
                "geometry %r" % (tuple(handoff.shape), expect))
        plen = int(handoff.plen)
        if plen < 1 or plen > self.cache_len:
            raise ValueError("handoff plen %d outside [1, cache_len=%d]"
                             % (plen, self.cache_len))
        max_new = self.default_max_new if max_new is None else int(max_new)
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if plen + max_new - 1 > self.cache_len:
            raise ValueError(
                "handoff plen %d + max_new %d - 1 exceeds cache_len %d"
                % (plen, max_new, self.cache_len))
        req = _Request()
        req.prompt = np.asarray(handoff.prompt, np.int64).reshape(-1)
        req.plen = plen
        req.bucket = None
        req.max_new = max_new
        req.eos_id = self.eos_id if eos_id is None else eos_id
        req.handoff = handoff
        if trace_ctx is None:
            # the handoff's embedded context keeps the prefill-side
            # trace alive across a transport that dropped the kwarg
            trace_ctx = getattr(handoff, "trace", None)
        return self._enqueue(req, deadline_ms, tenant, priority, trace_ctx)

    def check_hbm_budget(self, budget_bytes=None):
        raise _later("the device-memory admission check "
                     "(check_hbm_budget)", "11")

    def check_ladder(self):
        raise _later("the ladder lint (check_ladder)", "11")

    def warmup(self, check_hbm=False):
        """Run the step program and every prompt-bucket prefill once (the
        first launch builds the CUDA kernels) on zero caches, without
        touching the engine's slots — a decode-role replica's whole
        ladder is the step. Returns the per-program report.
        ``check_hbm=True`` asks for :meth:`check_hbm_budget`, which is
        not ported yet."""
        if check_hbm:
            self.check_hbm_budget()
        report = []
        warm_feeds = {
            "gpt_step_tok": self._tok, "gpt_step_pos": self._pos,
            "gpt_step_k": torch.zeros_like(self._k),
            "gpt_step_v": torch.zeros_like(self._v)}
        if self.kv_dtype == "int8":
            warm_feeds["gpt_step_kscale"] = torch.zeros_like(self._kscale)
            warm_feeds["gpt_step_vscale"] = torch.zeros_like(self._vscale)
        source = self._step_pred.warm(warm_feeds)
        report.append({"program": "step", "slots": self.slots,
                       "cache_len": self.cache_len,
                       "kv_dtype": self.kv_dtype, "source": source})
        for b in sorted(self._prefill_preds):
            source = self._prefill_preds[b].warm({
                "gpt_prefill_ids": np.zeros((1, b), np.int64),
                "gpt_prefill_len": np.ones((1, 1), np.int64)})
            report.append({"program": "prefill", "bucket": b,
                           "source": source})
        obs.event(
            "warmup", source="serving", count=False, model=self.name,
            engine="decode", engines=len(report),
            compiled=sum(1 for r in report if r["source"] == "compile"),
            disk_warm=sum(1 for r in report if r["source"] == "disk"))
        return report

    # -- dispatch loop ---------------------------------------------------
    def _loop(self):
        while True:
            self._sweep_cancelled()
            self._admit()
            live = sum(1 for s in self._slots if s is not None)
            if self._abort:
                self._fail_all()
                return
            if live == 0:
                if self._stop_event.is_set() and self._q.empty():
                    return
                time.sleep(0.002)
                continue
            self._step()

    def _fail_all(self):
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.handle._fail(EngineClosedError(
                "engine %r stopped before prefill" % self.name))
        for i, s in enumerate(self._slots):
            if s is not None:
                self._retire(i, "error", error=EngineClosedError(
                    "engine %r stopped mid-generation" % self.name))

    def _sweep_cancelled(self):
        for i, s in enumerate(self._slots):
            if s is not None and s.handle.cancelled:
                self._retire(i, "cancelled")

    def _admit(self):
        """Prefill queued requests into free slots. In ``barrier`` mode
        (the full-batch baseline) admission waits until EVERY slot has
        retired."""
        if self.barrier and any(s is not None for s in self._slots):
            return
        for i in range(self.slots):
            if self._slots[i] is not None:
                continue
            req = None
            while req is None:
                try:
                    req = self._q.get_nowait()
                except queue.Empty:
                    obs.set_gauge(
                        "serving.queue_depth.%s" % self.name,
                        self._q.qsize())
                    return
                if req.handle.cancelled:
                    req.handle._finish("cancelled")
                    self._bump("cancelled")
                    req = None
                    continue
                now = time.monotonic()
                if req.deadline is not None and now > req.deadline:
                    # shed BEFORE prefill: no device time for an answer
                    # nobody is waiting for
                    self._bump("deadline_miss")
                    waited_ms = round(
                        1000 * (now - req.handle.t_submit), 3)
                    obs.event("deadline_miss", source="serving",
                              model=self.name, engine="decode",
                              waited_ms=waited_ms)
                    req.handle._fail(DeadlineExceededError(
                        "deadline expired after %s ms in decode queue "
                        "(model %r)" % (waited_ms, self.name)))
                    req = None
            self._fill_slot(i, req)
        obs.set_gauge("serving.queue_depth.%s" % self.name,
                      self._q.qsize())

    def _fill_slot(self, slot, req):
        """Route one admitted request onto its fill path: a remote
        handoff's adoption or the cold prefill (prefix hits and session
        resumes come with ROADMAP.md Queue 1 item 7.4)."""
        if req.handoff is not None:
            return self._adopt(slot, req)
        return self._prefill(slot, req)

    def _write_slot_cache(self, slot, k1, v1, ks=None, vs=None):
        """Install one sequence's cache pair into slot ``slot`` of the
        resident buffers, in place (the buffers stay where they are; the
        reference's donated ``dynamic_update_slice``). ``k1``/``v1`` are
        (1, L, T, H) in the engine's residency dtype, host arrays or
        tensors; int8 engines also take the (1, L, T, 1) fp32 scale
        pair."""
        pairs = [(self._k, k1), (self._v, v1)]
        if self.kv_dtype == "int8":
            pairs += [(self._kscale, ks), (self._vscale, vs)]
        with torch.inference_mode():
            for buf, val in pairs:
                if not isinstance(val, torch.Tensor):
                    # a handoff read off the wire is a read-only view
                    val = torch.from_numpy(
                        np.require(val, requirements=("C", "W")))
                buf[slot].copy_(val[0])

    def _trace_queue_span(self, req, now):
        """Export the (already finished) queue-wait span for a traced
        request; returns the context its work span should parent to."""
        ctx = req.trace.child()
        obs.export_span(
            "decode.queue", ctx, req.t_wall,
            now - req.handle.t_submit,
            {"proc": "decode:%s" % self.name, "tenant": req.tenant})
        return ctx

    def _prefill(self, slot, req):
        t0 = time.monotonic()
        ctx = (self._trace_queue_span(req, t0)
               if req.trace is not None else None)
        sp = None
        if ctx is not None:
            sp = obs.span("decode.prefill", ctx=ctx,
                          proc="decode:%s" % self.name, slot=slot,
                          bucket=req.bucket, plen=req.plen)
            sp.__enter__()
        ids = np.zeros((1, req.bucket), np.int64)
        ids[0, :req.plen] = req.prompt
        plen = np.asarray([[req.plen]], np.int64)
        try:
            nxt, k1, v1 = self._prefill_preds[req.bucket].run(
                {"gpt_prefill_ids": ids, "gpt_prefill_len": plen},
                return_numpy=False)
            if self.kv_dtype == "int8":
                # the prefill program stays fp32; quantize per row on the
                # way into the resident buffers (same codec as the wire)
                from .disagg import kv_wire

                kq, ks = kv_wire.quantize_rows(k1[0])
                vq, vs = kv_wire.quantize_rows(v1[0])
                self._write_slot_cache(slot, kq[None], vq[None],
                                       ks[None], vs[None])
            else:
                self._write_slot_cache(slot, k1, v1)
            tok = int(nxt[0, 0])
        except Exception as e:  # noqa: BLE001 — fail the request, not the loop
            if sp is not None:
                sp.__exit__(type(e), e, None)
            self._bump("prefill_errors")
            obs.event("prefill_error", source="serving", model=self.name,
                      error="%s: %s" % (type(e).__name__, str(e)[:200]))
            req.handle._fail(e)
            return
        if sp is not None:
            sp.__exit__(None, None, None)
        self._tok[slot, 0] = tok
        self._pos[slot, 0] = req.plen
        self._slots[slot] = _Slot(req.handle, req.max_new, req.eos_id,
                                  trace=sp.ctx if sp is not None else None)
        self._bump("prefill_rows_computed", req.bucket)
        now = time.monotonic()
        obs.observe("serving.decode.prefill_seconds", now - t0)
        obs.observe("serving.decode.ttft_seconds",
                    now - req.handle.t_submit)
        self._bump("prefills")
        self._emit(slot, tok)
        self._gauges()

    def _adopt(self, slot, req):
        """Install a remote prefill's :class:`KVHandoff` into a slot —
        the decode half of the disaggregated handoff. The digest is
        checked first; an int8 handoff whose block is the hidden width
        drops payload+scales straight into an int8-resident engine (no
        requantize); every other combination goes through fp32."""
        t0 = time.monotonic()
        h = req.handoff
        if req.trace is not None:
            self._trace_queue_span(req, t0)
        # the adopt span parents to the PREFILL side's span when the
        # handoff carries one — that's the cross-process flow arrow
        actx = getattr(h, "trace", None) or req.trace
        sp = None
        if actx is not None and actx.sampled:
            sp = obs.span("decode.adopt", ctx=actx,
                          proc="decode:%s" % self.name, slot=slot,
                          plen=req.plen, wire_dtype=h.wire_dtype,
                          wire_bytes=h.wire_bytes())
            sp.__enter__()
        try:
            # digest check FIRST: a corrupted handoff must fail the
            # inner stream here (the router's migration path then
            # re-prefills) — never install garbage into a slot
            if getattr(h, "digest", None) is not None:
                h.verify()
            if self.kv_dtype == "int8":
                if h.wire_dtype == "int8":
                    kq, ks = np.asarray(h.k, np.int8), h.k_scales
                    vq, vs = np.asarray(h.v, np.int8), h.v_scales
                else:
                    from .disagg import kv_wire

                    kd, vd = h.dense()
                    kq, ks = kv_wire.quantize_rows(kd)
                    vq, vs = kv_wire.quantize_rows(vd)
                self._write_slot_cache(
                    slot, kq[None], vq[None],
                    np.asarray(ks, np.float32)[None],
                    np.asarray(vs, np.float32)[None])
            else:
                kd, vd = h.dense()
                self._write_slot_cache(slot, kd[None], vd[None])
        except Exception as e:  # noqa: BLE001 — fail the request, not the loop
            if sp is not None:
                sp.__exit__(type(e), e, None)
            self._bump("adopt_errors")
            from ..integrity.digest import IntegrityError
            if isinstance(e, IntegrityError):
                obs.inc("integrity.handoff_digest_mismatch")
                obs.event("integrity_violation", source="serving",
                          model=self.name, check="kv_handoff",
                          op="adopt", tensor=e.tensor,
                          error=str(e)[:200])
            obs.event("adopt_error", source="serving", model=self.name,
                      error="%s: %s" % (type(e).__name__, str(e)[:200]))
            req.handle._fail(e)
            return
        if sp is not None:
            sp.__exit__(None, None, None)
        self._tok[slot, 0] = tok = int(h.next_token)
        self._pos[slot, 0] = req.plen
        self._slots[slot] = _Slot(req.handle, req.max_new, req.eos_id,
                                  trace=sp.ctx if sp is not None else None)
        obs.observe("serving.disagg.adopt_seconds", time.monotonic() - t0)
        self._bump("adopts")
        self._emit(slot, tok)
        self._gauges()

    def _step_feeds(self):
        feeds = {"gpt_step_tok": self._tok, "gpt_step_pos": self._pos,
                 "gpt_step_k": self._k, "gpt_step_v": self._v}
        if self.kv_dtype == "int8":
            feeds["gpt_step_kscale"] = self._kscale
            feeds["gpt_step_vscale"] = self._vscale
        return feeds

    def _emit(self, slot, tok):
        """Deliver one generated token to a slot's stream; retires the
        slot the SAME step when the sequence finishes (EOS or length)."""
        s = self._slots[slot]
        s.handle._emit(tok)
        s.remaining -= 1
        self._bump("tokens")
        obs.inc("serving.decode.tokens")
        if s.trace is not None:
            # one tiny span per generated token on a SAMPLED request:
            # dur is the inter-token gap (the per-token-p99 SLO leg)
            now = time.monotonic()
            gap = now - s.t_last
            s.t_last = now
            obs.export_span(
                "decode.token", s.trace.child(), time.time() - gap, gap,
                {"proc": "decode:%s" % self.name, "slot": slot,
                 "index": len(s.handle._tokens)})
        if s.eos_id is not None and tok == s.eos_id:
            self._retire(slot, "eos")
        elif s.remaining <= 0:
            self._retire(slot, "length")

    def _retire(self, slot, reason, error=None):
        s = self._slots[slot]
        self._slots[slot] = None
        self._tok[slot, 0] = 0
        self._pos[slot, 0] = 0
        if error is not None:
            s.handle._fail(error)
        else:
            s.handle._finish(reason)
        self._bump("retired")
        if reason == "cancelled":
            self._bump("cancelled")
        now = time.monotonic()
        obs.observe("serving.decode.request_seconds",
                    now - s.handle.t_submit)
        if s.trace is not None:
            obs.export_span(
                "decode.stream", s.trace.child(), s.t_wall,
                now - s.t_prefill,
                {"proc": "decode:%s" % self.name, "slot": slot,
                 "reason": reason, "tokens": len(s.handle._tokens)})
        with self._stats_lock:
            self._rate.append((now, 1))
        obs.event("slot_retired", source="serving", count=False,
                  model=self.name, slot=slot, reason=reason,
                  tokens=len(s.handle._tokens))

    def _step(self):
        t0 = time.monotonic()
        try:
            # chaos site: a 'slow' clause stalls the step in place; an
            # exception clause flows to the step_error path below
            R.fault_check("dispatch")
            # the step's outputs replace the resident buffers
            outs = self._step_pred.run(self._step_feeds(),
                                       return_numpy=False)
            if self.kv_dtype == "int8":
                (nxt, self._k, self._v, self._kscale,
                 self._vscale) = outs
            else:
                nxt, self._k, self._v = outs
            nxt_np = nxt.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — fail the slots, not the loop
            self._bump("step_errors")
            obs.event("step_error", source="serving", model=self.name,
                      error="%s: %s" % (type(e).__name__, str(e)[:200]))
            for i, s in enumerate(self._slots):
                if s is not None:
                    self._retire(i, "error", error=e)
            return
        obs.observe("serving.decode.step_seconds", time.monotonic() - t0)
        self._bump("steps")
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            tok = int(nxt_np[i, 0])
            self._pos[i, 0] += 1
            self._tok[i, 0] = tok
            self._emit(i, tok)
        self._gauges()

    def _gauges(self):
        live = sum(1 for s in self._slots if s is not None)
        obs.set_gauge("serving.decode.slot_utilization.%s" % self.name,
                      live / float(self.slots))
        occupancy = float(self._pos.sum()) / (self.slots * self.cache_len)
        obs.set_gauge("serving.decode.cache_occupancy.%s" % self.name,
                      occupancy)

    # -- introspection ---------------------------------------------------
    def _bump(self, key, n=1):
        with self._stats_lock:
            self._stats[key] += n
        # mirror every lifecycle counter into the hub so /metrics sees
        # the same numbers stats() reports ("tokens" incs at its own
        # site to keep the hot emit path one call)
        if key != "tokens":
            obs.inc("serving.decode.%s" % key, n)

    def stats(self):
        """Local lifetime counters: requests/tokens/prefills/adopts/
        steps/retired/shed/deadline_miss/cancelled/prefill_errors/
        adopt_errors/step_errors, plus ``kv_dtype`` and ``role``."""
        with self._stats_lock:
            out = dict(self._stats)
        for k in ("requests", "tokens", "prefills", "adopts", "steps",
                  "retired", "shed", "deadline_miss", "cancelled",
                  "prefill_errors", "adopt_errors", "step_errors",
                  "prefill_rows_computed"):
            out.setdefault(k, 0)
        out["live_slots"] = sum(1 for s in self._slots if s is not None)
        out["slots"] = self.slots
        out["kv_dtype"] = self.kv_dtype
        out["role"] = self.role
        return out

    def reuse_info(self):
        """KV-reuse + speculation state for ``/healthz`` (the registry's
        ``info()`` attaches it), in the JAX engine's shape: no draft,
        prefix pool or session tier attaches to the port's engine yet
        (ROADMAP.md Queue 1 item 7.4), so those read None and no prefill
        row is saved."""
        with self._stats_lock:
            computed = self._stats.get("prefill_rows_computed", 0)
        return {
            "draft": None,
            "spec_accept_rate": None,
            "prefix_pool": None,
            "session_tier": None,
            "prefill_rows_computed": computed,
            "prefill_rows_saved": 0,
            "prefill_rows_saved_pct": 0.0 if computed else None,
        }

    def slot_bytes(self):
        """Device bytes one slot's resident KV pair occupies (see
        :func:`kv_slot_bytes`)."""
        return kv_slot_bytes(self.cfg, self.cache_len, self.kv_dtype)

    def queue_depth(self):
        return self._q.qsize()

    def drain_rate(self):
        """Requests/sec retired over the recent window (None until the
        first retire, or after 30s idle)."""
        now = time.monotonic()
        with self._stats_lock:
            pts = [(t, n) for t, n in self._rate if now - t < 30.0]
        if not pts:
            return None
        span = max(1e-3, now - min(t for t, _ in pts))
        return sum(n for _, n in pts) / span

    def retry_after_hint(self):
        """Seconds until the queue likely drains at the observed retire
        rate (the HTTP 429 ``Retry-After``). Clamped to [1, 60]."""
        rate = self.drain_rate()
        if not rate:
            return 1.0
        return min(60.0, max(1.0, (self.queue_depth() + 1) / rate))

    @property
    def closed(self):
        return self._closed


def _snapshot(value, device):
    """A private copy of one parameter on `device`: a later update of the
    caller's scope (training on) never reaches the engine."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device=device, copy=True)
    return torch.tensor(np.asarray(value), device=device)
