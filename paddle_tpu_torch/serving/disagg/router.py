"""DisaggRouter: a phase-specialized, tenant-aware decode fleet (port of
paddle_tpu/serving/disagg/router.py).

Layered on the same elastic-heartbeat machinery as
:class:`~paddle_tpu_torch.serving.router.ServingRouter`, but the replicas
are no longer interchangeable: **prefill replicas**
(:class:`~.prefill.PrefillEngine`, bucketed prefill only) turn prompts
into serialized :class:`~.kv_wire.KVHandoff`\\ s, and **decode
replicas** (``DecodeEngine(role="decode")``, step only) adopt them
into slots and stream tokens. The split is the TTFT-vs-per-token-p99
fix: a long prompt burns a prefill engine, never a step loop.

- **Session affinity** — a stream is placed ONCE: the decode replica
  chosen at adoption (fewest live sessions wins) owns every subsequent
  step, because its slot holds the KV cache. There is no per-token
  routing decision to get wrong.
- **Migration via re-prefill** — when a decode replica dies mid-stream
  (silenced beacons or an :class:`EngineClosedError` out of its slot),
  the session's pump re-prefills ``prompt + so_far()`` on a prefill
  replica — greedy decode is deterministic, so the new handoff's first
  token is exactly the next token the dead replica would have emitted
  — and adopts the result on a surviving decode replica. Live streams
  complete token-for-token identical; ``serving.disagg.failed_streams``
  stays 0 through chaos.
- **Multi-tenant admission** — a :class:`~.tenancy.TenantTable` gates
  ``submit``: per-tenant live-session quotas shed with 429, the
  tenant's priority class orders the prefill queue, and the two SLO
  legs are scored separately (``ttft_slo_ms`` against queue-wait +
  prefill, ``per_token_slo_ms`` against inter-token gaps on the decode
  leg, both per tenant).

Scheduling reads the same signals the gauges publish: prefill
candidates order by queue depth (``serving.queue_depth.*``), decode
candidates by live-session count
(``serving.disagg.decode_sessions.*``).

Telemetry: ``serving.disagg.sessions`` / ``migrations`` /
``failed_streams`` / ``handoffs`` counters,
``serving.disagg.prefill_ttft_seconds`` / ``per_token_seconds`` (and
``per_token_seconds.<tenant>``) histograms,
``serving.disagg.slo_miss_ttft`` / ``slo_miss_per_token`` counters,
``serving.disagg.decode_sessions.<rid>`` gauges.

On one card every replica of :func:`disagg_fleet` shares the device (each
engine holds its own copy of the parameters); the engines run on the card
unless ``place`` says otherwise. Not ported yet: the SDC sentinel
(``attach_sentinel`` and ``quarantine_replica`` raise, naming ROADMAP.md
Queue 1 item 11). The JAX router's lock-sanitizer hooks wait for item 11
as well: the locks here are plain ``threading`` locks.
"""
import collections
import threading
import time

import numpy as np

from ... import observability as obs
from ...integrity.digest import IntegrityError
from ...parallel.elastic import ElasticConfig, HeartbeatMonitor, InMemoryStore
from ..decode import DecodeEngine, DecodeStream
from ..engine import EngineClosedError, ShedError
from ..router import NoReplicasError
from .prefill import PrefillEngine
from .tenancy import TenantTable, resolve_priority

__all__ = ["DisaggReplica", "DisaggRouter", "DisaggStream",
           "disagg_fleet"]


class _ReplicaLost(RuntimeError):
    """Internal: a decode replica died with this session on it."""

    def __init__(self, rid, cause):
        RuntimeError.__init__(self, "decode replica %d lost: %s"
                              % (rid, cause))
        self.rid = rid
        self.cause = cause


class DisaggStream(DecodeStream):
    """Router-level stream: survives the death of the replica serving
    it (the pump re-attaches underneath). Carries tenant/priority."""

    def __init__(self, prompt_len, max_new, stall_timeout_s=60.0,
                 tenant=None, priority=None):
        DecodeStream.__init__(self, prompt_len, max_new,
                              stall_timeout_s=stall_timeout_s)
        self.tenant = tenant
        self.priority = priority


class DisaggReplica:
    """One phase-specialized engine + its heartbeat beater (the
    LocalReplica pattern: silence IS death — :meth:`kill` stops the
    beacons without a goodbye, :meth:`stop` leaves cleanly)."""

    def __init__(self, rid, engine, store, name="default", config=None,
                 start_beating=True):
        self.rid = int(rid)
        self.engine = engine
        self.kind = getattr(engine, "engine_kind", "decode")
        self.name = str(name)
        self.config = config or ElasticConfig()
        self.monitor = HeartbeatMonitor(
            store, self.rid, world_size=1, config=self.config)
        self._beats = 0
        self._beat_stop = threading.Event()
        self._beater = None
        if start_beating:
            self.start_beating()

    def _beat_once(self):
        self._beats += 1
        rate = self.engine.drain_rate()
        depth = self.engine.queue_depth()
        extra = {"queue_depth": depth,
                 "model": self.name, "kind": self.kind}
        if obs.mode() != obs.OFF:
            # federation: the beacon carries this replica's metrics doc
            # so a FleetMetrics aggregator anywhere on the store can
            # merge the fleet without talking to engines directly
            try:
                extra["metrics"] = obs.replica_metrics_doc(
                    self.engine.stats(), queue_depth=depth)
            except Exception:  # noqa: BLE001 — beacons must not die
                pass
        self.monitor.beat(
            self._beats,
            latency=(1.0 / rate) if rate else None,
            extra=extra)

    def _beat_loop(self):
        interval = max(0.005, self.config.heartbeat_interval / 2.0)
        while not self._beat_stop.wait(interval):
            try:
                self._beat_once()
            except BaseException:  # noqa: BLE001 — cannot beat => dead
                return

    def start_beating(self):
        if self._beater is None or not self._beater.is_alive():
            self._beat_stop.clear()
            try:
                self._beat_once()
            except BaseException:  # noqa: BLE001
                return
            self._beater = threading.Thread(
                target=self._beat_loop, daemon=True,
                name="disagg-beat-%s-%d" % (self.name, self.rid))
            self._beater.start()

    def queue_depth(self):
        return self.engine.queue_depth()

    def stats(self):
        return self.engine.stats()

    def kill(self):
        """Simulated crash: beacons go silent, queued/live work fails
        so the router's pumps migrate it."""
        self._beat_stop.set()
        if self._beater is not None:
            self._beater.join(timeout=1.0)
        self.engine.stop(drain=False, timeout=0.2)

    def stop(self, drain=True, timeout=30.0):
        self.engine.stop(drain=drain, timeout=timeout)
        self._beat_stop.set()
        if self._beater is not None:
            self._beater.join(timeout=1.0)
        try:
            self.monitor.leave()
        except BaseException:  # noqa: BLE001 — best-effort goodbye
            pass


class _Session:
    __slots__ = ("prompt", "max_new", "eos_id", "spec", "priority",
                 "handle", "deadline_ms", "rid", "trace", "migration")

    def __init__(self, prompt, max_new, eos_id, spec, priority, handle,
                 deadline_ms, trace=None):
        self.prompt = prompt
        self.max_new = max_new
        self.eos_id = eos_id
        self.spec = spec
        self.priority = priority
        self.handle = handle
        self.deadline_ms = deadline_ms
        self.rid = None
        self.trace = trace       # TraceContext (sampled) or None
        self.migration = 0       # bumps on every re-prefill migration


class DisaggRouter:
    """Engine-duck-typed front door over a prefill fleet + a decode
    fleet (``submit``/``generate``/``stats``/``queue_depth``/``stop``
    — the registry and HTTP frontend drive it like one DecodeEngine).

    Build it with :func:`disagg_fleet`, or hand it replicas directly::

        router = DisaggRouter([pre0, pre1], [dec0, dec1],
                              store=store, tenants=table)
        for tok in router.submit(prompt, max_new=64,
                                 tenant="chat",
                                 priority="interactive").tokens():
            ...
    """

    engine_kind = "decode"

    def __init__(self, prefill_replicas, decode_replicas, store=None,
                 name="default", config=None, tenants=None,
                 request_timeout_s=120.0, max_migrations=3,
                 health_interval=None, auto_health=True):
        prefill_replicas = list(prefill_replicas)
        decode_replicas = list(decode_replicas)
        if not prefill_replicas or not decode_replicas:
            raise ValueError(
                "a disagg router needs >=1 prefill and >=1 decode "
                "replica")
        self.name = str(name)
        self.config = config or ElasticConfig()
        self.store = store if store is not None else InMemoryStore()
        self.tenants = tenants or TenantTable(model=self.name)
        self.request_timeout_s = float(request_timeout_s)
        self.max_migrations = int(max_migrations)
        self._lock = threading.RLock()
        self._prefill = {r.rid: r for r in prefill_replicas}
        self._decode = {r.rid: r for r in decode_replicas}
        if len(self._prefill) + len(self._decode) != (
                len(prefill_replicas) + len(decode_replicas)):
            raise ValueError("replica ids must be unique fleet-wide")
        self._dead = {}
        self._sessions = collections.defaultdict(set)  # rid -> handles
        self._pumps = set()
        self._counters = collections.Counter()
        self._closed = False
        # geometry/validation source: every decode replica was built
        # from the same cfg; the first one speaks for the fleet
        eng = decode_replicas[0].engine
        self.cfg = eng.cfg
        self.cache_len = eng.cache_len
        self.default_max_new = eng.default_max_new
        self.eos_id = eng.eos_id
        self._prompt_buckets = prefill_replicas[0].engine.prompt_buckets
        # observer monitor (worker -1 never beats, never counts)
        world = max(list(self._prefill) + list(self._decode)) + 1
        self.monitor = HeartbeatMonitor(
            self.store, -1, world_size=world, config=self.config)
        self._health_interval = (
            float(health_interval) if health_interval is not None
            else max(0.02, self.config.heartbeat_interval / 2.0))
        self._health_stop = threading.Event()
        self._health = None
        obs.set_gauge("serving.disagg.prefill_live", len(self._prefill))
        obs.set_gauge("serving.disagg.decode_live", len(self._decode))
        for c in ("sessions", "migrations", "failed_streams"):
            obs.inc("serving.disagg.%s" % c, 0)
        if auto_health:
            self.start_health()

    # -- admission -------------------------------------------------------
    def _bucket_for(self, plen):
        for b in self._prompt_buckets:
            if b >= plen:
                return b
        return None

    def submit(self, prompt, max_new=None, eos_id=None, deadline_ms=None,
               tenant=None, priority=None, trace_ctx=None):
        """Admit one generation session; returns a
        :class:`DisaggStream`. Sheds with 429 when the tenant is at
        quota or the prefill fleet is saturated; malformed priority
        raises ``ValueError`` (400 upstream). ``trace_ctx`` (a sampled
        :class:`~paddle_tpu_torch.observability.TraceContext`, e.g. from a
        ``traceparent`` header) threads one trace_id through the
        prefill leg, the KV handoff and every decode-side span."""
        if self._closed:
            raise EngineClosedError(
                "disagg router %r is draining/stopped" % self.name)
        prompt = np.asarray(prompt, dtype=np.int64).reshape(-1)
        plen = int(prompt.shape[0])
        if plen < 1:
            raise ValueError("empty prompt")
        if prompt.min() < 0 or prompt.max() >= self.cfg.vocab:
            raise ValueError(
                "prompt token out of range [0, %d)" % self.cfg.vocab)
        if self._bucket_for(plen) is None:
            raise ValueError(
                "prompt length %d exceeds the largest prompt bucket "
                "(%d)" % (plen, self._prompt_buckets[-1]))
        max_new = (self.default_max_new if max_new is None
                   else int(max_new))
        if max_new < 1:
            raise ValueError("max_new must be >= 1")
        if plen + max_new - 1 > self.cache_len:
            raise ValueError(
                "prompt_len %d + max_new %d - 1 exceeds cache_len %d"
                % (plen, max_new, self.cache_len))
        spec = self.tenants.acquire(tenant)   # ShedError at quota
        try:
            prio = resolve_priority(priority, default=spec.priority)
        except ValueError:
            self.tenants.release(tenant)
            raise
        handle = DisaggStream(
            plen, max_new, stall_timeout_s=self.request_timeout_s,
            tenant=spec.name, priority=prio)
        if trace_ctx is not None and getattr(trace_ctx, "sampled", False):
            handle.trace = trace_ctx
        else:
            trace_ctx = None
        sess = _Session(prompt, max_new,
                        self.eos_id if eos_id is None else eos_id,
                        spec, prio, handle, deadline_ms,
                        trace=trace_ctx)
        self._bump("sessions")
        obs.inc("serving.disagg.sessions")
        pump = threading.Thread(
            target=self._run_session, args=(sess,), daemon=True,
            name="disagg-session-%s" % self.name)
        with self._lock:
            self._pumps.add(pump)
        pump.start()
        return handle

    def generate(self, prompt, max_new=None, eos_id=None,
                 deadline_ms=None, tenant=None, priority=None,
                 timeout=None, trace_ctx=None):
        h = self.submit(prompt, max_new=max_new, eos_id=eos_id,
                        deadline_ms=deadline_ms, tenant=tenant,
                        priority=priority, trace_ctx=trace_ctx)
        return h.result(
            timeout if timeout is not None else self.request_timeout_s)

    # -- the per-session pump --------------------------------------------
    def _run_session(self, sess):
        try:
            handoff = self._prefill_leg(sess, sess.prompt)
            migrations = 0
            while True:
                try:
                    self._decode_leg(sess, handoff)
                    return
                except _ReplicaLost as lost:
                    migrations += 1
                    sess.migration = migrations
                    self._bump("migrations")
                    obs.inc("serving.disagg.migrations")
                    obs.event("session_migrated", source="serving",
                              model=self.name, replica=lost.rid,
                              tenant=sess.spec.name,
                              delivered=len(sess.handle.so_far()),
                              migration=migrations)
                    if migrations > self.max_migrations:
                        raise RuntimeError(
                            "session migrated %d times without "
                            "finishing (last: %s)"
                            % (migrations - 1, lost.cause))
                    handoff = self._replay_handoff(sess)
                    if handoff is None:
                        return  # delivered everything already
        except Exception as e:  # noqa: BLE001 — fail the stream, not silence
            if not sess.handle.done:
                self._bump("failed_streams")
                obs.inc("serving.disagg.failed_streams")
                obs.event("stream_failed", source="serving",
                          model=self.name, tenant=sess.spec.name,
                          error="%s: %s" % (type(e).__name__,
                                            str(e)[:200]))
                sess.handle._fail(e)
        finally:
            self.tenants.release(sess.spec.name)
            with self._lock:
                self._pumps.discard(threading.current_thread())

    def _replay_handoff(self, sess):
        """Rebuild a dead session's decode state by re-prefilling
        ``prompt + delivered`` — greedy determinism makes the new
        handoff's first token exactly the next undelivered token."""
        delivered = sess.handle.so_far()
        if sess.eos_id is not None and delivered and \
                delivered[-1] == sess.eos_id:
            sess.handle._finish("eos")
            return None
        if len(delivered) >= sess.max_new:
            sess.handle._finish("length")
            return None
        replay = np.concatenate(
            [sess.prompt, np.asarray(delivered, np.int64)])
        return self._prefill_leg(sess, replay)

    def _prefill_leg(self, sess, prompt):
        """Run one prefill on the least-loaded live prefill replica,
        failing over on dead/shedding replicas. Traced sessions get a
        ``disagg.prefill_leg`` span on the router track annotated with
        the migration count — a re-prefill after replica death shows up
        in the merged timeline under the ORIGINAL trace_id with
        ``migration >= 1``."""
        sp = None
        if sess.trace is not None:
            sp = obs.span(
                "disagg.prefill_leg", ctx=sess.trace,
                proc="router:%s" % self.name, tenant=sess.spec.name,
                plen=int(prompt.shape[0]), migration=sess.migration)
            sp.__enter__()
        try:
            handoff = self._prefill_leg_inner(
                sess, prompt, sp.ctx if sp is not None else None)
        except BaseException as e:
            if sp is not None:
                sp.__exit__(type(e), e, e.__traceback__)
            raise
        if sp is not None:
            sp.__exit__(None, None, None)
        return handoff

    def _prefill_leg_inner(self, sess, prompt, tctx):
        deadline = time.monotonic() + self.request_timeout_s
        tried_all_shed = 0.01
        while True:
            with self._lock:
                if self._closed:
                    raise EngineClosedError(
                        "disagg router %r stopped" % self.name)
                candidates = sorted(
                    self._prefill.values(),
                    key=lambda r: r.engine.queue_depth())
            if not candidates:
                raise NoReplicasError(
                    "no live prefill replicas for %r" % self.name)
            last_err = None
            for rep in candidates:
                try:
                    ticket = rep.engine.submit(
                        prompt, priority=sess.priority,
                        tenant=sess.spec.name,
                        deadline_ms=sess.deadline_ms,
                        trace_ctx=tctx)
                    handoff = ticket.result(self.request_timeout_s)
                    ttft_ms = 1000 * (time.monotonic()
                                      - ticket.t_submit)
                    if (sess.spec.ttft_slo_ms is not None
                            and ttft_ms > sess.spec.ttft_slo_ms):
                        obs.inc("serving.disagg.slo_miss_ttft")
                    return handoff
                except ShedError as e:
                    last_err = e
                    continue
                except (EngineClosedError, TimeoutError) as e:
                    last_err = e
                    self._mark_dead(rep.rid)
                    continue
            if time.monotonic() > deadline:
                raise last_err or NoReplicasError(
                    "every prefill replica shed for %r" % self.name)
            time.sleep(tried_all_shed)
            tried_all_shed = min(0.2, tried_all_shed * 2)

    def _decode_leg(self, sess, handoff):
        """Adopt the handoff on a decode replica (fewest live sessions
        — session affinity is set HERE, once) and pump its tokens into
        the router-level stream until the sequence finishes. Raises
        :class:`_ReplicaLost` if the replica dies underneath."""
        remaining = sess.max_new - len(sess.handle.so_far())
        hsp = None
        if sess.trace is not None:
            # the handoff span bridges the two processes: it parents to
            # the prefill-side span that encoded the KV (carried on the
            # handoff itself) so the merged timeline draws a flow arrow
            # prefill -> router -> decode under one trace_id
            hctx = getattr(handoff, "trace", None) or sess.trace
            hsp = obs.span(
                "disagg.handoff", ctx=hctx,
                proc="router:%s" % self.name,
                wire_dtype=handoff.wire_dtype,
                wire_bytes=handoff.wire_bytes(), plen=handoff.plen,
                migration=sess.migration)
            hsp.__enter__()
        try:
            rep, inner = self._adopt_on_decode(
                sess, handoff, remaining,
                hsp.ctx if hsp is not None else None)
        except BaseException as e:
            if hsp is not None:
                hsp.__exit__(type(e), e, e.__traceback__)
            raise
        if hsp is not None:
            hsp.__exit__(None, None, None)
        rid = rep.rid
        sess.rid = rid
        with self._lock:
            self._sessions[rid].add(sess.handle)
        obs.set_gauge("serving.disagg.decode_sessions.%d" % rid,
                      len(self._sessions[rid]))
        slo_s = (sess.spec.per_token_slo_ms / 1000.0
                 if sess.spec.per_token_slo_ms is not None else None)
        t_prev = time.monotonic()
        try:
            for tok in inner.tokens(timeout=self.request_timeout_s):
                if sess.handle.cancelled:
                    inner.cancel()
                now = time.monotonic()
                gap = now - t_prev
                t_prev = now
                obs.observe("serving.disagg.per_token_seconds", gap)
                obs.observe("serving.disagg.per_token_seconds.%s"
                            % sess.spec.name, gap)
                if slo_s is not None and gap > slo_s:
                    obs.inc("serving.disagg.slo_miss_per_token")
                sess.handle._emit(int(tok))
            if inner.finish_reason == "error":
                raise _ReplicaLost(rid, inner._error)
            sess.handle._finish(inner.finish_reason or "length")
        except IntegrityError as e:
            # corrupted handoff or an SDC-withheld step: the replica is
            # healthy — route through the migration path (re-prefill
            # from prompt + delivered) instead of failing the stream
            raise _ReplicaLost(rid, e)
        except (EngineClosedError, TimeoutError) as e:
            self._mark_dead(rid)
            raise _ReplicaLost(rid, e)
        finally:
            with self._lock:
                self._sessions[rid].discard(sess.handle)
            obs.set_gauge("serving.disagg.decode_sessions.%d" % rid,
                          len(self._sessions[rid]))

    def _adopt_on_decode(self, sess, handoff, remaining, tctx):
        """Place the handoff on the fewest-sessions live decode
        replica, failing over on shed/dead ones; returns
        ``(replica, inner_stream)``."""
        deadline = time.monotonic() + self.request_timeout_s
        backoff = 0.01
        while True:
            with self._lock:
                if self._closed:
                    raise EngineClosedError(
                        "disagg router %r stopped" % self.name)
                candidates = sorted(
                    self._decode.values(),
                    key=lambda r: len(self._sessions[r.rid]))
            if not candidates:
                raise NoReplicasError(
                    "no live decode replicas for %r" % self.name)
            inner = None
            lost = None
            for rep in candidates:
                try:
                    inner = rep.engine.submit_prefilled(
                        handoff, max_new=remaining, eos_id=sess.eos_id,
                        tenant=sess.spec.name, priority=sess.priority,
                        trace_ctx=tctx)
                    break
                except ShedError:
                    continue
                except EngineClosedError as e:
                    lost = e
                    self._mark_dead(rep.rid)
                    continue
            if inner is not None:
                return rep, inner
            if time.monotonic() > deadline:
                raise lost or ShedError(
                    "every decode replica shed for %r" % self.name,
                    model=self.name,
                    retry_after=self.retry_after_hint())
            time.sleep(backoff)
            backoff = min(0.2, backoff * 2)

    # -- health / membership ---------------------------------------------
    def start_health(self):
        if self._health is None or not self._health.is_alive():
            self._health_stop.clear()
            self._health = threading.Thread(
                target=self._health_loop, daemon=True,
                name="disagg-health-%s" % self.name)
            self._health.start()
        return self

    def _health_loop(self):
        while not self._health_stop.wait(self._health_interval):
            try:
                self._health_tick()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                obs.event("router_health_error", source="serving",
                          model=self.name,
                          error="%s: %s" % (type(e).__name__, e))

    def _health_tick(self):
        with self._lock:
            replicas = dict(self._prefill)
            replicas.update(self._decode)
        if not replicas:
            return
        members = set(replicas)
        for rid in self.monitor.dead_peers(members=members) & members:
            beater = getattr(replicas[rid], "_beater", None)
            stop = getattr(replicas[rid], "_beat_stop", None)
            if (beater is not None and beater.is_alive()
                    and stop is not None and not stop.is_set()):
                # in-process ground truth beats the heartbeat: the
                # beater thread exists and was not told to stop, so the
                # silence is scheduler starvation under load (GIL
                # contention), not death — killing a healthy replica
                # here would cascade migrations. kill() sets _beat_stop
                # first, so real kill drills still classify promptly.
                continue
            self._mark_dead(rid)

    def _mark_dead(self, rid):
        with self._lock:
            replica = self._prefill.pop(rid, None)
            kind = "prefill"
            if replica is None:
                replica = self._decode.pop(rid, None)
                kind = "decode"
            if replica is None:
                return
            self._dead[rid] = replica
            n_pre, n_dec = len(self._prefill), len(self._decode)
            orphans = len(self._sessions.get(rid, ()))
        self._bump("replica_dead")
        obs.inc("serving.disagg.replica_dead")
        obs.set_gauge("serving.disagg.prefill_live", n_pre)
        obs.set_gauge("serving.disagg.decode_live", n_dec)
        obs.event("replica_dead", source="serving", model=self.name,
                  replica=rid, phase=kind, sessions=orphans,
                  prefill_live=n_pre, decode_live=n_dec)
        # ensure the dead engine's streams fail fast so every orphaned
        # pump wakes up and migrates (kill() already did this when the
        # death was a simulated crash; an observed silence may not have)
        try:
            replica.engine.stop(drain=False, timeout=0.2)
        except BaseException:  # noqa: BLE001 — already dead is fine
            pass

    def kill_replica(self, rid):
        """Chaos helper: SIGKILL-equivalent on one replica (beacons go
        silent, its work fails, sessions migrate)."""
        with self._lock:
            replica = self._prefill.get(rid) or self._decode.get(rid)
        if replica is None:
            raise KeyError("no live replica %r" % (rid,))
        replica.kill()
        self._mark_dead(rid)

    # -- SDC sentinel (ROADMAP.md Queue 1 item 11) ----------------------
    def attach_sentinel(self, sentinel):
        from ..decode import _later

        raise _later("the SDC sentinel (attach_sentinel)", "11")

    def quarantine_replica(self, rid):
        from ..decode import _later

        raise _later("replica quarantine (quarantine_replica)", "11")

    # -- introspection / lifecycle ---------------------------------------
    def _bump(self, key, n=1):
        with self._lock:
            self._counters[key] += n

    def warmup(self, check_hbm=False):
        report = []
        with self._lock:
            pool = list(self._prefill.values()) + \
                list(self._decode.values())
        for rep in pool:
            if rep.kind == "decode":
                report += rep.engine.warmup(check_hbm=check_hbm)
            else:
                report += rep.engine.warmup()
        return report

    def stats(self):
        with self._lock:
            pool = (list(self._prefill.values())
                    + list(self._decode.values())
                    + list(self._dead.values()))
            out = collections.Counter()
            for rep in pool:
                try:
                    for k, v in rep.stats().items():
                        if isinstance(v, (int, float)):
                            out[k] += v
                except Exception:  # noqa: BLE001
                    continue
            out.update(self._counters)
            out["prefill_live"] = len(self._prefill)
            out["decode_live"] = len(self._decode)
            out["live_sessions"] = sum(
                len(s) for s in self._sessions.values())
        for k in ("sessions", "migrations", "failed_streams",
                  "replica_dead", "quarantined"):
            out.setdefault(k, 0)
        out["tenant_shed"] = sum(
            self.tenants.stats()["shed"].values())
        return dict(out)

    def reuse_info(self):
        """Fleet-wide KV-reuse snapshot: per-replica ``reuse_info()``
        docs plus summed redundant-prefill economics (no prefix pool,
        draft or session tier attaches until ROADMAP.md Queue 1 item
        7.4) —
        the ``reuse`` block ``/healthz`` shows for a published
        router."""
        with self._lock:
            pool = (list(self._prefill.values())
                    + list(self._decode.values()))
        replicas = {}
        computed = saved = 0
        for rep in pool:
            fn = getattr(rep.engine, "reuse_info", None)
            if not callable(fn):
                continue
            try:
                doc = fn()
            except Exception:  # noqa: BLE001 — health must not raise
                continue
            replicas[rep.rid] = doc
            computed += doc.get("prefill_rows_computed") or 0
            saved += doc.get("prefill_rows_saved") or 0
        return {
            "replicas": replicas,
            "prefill_rows_computed": computed,
            "prefill_rows_saved": saved,
            "prefill_rows_saved_pct": (
                100.0 * saved / float(saved + computed)
                if (saved + computed) else None),
        }

    # -- fleet metrics federation ----------------------------------------
    def fleet_metrics(self):
        """A :class:`~paddle_tpu_torch.observability.FleetMetrics` aggregator
        fed from the heartbeat table — every replica's beacon carries
        its metrics doc, so this works identically for in-process
        replicas and store-backed worker processes."""
        fm = obs.FleetMetrics()
        fm.ingest_beacons(self.monitor.table())
        return fm

    def fleet_render_prom(self, style=None):
        """Prometheus exposition of the federated fleet view (what
        ``/metrics?scope=fleet`` serves): merged ``fleet.*`` series
        plus per-tenant SLO burn-rate gauges."""
        fm = self.fleet_metrics()
        out = fm.render_prom(style=style)
        try:
            obs.SLOMonitor(self.tenants).tick(publish=True)
            slo = "\n".join(
                ln for ln in obs.render_prom().splitlines()
                if "fleet_slo_burn" in ln)
            if slo:
                out += slo + "\n"
        except Exception:  # noqa: BLE001 — metrics must not 500
            pass
        return out

    def queue_depth(self):
        with self._lock:
            return sum(r.engine.queue_depth()
                       for r in list(self._prefill.values())
                       + list(self._decode.values()))

    def live_replicas(self):
        """``(prefill_rids, decode_rids)`` of the live fleet — a
        membership view that does not depend on heartbeat beacons
        (the quarantine leg's last-replica guard uses it)."""
        with self._lock:
            return sorted(self._prefill), sorted(self._decode)

    def decode_latencies(self):
        """{rid: beacon latency seconds} for the live decode fleet —
        each replica's inverse drain rate as last published on its
        heartbeat. The autopilot's degraded-replica signal: a replica
        whose latency departs its own baseline (and its peers') is the
        kill+migrate candidate."""
        with self._lock:
            rids = set(self._decode)
        return {rid: lat
                for rid, lat in self.monitor.latencies(
                    members=rids).items()
                if rid in rids}

    def drain_rate(self):
        rates = []
        with self._lock:
            pool = list(self._decode.values())
        for rep in pool:
            try:
                r = rep.engine.drain_rate()
            except Exception:  # noqa: BLE001
                r = None
            if r:
                rates.append(r)
        return sum(rates) if rates else None

    def retry_after_hint(self):
        rate = self.drain_rate()
        if not rate:
            return 1.0
        return min(60.0, max(1.0, (self.queue_depth() + 1) / rate))

    @property
    def closed(self):
        return self._closed

    def stop(self, drain=True, timeout=30.0):
        with self._lock:
            self._closed = True
            pumps = list(self._pumps)
        self._health_stop.set()
        if self._health is not None and self._health.is_alive():
            self._health.join(timeout=1.0)
        if drain:
            end = time.monotonic() + float(timeout)
            for p in pumps:
                p.join(timeout=max(0.05, end - time.monotonic()))
        with self._lock:
            pool = (list(self._prefill.values())
                    + list(self._decode.values()))
        for rep in pool:
            rep.stop(drain=drain, timeout=timeout)
        obs.event("engine_stop", source="serving", count=False,
                  model=self.name, engine="disagg", drained=bool(drain))


def disagg_fleet(cfg, scope, n_prefill=2, n_decode=2, slots=4,
                 cache_len=64, prompt_buckets=None, kv_dtype="fp32",
                 wire_dtype="int8", tenants=None, name="default",
                 store=None, config=None, eos_id=None,
                 default_max_new=32, queue_capacity=64,
                 request_timeout_s=120.0, warm=False, place=None,
                 **router_kw):
    """Build a disaggregated fleet in-process: ``n_prefill`` prefill
    replicas + ``n_decode`` step-only decode replicas over one shared
    heartbeat store, fronted by a :class:`DisaggRouter`.

    ``kv_dtype="int8"`` makes the decode replicas int8-resident
    (~4x slots per device-memory budget); ``wire_dtype`` picks the handoff codec
    ("int8" compresses ~3.9x, "fp32" is lossless — what bit-identity
    tests pin). Every engine runs on the card unless ``place`` says
    otherwise."""
    store = store if store is not None else InMemoryStore()
    config = config or ElasticConfig(heartbeat_interval=0.05)
    prefills, decodes = [], []
    rid = 0
    for _ in range(int(n_prefill)):
        eng = PrefillEngine(
            cfg, scope, cache_len=cache_len,
            prompt_buckets=prompt_buckets,
            queue_capacity=queue_capacity, wire_dtype=wire_dtype,
            request_timeout_s=request_timeout_s,
            name="%s-pre%d" % (name, rid), place=place)
        prefills.append(DisaggReplica(rid, eng, store, name=name,
                                      config=config))
        rid += 1
    for _ in range(int(n_decode)):
        eng = DecodeEngine(
            cfg, scope, slots=slots, cache_len=cache_len,
            prompt_buckets=prompt_buckets, eos_id=eos_id,
            queue_capacity=queue_capacity,
            default_max_new=default_max_new,
            request_timeout_s=request_timeout_s,
            name="%s-dec%d" % (name, rid), kv_dtype=kv_dtype,
            role="decode", place=place)
        decodes.append(DisaggReplica(rid, eng, store, name=name,
                                     config=config))
        rid += 1
    router = DisaggRouter(
        prefills, decodes, store=store, name=name, config=config,
        tenants=tenants, request_timeout_s=request_timeout_s,
        **router_kw)
    if warm:
        router.warmup()
    return router
