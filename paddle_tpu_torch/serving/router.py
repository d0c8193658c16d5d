"""ServingRouter: one model spread across N ServingEngine replicas (port
of paddle_tpu/serving/router.py).

One engine's dispatch thread serves one model on one device; this module
makes the MODEL survive the replica. A
:class:`ServingRouter` wears the ServingEngine duck-type surface
(``submit`` / ``predict`` / ``stats`` / ``queue_depth`` / ``stop``) so
:meth:`~paddle_tpu_torch.serving.registry.ModelRegistry.publish` and the
HTTP frontend drive a fleet exactly like a single engine — and
underneath it is built from the elastic heartbeat machinery
(``parallel/elastic.py``): every replica publishes heartbeat beacons
(queue depth + model version riding the ``extra`` field) into a shared
:class:`~paddle_tpu_torch.parallel.elastic.HeartbeatStore`, and the
router's :class:`~paddle_tpu_torch.parallel.elastic.HeartbeatMonitor` —
a pure observer, never a member — classifies replicas dead or
straggling with the JAX package's silence/lag rules.

Replica flavors:

- :class:`LocalReplica` — in-process engine, optionally pinned to one
  card (``local_fleet(per_device=True)`` puts replica i on
  ``cuda:(i % torch.cuda.device_count())``; on one card every replica
  shares ``cuda:0``, each with its own copy of the parameters), beating
  into the shared store from a background thread. ``kill()`` simulates a crash: the beater goes silent (death
  IS silence — no clean 'left' beacon) and queued futures fail so the
  router replays them on survivors.
- :class:`StoreReplica` / :class:`ReplicaWorker` — the per-process
  pair: the router-side proxy serializes requests into FileStore
  namespaces (``serve/<model>/req/<rid>``), the worker process
  (``python -m paddle_tpu_torch.serving.router``, on the card unless
  given ``--place cpu``) drains them through its own ServingEngine and
  writes responses back. SIGKILL the worker and its
  beacons stop; the router's health loop fails the orphaned in-flight
  requests with :class:`ReplicaGoneError`, which the dispatch layer
  treats as "replay on the next replica".

Dispatch is least-loaded with shed-aware failover: candidates are the
live replicas ordered by (straggler?, queue depth), depth ties rotated
round-robin so an idle fleet still spreads load; a replica that
sheds (:class:`~.engine.ShedError`) or is draining just moves the
request to the next candidate, and when EVERY replica sheds the router
backs off exponentially and retries inside the request's deadline
budget before surfacing a fleet-wide ShedError (HTTP 429 upstream,
``Retry-After`` from the healthiest replica's drain rate). Retries are
safe because inference is idempotent — a request is only ever resolved
once, by whichever replica finishes it.

Lifecycle:

- **drain-then-kill preemption** — ``remove_replica(rid, drain=True)``
  unmaps the replica first (no new work), then ``stop(drain=True)``
  finishes its queue; an UNplanned death instead replays the queue on
  survivors via failover.
- **autoscale** — sustained queue pressure above ``scale_up_depth``
  activates a warm standby (already built + warmed, just not in the
  dispatch set); sustained idleness below ``scale_down_depth`` returns
  the most recently scaled-up replica to standby after its queue
  drains.
- **rolling reload** — ``rolling_reload(new_dirname)`` upgrades one
  replica at a time: quiesce (out of the dispatch set), drain, rebuild
  from the new version directory, probe (health gate), rejoin. Any
  build/probe failure rolls every already-upgraded replica back to the
  prior version and raises :class:`RolloutError` — no version limbo,
  and the other replicas served v_old the whole time (zero downtime).

Fault sites (``PADDLE_TPU_FAULT_SPEC``): ``dispatch`` fires per router
dispatch attempt, ``replica`` in LocalReplica admission — so
``replica:at=1:RuntimeError`` is a replica crash drill and
``replica:every=3:slow`` a brownout drill, both absorbed by failover.

Telemetry: ``serving.replicas_live`` / ``serving.rollout_state``
gauges, ``serving.failovers`` / ``serving.router_retry`` /
``serving.replica_dead`` counters, ``serving.dispatch_seconds``
histogram.

The JAX router's lock-sanitizer hooks wait for ROADMAP.md Queue 1 item
11: the locks here are plain ``threading`` locks.
"""
import collections
import itertools
import json
import os
import threading
import time
from concurrent.futures import Future, InvalidStateError

import numpy as np

from .. import observability as obs
from ..fluid import resilience as R
from ..parallel.elastic import (
    ElasticConfig, FileStore, HeartbeatMonitor, InMemoryStore,
)
from .engine import EngineClosedError, ServingEngine, ShedError

__all__ = [
    "LocalReplica", "NoReplicasError", "ReplicaGoneError", "ReplicaWorker",
    "RolloutError", "ServingRouter", "StoreReplica", "local_fleet",
    "make_engine_factory", "worker_main",
]


class NoReplicasError(RuntimeError):
    """The router has zero live replicas (HTTP 503 upstream — the
    frontend matches this class by name to avoid the import)."""


class ReplicaGoneError(RuntimeError):
    """A replica died with this request in flight; the router treats it
    as retryable and replays the request on a survivor.

    ``dump_paths`` lists any crash-dump files the dead worker
    advertised on its beacons — per-pid paths (see
    :func:`paddle_tpu_torch.observability.crash_dump_path`), so two workers
    crashing together never clobber one dump file."""

    def __init__(self, msg, dump_paths=()):
        RuntimeError.__init__(self, msg)
        self.dump_paths = tuple(dump_paths)


class RolloutError(RuntimeError):
    """A rolling reload failed and was rolled back (or could not be)."""


# ---------------------------------------------------------------------------
# wire format (StoreReplica <-> ReplicaWorker)
# ---------------------------------------------------------------------------


def _encode_array(a):
    a = np.asarray(a)
    return {"data": a.tolist(), "shape": list(a.shape),
            "dtype": str(a.dtype)}


def _decode_array(doc):
    return np.asarray(
        doc["data"], dtype=np.dtype(doc["dtype"])
    ).reshape([int(s) for s in doc["shape"]])


def _encode_feeds(feeds):
    return {str(k): _encode_array(v) for k, v in dict(feeds).items()}


def _decode_feeds(doc):
    return {k: _decode_array(v) for k, v in doc.items()}


def _decode_error(doc, rid, model):
    """Rebuild a typed exception from a worker's error response so the
    router's failover logic sees the same classes it would in-process.
    JSON float round-trips are exact for float32/float64, and these
    names are the whole retry contract."""
    from .engine import DeadlineExceededError

    name = doc.get("error")
    msg = "%s (replica %s of model %r)" % (doc.get("message", ""), rid, model)
    if name == "ShedError":
        return ShedError(msg, model=model, replica=rid,
                         retry_after=doc.get("retry_after"))
    if name == "EngineClosedError":
        return EngineClosedError(msg)
    if name == "DeadlineExceededError":
        return DeadlineExceededError(msg)
    return RuntimeError("%s: %s" % (name, msg))


# ---------------------------------------------------------------------------
# engine factories
# ---------------------------------------------------------------------------


def _place_for(device):
    """The fluid place of a torch device (or device string)."""
    import torch

    from ..fluid import core

    device = torch.device(device)
    if device.type == "cpu":
        return core.CPUPlace()
    if device.type != "cuda":
        raise ValueError("replicas run on a CUDA card or the CPU, not %r"
                         % (str(device),))
    return core.CUDAPlace(device.index if device.index is not None else 0)


def make_engine_factory(buckets=(), name="default", replica_id=None,
                        device=None, warm=True, predictor_opts=None,
                        **engine_opts):
    """A ``factory(dirname) -> ServingEngine`` closure for replica
    (re)builds. The predictor — its parameters and every launch — lives
    on ``device`` (a torch device) when one is given, else on
    ``predictor_opts["place"]``, else on the card (no card and no CPU
    place raises)."""

    def factory(dirname):
        from ..fluid.inference import Predictor

        opts = dict(predictor_opts or {})
        if device is not None and "place" not in opts:
            opts["place"] = _place_for(device)
        predictor = Predictor.from_model(str(dirname), **opts)
        engine = ServingEngine(
            predictor, buckets=buckets, name=str(name),
            replica_id=replica_id, **engine_opts)
        try:
            if warm:
                engine.warmup()
        except Exception:
            engine.stop(drain=False, timeout=1.0)
            raise
        return engine

    return factory


# ---------------------------------------------------------------------------
# replicas
# ---------------------------------------------------------------------------


class LocalReplica:
    """One in-process engine + its heartbeat beater.

    The beater publishes ``(queue_depth, version, model)`` in the
    beacon's ``extra`` field every half heartbeat interval; an injected
    ``heartbeat`` fault (or :meth:`kill`) silences it, which IS death
    as far as every observer is concerned."""

    kind = "local"

    def __init__(self, rid, factory, store, name="default", config=None,
                 dirname=None, start_beating=True):
        self.rid = int(rid)
        self.name = str(name)
        self.config = config or ElasticConfig()
        self._factory = factory
        self.dirname = str(dirname) if dirname is not None else None
        self.version = 1
        self.engine = factory(self.dirname)
        self.monitor = HeartbeatMonitor(
            store, self.rid, world_size=1, config=self.config)
        self._beats = 0
        self._beat_stop = threading.Event()
        self._beater = None
        if start_beating:
            self.start_beating()

    # -- heartbeat -------------------------------------------------------
    def _beat_once(self):
        self._beats += 1
        rate = self.engine.drain_rate()
        extra = {"queue_depth": self.engine.queue_depth(),
                 "version": self.version, "model": self.name,
                 "kind": "replica"}
        if obs.mode() != obs.OFF:
            # federation: beacons carry this replica's stats() doc so a
            # FleetMetrics aggregator can merge the fleet off the store
            try:
                extra["metrics"] = obs.replica_metrics_doc(
                    self.engine.stats(), queue_depth=extra["queue_depth"])
            except Exception:  # noqa: BLE001 — beacons must not die
                pass
        self.monitor.beat(
            self._beats,
            # per-request service time: the straggler classifier's
            # latency signal (a slow replica drains slowly)
            latency=(1.0 / rate) if rate else None,
            extra=extra)

    def _beat_loop(self):
        interval = max(0.005, self.config.heartbeat_interval / 2.0)
        while not self._beat_stop.wait(interval):
            try:
                self._beat_once()
            except BaseException:  # noqa: BLE001 — injected heartbeat fault
                return  # a replica that cannot beat is dead to the fleet

    def start_beating(self):
        if self._beater is None or not self._beater.is_alive():
            self._beat_stop.clear()
            try:
                self._beat_once()  # appear immediately, not one tick late
            except BaseException:  # noqa: BLE001
                return
            self._beater = threading.Thread(
                target=self._beat_loop, daemon=True,
                name="serving-beat-%s-%d" % (self.name, self.rid))
            self._beater.start()

    # -- engine surface --------------------------------------------------
    def submit(self, feeds, deadline_ms=None, trace_ctx=None):
        R.fault_check("replica")
        if trace_ctx is not None:
            return self.engine.submit(feeds, deadline_ms=deadline_ms,
                                      trace_ctx=trace_ctx)
        return self.engine.submit(feeds, deadline_ms=deadline_ms)

    def queue_depth(self):
        return self.engine.queue_depth()

    def stats(self):
        return self.engine.stats()

    def retry_after_hint(self):
        return self.engine.retry_after_hint()

    # -- lifecycle -------------------------------------------------------
    def reload(self, dirname):
        """Rebuild from `dirname` fully off to the side (the current
        engine keeps serving until the replacement is built + warmed),
        then swap; the old engine drains in the background."""
        new = self._factory(str(dirname))  # raises => no swap, no limbo
        old, self.engine = self.engine, new
        self.dirname = str(dirname)
        self.version += 1
        threading.Thread(
            target=old.stop, kwargs={"drain": True}, daemon=True,
            name="serving-drain-%s-r%d" % (self.name, self.rid)).start()
        return self.version

    def kill(self):
        """Simulated crash: silence the beacons (no 'left' — peers must
        infer death from the miss threshold) and fail everything queued
        so the router replays it on survivors."""
        self._beat_stop.set()
        if self._beater is not None:
            self._beater.join(timeout=1.0)
        self.engine.stop(drain=False, timeout=0.2)

    def stop(self, drain=True, timeout=30.0):
        """Planned removal: queued work finishes (``drain=True``), then
        the beater leaves cleanly so no observer counts this as death."""
        self.engine.stop(drain=drain, timeout=timeout)
        self._beat_stop.set()
        if self._beater is not None:
            self._beater.join(timeout=1.0)
        try:
            self.monitor.leave()
        except BaseException:  # noqa: BLE001 — best-effort goodbye
            pass


class StoreReplica:
    """Router-side proxy for a replica living in ANOTHER process,
    reached through the FileStore: requests land in
    ``serve/<model>/req/<rid>``, responses come back in
    ``serve/<model>/resp/<rid>``, control (reload/stop) goes through
    ``serve/<model>/ctl/<rid>`` and is acked in ``.../ack/<rid>``. A
    background poller resolves futures from the response namespace;
    :meth:`fail_inflight` is the router's hook for a worker that died
    mid-request."""

    kind = "store"

    def __init__(self, rid, store, name="default", config=None,
                 poll_interval=None):
        self.rid = int(rid)
        self.name = str(name)
        self.store = store
        self.config = config or ElasticConfig()
        self._poll = (float(poll_interval) if poll_interval is not None
                      else max(0.005, self.config.heartbeat_interval / 5.0))
        base = "serve/%s" % self.name
        self._req_ns = "%s/req/%d" % (base, self.rid)
        self._resp_ns = "%s/resp/%d" % (base, self.rid)
        self._ctl_ns = "%s/ctl/%d" % (base, self.rid)
        self._ack_ns = "%s/ack/%d" % (base, self.rid)
        self._seq = itertools.count(1)
        self._ctl_seq = itertools.count(1)
        self._lock = threading.Lock()
        self._pending = {}  # key -> Future
        self._closed = False
        self.version = 1
        self._poller = threading.Thread(
            target=self._poll_loop, daemon=True,
            name="serving-proxy-%s-%d" % (self.name, self.rid))
        self._poller.start()

    # -- engine surface --------------------------------------------------
    def submit(self, feeds, deadline_ms=None, trace_ctx=None):
        if self._closed:
            raise EngineClosedError(
                "replica proxy %d of %r is stopped" % (self.rid, self.name))
        key = "r%d-%d" % (os.getpid(), next(self._seq))
        fut = Future()
        with self._lock:
            self._pending[key] = fut
        doc = {"feeds": _encode_feeds(feeds),
               "deadline_ms": deadline_ms, "t": time.time()}
        if trace_ctx is not None and getattr(trace_ctx, "sampled", False):
            # the req mailbox carries the trace context across the
            # process boundary; the worker's span parents to it
            doc["trace"] = trace_ctx.to_doc()
        self.store.put(self._req_ns, key, doc)
        return fut

    def queue_depth(self):
        # outstanding = queued-or-running on the worker, as this side
        # knows it; good enough for least-loaded ordering
        with self._lock:
            return len(self._pending)

    def stats(self):
        with self._lock:
            return {"pending": len(self._pending)}

    def retry_after_hint(self):
        return None  # the worker's hint rides its ShedError responses

    # -- response poller -------------------------------------------------
    def _poll_loop(self):
        while not self._closed:
            try:
                self._drain_responses()
            except Exception:  # noqa: BLE001 — keep polling through blips
                pass
            time.sleep(self._poll)

    def _drain_responses(self):
        resp = self.store.all(self._resp_ns)
        if not resp:
            return
        with self._lock:
            ready = [(k, self._pending.pop(k))
                     for k in list(self._pending) if k in resp]
        for key, fut in ready:
            doc = resp[key]
            try:
                if doc.get("ok"):
                    fut.set_result(
                        [_decode_array(o) for o in doc["outputs"]])
                else:
                    fut.set_exception(
                        _decode_error(doc, self.rid, self.name))
            except InvalidStateError:
                pass
        # GC every response this proxy has fully consumed — including
        # late answers for requests fail_inflight() already replayed —
        # so the scan stays proportional to in-flight work, not to
        # lifetime traffic
        with self._lock:
            pending_now = set(self._pending)
        for key in resp:
            if key not in pending_now:
                self.store.delete(self._resp_ns, key)

    def fail_inflight(self, exc):
        """Fail every outstanding request (worker confirmed dead);
        returns how many — the router replays them on survivors."""
        with self._lock:
            doomed = list(self._pending.values())
            self._pending.clear()
        for fut in doomed:
            try:
                fut.set_exception(exc)
            except InvalidStateError:
                pass
        return len(doomed)

    # -- control ---------------------------------------------------------
    def _command(self, cmd, timeout, **fields):
        seq = next(self._ctl_seq)
        self.store.put(self._ctl_ns, "c%d" % seq,
                       dict(fields, cmd=cmd, seq=seq))
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            ack = self.store.all(self._ack_ns).get(str(seq))
            if ack is not None:
                return ack
            time.sleep(self._poll)
        return None

    def reload(self, dirname, timeout=120.0):
        """Ask the worker to rebuild from `dirname`; blocks on the ack."""
        ack = self._command("reload", timeout, dirname=str(dirname))
        if ack is None:
            raise RolloutError(
                "replica %d of %r did not ack reload within %.1fs"
                % (self.rid, self.name, timeout))
        if not ack.get("ok"):
            raise RolloutError(
                "replica %d of %r failed reload: %s"
                % (self.rid, self.name, ack.get("error")))
        self.version = int(ack.get("version", self.version + 1))
        return self.version

    def kill(self):  # parity with LocalReplica: drop the proxy side
        self._closed = True
        self.fail_inflight(ReplicaGoneError(
            "replica %d of %r killed" % (self.rid, self.name)))

    def stop(self, drain=True, timeout=30.0):
        ack = self._command("stop", timeout, drain=bool(drain))
        self._closed = True
        n = self.fail_inflight(EngineClosedError(
            "replica %d of %r stopped" % (self.rid, self.name)))
        if ack is None and n:
            obs.event("replica_stop_unacked", source="serving",
                      model=self.name, replica=self.rid, orphaned=n)


class ReplicaWorker:
    """The worker-process half of :class:`StoreReplica`: drains the
    request namespace through a local ServingEngine, writes responses
    back, beats with queue depth + version, and obeys reload/stop
    control commands. ``run_forever()`` is the process main loop."""

    def __init__(self, store, rid, factory, dirname, name="default",
                 config=None, poll_interval=None):
        self.store = store
        self.rid = int(rid)
        self.name = str(name)
        self.config = config or ElasticConfig()
        self._poll = (float(poll_interval) if poll_interval is not None
                      else max(0.005, self.config.heartbeat_interval / 5.0))
        self._factory = factory
        self.dirname = str(dirname)
        self.version = 1
        self.engine = factory(self.dirname)
        base = "serve/%s" % self.name
        self._req_ns = "%s/req/%d" % (base, self.rid)
        self._resp_ns = "%s/resp/%d" % (base, self.rid)
        self._ctl_ns = "%s/ctl/%d" % (base, self.rid)
        self._ack_ns = "%s/ack/%d" % (base, self.rid)
        self._seen = set()
        self._done_ctl = set()
        self._beats = 0
        self.monitor = HeartbeatMonitor(
            store, self.rid, world_size=1, config=self.config)
        # crash dump routing: $PADDLE_TPU_CRASH_DUMP names ONE file —
        # route this worker's dump to a per-pid sibling so two workers
        # crashing together never clobber each other, and advertise the
        # path on beacons (the router surfaces it in ReplicaGoneError)
        self._crash_dump = None
        if os.environ.get(obs.CRASH_DUMP_ENV):
            self._crash_dump = obs.crash_dump_path(per_pid=True)
            os.environ[obs.CRASH_DUMP_ENV] = self._crash_dump
        if obs.process_label() == "pid%d" % os.getpid():
            obs.set_process_label(
                "worker:%s-%d" % (self.name, self.rid))

    def _beat(self):
        self._beats += 1
        rate = self.engine.drain_rate()
        extra = {"queue_depth": self.engine.queue_depth(),
                 "version": self.version, "model": self.name,
                 "kind": "replica", "pid": os.getpid()}
        if self._crash_dump:
            extra["crash_dump"] = self._crash_dump
        if obs.mode() != obs.OFF:
            # federation: a worker process owns its whole telemetry
            # hub, so the beacon ships the full federation doc
            try:
                extra["metrics"] = obs.get_telemetry().federation_doc()
            except Exception:  # noqa: BLE001 — beacons must not die
                pass
        self.monitor.beat(
            self._beats, latency=(1.0 / rate) if rate else None,
            extra=extra)

    def _finish(self, key, fut, trace=None, t_wall=None):
        try:
            outs = fut.result()
            payload = {"ok": True,
                       "outputs": [_encode_array(o) for o in outs]}
        except BaseException as e:  # noqa: BLE001 — every failure goes on the wire
            payload = {"ok": False, "error": type(e).__name__,
                       "message": str(e),
                       "retry_after": getattr(e, "retry_after", None)}
        self.store.put(self._resp_ns, key, payload)
        if trace is not None and t_wall is not None:
            obs.export_span(
                "worker.predict", trace, t_wall, time.time() - t_wall,
                {"replica": self.rid, "ok": payload["ok"],
                 "error": payload.get("error")})

    def _take_requests(self):
        reqs = self.store.all(self._req_ns)
        fresh = sorted(
            (k for k in reqs if k not in self._seen),
            key=lambda k: (reqs[k].get("t", 0.0), k))
        for key in fresh:
            self._seen.add(key)
            doc = reqs[key]
            # consumed: GC the mailbox entry so sustained traffic does
            # not grow every later poll's scan (the proxy side recovers
            # lost work from heartbeats, not from the request file)
            self.store.delete(self._req_ns, key)
            trace = obs.TraceContext.from_doc(doc.get("trace"))
            trace = trace.child() if trace is not None else None
            t_wall = time.time() if trace is not None else None
            try:
                fut = self.engine.submit(
                    _decode_feeds(doc["feeds"]),
                    deadline_ms=doc.get("deadline_ms"))
            except BaseException as e:  # noqa: BLE001 — shed/closed/bad feeds
                self.store.put(self._resp_ns, key, {
                    "ok": False, "error": type(e).__name__,
                    "message": str(e),
                    "retry_after": getattr(e, "retry_after", None)})
                continue
            fut.add_done_callback(
                lambda f, key=key, tr=trace, tw=t_wall:
                self._finish(key, f, trace=tr, t_wall=tw))

    def _take_control(self):
        """Returns False once a stop command was obeyed."""
        ctl = self.store.all(self._ctl_ns)
        for key in sorted(ctl, key=lambda k: ctl[k].get("seq", 0)):
            doc = ctl[key]
            seq = doc.get("seq")
            if seq in self._done_ctl:
                continue
            self._done_ctl.add(seq)
            if doc.get("cmd") == "reload":
                try:
                    new = self._factory(doc["dirname"])
                except Exception as e:  # noqa: BLE001 — build failed: no swap
                    self.store.put(self._ack_ns, str(seq), {
                        "ok": False,
                        "error": "%s: %s" % (type(e).__name__, e)})
                    continue
                old, self.engine = self.engine, new
                self.dirname = str(doc["dirname"])
                self.version += 1
                threading.Thread(
                    target=old.stop, kwargs={"drain": True},
                    daemon=True).start()
                self._beat()  # advertise the new version immediately
                self.store.put(self._ack_ns, str(seq),
                               {"ok": True, "version": self.version})
            elif doc.get("cmd") == "stop":
                self.engine.stop(drain=bool(doc.get("drain", True)))
                self.store.put(self._ack_ns, str(seq), {"ok": True})
                self.monitor.leave()
                return False
        return True

    def run_forever(self):
        last_beat = 0.0
        beat_every = max(0.005, self.config.heartbeat_interval / 2.0)
        while True:
            now = time.monotonic()
            if now - last_beat >= beat_every:
                self._beat()
                last_beat = now
            self._take_requests()
            if not self._take_control():
                return
            time.sleep(self._poll)


# ---------------------------------------------------------------------------
# the router
# ---------------------------------------------------------------------------


class ServingRouter:
    """N replicas behind one ServingEngine-shaped surface (see module
    docstring for the dispatch / health / autoscale / rollout story)."""

    def __init__(self, replicas, store, name=None, config=None, standby=(),
                 dirname=None, max_retries=3, retry_base_s=0.05,
                 request_timeout_s=60.0, min_replicas=1,
                 scale_up_depth=8, scale_down_depth=1, scale_window_s=1.0,
                 health_interval=None, start_health=True):
        if not replicas:
            raise ValueError("a router needs at least one replica")
        self.name = str(name if name is not None else replicas[0].name)
        self.config = config or ElasticConfig()
        self.store = store
        self.dirname = str(dirname) if dirname is not None else None
        self.max_retries = int(max_retries)
        self.retry_base_s = float(retry_base_s)
        self.request_timeout_s = float(request_timeout_s)
        self.min_replicas = int(min_replicas)
        self.scale_up_depth = int(scale_up_depth)
        self.scale_down_depth = int(scale_down_depth)
        self.scale_window_s = float(scale_window_s)
        self._lock = threading.RLock()
        self._live = {r.rid: r for r in replicas}
        self._standby = list(standby)
        self._dead = {}
        self._scaled_up = []      # rids activated by pressure (LIFO)
        self._stragglers = set()
        self._rr = 0              # round-robin cursor for depth ties
        self._pressure = collections.deque()
        self._closed = False
        self._inflight = set()
        self._inflight_lock = threading.Lock()
        self._counters = collections.Counter()
        self._rollout_lock = threading.Lock()
        # observer only: worker_index -1 never beats, never counts as a
        # member — it just reads the replica beacon table
        self.monitor = HeartbeatMonitor(
            store, -1, world_size=max(self._live) + 1, config=self.config)
        self._health_interval = (
            float(health_interval) if health_interval is not None
            else max(0.02, self.config.heartbeat_interval / 2.0))
        self._health_stop = threading.Event()
        self._health = None
        obs.set_gauge("serving.replicas_live", len(self._live))
        obs.set_gauge("serving.rollout_state", 0)
        # pre-register the fleet counters so /metrics shows them at 0
        # from the first scrape instead of only after the first incident
        for name in ("failovers", "router_retry", "replica_dead"):
            obs.inc("serving.%s" % name, 0)
        if start_health:
            self.start_health()

    # -- introspection surface (engine duck type) ------------------------
    @property
    def closed(self):
        return self._closed

    def queue_depth(self):
        with self._lock:
            return sum(r.queue_depth() for r in self._live.values())

    def replicas_live(self):
        with self._lock:
            return sorted(self._live)

    def stats(self):
        """Fleet-aggregate engine counters + router-level counters."""
        with self._lock:
            pool = list(self._live.values()) + list(self._standby) \
                + list(self._dead.values())
            out = collections.Counter()
            for r in pool:
                try:
                    for k, v in r.stats().items():
                        if isinstance(v, (int, float)):
                            out[k] += v
                except Exception:  # noqa: BLE001 — dead proxies can't count
                    continue
            out.update(self._counters)
            out["replicas_live"] = len(self._live)
            out["replicas_standby"] = len(self._standby)
            return dict(out)

    def retry_after_hint(self):
        with self._lock:
            hints = []
            for r in self._live.values():
                try:
                    h = r.retry_after_hint()
                except Exception:  # noqa: BLE001
                    h = None
                if h:
                    hints.append(float(h))
        return min(hints) if hints else 1.0

    # -- dispatch --------------------------------------------------------
    def submit(self, feeds, deadline_ms=None, trace_ctx=None):
        """Engine-compatible: returns ONE future the caller holds while
        the router moves the request between replicas underneath.
        ``trace_ctx`` (a sampled TraceContext) rides the dispatch to
        the chosen replica — across the FileStore wire for worker
        processes."""
        if self._closed:
            raise EngineClosedError(
                "router %r is draining/stopped" % self.name)
        t0 = time.monotonic()
        budget = (float(deadline_ms) / 1000.0 if deadline_ms is not None
                  else self.request_timeout_s)
        if trace_ctx is not None and not getattr(trace_ctx, "sampled",
                                                 False):
            trace_ctx = None
        state = {"feeds": feeds, "deadline_ms": deadline_ms,
                 "future": Future(), "t0": t0, "t_deadline": t0 + budget,
                 "tried": set(), "rounds": 0, "trace": trace_ctx}
        with self._inflight_lock:
            self._inflight.add(state["future"])
        state["future"].add_done_callback(self._forget)
        self._bump("router_requests")
        self._dispatch(state)  # ValueError/KeyError (bad feeds) raise here
        return state["future"]

    def predict(self, feeds, deadline_ms=None, timeout=None):
        fut = self.submit(feeds, deadline_ms=deadline_ms)
        return fut.result(
            timeout if timeout is not None else self.request_timeout_s)

    def _forget(self, fut):
        with self._inflight_lock:
            self._inflight.discard(fut)

    def _candidates(self, tried):
        """Live replicas this request has not tried, least-loaded
        first; depth ties rotate round-robin so an idle fleet spreads
        even a strictly serial stream instead of funnelling every
        request at the lowest rid; flagged stragglers sort behind
        healthy peers."""
        with self._lock:
            reps = [r for r in self._live.values() if r.rid not in tried]
            if reps:
                k = self._rr % len(reps)
                self._rr += 1
                reps = reps[k:] + reps[:k]
            pool = [(r.rid in self._stragglers, r.queue_depth(), r)
                    for r in reps]
        pool.sort(key=lambda t: t[:2])  # stable: ties keep rotation
        return [r for *_, r in pool]

    def _dispatch(self, state):
        try:
            R.fault_check("dispatch")
        except Exception:  # noqa: BLE001 — injected blip: transient, retry
            self._retry_later(state)
            return
        for replica in self._candidates(state["tried"]):
            try:
                if state.get("trace") is not None:
                    try:
                        fut = replica.submit(
                            state["feeds"],
                            deadline_ms=state["deadline_ms"],
                            trace_ctx=state["trace"])
                    except TypeError:
                        # duck-typed replica without the kwarg: the
                        # request matters more than its trace
                        fut = replica.submit(
                            state["feeds"],
                            deadline_ms=state["deadline_ms"])
                else:
                    fut = replica.submit(
                        state["feeds"], deadline_ms=state["deadline_ms"])
            except (ValueError, KeyError):
                raise  # malformed request: permanent, caller's problem
            except Exception:  # noqa: BLE001 — shed/closed/injected: next
                state["tried"].add(replica.rid)
                self._bump("failovers")
                obs.inc("serving.failovers")
                continue
            obs.observe("serving.dispatch_seconds",
                        time.monotonic() - state["t0"])
            fut.add_done_callback(
                lambda f, rid=replica.rid: self._on_replica_done(
                    state, rid, f))
            return
        self._retry_later(state)  # everyone shed (or nobody's live)

    def _retry_later(self, state):
        now = time.monotonic()
        with self._lock:
            n_live = len(self._live)
        out_of_budget = (state["rounds"] >= self.max_retries
                         or now >= state["t_deadline"] or self._closed)
        if out_of_budget:
            if n_live == 0:
                exc = NoReplicasError(
                    "model %r has no live replicas" % self.name)
            else:
                exc = ShedError(
                    "all %d replica(s) of %r shed across %d attempt(s)"
                    % (n_live, self.name, state["rounds"] + 1),
                    model=self.name,
                    retry_after=self.retry_after_hint())
            self._fail(state, exc)
            return
        state["rounds"] += 1
        state["tried"] = set()  # new round: everyone eligible again
        self._bump("router_retry")
        obs.inc("serving.router_retry")
        delay = min(self.retry_base_s * (2 ** (state["rounds"] - 1)),
                    max(0.001, state["t_deadline"] - now), 1.0)
        timer = threading.Timer(delay, self._redispatch, args=(state,))
        timer.daemon = True
        timer.start()

    def _redispatch(self, state):
        if state["future"].done():
            return
        if self._closed:
            self._fail(state, EngineClosedError(
                "router %r stopped mid-retry" % self.name))
            return
        try:
            self._dispatch(state)
        except Exception as e:  # noqa: BLE001 — timer thread: fail the future
            self._fail(state, e)

    def _on_replica_done(self, state, rid, fut):
        pub = state["future"]
        if pub.done():
            return
        exc = fut.exception()
        if exc is None:
            try:
                pub.set_result(fut.result())
            except InvalidStateError:
                pass
            return
        if isinstance(exc, (ShedError, EngineClosedError,
                            ReplicaGoneError)):
            # the replica bailed, the request did not run: replay it
            self._bump("failovers")
            obs.inc("serving.failovers")
            # count=False: serving.failovers (inc'd above) is the one
            # canonical counter — it also covers submit-time sheds,
            # which steer without an event
            obs.event("failover", source="serving", count=False,
                      model=self.name, replica=rid,
                      error=type(exc).__name__)
            state["tried"].add(rid)
            try:
                self._dispatch(state)
            except Exception as e:  # noqa: BLE001
                self._fail(state, e)
        else:
            # model error or expired deadline: retrying can't help
            try:
                pub.set_exception(exc)
            except InvalidStateError:
                pass

    def _fail(self, state, exc):
        try:
            state["future"].set_exception(exc)
        except InvalidStateError:
            pass

    def _bump(self, key, n=1):
        with self._lock:
            self._counters[key] += n

    # -- health / membership ---------------------------------------------
    def start_health(self):
        if self._health is None or not self._health.is_alive():
            self._health_stop.clear()
            self._health = threading.Thread(
                target=self._health_loop, daemon=True,
                name="serving-router-health-%s" % self.name)
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
            members = set(self._live)
        if members:
            for rid in self.monitor.dead_peers(members=members) & members:
                self._mark_dead(rid)
            with self._lock:
                members = set(self._live)
            # step_lag=False: replica beats count from each process's
            # start, not a shared training step — lag is meaningless
            # here and would pin late-built replicas behind forever
            self._stragglers = (
                self.monitor.stragglers(members=members, step_lag=False)
                if len(members) >= 2 else set())
        obs.set_gauge("serving.queue_depth.%s" % self.name,
                      self.queue_depth())
        self._autoscale_tick()

    def _mark_dead(self, rid):
        with self._lock:
            replica = self._live.pop(rid, None)
            if replica is None:
                return
            self._dead[rid] = replica
            if rid in self._scaled_up:
                self._scaled_up.remove(rid)
            n_live = len(self._live)
        self._bump("replica_dead")
        obs.set_gauge("serving.replicas_live", n_live)
        dumps = []
        try:
            table = self.monitor.table()
            beacon = table.get(rid, table.get(str(rid)))
            if isinstance(beacon, dict) and beacon.get("crash_dump"):
                dumps.append(str(beacon["crash_dump"]))
        except Exception:  # noqa: BLE001 — diagnostics only
            pass
        replayed = 0
        fail = getattr(replica, "fail_inflight", None)
        if fail is not None:
            # orphaned in-flight requests come back through
            # _on_replica_done as ReplicaGoneError -> replayed
            replayed = fail(ReplicaGoneError(
                "replica %d of %r died mid-request (missed %d beacons)%s"
                % (rid, self.name, self.config.miss_threshold,
                   " — crash dump: %s" % ", ".join(dumps)
                   if dumps else ""),
                dump_paths=dumps))
        obs.event("replica_dead", source="serving", model=self.name,
                  replica=rid, replayed=replayed, live=n_live,
                  crash_dump=dumps[0] if dumps else None)
        self._activate_standby(reason="replace_dead")

    def _activate_standby(self, reason, scaled=False):
        with self._lock:
            if not self._standby:
                return None
            replica = self._standby.pop(0)
            self._live[replica.rid] = replica
            if scaled:
                self._scaled_up.append(replica.rid)
            n_live = len(self._live)
        obs.set_gauge("serving.replicas_live", n_live)
        obs.event("replica_activate", source="serving", model=self.name,
                  replica=replica.rid, reason=reason, live=n_live)
        return replica

    def scale_up(self, reason="manual"):
        """Activate one warm standby into the dispatch set NOW —
        the operator/autopilot override of the sustained-pressure
        autoscaler. The replica counts as scaled-up, so the autoscaler
        parks it back once pressure subsides. Returns the activated
        replica, or None when no standby is available."""
        replica = self._activate_standby(reason=str(reason), scaled=True)
        if replica is not None:
            self._pressure.clear()
        return replica

    def _autoscale_tick(self):
        now = time.monotonic()
        with self._lock:
            live = list(self._live.values())
            depth = (sum(r.queue_depth() for r in live) / len(live)
                     if live else 0.0)
        self._pressure.append((now, depth))
        while self._pressure and \
                now - self._pressure[0][0] > self.scale_window_s:
            self._pressure.popleft()
        if len(self._pressure) < 3 or \
                now - self._pressure[0][0] < 0.75 * self.scale_window_s:
            return  # not enough window yet: pressure must be SUSTAINED
        samples = [d for _, d in self._pressure]
        if min(samples) >= self.scale_up_depth:
            if self._activate_standby(reason="pressure",
                                      scaled=True) is not None:
                self._pressure.clear()
        elif max(samples) <= self.scale_down_depth:
            self._scale_down()

    def _scale_down(self):
        with self._lock:
            if not self._scaled_up or len(self._live) <= self.min_replicas:
                return
            rid = self._scaled_up.pop()
            replica = self._live.pop(rid, None)
            n_live = len(self._live)
        if replica is None:
            return
        obs.set_gauge("serving.replicas_live", n_live)
        # warm parkback: wait out its queue (it is out of the dispatch
        # set, so the depth only falls), keep the engine running
        deadline = time.monotonic() + 2.0
        while replica.queue_depth() > 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        with self._lock:
            self._standby.append(replica)
        obs.event("replica_parked", source="serving", model=self.name,
                  replica=rid, live=n_live)
        self._pressure.clear()

    def remove_replica(self, rid, drain=True):
        """Planned removal: out of the dispatch set FIRST (no new
        work), then a draining stop — queued requests finish instead of
        being replayed. Returns the removed replica."""
        with self._lock:
            replica = self._live.pop(int(rid), None)
            if replica is None:
                raise KeyError(
                    "no live replica %s on router %r" % (rid, self.name))
            if int(rid) in self._scaled_up:
                self._scaled_up.remove(int(rid))
            n_live = len(self._live)
        obs.set_gauge("serving.replicas_live", n_live)
        replica.stop(drain=drain)
        obs.event("replica_remove", source="serving", model=self.name,
                  replica=int(rid), drained=bool(drain), live=n_live)
        return replica

    # -- rolling reload ---------------------------------------------------
    def rolling_reload(self, dirname, probe_feeds=None, watch_s=0.0,
                       reload_timeout=120.0):
        """Upgrade the fleet to `dirname` one replica at a time:
        quiesce -> drain -> rebuild -> probe -> rejoin. The other
        replicas keep serving the old version throughout (zero
        downtime). Any failure rolls every upgraded replica back to the
        pre-rollout version and raises :class:`RolloutError`."""
        with self._rollout_lock:
            if self._closed:
                raise EngineClosedError(
                    "router %r is draining/stopped" % self.name)
            with self._lock:
                order = sorted(self._live)
            if not order:
                raise NoReplicasError(
                    "model %r has no live replicas to reload" % self.name)
            old_dirname = self.dirname
            obs.set_gauge("serving.rollout_state", 1)
            obs.event("rollout_start", source="serving", model=self.name,
                      dirname=str(dirname), replicas=order)
            done = []
            for rid in order:
                with self._lock:
                    replica = self._live.pop(rid, None)  # quiesce
                if replica is None:
                    continue  # died mid-rollout; survivors carry on
                try:
                    self._wait_idle(replica, timeout=reload_timeout)
                    version = replica.reload(dirname)
                    if probe_feeds is not None:
                        # the health gate: the NEW version must answer
                        # before this replica rejoins the dispatch set
                        replica.submit(probe_feeds).result(
                            timeout=reload_timeout)
                except Exception as e:  # noqa: BLE001 — any failure => rollback
                    with self._lock:
                        self._live[rid] = replica
                    self._abort_rollout(done + [rid], old_dirname, e)
                with self._lock:
                    self._live[rid] = replica  # unquiesce
                done.append(rid)
                obs.event("rollout_step", source="serving",
                          model=self.name, replica=rid, version=version)
                if watch_s > 0 and self._regressed(replica, watch_s):
                    self._abort_rollout(
                        done, old_dirname,
                        RuntimeError(
                            "error-rate regression on replica %d after "
                            "reload" % rid))
            self.dirname = str(dirname)
            obs.set_gauge("serving.rollout_state", 0)
            obs.event("rollout_done", source="serving", model=self.name,
                      dirname=str(dirname), replicas=done)
            return done

    def _wait_idle(self, replica, timeout):
        deadline = time.monotonic() + float(timeout)
        while replica.queue_depth() > 0 and time.monotonic() < deadline:
            time.sleep(0.005)

    def _regressed(self, replica, watch_s):
        """Live-traffic canary: any fresh batch errors inside the watch
        window on the just-upgraded replica reads as a bad version."""
        try:
            before = int(replica.stats().get("batch_errors", 0))
        except Exception:  # noqa: BLE001
            return False
        time.sleep(float(watch_s))
        try:
            after = int(replica.stats().get("batch_errors", 0))
        except Exception:  # noqa: BLE001
            return False
        return after > before

    def _abort_rollout(self, touched, old_dirname, cause):
        """Roll every touched replica back to the pre-rollout version,
        then raise. A replica whose rollback ALSO fails is reported in
        the error rather than silently left on the bad version."""
        stuck = []
        if old_dirname is not None:
            for rid in touched:
                with self._lock:
                    replica = self._live.get(rid)
                if replica is None:
                    continue
                try:
                    replica.reload(old_dirname)
                except Exception:  # noqa: BLE001
                    stuck.append(rid)
        obs.set_gauge("serving.rollout_state", 2)
        obs.event("rollout_rollback", source="serving", model=self.name,
                  touched=list(touched), stuck=stuck,
                  error="%s: %s" % (type(cause).__name__, cause))
        msg = ("rolling reload of %r failed (%s: %s); rolled %d "
               "replica(s) back to %r"
               % (self.name, type(cause).__name__, cause, len(touched),
                  old_dirname))
        if stuck:
            msg += " — ROLLBACK INCOMPLETE on replica(s) %s" % stuck
        raise RolloutError(msg) from cause

    # -- lifecycle -------------------------------------------------------
    def stop(self, drain=True, timeout=30.0):
        """Stop the fleet: no new admissions, health loop down, every
        replica stopped (draining by default), stragglers in the retry
        pipeline failed loudly."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            pool = list(self._live.values()) + list(self._standby)
            self._live.clear()
            self._standby = []
        self._health_stop.set()
        if self._health is not None:
            self._health.join(timeout=2.0)
        for replica in pool:
            try:
                replica.stop(drain=drain, timeout=timeout)
            except Exception:  # noqa: BLE001 — stop the rest regardless
                pass
        with self._inflight_lock:
            doomed = list(self._inflight)
            self._inflight.clear()
        for fut in doomed:
            try:
                fut.set_exception(EngineClosedError(
                    "router %r stopped" % self.name))
            except InvalidStateError:
                pass
        obs.set_gauge("serving.replicas_live", 0)
        obs.event("router_stop", source="serving", count=False,
                  model=self.name, drained=bool(drain))


# ---------------------------------------------------------------------------
# fleet builders + worker CLI
# ---------------------------------------------------------------------------


def local_fleet(dirname, n_replicas=2, buckets=(), name="default",
                store=None, n_standby=0, per_device=False, config=None,
                warm=True, predictor_opts=None, router_opts=None,
                **engine_opts):
    """Build an in-process fleet: `n_replicas` live LocalReplicas (+
    `n_standby` warm standbys) behind a :class:`ServingRouter`. With
    ``per_device=True`` replica i is pinned to ``cuda:(i %
    torch.cuda.device_count())`` — one parameter set per card (on one
    card every replica shares ``cuda:0``). Replicas run on the card
    unless ``predictor_opts={"place": CPUPlace()}`` says otherwise."""
    store = store if store is not None else InMemoryStore()
    config = config or ElasticConfig()
    devices = None
    if per_device:
        import torch

        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError(
                "local_fleet(per_device=True) pins replicas to cards, and "
                "torch sees none")
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    replicas = []
    for rid in range(int(n_replicas) + int(n_standby)):
        device = devices[rid % len(devices)] if devices else None
        factory = make_engine_factory(
            buckets=buckets, name=name, replica_id=rid, device=device,
            warm=warm, predictor_opts=predictor_opts, **engine_opts)
        replicas.append(LocalReplica(
            rid, factory, store, name=name, config=config,
            dirname=str(dirname)))
    return ServingRouter(
        replicas[:int(n_replicas)], store=store, name=name, config=config,
        standby=replicas[int(n_replicas):], dirname=str(dirname),
        **dict(router_opts or {}))


def _parse_buckets(text):
    from .batcher import BucketSpec

    specs = []
    for doc in json.loads(text or "[]"):
        specs.append(BucketSpec(
            {k: tuple(v) for k, v in doc["feeds"].items()},
            batch_sizes=tuple(doc.get("batch_sizes", (1, 2, 4, 8))),
            dtypes=doc.get("dtypes")))
    return specs


def worker_main(argv=None):
    """Process entry point for one FileStore-transport replica::

        python -m paddle_tpu_torch.serving.router --store /shared/fleet \\
            --rid 0 --name mnist --model-dir /models/mnist \\
            --buckets '[{"feeds": {"img": [784]}, "batch_sizes": [1,4,8]}]'

    The replica serves on the card; ``--place cpu`` asks for the CPU.
    """
    import argparse

    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.serving.router",
        description="one serving-fleet replica worker over a FileStore")
    p.add_argument("--store", required=True,
                   help="FileStore root shared with the router")
    p.add_argument("--rid", type=int, required=True)
    p.add_argument("--name", default="default")
    p.add_argument("--model-dir", required=True)
    p.add_argument("--buckets", default="",
                   help='JSON: [{"feeds": {name: [dims...]}, '
                        '"batch_sizes": [...], "dtypes": {...}?}, ...]')
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--queue-capacity", type=int, default=64)
    p.add_argument("--no-warm", action="store_true")
    p.add_argument("--heartbeat-interval", type=float, default=None)
    p.add_argument("--trace-proc", default=None,
                   help="trace track label for this process (default "
                        "worker:<name>-<rid>)")
    p.add_argument("--place", choices=("cuda", "cpu"), default="cuda",
                   help="where the replica runs: the card (default) or, "
                        "when asked, the CPU")
    args = p.parse_args(argv)
    from ..fluid import core

    place = (core.CPUPlace() if args.place == "cpu"
             else core.default_place())  # no card: raises

    obs.set_process_label(
        args.trace_proc or "worker:%s-%d" % (args.name, args.rid))
    obs.install_excepthook()
    config = ElasticConfig(heartbeat_interval=args.heartbeat_interval)
    factory = make_engine_factory(
        buckets=_parse_buckets(args.buckets), name=args.name,
        replica_id=args.rid, warm=not args.no_warm,
        predictor_opts={"place": place},
        max_batch_size=args.max_batch_size, max_wait_ms=args.max_wait_ms,
        queue_capacity=args.queue_capacity)
    worker = ReplicaWorker(
        FileStore(args.store), args.rid, factory, args.model_dir,
        name=args.name, config=config)
    print("replica %d serving %r from %s (pid %d)"
          % (args.rid, args.name, args.model_dir, os.getpid()), flush=True)
    worker.run_forever()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(worker_main())
