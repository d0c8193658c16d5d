"""Elastic fleet health: heartbeat stores and the heartbeat monitor
(port of the stores-and-monitor half of paddle_tpu/parallel/elastic.py).

The serving fleet (``serving/router.py``, ``serving/disagg/router.py``)
learns that a replica died the way the JAX package's training fleet
does — the replica goes silent:

- **HeartbeatStore** — a tiny pluggable blackboard the replicas exchange
  beacons and mailbox docs through: :class:`InMemoryStore` for
  in-process fleets (threads), :class:`FileStore` (atomic tmp+rename
  JSON files, each stamped with an integrity digest) for fleets of
  processes. Nothing above the store assumes locality.
- **HeartbeatMonitor** — each member publishes ``(step, wall-clock,
  latency, generation)`` beacons; the monitor classifies peers as
  *dead* (no beacon for ``miss_threshold x heartbeat_interval``),
  *stragglers* (step lag or latency over a bound), or *partitioned*
  (beating on a stale generation), emitting structured
  ``heartbeat_miss``/``worker_dead``/``straggler``/``partition`` events
  into an :class:`~paddle_tpu_torch.fluid.resilience.EventLog`.

Fault sites (``PADDLE_TPU_FAULT_SPEC``, see ``fluid/resilience.py``):
``heartbeat`` fires in the beacon writer (a member that can no longer
beat IS dead to everyone else), ``mailbox`` corrupts FileStore writes.

Env knobs (all overridable per-:class:`ElasticConfig`)::

    PADDLE_TPU_HEARTBEAT_INTERVAL   beacon period, seconds   (0.25)
    PADDLE_TPU_HEARTBEAT_MISSES     beacons missed => dead   (4)
    PADDLE_TPU_COLLECTIVE_TIMEOUT   host-wait budget, secs   (30)
    PADDLE_TPU_STRAGGLER_FACTOR     latency bound, x median  (3.0)
    PADDLE_TPU_STRAGGLER_LAG        step-lag bound, steps    (10)

The training half — ``FleetGuard`` (guarded steps, store all-reduce,
consensus checkpoints, shrink-to-survivors) and ``DeadPeerError`` —
waits for ROADMAP.md Queue 1 item 8.6. The JAX module's lock-sanitizer
hooks wait for item 11: the locks here are plain ``threading`` locks.
"""
import collections
import json
import os
import threading
import time

import numpy as np

from .. import observability as obs
from ..fluid import resilience as R
from ..fluid.resilience import EventLog
from ..integrity import envelope as _env
from ..integrity import jsonl as _jsonl

__all__ = [
    "ElasticConfig", "HeartbeatStore", "InMemoryStore", "FileStore",
    "HeartbeatMonitor",
]


def _env_float(name, default):
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return float(default)


class ElasticConfig:
    """Knobs for the elastic fleet, env-seeded (see module docstring)."""

    def __init__(self, heartbeat_interval=None, miss_threshold=None,
                 collective_timeout=None, straggler_factor=None,
                 straggler_lag=None, straggler_min_steps=3,
                 poll_interval=None, startup_grace=None):
        self.heartbeat_interval = float(
            heartbeat_interval if heartbeat_interval is not None
            else _env_float("PADDLE_TPU_HEARTBEAT_INTERVAL", 0.25))
        self.miss_threshold = int(
            miss_threshold if miss_threshold is not None
            else _env_float("PADDLE_TPU_HEARTBEAT_MISSES", 4))
        self.collective_timeout = float(
            collective_timeout if collective_timeout is not None
            else _env_float("PADDLE_TPU_COLLECTIVE_TIMEOUT", 30.0))
        self.straggler_factor = float(
            straggler_factor if straggler_factor is not None
            else _env_float("PADDLE_TPU_STRAGGLER_FACTOR", 3.0))
        self.straggler_lag = int(
            straggler_lag if straggler_lag is not None
            else _env_float("PADDLE_TPU_STRAGGLER_LAG", 10))
        self.straggler_min_steps = int(straggler_min_steps)
        self.poll_interval = float(
            poll_interval if poll_interval is not None
            else max(0.002, self.heartbeat_interval / 10.0))
        # a worker that NEVER beat gets this long to appear before it
        # counts as dead (process spawn + import + first trace)
        self.startup_grace = float(
            startup_grace if startup_grace is not None
            else max(5.0, 10.0 * self.heartbeat_interval))

    @property
    def dead_after(self):
        """Seconds of beacon silence after which a peer is dead."""
        return self.miss_threshold * self.heartbeat_interval


# ---------------------------------------------------------------------------
# stores
# ---------------------------------------------------------------------------


class HeartbeatStore:
    """Blackboard the fleet coordinates through. Keys are worker
    indices (stringified), namespaces partition uses (heartbeats,
    per-barrier rendezvous, per-step all-reduce payloads). Writes must
    be atomic per (namespace, key); readers may see a subset of
    concurrent writes but never a torn value."""

    def put(self, namespace, key, payload):
        raise NotImplementedError

    def all(self, namespace):
        """{key: payload} for every committed write in `namespace`."""
        raise NotImplementedError

    def delete(self, namespace, key):
        """Drop one committed write. Consumers that fully own a key
        (the serving fleet's request/response mailboxes) garbage-
        collect it so sustained traffic doesn't grow ``all()`` scans
        without bound. Deleting a missing key is a no-op."""
        raise NotImplementedError


class InMemoryStore(HeartbeatStore):
    """Single-process fleets (threads as simulated workers) — and the
    reference semantics the FileStore must match."""

    def __init__(self):
        self._lock = threading.RLock()
        self._data = collections.defaultdict(dict)

    def put(self, namespace, key, payload):
        with self._lock:
            self._data[namespace][str(key)] = dict(payload)

    def all(self, namespace):
        with self._lock:
            return {k: dict(v) for k, v in self._data[namespace].items()}

    def delete(self, namespace, key):
        with self._lock:
            self._data[namespace].pop(str(key), None)


class FileStore(HeartbeatStore):
    """Multi-process fleets on a shared filesystem: one JSON file per
    (namespace, key), committed by atomic tmp+rename so a reader never
    observes a torn beacon. Namespaces become directories.

    Reads are mtime-gated: ``all()`` caches the parsed namespace and
    serves it back as long as the directory mtime is unchanged AND the
    cached scan started comfortably after the last modification (the
    slack absorbs coarse filesystem timestamp granularity — a write
    landing in the same mtime tick as the scan can never validate the
    cache). A 16-replica router polling heartbeats at 100ms then costs
    one ``stat()`` per poll between beacons instead of 16 opens + JSON
    parses. ``elastic.store_scan_cached`` / ``elastic.store_scan_full``
    counters and the ``elastic.store_scan_seconds`` histogram expose
    the hit rate and the per-scan cost."""

    # a cached scan only validates once the directory has been quiet
    # for this long: kernels stamp directory mtimes from a coarse clock
    # (up to ~10ms per tick), so "same mtime" alone cannot prove "no
    # write since the scan"
    MTIME_SLACK_NS = 50_000_000

    def __init__(self, root):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._cache_lock = threading.Lock()
        self._cache = {}   # dir -> (dir_mtime_ns, scan_wall_ns, parsed)
        self._made = set()  # dirs already created (skip makedirs per op)

    def _dir(self, namespace):
        # namespaces may be hierarchical ("barrier/g0/shrink/3")
        d = os.path.join(self.root, *str(namespace).split("/"))
        if d not in self._made:
            os.makedirs(d, exist_ok=True)
            self._made.add(d)
        return d

    def put(self, namespace, key, payload):
        d = self._dir(namespace)
        path = os.path.join(d, "%s.json" % key)
        # tmp name unique per WRITER: the background beater and the
        # train loop both beat for the same key, and a shared tmp path
        # would let one thread's replace() steal the other's file
        tmp = path + ".tmp-%d-%d" % (os.getpid(), threading.get_ident())
        # every mailbox doc carries an ``_integrity`` digest stamp
        # (stripped again on read); the encoded bytes route through the
        # ``mailbox`` corruption fault site for chaos drills
        data = R.fault_corrupt(
            "mailbox", json.dumps(_env.stamp_doc(payload)).encode("utf-8"))
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        # same-process readers must see this write on the next poll even
        # if the directory mtime tick has not advanced
        with self._cache_lock:
            self._cache.pop(d, None)

    def delete(self, namespace, key):
        d = self._dir(namespace)
        try:
            os.unlink(os.path.join(d, "%s.json" % key))
        except OSError:
            pass
        with self._cache_lock:
            self._cache.pop(d, None)

    def _scan(self, d):
        # a directory of beacon files is a blocking filesystem walk —
        # it must never run under the cache lock (or any engine lock):
        # health polls would convoy every submitter behind disk latency
        out = {}
        torn = corrupt = 0
        for entry in os.listdir(d):
            if not entry.endswith(".json"):
                continue
            doc, bad = _jsonl.read_json_doc(os.path.join(d, entry))
            if doc is None:
                # OSError (concurrent replace) skips silently; a torn
                # write (unparseable JSON) is counted
                torn += bad
                continue
            if isinstance(doc, dict):
                ok, doc = _env.check_doc(doc)
                if not ok:
                    corrupt += 1
                    continue
            out[entry[:-5]] = doc
        if torn:
            obs.inc("integrity.mailbox_doc_torn", torn)
        if corrupt:
            obs.inc("integrity.mailbox_doc_corrupt", corrupt)
            obs.event("integrity_violation", source="elastic",
                      check="mailbox", dir=d, count=corrupt)
        return out

    def all(self, namespace):
        d = self._dir(namespace)
        t0 = time.monotonic()
        try:
            mtime = os.stat(d).st_mtime_ns
        except OSError:
            return {}
        with self._cache_lock:
            hit = self._cache.get(d)
        if (hit is not None and hit[0] == mtime
                and hit[1] > mtime + self.MTIME_SLACK_NS):
            obs.inc("elastic.store_scan_cached")
            obs.observe("elastic.store_scan_seconds",
                        time.monotonic() - t0)
            return {k: dict(v) for k, v in hit[2].items()}
        scan_ns = time.time_ns()
        out = self._scan(d)
        try:
            mtime_after = os.stat(d).st_mtime_ns
        except OSError:
            mtime_after = None
        if mtime_after == mtime:
            # nothing changed while we read: the parse is cacheable
            with self._cache_lock:
                self._cache[d] = (
                    mtime, scan_ns, {k: dict(v) for k, v in out.items()})
        obs.inc("elastic.store_scan_full")
        obs.observe("elastic.store_scan_seconds", time.monotonic() - t0)
        return out


# ---------------------------------------------------------------------------
# heartbeat table + health classification
# ---------------------------------------------------------------------------


class HeartbeatMonitor:
    """One worker's view of the fleet heartbeat table.

    ``beat()`` publishes this worker's beacon (counting a ``heartbeat``
    fault-site check first — an injected fault here IS the worker dying,
    because the beacon never lands); the classifiers below read
    everyone's newest beacons and emit structured events on state
    *transitions* (a peer is declared dead once, not once per poll).
    """

    NAMESPACE = "heartbeat"

    def __init__(self, store, worker_index, world_size, config=None,
                 log=None, fault_hook=None):
        self.store = store
        self.worker_index = int(worker_index)
        self.world_size = int(world_size)
        self.config = config or ElasticConfig()
        self.log = log if log is not None else EventLog(source="fleet")
        self._fault = fault_hook or R.fault_check
        self._born = time.time()
        self._last = None           # last record this worker published
        self._declared_dead = set()
        self._flagged_straggler = set()
        self._flagged_partition = set()
        self.generation = 0

    # core beacon fields extras can never shadow
    _CORE_FIELDS = frozenset(
        {"worker", "step", "time", "latency", "state", "generation"})

    # -- publishing ------------------------------------------------------
    def beat(self, step, latency=None, state="alive", extra=None):
        """Publish this worker's beacon. `extra` merges additional
        reporter fields (serving replicas ride it for queue depth /
        model version) without touching the core health record — and
        survives ``keepalive()`` re-stamps."""
        self._fault("heartbeat")
        rec = {}
        if extra:
            rec.update({k: v for k, v in dict(extra).items()
                        if k not in self._CORE_FIELDS})
        rec.update({"worker": self.worker_index, "step": int(step),
                    "time": time.time(), "latency": latency,
                    "state": state, "generation": int(self.generation)})
        self.store.put(self.NAMESPACE, self.worker_index, rec)
        self._last = rec
        return rec

    def keepalive(self):
        """Re-stamp the last beacon (long host-side waits must not read
        as death to the peers)."""
        if self._last is not None:
            self.beat(self._last["step"], self._last.get("latency"),
                      self._last.get("state", "alive"),
                      extra={k: v for k, v in self._last.items()
                             if k not in self._CORE_FIELDS})

    def leave(self):
        """Clean departure — peers see 'left', not silence."""
        if self._last is not None:
            self.beat(self._last["step"], self._last.get("latency"),
                      state="left")

    # -- classification --------------------------------------------------
    def table(self):
        """{worker_index: newest beacon} (ints for keys)."""
        return {int(k): v
                for k, v in self.store.all(self.NAMESPACE).items()}

    def extras(self, key):
        """{worker_index: beacon[key]} for every live beacon carrying
        the extra field — the fleet-metrics federation reads replica
        ``metrics`` docs (and crash-dump paths) off beacons with this,
        so aggregators never need a side channel to the replicas."""
        out = {}
        for w, rec in self.table().items():
            if isinstance(rec, dict) and rec.get(key) is not None:
                out[w] = rec[key]
        return out

    def latencies(self, members=None):
        """{worker_index: beacon latency seconds} for every live beacon
        reporting one (departed workers and non-numeric values are
        skipped). A serving replica's beacon latency is its inverse
        drain rate, so this is the autopilot's degraded-replica
        signal — read fleet-wide off the store, no engine channel."""
        members = None if members is None else {int(m) for m in members}
        out = {}
        for w, rec in self.table().items():
            if members is not None and w not in members:
                continue
            if not isinstance(rec, dict) or rec.get("state") == "left":
                continue
            lat = rec.get("latency")
            if (isinstance(lat, (int, float))
                    and not isinstance(lat, bool) and lat > 0):
                out[w] = float(lat)
        return out

    def dead_peers(self, members=None, now=None):
        """Worker indices (excluding self) whose beacons went silent
        past the miss threshold — or that never appeared within the
        startup grace. Emits ``heartbeat_miss`` per fresh observation
        and ``worker_dead`` once per transition."""
        cfg = self.config
        now = time.time() if now is None else now
        table = self.table()
        members = (set(range(self.world_size)) if members is None
                   else set(members))
        dead = set()
        max_age = 0.0
        for w in members:
            if w == self.worker_index:
                continue
            rec = table.get(w)
            if rec is None:
                if now - self._born > cfg.startup_grace:
                    dead.add(w)
                continue
            if rec.get("state") == "left":
                continue
            silent = now - rec["time"]
            if silent > max_age:
                max_age = silent
            if silent > cfg.dead_after:
                dead.add(w)
                self.log.emit("heartbeat_miss", worker=w,
                              silent=round(silent, 4),
                              threshold=cfg.dead_after,
                              last_step=rec.get("step"))
        # oldest still-counted peer beacon, as THIS worker sees it — a
        # rising gauge is the leading signal of a dying/partitioned peer
        obs.set_gauge("fleet.heartbeat_age_seconds", max_age)
        for w in sorted(dead - self._declared_dead):
            self._declared_dead.add(w)
            self.log.emit("worker_dead", worker=w,
                          observer=self.worker_index,
                          threshold=cfg.dead_after)
        return dead

    def stragglers(self, members=None, step_lag=True):
        """Alive peers whose step lag exceeds ``straggler_lag`` or whose
        reported per-step latency exceeds ``straggler_factor`` x the
        fleet median. Emits ``straggler`` on the transition in and
        ``straggler_recovered`` on the way out.

        ``step_lag=False`` disables the lag trigger: serving fleets
        beat a per-process tick counter whose ZERO is each replica's
        start time, so a replica built after a slow sibling warmup is
        offset forever — only the latency signal means anything there
        (training fleets step in lockstep, so lag stays on)."""
        cfg = self.config
        table = self.table()
        members = (set(range(self.world_size)) if members is None
                   else set(members))
        alive = {w: table[w] for w in members
                 if w in table and table[w].get("state") == "alive"}
        if len(alive) < 2:
            return set()
        steps = {w: r.get("step", 0) for w, r in alive.items()}
        lead = max(steps.values())
        lats = [r["latency"] for r in alive.values()
                if r.get("latency") is not None]
        median = float(np.median(lats)) if lats else None
        flagged = set()
        for w, rec in alive.items():
            if w == self.worker_index:
                continue
            if rec.get("step", 0) < cfg.straggler_min_steps:
                continue
            lag = lead - steps[w]
            lat = rec.get("latency")
            slow = (median is not None and lat is not None and median > 0
                    and lat > cfg.straggler_factor * median)
            if (step_lag and lag > cfg.straggler_lag) or slow:
                flagged.add(w)
                if w not in self._flagged_straggler:
                    self._flagged_straggler.add(w)
                    self.log.emit(
                        "straggler", worker=w, lag=lag,
                        latency=lat, median_latency=median,
                        factor=cfg.straggler_factor,
                        lag_bound=cfg.straggler_lag)
        for w in sorted(self._flagged_straggler - flagged):
            self._flagged_straggler.discard(w)
            self.log.emit("straggler_recovered", worker=w)
        return flagged

    def partitioned_peers(self, members=None):
        """Alive peers still beating on a STALE fleet generation — the
        partition signature: they can reach the store but did not join
        the last membership change. Emits ``partition`` per
        transition."""
        table = self.table()
        members = (set(range(self.world_size)) if members is None
                   else set(members))
        split = set()
        for w in members:
            rec = table.get(w)
            if (w == self.worker_index or rec is None
                    or rec.get("state") != "alive"):
                continue
            if rec.get("generation", 0) < self.generation:
                split.add(w)
                if w not in self._flagged_partition:
                    self._flagged_partition.add(w)
                    self.log.emit("partition", worker=w,
                                  worker_generation=rec.get("generation"),
                                  fleet_generation=self.generation)
        self._flagged_partition &= split
        return split


# ---------------------------------------------------------------------------
# the per-worker driver
# ---------------------------------------------------------------------------


