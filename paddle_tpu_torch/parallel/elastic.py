"""Elastic fleet guard: heartbeats, straggler/partition detection,
collective deadlines, and shrink-to-survivors resume (port of
paddle_tpu/parallel/elastic.py).

The training fleet (:class:`FleetGuard`) and the serving fleet
(``serving/router.py``, ``serving/disagg/router.py``) learn that a
member died the same way — the member goes silent:

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

- **Collective deadlines** — every host-side wait here polls against a
  budget, and the collective-op lowerings + ``Fleet.barrier_worker``
  check the thread's armed
  :func:`~paddle_tpu_torch.fluid.resilience.collective_deadline` before
  issuing work, raising a typed
  :class:`~paddle_tpu_torch.fluid.resilience.CollectiveTimeoutError`
  instead of hanging.
- **FleetGuard** — the per-worker driver: guarded train steps (riding
  :class:`~paddle_tpu_torch.fluid.resilience.GuardedExecutor`),
  store-backed parameter averaging whose denominator is ALWAYS the live
  member count, consensus checkpoints (every member saves, then writes
  a marker via ``parallel/checkpoint.py``; only a fully-marked step is
  a resume point), and shrink-to-survivors recovery: on a
  confirmed-dead peer the survivors bump the fleet generation,
  rendezvous, rebuild their device view over the survivors, shrink a
  ``StackedDpProgram``'s rank group (``shrink_dp``, through
  ``mesh.shrink_mesh``), restore the last fleet-consistent checkpoint,
  and resume.

The JAX package maps members to ``jax.devices()``, wrapping around; the
port maps them to ``torch.device`` objects: the cards, or the CPU when
the caller passes ``devices=`` or a ``CPUPlace()`` executor. The
fleet's device view (:class:`FleetMesh`) and a program's
``torch.distributed`` rank group are separate objects in the port
(ROADMAP.md Queue 3).

Fault sites (``PADDLE_TPU_FAULT_SPEC``, see ``fluid/resilience.py``):
``heartbeat`` fires in the beacon writer (a member that can no longer
beat IS dead to everyone else), ``collective`` in the store all-reduce,
``barrier`` in every rendezvous, ``mailbox`` corrupts FileStore writes.
Each FleetGuard can also carry its OWN injector (``fault_spec=``) so a
fleet of threads can kill exactly one worker deterministically.

Env knobs (all overridable per-:class:`ElasticConfig`)::

    PADDLE_TPU_HEARTBEAT_INTERVAL   beacon period, seconds   (0.25)
    PADDLE_TPU_HEARTBEAT_MISSES     beacons missed => dead   (4)
    PADDLE_TPU_COLLECTIVE_TIMEOUT   host-wait budget, secs   (30)
    PADDLE_TPU_STRAGGLER_FACTOR     latency bound, x median  (3.0)
    PADDLE_TPU_STRAGGLER_LAG        step-lag bound, steps    (10)

The JAX module's lock-sanitizer hooks wait for ROADMAP.md Queue 1 item
11: the locks here are plain ``threading`` locks.
"""
import collections
import json
import os
import threading
import time

import numpy as np
import torch

from .. import observability as obs
from ..fluid import resilience as R
from ..fluid.io import _apply_state, _distributed_of, _persistable_state
from ..fluid.resilience import (  # re-exported surface  # noqa: F401
    CollectiveTimeoutError, collective_deadline, deadline_remaining,
    EventLog, FaultInjector, GuardedExecutor,
)
from ..integrity import envelope as _env
from ..integrity import jsonl as _jsonl
from . import checkpoint as ckpt

__all__ = [
    "ElasticConfig", "HeartbeatStore", "InMemoryStore", "FileStore",
    "HeartbeatMonitor", "FleetGuard", "DeadPeerError",
    "CollectiveTimeoutError", "collective_deadline",
]


class DeadPeerError(CollectiveTimeoutError):
    """A host-side wait aborted early because a waited-on peer was
    confirmed dead (missed heartbeats) — stronger evidence than a bare
    timeout. Carries ``dead`` (the worker indices)."""

    def __init__(self, message, dead=()):
        super().__init__(message)
        self.dead = frozenset(dead)


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




class FleetMesh:
    """The fleet's device view: a ``{"dp": n}`` axis over one
    ``torch.device`` per member (the JAX package's ``build_mesh`` over
    the members' jax devices). It launches nothing; a program's
    ``torch.distributed`` rank group is the program's own."""

    axis_names = ("dp",)

    def __init__(self, devices):
        self.devices = np.empty(len(devices), dtype=object)
        for i, d in enumerate(devices):
            self.devices[i] = d
        self.shape = {"dp": len(devices)}


def _device_pool(executor, devices):
    """The devices members map onto: `devices` when given, the CPU for
    a ``CPUPlace()`` executor, else every card."""
    from .mesh import _as_device

    if devices is not None:
        return [_as_device(d) for d in devices]
    dev = getattr(executor, "device", None)
    if dev is not None and dev.type == "cpu":
        return [dev]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible to torch; a FleetGuard maps its "
            "members to the cards unless asked otherwise — pass "
            "devices=['cpu'] or an Executor(CPUPlace())")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class FleetGuard:
    """Elastic driver for ONE worker of a fleet of threads or processes.

    ::

        guard = FleetGuard(exe, program=prog, store=store,
                           worker_index=i, world_size=4,
                           ckpt_dir=shared_dir, fetch_list=[loss],
                           feed_fn=make_feed, save_every=5)
        fleet.attach_elastic(guard)          # optional: real barriers
        summary = guard.train(num_steps=40)

    Per step: beat -> classify peers (dead/straggler/partition) ->
    guarded ``Executor.run`` under an armed collective deadline ->
    store-backed parameter averaging over the LIVE member set ->
    consensus checkpoint every `save_every`. A confirmed-dead peer (or
    a collective timeout that resolves to one) triggers
    :meth:`shrink`: generation bump, survivor rendezvous, device view
    rebuilt over the survivors, restore from the newest fleet-consistent
    checkpoint, resume. Every host-side wait lands in ``block_log`` so a
    test watchdog can assert nothing outlived its deadline.

    The store all-reduce carries each synced value as a JSON list of
    float64s, as in the JAX package: at BERT-base width pass
    ``sync_vars=`` a small set.
    """

    def __init__(self, executor, program=None, store=None, worker_index=0,
                 world_size=1, config=None, ckpt_dir=None, fetch_list=None,
                 feed_fn=None, scope=None, save_every=0, sync_every=1,
                 sync_vars=None, devices=None, on_event=None,
                 fault_spec=None, log_maxlen=10000, recorder=None,
                 **guard_opts):
        self.config = config or ElasticConfig()
        self.store = store if store is not None else InMemoryStore()
        self.worker_index = int(worker_index)
        self.world_size = int(world_size)
        self.members = set(range(self.world_size))
        self.generation = 0
        self.log = EventLog(maxlen=log_maxlen, sink=on_event,
                            recorder=recorder, source="fleet")
        self._injector = (FaultInjector(fault_spec) if fault_spec else None)
        self.monitor = HeartbeatMonitor(
            self.store, self.worker_index, self.world_size,
            config=self.config, log=self.log, fault_hook=self._fault)
        self._exe = executor
        self._program = program
        self._scope = scope
        self._fetch_list = fetch_list
        self._feed_fn = feed_fn
        self._ckpt_dir = ckpt_dir
        self._save_every = int(save_every)
        self._sync_every = int(sync_every)
        self._sync_vars = sync_vars
        self.guard = GuardedExecutor(
            executor, on_event=self._relay, recorder=recorder,
            **guard_opts)
        # one device per member: the fleet's device view. Devices wrap
        # around when the fleet is wider than the device pool (workers
        # share a card).
        pool = _device_pool(executor, devices)
        self._device_of = {
            w: pool[w % len(pool)] for w in range(self.world_size)}
        self.mesh = FleetMesh(
            [self._device_of[w] for w in sorted(self.members)]) \
            if self.world_size > 1 else None
        self.block_log = []       # (what, seconds) per host-side wait
        self._seq = collections.Counter()
        # background beater: beacons must keep landing while the main
        # loop sits in a long step / restore / device transfer, or every
        # long step reads as death to the peers
        self._beater = None
        self._beater_stop = threading.Event()
        self._fatal = None        # exception that killed the beater

    # -- background beacon thread ----------------------------------------
    def _beat_loop(self):
        interval = max(0.001, self.config.heartbeat_interval / 2.0)
        while not self._beater_stop.wait(interval):
            try:
                self.monitor.keepalive()
            except BaseException as e:  # noqa: BLE001 — injected faults
                # a worker that cannot beat IS dead to the fleet: record
                # the cause and stop participating; the train loop (and
                # any in-flight wait) re-raises it
                self._fatal = e
                return

    def _start_beater(self):
        if self._beater is None or not self._beater.is_alive():
            self._beater_stop.clear()
            self._beater = threading.Thread(
                target=self._beat_loop, daemon=True,
                name="paddle_tpu-heartbeat-%d" % self.worker_index)
            self._beater.start()

    def _stop_beater(self):
        self._beater_stop.set()
        if self._beater is not None:
            self._beater.join(timeout=2.0)

    def _check_fatal(self):
        if self._fatal is not None:
            raise self._fatal

    # -- plumbing --------------------------------------------------------
    def _fault(self, site):
        if self._injector is not None:
            self._injector.check(site)
        else:
            R.fault_check(site)

    def _relay(self, ev):
        # already hub-routed by GuardedExecutor._emit at the origin
        self.log.emit(ev.pop("kind"), _forward=False, **ev)

    def _resolve(self):
        from ..fluid.executor import global_scope
        from ..fluid.framework import default_main_program

        program = self._program if self._program is not None \
            else default_main_program()
        scope = self._scope if self._scope is not None else global_scope()
        return program, scope

    # -- host-side collectives over the store ----------------------------
    def _wait(self, namespace, need, timeout, what,
              metric="fleet.wait_seconds"):
        """Poll `namespace` until every worker in `need` posted; beats
        our own keepalive while waiting; aborts with DeadPeerError the
        moment a waited-on peer is confirmed dead, and with
        CollectiveTimeoutError at the deadline. Returns elapsed. Every
        wait lands in ``block_log`` AND the `metric` histogram."""
        cfg = self.config
        budget = cfg.collective_timeout if timeout is None else timeout
        armed = deadline_remaining()
        if armed is not None:
            budget = min(budget, armed)
        t0 = time.monotonic()
        deadline = t0 + budget
        last_alive = t0
        need = set(int(n) for n in need)
        try:
            while True:
                have = {int(k) for k in self.store.all(namespace)}
                if need <= have:
                    return time.monotonic() - t0
                self._check_fatal()
                now = time.monotonic()
                if now - last_alive >= cfg.heartbeat_interval:
                    self.monitor.keepalive()
                    last_alive = now
                    missing = need - have
                    dead = self.monitor.dead_peers(members=self.members) \
                        & missing
                    if dead:
                        raise DeadPeerError(
                            "%s aborted: peer(s) %s confirmed dead "
                            "(no heartbeat for > %.3fs) while the fleet "
                            "waited on them"
                            % (what, sorted(dead), cfg.dead_after),
                            dead=dead)
                if now >= deadline:
                    raise CollectiveTimeoutError(
                        "%s timed out after %.3fs waiting for worker(s) "
                        "%s" % (what, budget, sorted(need - have)))
                time.sleep(cfg.poll_interval)
        finally:
            elapsed = time.monotonic() - t0
            self.block_log.append((what, elapsed))
            obs.observe(metric, elapsed)

    def barrier(self, name="fleet", timeout=None, members=None):
        """Rendezvous the (surviving) members. Deterministic namespace:
        (generation, name, per-name sequence) — every member calls its
        barriers in the same order, so the Nth 'name' barrier of a
        generation lines up fleet-wide."""
        self._fault("barrier")
        members = self.members if members is None else set(members)
        seq_key = (self.generation, name)
        self._seq[seq_key] += 1
        ns = "barrier/g%d/%s/%d" % (self.generation, name,
                                    self._seq[seq_key])
        self.store.put(ns, self.worker_index,
                       {"worker": self.worker_index, "time": time.time()})
        return self._wait(ns, members, timeout,
                          "barrier %r (gen %d)" % (name, self.generation),
                          metric="fleet.barrier_wait_seconds")

    def allreduce_mean(self, value, tag, timeout=None):
        """Fleet mean of `value` over the LIVE member set — the
        denominator is ``len(self.members)``, so after a shrink the
        averaging weight of each survivor rescales automatically
        (``StackedDpProgram.shrink_dp`` gives a program's own gradient
        collectives the same property)."""
        self._fault("collective")
        arr = np.asarray(value, dtype=np.float64)
        ns = "ar/g%d/%s" % (self.generation, tag)
        self.store.put(ns, self.worker_index,
                       {"worker": self.worker_index,
                        "shape": list(arr.shape),
                        "value": arr.ravel().tolist()})
        self._wait(ns, self.members, timeout,
                   "allreduce %r (gen %d)" % (tag, self.generation),
                   metric="fleet.allreduce_wait_seconds")
        posted = self.store.all(ns)
        vals = [np.asarray(posted[str(w)]["value"], dtype=np.float64)
                .reshape(posted[str(w)]["shape"])
                for w in sorted(self.members)]
        return np.mean(vals, axis=0)

    # -- checkpoints -----------------------------------------------------
    def save(self, step, program=None, scope=None):
        """Consensus checkpoint: this worker's payload + done-marker.
        The step becomes the fleet's resume point only once EVERY live
        member's marker landed (parallel/checkpoint.py consensus). Split
        state is saved as its global values, as ``fluid.io`` saves it
        (``io._persistable_state``), into this worker's own directory."""
        if program is None or scope is None:
            rp, rs = self._resolve()
            program, scope = program or rp, scope or rs
        _, state = _persistable_state(program, scope)
        wdir = ckpt.worker_dir(self._ckpt_dir, self.worker_index)
        digests = ckpt.save_checkpoint(wdir, state, step=int(step),
                                       wait=True)
        ckpt.mark_save_complete(
            self._ckpt_dir, int(step), self.worker_index,
            world_size=self.world_size, members=sorted(self.members),
            digests=digests)
        self.log.emit("save", step=int(step), vars=len(state),
                      members=sorted(self.members))

    def _maybe_restore(self, program, scope):
        """Apply the newest fleet-consistent checkpoint; returns the
        resumed step or 0."""
        if not self._ckpt_dir:
            return 0
        res = ckpt.restore_latest_consensus(
            self._ckpt_dir, self.worker_index)
        if res is None:
            return 0
        step, state = res
        restored = _apply_state(program, state, scope)
        self.log.emit("restore", step=step, vars=restored,
                      generation=self.generation)
        return int(step)

    # -- shrink-to-survivors ---------------------------------------------
    def shrink(self, dead, program=None, scope=None):
        """Drop `dead` from the membership, bump the generation,
        rendezvous the survivors, rebuild the device view over the
        survivors (and a ``StackedDpProgram``'s rank group, through its
        ``shrink_dp``), and restore the newest fleet-consistent
        checkpoint. Returns the step to resume AFTER (0 = no
        checkpoint; keep current state). Deterministic: every survivor
        reads the same heartbeat table, computes the same survivor set,
        and meets the same generation-stamped barrier."""
        if program is None or scope is None:
            rp, rs = self._resolve()
            program, scope = program or rp, scope or rs
        dead = set(dead) & self.members
        old_order = sorted(self.members)
        survivors = sorted(self.members - dead)
        if self.worker_index not in survivors:
            raise RuntimeError(
                "worker %d is in the dead set %s — a fenced worker must "
                "not rejoin without a fresh generation"
                % (self.worker_index, sorted(dead)))
        if not dead:
            return None
        _, dist = _distributed_of(program)
        group = getattr(dist, "_mesh", None)
        if group is not None and group.group is not None \
                and getattr(dist, "shrink_dp", None) is None:
            raise RuntimeError(
                "worker %d: peer(s) %s died, and the program runs over the "
                "rank group %s, which only a per-rank program "
                "(StackedDpProgram, LocalSGD) rebuilds over the survivors "
                "(shrink_dp); a gloo or nccl collective over the old group "
                "would wait for the dead rank"
                % (self.worker_index, sorted(dead), group))
        self.generation += 1
        self.monitor.generation = self.generation
        self.members = set(survivors)
        obs.set_gauge("fleet.members", len(survivors))
        obs.set_gauge("fleet.generation", self.generation)
        self.log.emit("shrink", generation=self.generation,
                      dead=sorted(dead), survivors=survivors)
        # announce the new generation before blocking so peers polling
        # the table see us moving, then rendezvous the survivors
        self.monitor.keepalive()
        self.barrier("shrink")
        if self.mesh is not None and len(survivors) >= 1:
            self.mesh = FleetMesh(
                [self._device_of[w] for w in survivors]) \
                if len(survivors) > 1 else None
            self.log.emit("mesh_rebuild", generation=self.generation,
                          dp=len(survivors))
        if getattr(program, "shrink_dp", None) is not None \
                and self.mesh is not None:
            # a per-rank program (StackedDpProgram, LocalSGDProgram):
            # its rank group shrinks to the survivors, so its gradient
            # collectives divide by the survivor count. Positions are
            # the survivors' places in the OLD member order.
            program.shrink_dp(scope, [old_order.index(w)
                                      for w in survivors])
        resumed = self._maybe_restore(program, scope)
        self.log.emit("resume", generation=self.generation, step=resumed)
        return resumed

    # -- the loop --------------------------------------------------------
    def _sync_names(self, program):
        if self._sync_vars is not None:
            return list(self._sync_vars)
        src = getattr(program, "_program", program)
        return sorted(
            v.name for v in src.global_block().all_parameters()
            if getattr(v, "trainable", True))

    def train(self, num_steps):
        """Run until `num_steps` steps completed fleet-wide. Returns a
        summary dict (counters + events + final membership)."""
        program, scope = self._resolve()
        cfg = self.config
        start = self._maybe_restore(program, scope)
        sync_names = self._sync_names(program)
        completed = start
        step = start + 1
        last_latency = None
        self.monitor.beat(step, latency=None)
        self._start_beater()
        try:
            return self._train_loop(program, scope, cfg, sync_names,
                                    num_steps, start, completed, step,
                                    last_latency)
        finally:
            self._stop_beater()

    def _sync(self, scope, sync_names, step):
        from ..fluid.executor import to_numpy

        for name in sync_names:
            v = scope.find_value(name)
            if v is None:
                continue
            if isinstance(v, torch.Tensor):
                avg = self.allreduce_mean(
                    to_numpy(v), tag="s%d/%s" % (step, name))
                scope.update(name, torch.from_numpy(avg).to(
                    device=v.device, dtype=v.dtype))
            else:
                avg = self.allreduce_mean(
                    np.asarray(v), tag="s%d/%s" % (step, name))
                scope.update(name, avg.astype(np.asarray(v).dtype))

    def _train_loop(self, program, scope, cfg, sync_names, num_steps,
                    start, completed, step, last_latency):
        while step <= num_steps:
            t0 = time.monotonic()
            try:
                self._check_fatal()
                self.monitor.beat(step, latency=last_latency)
                dead = self.monitor.dead_peers(members=self.members) \
                    & self.members
                if dead:
                    resumed = self.shrink(dead, program, scope)
                    if resumed:
                        completed = resumed
                        step = resumed + 1
                        continue
                self.monitor.stragglers(members=self.members)
                self.monitor.partitioned_peers(members=self.members)
                feed = self._feed_fn(step, self) if self._feed_fn else None
                with collective_deadline(cfg.collective_timeout):
                    report = self.guard.run(
                        program, feed=feed, fetch_list=self._fetch_list,
                        scope=scope)
                self.last_report = report
                if (len(self.members) > 1 and self._sync_every
                        and step % self._sync_every == 0):
                    self._sync(scope, sync_names, step)
            except DeadPeerError as e:
                resumed = self.shrink(e.dead, program, scope)
                if resumed:
                    completed = resumed
                    step = resumed + 1
                # else: no fleet-consistent checkpoint yet — retry the
                # step with the shrunken fleet, state as-is
                continue
            except CollectiveTimeoutError:
                # a timeout without a confirmed death: either a peer is
                # wedged-but-beating or the budget was too tight — check
                # once, shrink if someone actually died, otherwise
                # surface (a blind retry would hang again)
                dead = self.monitor.dead_peers(members=self.members) \
                    & self.members
                if not dead:
                    raise
                resumed = self.shrink(dead, program, scope)
                if resumed:
                    completed = resumed
                    step = resumed + 1
                continue
            last_latency = time.monotonic() - t0
            completed = step
            self.log.emit("step", step=step, worker=self.worker_index,
                          skipped=report.skipped, retries=report.retries,
                          latency=round(last_latency, 5))
            if (self._ckpt_dir and self._save_every
                    and step % self._save_every == 0):
                self.save(step, program, scope)
            step += 1
        self.monitor.leave()
        self.log.emit("final", step=completed,
                      generation=self.generation,
                      members=sorted(self.members))
        return {
            "worker": self.worker_index,
            "final_step": completed,
            "resumed_from": start if start else None,
            "generation": self.generation,
            "members": sorted(self.members),
            "max_blocked": max((s for _, s in self.block_log),
                               default=0.0),
            "counters": dict(self.log.counters),
            "events": list(self.log.events),
        }
