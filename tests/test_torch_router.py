"""The port's serving fleet on the CPU, against the JAX package's
(ServingRouter over local and store replicas; the heartbeat stores and
monitor, fault injection and integrity digests under it).

Setup: tests/test_serving.py's 2-layer softmax model (x: 6 -> 3), saved
by the JAX package and served by the port's replicas on ``CPUPlace()``.

Exactness bars:

- a routed reply equals, bit for bit, the same request served alone by a
  solo port ``ServingEngine`` with the same buckets (one bucket, one M:
  the test submits serially, so no two requests share a micro-batch);
- every reply, coalesced or not, failed over or replayed, is within
  1e-5 * max|ref| of the JAX ``Predictor`` at the request's own batch
  (the two packages sum the f32 matmuls in other orders).

Every status is decided without a race: heartbeats are fast
(``ElasticConfig(heartbeat_interval=0.05, miss_threshold=10)``), every
wait has a timeout, and the traffic of the rolling-reload drills is
gated on replies already received, not on sleeps. The SIGKILL drill of
a worker process keeps the reference's ``slow`` mark (chip_smoke.py's
phase 12c runs it on the card).
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from paddle_tpu import observability as jobs
from paddle_tpu.fluid import resilience as jres
from paddle_tpu.fluid.inference import Predictor as JaxPredictor
from paddle_tpu.integrity import digest as jdigest
from paddle_tpu.integrity import envelope as jenv
from paddle_tpu.parallel import elastic as jel
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.fluid import core
from paddle_tpu_torch.fluid.inference import Predictor
from paddle_tpu_torch.fluid.resilience import FaultInjector, FaultSpecError
from paddle_tpu_torch.integrity import digest as pdigest
from paddle_tpu_torch.integrity import envelope as penv
from paddle_tpu_torch.parallel import elastic as pel
from paddle_tpu_torch.parallel.elastic import (
    ElasticConfig, FileStore, HeartbeatMonitor, InMemoryStore,
)
from paddle_tpu_torch.serving import (
    BucketSpec, EngineClosedError, ModelRegistry, ServingEngine,
    ServingServer, ShedError,
)
from paddle_tpu_torch.serving.router import (
    LocalReplica, NoReplicasError, ReplicaWorker, RolloutError,
    ServingRouter, StoreReplica, local_fleet, make_engine_factory,
)
from test_serving import _build_and_save, _post

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUCKETS = [BucketSpec({"x": (6,)}, batch_sizes=(1, 2, 4, 8))]
CPU = core.CPUPlace()
WAIT = 30.0          # seconds: the bound of every blocking wait
TOL = 1e-5           # of max|ref|, against the JAX Predictor


@pytest.fixture(autouse=True)
def _reset():
    """Both packages' hubs are process-global, and so is each package's
    fault injector: every test starts clean and leaves nothing armed."""
    obs.reset()
    jobs.reset()
    FaultInjector.uninstall()
    yield
    FaultInjector.uninstall()


def _cfg(**kw):
    """Fast heartbeat config so death detection fits in a test: a beacon
    every 25 ms, dead after 0.5 s of silence (a beater starved for a few
    hundred ms on a loaded host must not read as a death)."""
    kw.setdefault("heartbeat_interval", 0.05)
    kw.setdefault("miss_threshold", 10)
    kw.setdefault("startup_grace", 5.0)
    return ElasticConfig(**kw)


def _fleet(dirname, n_replicas=2, **kw):
    kw.setdefault("config", _cfg())
    kw.setdefault("buckets", BUCKETS)
    kw.setdefault("max_wait_ms", 1.0)
    kw.setdefault("predictor_opts", {"place": CPU})
    return local_fleet(dirname, n_replicas=n_replicas, name="m", **kw)


def _factory(rid, **kw):
    kw.setdefault("predictor_opts", {"place": CPU})
    return make_engine_factory(name="m", replica_id=rid, **kw)


@pytest.fixture()
def model_dir(tmp_path):
    d = tmp_path / "m"
    _build_and_save(d)
    return d


@pytest.fixture()
def jref(model_dir):
    """The JAX package's predictor on the same saved model."""
    return JaxPredictor.from_model(str(model_dir))


def _close(out, jpred, x):
    """Hold one reply to the JAX Predictor at the request's batch."""
    ref = np.asarray(jpred.run({"x": x})[0])
    assert out.shape == ref.shape and out.dtype == ref.dtype
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=TOL * float(np.abs(ref).max()))


def _matches(out, jpred, x):
    ref = np.asarray(jpred.run({"x": x})[0])
    return bool(np.abs(out - ref).max() <= TOL * float(np.abs(ref).max()))


def _wait_for(cond, timeout=WAIT):
    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.01)
    return cond()


def _stall(engine):
    """Leave `engine` accepting work but never dispatching it (its queue
    only grows until the test releases it)."""
    engine.stop(drain=False, timeout=WAIT)
    engine._closed = False
    engine._stop_event.clear()


# ---------------------------------------------------------------------------
# dispatch: balance + bit identity
# ---------------------------------------------------------------------------

def test_fleet_bit_identity_and_balance(model_dir, jref):
    solo = ServingEngine(Predictor.from_model(str(model_dir), place=CPU),
                         buckets=BUCKETS, name="solo", max_wait_ms=1.0)
    router = _fleet(model_dir, n_replicas=2)
    try:
        rng = np.random.default_rng(3)
        reqs = [rng.normal(size=(2 + i % 3, 6)).astype(np.float32)
                for i in range(16)]
        for x in reqs:  # serial: each request is its own micro-batch
            out, = router.predict({"x": x}, timeout=WAIT)
            want, = solo.predict({"x": x}, timeout=WAIT)
            np.testing.assert_array_equal(out, want)
            _close(out, jref, x)
        stats = router.stats()
        assert stats["requests"] == 16
        assert stats["router_requests"] == 16
        assert stats["replicas_live"] == 2
        # both replicas served work: depth ties rotate round-robin, so
        # even a strictly serial stream spreads
        per = [r.stats()["requests"] for r in router._live.values()]
        assert sum(per) == 16 and all(n > 0 for n in per), per
        assert obs.gauge("serving.replicas_live") == 2
        assert obs.histogram("serving.dispatch_seconds")["count"] == 16
    finally:
        router.stop()
        solo.stop()


def test_router_wears_engine_duck_type(model_dir):
    router = _fleet(model_dir, n_replicas=2)
    try:
        assert router.queue_depth() == 0
        assert not router.closed
        assert router.request_timeout_s > 0
        assert isinstance(router.retry_after_hint(), float)
        out, = router.predict({"x": np.zeros((2, 6), np.float32)})
        assert out.shape == (2, 3)
    finally:
        router.stop()
    assert router.closed
    with pytest.raises(EngineClosedError):
        router.submit({"x": np.zeros((2, 6), np.float32)})


def test_bad_feeds_fail_fast_not_retried(model_dir):
    router = _fleet(model_dir, n_replicas=2)
    try:
        with pytest.raises((ValueError, KeyError)):
            router.submit({"wrong": np.zeros((2, 6), np.float32)})
        assert router.stats().get("router_retry", 0) == 0
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------

class _ShedFirst:
    """Wrap a replica so its first `n` submits shed — the router must
    steer those requests to a peer (and count the failovers)."""

    def __init__(self, inner, n=1):
        self._inner = inner
        self._left = n

    def submit(self, feeds, deadline_ms=None):
        if self._left > 0:
            self._left -= 1
            raise ShedError("synthetic shed", model=self._inner.name,
                            replica=self._inner.rid, retry_after=0.01)
        return self._inner.submit(feeds, deadline_ms=deadline_ms)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_shed_failover_moves_request_to_peer(model_dir, jref):
    router = _fleet(model_dir, n_replicas=2)
    try:
        for rid in list(router._live):
            router._live[rid] = _ShedFirst(router._live[rid], n=1)
        x = np.random.default_rng(4).normal(size=(2, 6)).astype(np.float32)
        # first pass: both candidates shed -> backoff round -> success
        out, = router.predict({"x": x}, timeout=WAIT)
        _close(out, jref, x)
        stats = router.stats()
        assert stats["failovers"] >= 2
        assert stats["router_retry"] >= 1
        assert obs.counter("serving.failovers") >= 2
        assert obs.counter("serving.router_retry") >= 1
    finally:
        router.stop()


def test_all_replicas_shedding_exhausts_to_shed_error(model_dir):
    router = _fleet(model_dir, n_replicas=2,
                    router_opts={"max_retries": 2, "retry_base_s": 0.01})
    try:
        for rid in list(router._live):
            router._live[rid] = _ShedFirst(router._live[rid], n=10_000)
        fut = router.submit({"x": np.zeros((2, 6), np.float32)})
        with pytest.raises(ShedError) as ei:
            fut.result(timeout=WAIT)
        assert ei.value.model == "m"
        assert ei.value.retry_after is not None
    finally:
        router.stop()


def test_kill_replays_queued_requests_on_survivor(model_dir, jref):
    """The kill side of the preemption contract: a dead replica's queued
    requests fail internally with EngineClosedError and the router
    replays every one on the survivor — zero client-visible failures."""
    router = _fleet(model_dir, n_replicas=2)
    try:
        victim = router._live[0]
        _stall(victim.engine)
        rng = np.random.default_rng(5)
        reqs = [rng.normal(size=(2, 6)).astype(np.float32)
                for _ in range(8)]
        futs = [router.submit({"x": v}) for v in reqs]
        # least-loaded dispatch with rotated ties puts one of the first
        # two requests on the (never-draining) victim
        assert victim.engine.queue_depth() > 0
        victim.kill()
        for f, x in zip(futs, reqs):
            out, = f.result(timeout=WAIT)
            _close(out, jref, x)
        assert obs.counter("serving.failovers") >= 1
    finally:
        router.stop()


def test_dead_replica_detected_and_standby_backfills(model_dir):
    router = _fleet(model_dir, n_replicas=2, n_standby=1)
    try:
        assert router.replicas_live() == [0, 1]
        t0 = time.monotonic()
        router._live[0].kill()
        assert _wait_for(lambda: 0 not in router.replicas_live())
        # declared dead after the silence bound (10 x 50 ms), not before
        assert time.monotonic() - t0 >= router.config.dead_after * 0.5
        assert router.replicas_live() == [1, 2]  # standby 2 backfilled
        assert obs.counter("serving.replica_dead") == 1
        out, = router.predict({"x": np.zeros((2, 6), np.float32)})
        assert out.shape == (2, 3)
    finally:
        router.stop()


def test_remove_replica_drains_queued_work(model_dir, jref):
    """The drain side: planned removal finishes the replica's queue
    instead of replaying it."""
    router = _fleet(model_dir, n_replicas=2)
    try:
        victim = router._live[0]
        _stall(victim.engine)
        x = np.random.default_rng(6).normal(size=(2, 6)).astype(np.float32)
        futs = [router.submit({"x": x}) for _ in range(4)]
        assert victim.engine.queue_depth() > 0

        done = threading.Event()

        def remove():
            victim.engine.start()  # dispatch resumes so the drain ends
            router.remove_replica(0, drain=True)
            done.set()

        threading.Thread(target=remove, daemon=True).start()
        for f in futs:
            out, = f.result(timeout=WAIT)
            _close(out, jref, x)
        assert done.wait(timeout=WAIT)
        assert router.replicas_live() == [1]
        # clean departure: the survivor never declared it dead
        assert obs.counter("serving.replica_dead") == 0
        assert obs.counter("serving.failovers") == 0
        with pytest.raises(KeyError):
            router.remove_replica(0)
    finally:
        router.stop()


def test_held_replicas_kill_backfill_and_drain(model_dir, jref):
    """chip_smoke.py's phase 12b drill from public parts: replica 0 and
    the warm standby 2 are built but not started (``auto_start=False``),
    so their queues only fill. kill() of 0 replays its queue on the
    survivor and the standby takes its place; started, the standby
    drains its queue on removal."""
    store = InMemoryStore()
    reps = [LocalReplica(
        rid, _factory(rid, buckets=BUCKETS, max_wait_ms=1.0,
                      auto_start=rid == 1),
        store, name="m", config=_cfg(), dirname=str(model_dir))
        for rid in range(3)]
    victim, standby = reps[0], reps[2]
    router = ServingRouter(reps[:2], store=store, name="m", config=_cfg(),
                           standby=[standby], scale_up_depth=1 << 30)
    try:
        rng = np.random.default_rng(7)
        reqs = [rng.normal(size=(2, 6)).astype(np.float32)
                for _ in range(8)]
        futs = [router.submit({"x": x}) for x in reqs]
        # rotated ties put one of the first two requests on each replica
        assert victim.engine.queue_depth() > 0
        victim.kill()
        for f, x in zip(futs, reqs):
            out, = f.result(timeout=WAIT)
            _close(out, jref, x)
        assert _wait_for(lambda: router.replicas_live() == [1, 2])
        assert obs.counter("serving.replica_dead") == 1

        futs = [router.submit({"x": x}) for x in reqs[:4]]
        assert standby.engine.queue_depth() > 0
        standby.engine.start()
        router.remove_replica(2, drain=True)
        for f, x in zip(futs, reqs):
            out, = f.result(timeout=WAIT)
            _close(out, jref, x)
        assert router.replicas_live() == [1]
        assert obs.counter("serving.replica_dead") == 1
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# autoscale
# ---------------------------------------------------------------------------

class _FakeReplica:
    """Dispatch-surface stub with a settable queue depth; resolves every
    submit immediately (the autoscale tests drive the pressure loop, not
    the model)."""

    def __init__(self, rid, name="m"):
        self.rid = rid
        self.name = name
        self.depth = 0
        self.stopped = False

    def submit(self, feeds, deadline_ms=None):
        fut = Future()
        fut.set_result([np.zeros((1, 3), np.float32)])
        return fut

    def queue_depth(self):
        return self.depth

    def stats(self):
        return {}

    def retry_after_hint(self):
        return None

    def stop(self, drain=True, timeout=30.0):
        self.stopped = True


def test_autoscale_up_on_pressure_then_park_on_idle():
    live = [_FakeReplica(0), _FakeReplica(1)]
    standby = [_FakeReplica(2)]
    router = ServingRouter(
        live, store=InMemoryStore(), name="m",
        config=_cfg(startup_grace=60.0),  # fakes never beat: "alive"
        standby=standby, scale_up_depth=4, scale_down_depth=1,
        scale_window_s=0.2, health_interval=0.02)
    try:
        for r in live:
            r.depth = 8  # sustained pressure on every live replica
        assert _wait_for(lambda: 2 in router.replicas_live())
        assert router.replicas_live() == [0, 1, 2]
        assert router._scaled_up == [2]

        for r in live + standby:
            r.depth = 0  # sustained idleness: the scaled-up one parks
        assert _wait_for(lambda: 2 not in router.replicas_live())
        assert router.replicas_live() == [0, 1]
        assert router._scaled_up == []
        assert [r.rid for r in router._standby] == [2]
        assert not standby[0].stopped  # parked WARM, not stopped
    finally:
        router.stop()


def test_scale_down_never_below_min_replicas():
    router = ServingRouter(
        [_FakeReplica(0)], store=InMemoryStore(), name="m",
        config=_cfg(startup_grace=60.0), min_replicas=1,
        start_health=False)
    try:
        router._scaled_up = [0]  # even if bookkeeping said scalable,
        router._scale_down()     # the floor holds
        assert router.replicas_live() == [0]
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# rolling reload
# ---------------------------------------------------------------------------

def _hammer(router, stop_evt, errors, results, seed):
    rng = np.random.default_rng(seed)
    while not stop_evt.is_set():
        x = rng.normal(size=(2, 6)).astype(np.float32)
        try:
            out, = router.predict({"x": x}, timeout=WAIT)
        except Exception as e:  # noqa: BLE001 — the assertion target
            errors.append(e)
            return
        results.append((x, out))


def _clients(router, n, results, errors):
    stop_evt = threading.Event()
    threads = [threading.Thread(
        target=_hammer, args=(router, stop_evt, errors, results, 20 + i),
        daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    # gate, not a sleep: traffic is flowing before the rollout starts
    assert _wait_for(lambda: len(results) >= 4 * n or errors)
    return stop_evt, threads


def test_rolling_reload_zero_downtime(model_dir, jref, tmp_path):
    d2 = tmp_path / "v2"
    _build_and_save(d2, seed=11)  # genuinely different weights
    jref2 = JaxPredictor.from_model(str(d2))
    router = _fleet(model_dir, n_replicas=2)
    try:
        errors, results = [], []
        stop_evt, threads = _clients(router, 3, results, errors)
        done = router.rolling_reload(
            d2, probe_feeds={"x": np.zeros((1, 6), np.float32)})
        n_at_done = len(results)
        assert _wait_for(lambda: len(results) >= n_at_done + 6 or errors)
        stop_evt.set()
        for t in threads:
            t.join(timeout=WAIT)
        assert not errors, errors[:3]  # ZERO failed requests
        assert sorted(done) == [0, 1]
        assert router.dirname == str(d2)
        assert all(r.version == 2 for r in router._live.values())
        # every mid-rollout answer is ONE of the two versions — never a
        # blend (v1 and v2 are far apart, so the bound tells them apart)
        assert all(_matches(out, jref, x) or _matches(out, jref2, x)
                   for x, out in results)
        assert obs.gauge("serving.rollout_state") == 0
        # steady state after the rollout: v2 answers only
        x = np.random.default_rng(9).normal(size=(2, 6)).astype(np.float32)
        for _ in range(4):
            out, = router.predict({"x": x})
            _close(out, jref2, x)
    finally:
        router.stop()


def test_rolling_reload_rolls_back_on_seeded_bad_version(
        model_dir, jref, tmp_path):
    """Replica 0 upgrades fine; replica 1's reload is seeded to fail —
    the rollout rolls replica 0 BACK to v1 and raises, leaving the fleet
    uniformly on v1 with zero downtime."""
    d2 = tmp_path / "v2"
    _build_and_save(d2, seed=11)
    router = _fleet(model_dir, n_replicas=2)
    try:
        flaky = router._live[1]
        orig_reload = flaky.reload

        def seeded(dirname):
            if str(dirname) == str(d2):
                raise RuntimeError("seeded bad version")
            return orig_reload(dirname)

        flaky.reload = seeded
        errors, results = [], []
        stop_evt, threads = _clients(router, 1, results, errors)
        with pytest.raises(RolloutError, match="seeded bad version"):
            router.rolling_reload(
                d2, probe_feeds={"x": np.zeros((1, 6), np.float32)})
        stop_evt.set()
        for t in threads:
            t.join(timeout=WAIT)
        assert not errors, errors[:3]
        assert router.dirname == str(model_dir)  # rollout never landed
        assert router.replicas_live() == [0, 1]
        assert all(r.dirname == str(model_dir)
                   for r in router._live.values())
        assert obs.gauge("serving.rollout_state") == 2
        x = np.random.default_rng(10).normal(size=(2, 6)).astype(np.float32)
        for _ in range(4):  # uniformly v1
            out, = router.predict({"x": x})
            _close(out, jref, x)
    finally:
        router.stop()


def test_rolling_reload_corrupt_dir_leaves_v1_serving(
        model_dir, jref, tmp_path):
    """The first replica's rebuild raises (missing model dir): no swap
    ever happens, the rollout aborts, and v1 keeps serving everywhere."""
    router = _fleet(model_dir, n_replicas=2)
    try:
        with pytest.raises(RolloutError):
            router.rolling_reload(tmp_path / "no-such-model")
        assert router.replicas_live() == [0, 1]
        assert router.dirname == str(model_dir)
        x = np.random.default_rng(12).normal(size=(2, 6)).astype(np.float32)
        out, = router.predict({"x": x})
        _close(out, jref, x)
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# FileStore transport (per-process replicas, here a worker thread)
# ---------------------------------------------------------------------------

def test_store_replica_roundtrip_and_ctl_reload(model_dir, jref, tmp_path):
    solo = ServingEngine(Predictor.from_model(str(model_dir), place=CPU),
                         name="solo", max_wait_ms=1.0)
    store = FileStore(tmp_path / "store")
    cfg = _cfg()
    worker = ReplicaWorker(store, 0, _factory(0, warm=False), model_dir,
                           name="m", config=cfg)
    wt = threading.Thread(target=worker.run_forever, daemon=True)
    wt.start()
    proxy = StoreReplica(0, store, name="m", config=cfg)
    router = ServingRouter([proxy], store=store, name="m", config=cfg,
                           dirname=model_dir)
    try:
        x = np.random.default_rng(13).normal(size=(3, 6)).astype(np.float32)
        out, = router.predict({"x": x}, timeout=WAIT)
        # float32 JSON round-trips are exact: wire == in-process
        want, = solo.predict({"x": x}, timeout=WAIT)
        np.testing.assert_array_equal(out, want)
        _close(out, jref, x)

        assert proxy.reload(model_dir, timeout=WAIT) == 2
        assert worker.version == 2
        out, = router.predict({"x": x}, timeout=WAIT)
        np.testing.assert_array_equal(out, want)
    finally:
        router.stop()
        wt.join(timeout=WAIT)
        solo.stop()
    assert not wt.is_alive()  # ctl stop terminated the worker loop


def test_store_replica_ctl_reload_failure_acks_error(model_dir, tmp_path):
    store = FileStore(tmp_path / "store")
    cfg = _cfg()
    worker = ReplicaWorker(store, 0, _factory(0, warm=False), model_dir,
                           name="m", config=cfg)
    wt = threading.Thread(target=worker.run_forever, daemon=True)
    wt.start()
    proxy = StoreReplica(0, store, name="m", config=cfg)
    try:
        with pytest.raises(RolloutError, match="failed reload"):
            proxy.reload(tmp_path / "nope", timeout=WAIT)
        assert worker.version == 1  # no swap, no limbo
    finally:
        proxy.stop(timeout=WAIT)
        wt.join(timeout=WAIT)
    assert not wt.is_alive()


def test_silent_store_replica_requests_replay_on_survivor(
        model_dir, jref, tmp_path):
    """A store replica whose worker never comes up: its in-flight requests
    are orphaned until the health loop declares it dead (startup grace),
    fails them with ReplicaGoneError, and the router replays each on the
    live local replica — zero client failures."""
    store = FileStore(tmp_path / "store")
    cfg = _cfg(startup_grace=0.4)
    ghost = StoreReplica(0, store, name="m", config=cfg)  # no worker
    real = LocalReplica(
        1, _factory(1, warm=False, buckets=BUCKETS, max_wait_ms=1.0),
        store, name="m", config=cfg, dirname=str(model_dir))
    router = ServingRouter([ghost, real], store=store, name="m",
                           config=cfg, dirname=model_dir)
    try:
        rng = np.random.default_rng(14)
        reqs = [rng.normal(size=(2, 6)).astype(np.float32)
                for _ in range(6)]
        futs = [router.submit({"x": v}) for v in reqs]
        for f, x in zip(futs, reqs):
            out, = f.result(timeout=WAIT)
            _close(out, jref, x)
        assert router.replicas_live() == [1]
        assert obs.counter("serving.replica_dead") == 1
    finally:
        router.stop()


# ---------------------------------------------------------------------------
# fault-site drills
# ---------------------------------------------------------------------------

@pytest.mark.faults
@pytest.mark.chaos
def test_replica_fault_drill_absorbed_by_failover(model_dir, jref):
    router = _fleet(model_dir, n_replicas=2)
    FaultInjector.install("replica:at=1:RuntimeError")
    try:
        x = np.random.default_rng(15).normal(size=(2, 6)).astype(np.float32)
        for _ in range(4):  # first admission blows up; request survives
            out, = router.predict({"x": x}, timeout=WAIT)
            _close(out, jref, x)
        assert obs.counter("serving.failovers") >= 1
    finally:
        FaultInjector.uninstall()
        router.stop()


@pytest.mark.faults
@pytest.mark.chaos
def test_dispatch_and_slow_fault_drills(model_dir, jref, monkeypatch):
    router = _fleet(model_dir, n_replicas=2,
                    router_opts={"retry_base_s": 0.01})
    monkeypatch.setenv("PADDLE_TPU_FAULT_SLOW_S", "0.02")
    inj = FaultInjector.install(
        "dispatch:at=1:RuntimeError;replica:every=3:slow")
    try:
        x = np.random.default_rng(16).normal(size=(2, 6)).astype(np.float32)
        for _ in range(6):  # dispatch blip -> backoff retry; slow
            out, = router.predict({"x": x}, timeout=WAIT)  # brownouts ride
            _close(out, jref, x)
        assert router.stats()["router_retry"] >= 1
        fires = {c["site"]: c["fires"] for c in inj.stats()}
        assert fires["dispatch"] == 1 and fires["replica"] >= 2
    finally:
        FaultInjector.uninstall()
        router.stop()


# ---------------------------------------------------------------------------
# process fleet (SIGKILL drill)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.multihost
def test_process_fleet_survives_sigkill(model_dir, jref, tmp_path):
    store_dir = tmp_path / "store"
    buckets_json = '[{"feeds": {"x": [6]}, "batch_sizes": [1,2,4,8]}]'
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.router",
         "--store", str(store_dir), "--rid", str(rid), "--name", "m",
         "--model-dir", str(model_dir), "--no-warm", "--place", "cpu",
         "--heartbeat-interval", "0.1", "--buckets", buckets_json],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rid in (0, 1)]
    store = FileStore(store_dir)
    cfg = ElasticConfig(heartbeat_interval=0.1, miss_threshold=4,
                        startup_grace=120.0)
    router = ServingRouter(
        [StoreReplica(r, store, name="m", config=cfg) for r in (0, 1)],
        store=store, name="m", config=cfg, dirname=model_dir)
    try:
        x = np.random.default_rng(17).normal(size=(2, 6)).astype(np.float32)
        out, = router.predict({"x": x}, timeout=120)
        _close(out, jref, x)

        procs[0].kill()  # SIGKILL: no drain, no goodbye
        assert _wait_for(lambda: 0 not in router.replicas_live())
        assert router.replicas_live() == [1]
        for _ in range(4):
            out, = router.predict({"x": x}, timeout=60)
            _close(out, jref, x)
    finally:
        router.stop()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)


def test_worker_cli_runs_on_the_card_unless_told(model_dir, tmp_path):
    """With no card visible, the worker refuses to start unless given
    ``--place cpu`` (no silent fallback); the flag is the counterpart of
    the JAX test's JAX_PLATFORMS=cpu."""
    code = ("import sys, torch; torch.cuda.is_available = lambda: False; "
            "from paddle_tpu_torch.serving.router import worker_main; "
            "sys.exit(worker_main(sys.argv[1:]))")
    r = subprocess.run(
        [sys.executable, "-c", code, "--store", str(tmp_path / "s"),
         "--rid", "0", "--model-dir", str(model_dir)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "CPUPlace" in r.stderr


def test_fleet_builders_need_a_card_or_the_cpu(model_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        make_engine_factory(name="m")(model_dir)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        local_fleet(model_dir, n_replicas=1, name="m", config=_cfg())
    with pytest.raises(RuntimeError, match="per_device"):
        local_fleet(model_dir, n_replicas=1, name="m", config=_cfg(),
                    per_device=True)
    # an explicit torch device pins the replica's predictor
    eng = make_engine_factory(name="m", device=torch.device("cpu"),
                              warm=False)(model_dir)
    try:
        assert eng.predictor.device == torch.device("cpu")
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# registry + HTTP integration
# ---------------------------------------------------------------------------

def test_published_router_behind_http(model_dir, jref):
    reg = ModelRegistry()
    router = _fleet(model_dir, n_replicas=2)
    reg.publish("m", router, dirname=model_dir)
    srv = ServingServer(reg).start()
    try:
        x = np.random.default_rng(18).normal(size=(2, 6)).astype(np.float32)
        code, doc = _post(srv.url + "/v1/models/m:predict",
                          {"feeds": {"x": x.tolist()}})
        assert code == 200
        o = doc["outputs"][0]
        _close(np.asarray(o["data"], dtype=o["dtype"]).reshape(o["shape"]),
               jref, x)
        # /healthz reads the router through the registry's engine surface
        with urllib.request.urlopen(srv.url + "/healthz", timeout=10) as r:
            health = json.load(r)
        assert health["models"]["m"]["stats"]["replicas_live"] == 2

        # one synthetic full-shed pass so every fleet metric exists
        saved = dict(router._live)
        for rid in list(router._live):
            router._live[rid] = _ShedFirst(router._live[rid], n=1)
        code, _doc = _post(srv.url + "/v1/models/m:predict",
                           {"feeds": {"x": x.tolist()}})
        assert code == 200  # retried inside the router, client never saw it
        router._live.update(saved)
        prom = urllib.request.urlopen(
            srv.url + "/metrics", timeout=10).read().decode()
        assert "paddle_tpu_serving_replicas_live" in prom
        assert obs.gauge("serving.replicas_live") == 2
        assert "paddle_tpu_serving_failovers" in prom
        assert "paddle_tpu_serving_router_retry" in prom
        assert "paddle_tpu_serving_rollout_state" in prom

        # published engines reload through their own surface, not the
        # registry's build-and-swap
        with pytest.raises(ValueError, match="rolling_reload"):
            reg.reload("m")
    finally:
        srv.stop()
        router.stop()


@pytest.mark.parametrize("how", ["stopped", "no_live_replicas"])
def test_stopped_router_maps_to_503(model_dir, how):
    reg = ModelRegistry()
    router = _fleet(model_dir, n_replicas=1,
                    router_opts={"max_retries": 0})
    reg.publish("m", router)
    srv = ServingServer(reg).start()
    try:
        if how == "stopped":
            router.stop()
        else:
            router.remove_replica(0, drain=True)
        code, doc = _post(srv.url + "/v1/models/m:predict",
                          {"feeds": {"x": [[0.0] * 6]}})
        assert code == 503
        assert doc["model"] == "m"
        if how == "no_live_replicas":
            assert "no live replicas" in doc["error"]
            with pytest.raises(NoReplicasError):
                router.predict({"x": np.zeros((1, 6), np.float32)})
    finally:
        srv.stop()
        router.stop()


# ---------------------------------------------------------------------------
# the machinery under the router, against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "replica:at=1:RuntimeError",
    "dispatch:every=1:slow=0.05",
    "wire:at=1:corrupt=bitflip",
    "run:every=0:RuntimeError",
    "nosuch:at=1:RuntimeError",
    "dispatch:at=1:nan",
    "replica:at=1:corrupt=bitflip",
    "mailbox:at=1:corrupt",
    "wire:at=1:corrupt=shred",
    "fetch:at=1:NoSuchError",
    "",
])
def test_fault_spec_grammar_matches_jax(spec):
    """The same PADDLE_TPU_FAULT_SPEC parses, or fails with the same
    message, in both packages (up to the hint in parentheses: the port
    has no reader EOFException to offer yet)."""
    def parse(mod):
        try:
            return [(c.site, c.mode, c.n, c.action_name, c.slow_s,
                     c.corrupt_mode) for c in mod.FaultInjector(spec).clauses]
        except mod.FaultSpecError as e:
            return str(e).split(" (want a builtin")[0]

    assert parse(__import__("paddle_tpu_torch.fluid.resilience",
                            fromlist=["x"])) == parse(jres)


def test_fault_corrupt_matches_jax():
    data = bytes(range(256)) * 3
    arr = np.arange(64, dtype=np.int8).reshape(8, 8)
    from paddle_tpu_torch.fluid import resilience as pres
    for mode in ("bitflip", "truncate", "torn"):
        assert pres.corrupt_bytes(mode, data) == jres.corrupt_bytes(
            mode, data)
        np.testing.assert_array_equal(pres.corrupt_array(mode, arr),
                                      jres.corrupt_array(mode, arr))
    with pytest.raises(FaultSpecError):
        FaultInjector("wire:at=1:corrupt")
    inj = FaultInjector.install("mailbox:every=2:corrupt=torn")
    assert pres.fault_corrupt("mailbox", data) == data
    assert pres.fault_corrupt("mailbox", data) == jres.corrupt_bytes(
        "torn", data)
    assert inj.stats()[0]["fires"] == 1


def test_integrity_digests_match_jax():
    doc = {"b": [1, 2.5, "x"], "a": {"z": None}}
    arr = np.random.default_rng(0).normal(size=(3, 5)).astype(np.float32)
    assert pdigest.doc_digest(doc) == jdigest.doc_digest(doc)
    assert pdigest.bytes_digest(b"abc") == jdigest.bytes_digest(b"abc")
    assert pdigest.tensor_digest(arr) == jdigest.tensor_digest(arr)
    assert pdigest.tensor_digest(torch.from_numpy(arr)) == \
        jdigest.tensor_digest(arr)
    blob = penv.seal_bytes(b"payload", kind="kv")
    assert blob == jenv.seal_bytes(b"payload", kind="kv")
    assert jenv.unseal_bytes(blob, kind="kv") == b"payload"
    assert penv.stamp_doc(doc) == jenv.stamp_doc(doc)
    ok, body = penv.check_doc(jenv.stamp_doc(doc))
    assert ok and body == doc
    bad = dict(penv.stamp_doc(doc), b=[1])
    assert penv.check_doc(bad)[0] is False
    with pytest.raises(pdigest.IntegrityError, match="digest mismatch"):
        penv.unseal_bytes(blob[:-1] + b"X")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_file_store_docs_cross_packages(tmp_path, writer):
    """A FileStore written by one package reads back in the other: the
    same files, stamps and tolerant scan (a torn doc is skipped and
    counted, a tampered one rejected)."""
    w = (pel if writer == "port" else jel).FileStore(tmp_path)
    r = (jel if writer == "port" else pel).FileStore(tmp_path)
    w.put("serve/m/req/0", "k1", {"feeds": {"x": 1}, "t": 1.5})
    w.put("serve/m/req/0", "k2", {"feeds": {"x": 2}, "t": 2.5})
    assert r.all("serve/m/req/0") == w.all("serve/m/req/0") == {
        "k1": {"feeds": {"x": 1}, "t": 1.5},
        "k2": {"feeds": {"x": 2}, "t": 2.5}}
    d = tmp_path / "serve" / "m" / "req" / "0"
    (d / "torn.json").write_text('{"feeds": ')
    tampered = json.loads((d / "k2.json").read_text())
    tampered["t"] = 9.9
    (d / "k2.json").write_text(json.dumps(tampered))
    time.sleep(0.06)  # past FileStore.MTIME_SLACK_NS: no stale cache
    assert set(pel.FileStore(tmp_path).all("serve/m/req/0")) == {"k1"}
    assert obs.counter("integrity.mailbox_doc_torn") == 1
    assert obs.counter("integrity.mailbox_doc_corrupt") == 1
    r.delete("serve/m/req/0", "k1")
    assert "k1" not in w.all("serve/m/req/0")


def test_heartbeat_monitor_classifies_like_jax():
    """The same beacon table classifies the same way in both packages:
    dead (silent past the bound), not yet appeared (inside the startup
    grace), left (clean goodbye), stragglers (latency over 3x the
    median)."""
    now = 1000.0
    table = {
        0: {"worker": 0, "step": 10, "time": now - 0.01, "latency": 0.01,
            "state": "alive", "generation": 0},
        1: {"worker": 1, "step": 10, "time": now - 1.0, "latency": 0.01,
            "state": "alive", "generation": 0},
        2: {"worker": 2, "step": 10, "time": now - 5.0, "latency": 0.01,
            "state": "left", "generation": 0},
        3: {"worker": 3, "step": 10, "time": now - 0.01, "latency": 0.5,
            "state": "alive", "generation": 0},
        4: {"worker": 4, "step": 10, "time": now - 0.01, "latency": 0.011,
            "state": "alive", "generation": 0},
    }

    def classify(mod):
        store = mod.InMemoryStore()
        for w, rec in table.items():
            store.put("heartbeat", w, rec)
        cfg = mod.ElasticConfig(heartbeat_interval=0.1, miss_threshold=3,
                                startup_grace=0.0)
        mon = mod.HeartbeatMonitor(store, -1, world_size=6, config=cfg)
        return (mon.dead_peers(now=now), mon.stragglers(step_lag=False),
                sorted(mon.latencies()), mon.extras("state"),
                mon.log.counters)

    got, want = classify(pel), classify(jel)
    assert got[:4] == want[:4]
    # worker 5 never beat, but `now` predates the monitor's birth: it is
    # still inside its startup grace
    assert got[0] == {1} and got[1] == {3}
    assert dict(got[4]) == dict(want[4])


def test_monitor_beat_fires_heartbeat_fault_and_leaves():
    store = InMemoryStore()
    mon = HeartbeatMonitor(store, 0, world_size=1, config=_cfg())
    mon.beat(1, latency=0.5, extra={"queue_depth": 3, "step": 99})
    rec = store.all("heartbeat")["0"]
    assert rec["queue_depth"] == 3 and rec["step"] == 1  # core wins
    mon.keepalive()
    assert store.all("heartbeat")["0"]["queue_depth"] == 3
    mon.leave()
    assert store.all("heartbeat")["0"]["state"] == "left"
    FaultInjector.install("heartbeat:at=1:ConnectionError")
    with pytest.raises(ConnectionError, match="injected fault"):
        mon.beat(2)
    assert store.all("heartbeat")["0"]["step"] == 1  # the beacon never landed
