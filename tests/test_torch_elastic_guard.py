"""The port's elastic training driver (paddle_tpu_torch/parallel/
elastic.py ``FleetGuard``) against the JAX package's.

Ported from tests/test_elastic.py (:356-443, :537-795) and
tests/test_multihost_elastic.py:

- store barriers and the all-reduce over the live members, their
  deadlines, and ``DeadPeerError`` when a waited-on peer is confirmed
  dead;
- ``shrink_mesh``, and ``StackedDpProgram.shrink_dp`` (through
  ``LocalSGDProgram``) on 3 gloo ranks where one rank's process ends
  for real (tests/torch_elastic_ranks.py): the survivors rebuild their
  group without it and the next step's average divides by 2;
- the 4-worker kill, detect, shrink and resume run on threads and an
  ``InMemoryStore``, the clean run (its parameters against the JAX
  package's fleet from the same start) and the chaos run;
- 3 worker processes on a ``FileStore``, one of them sent SIGKILL.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import executor as jexecutor
from paddle_tpu.fluid import framework as jframework
from paddle_tpu.fluid import unique_name as junique_name
from paddle_tpu.parallel import elastic as JE

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as executor_mod
from paddle_tpu_torch.fluid import framework, unique_name
from paddle_tpu_torch.fluid import resilience as R
from paddle_tpu_torch.parallel import checkpoint as ckpt
from paddle_tpu_torch.parallel import elastic as E
from paddle_tpu_torch.parallel import fleet as fleet_mod
from paddle_tpu_torch.parallel import mesh as mesh_mod

import torch_elastic_ranks as ter
import torch_ranks as tr

CPU = ["cpu"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh():
    tr.fresh_port_state()
    R.FaultInjector.uninstall()
    yield
    R.FaultInjector.uninstall()
    ckpt.finalize()


def _cfg(**kw):
    """Test-speed knobs: sub-second detection, generous startup."""
    kw.setdefault("heartbeat_interval", 0.05)
    kw.setdefault("miss_threshold", 4)
    kw.setdefault("collective_timeout", 5.0)
    kw.setdefault("startup_grace", 2.0)
    return E.ElasticConfig(**kw)


# ---------------------------------------------------------------------------
# barriers, the store all-reduce, dead peers
# ---------------------------------------------------------------------------


def test_dead_peer_error_is_a_typed_collective_timeout():
    e = E.DeadPeerError("gone", dead=[1, 3])
    assert isinstance(e, R.CollectiveTimeoutError)
    assert e.dead == frozenset({1, 3})
    assert E.CollectiveTimeoutError is R.CollectiveTimeoutError
    assert E.collective_deadline is R.collective_deadline
    assert sorted(E.__all__) == sorted(JE.__all__)


def test_elastic_barrier_times_out_within_budget():
    guard = E.FleetGuard(None, store=E.InMemoryStore(), worker_index=0,
                         world_size=2, devices=CPU,
                         config=_cfg(collective_timeout=0.3,
                                     startup_grace=30))
    # a one-rank world: the barrier goes through the guard's store,
    # where worker 1 never arrives
    fl = fleet_mod.Fleet().init(
        fleet_mod.UserDefinedRoleMaker(worker_num=1)).attach_elastic(guard)
    t0 = time.monotonic()
    with pytest.raises(R.CollectiveTimeoutError, match="timed out"):
        fl.barrier_worker()
    assert time.monotonic() - t0 < 2.0
    what, blocked = guard.block_log[-1]
    assert "barrier" in what and blocked <= 0.3 + 0.5


def test_armed_deadline_caps_barrier_budget():
    guard = E.FleetGuard(None, store=E.InMemoryStore(), worker_index=0,
                         world_size=2, devices=CPU,
                         config=_cfg(collective_timeout=30,
                                     startup_grace=30))
    t0 = time.monotonic()
    with R.collective_deadline(0.2):
        with pytest.raises(R.CollectiveTimeoutError):
            guard.barrier("capped")
    assert time.monotonic() - t0 < 2.0


def test_wait_aborts_early_on_confirmed_dead_peer():
    store = E.InMemoryStore()
    cfg = _cfg(heartbeat_interval=0.02, miss_threshold=2,
               collective_timeout=10.0)
    guard = E.FleetGuard(None, store=store, worker_index=0, world_size=2,
                         config=cfg, devices=CPU)
    peer = E.HeartbeatMonitor(store, 1, 2, config=cfg)
    guard.monitor.beat(1)
    peer.beat(1)
    time.sleep(cfg.dead_after + 0.1)   # peer goes silent
    t0 = time.monotonic()
    with pytest.raises(E.DeadPeerError) as exc:
        guard.barrier("doomed")
    assert exc.value.dead == frozenset({1})
    assert time.monotonic() - t0 < 3.0


def test_allreduce_mean_over_live_members():
    got = {}
    for name, pkg in (("jax", JE), ("port", E)):
        store = pkg.InMemoryStore()
        kw = {} if pkg is JE else {"devices": CPU}
        guards = [pkg.FleetGuard(None, store=store, worker_index=w,
                                 world_size=2, config=_cfg(), **kw)
                  for w in range(2)]
        for g in guards:
            g.monitor.beat(1)
        results = [None, None]

        def run(w):
            results[w] = guards[w].allreduce_mean(
                np.full(3, float(w * 2 + 1)), tag="t1")

        threads = [threading.Thread(target=run, args=(w,))
                   for w in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        got[name] = results
    for w in range(2):
        np.testing.assert_array_equal(got["port"][w], got["jax"][w])
        np.testing.assert_allclose(got["port"][w], np.full(3, 2.0))


def test_members_map_onto_devices():
    exe = fluid.Executor(fluid.CPUPlace())
    g = E.FleetGuard(exe, world_size=3)
    assert set(g._device_of.values()) == {torch.device("cpu")}
    assert g.mesh.shape == {"dp": 3}
    devs = [torch.device("cpu", i) for i in range(2)]
    g = E.FleetGuard(exe, world_size=3, devices=devs)
    assert [g._device_of[w] for w in range(3)] == [devs[0], devs[1],
                                                   devs[0]]
    assert E.FleetGuard(exe, world_size=1).mesh is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CPUPlace"):
            E.FleetGuard(None, world_size=2)


# ---------------------------------------------------------------------------
# shrink_mesh and shrink_dp
# ---------------------------------------------------------------------------


def test_shrink_mesh_survivors_and_dead():
    mesh = mesh_mod.RankGroup(range(8), 0, None, "gloo", "cpu")
    small = mesh_mod.shrink_mesh(mesh, survivors=[1, 5])
    assert small.shape == {"dp": 2} and small.ranks == (1, 5)
    assert small.rank is None           # rank 0 is not a survivor
    assert mesh_mod.shrink_mesh(mesh, dead={0, 1}).shape == {"dp": 6}
    with pytest.raises(ValueError, match="no survivors"):
        mesh_mod.shrink_mesh(mesh, survivors=[])
    with pytest.raises(ValueError, match="out of range"):
        mesh_mod.shrink_mesh(mesh, survivors=[0, 99])
    tp = mesh_mod.RankGroup(range(8), 0, None, "gloo", "cpu",
                            {"dp": 4, "tp": 2})
    with pytest.raises(NotImplementedError, match="pure-dp"):
        mesh_mod.shrink_mesh(tp, survivors=[0, 1])


def test_shrink_dp_after_a_rank_exits_for_real(tmp_path):
    """3 gloo ranks train LocalSGD (k = 1) for 2 steps; rank 1's process
    then ends. The survivors see it go silent, ``shrink_dp`` refuses a
    lone survivor and an out-of-range position before changing anything,
    then rebuilds the group over ranks 0 and 2 alone (the dead rank
    never calls it), and the next step, its batch split over 2 ranks,
    lands where one SGD step on the whole batch does: the average
    divides by 2, not 3."""
    rng = np.random.default_rng(0)

    def feed(n):
        x = rng.standard_normal((n, 6)).astype("float32")
        return {"cx": x,
                "cy": (x.sum(1, keepdims=True) * 0.5).astype("float32")}

    feeds = [feed(12), feed(12), feed(8)]
    out, code = ter.run_with_a_victim(
        ter.lsgd_shrink, 3, 1, tmp_path / "ranks", args=(feeds, 2),
        timeout=120)
    assert code == ter.VICTIM_EXIT and sorted(out) == [0, 2]
    for rank, o in out.items():
        assert o["refusals"][0].startswith("LocalSGD needs >= 2 surviving")
        assert "out of range for dp=3" in o["refusals"][1]
        assert o["size_after_refusals"] == 3
        assert o["group"] == ((0, 2), [0, 2].index(rank), 2)
        assert o["sum_of_ones"] == 2.0
        assert np.isfinite(o["last_loss"])
    assert out[0]["losses"] == out[2]["losses"]
    for n in out[0]["after"]:
        np.testing.assert_array_equal(out[0]["after"][n], out[2]["after"][n])
    # the expected step: one plain SGD step on the whole last batch
    tr.fresh_port_state()
    loss, _ = tr.regression(fluid, tr.plain_minimize)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    scope = fluid.global_scope()
    params = [p.name for p in
              fluid.default_main_program().global_block().all_parameters()]
    for n in params:
        scope.set(n, torch.from_numpy(out[0]["before"][n].copy()))
    exe.run(feed=feeds[-1], fetch_list=[loss])
    for n in params:
        want = scope.find_value(n).numpy()
        np.testing.assert_allclose(out[0]["after"][n], want, rtol=1e-5,
                                   atol=1e-6)


# ---------------------------------------------------------------------------
# fleets of threads: kill, clean run, chaos
# ---------------------------------------------------------------------------


def _worker_net(fl, seed=7):
    fl.default_startup_program().random_seed = seed
    fl.default_main_program().random_seed = seed
    x = fl.data("ex", shape=[None, 4], dtype="float32")
    y = fl.data("ey", shape=[None, 1], dtype="float32")
    p = fl.layers.fc(x, 1)
    loss = fl.layers.reduce_mean(fl.layers.square_error_cost(p, y))
    fl.optimizer.SGD(0.05).minimize(loss)
    return loss


def _feed_fn(step, guard=None):
    if guard is not None and guard._feed_pause:
        # the port's CPU step takes ~1 ms: pace the steps so that the
        # background beats reach the kill clause's count mid-run
        time.sleep(guard._feed_pause)
    rng = np.random.default_rng(1000 + step)
    x = rng.standard_normal((8, 4)).astype("float32")
    return {"ex": x,
            "ey": (x.sum(1, keepdims=True) * 0.5).astype("float32")}


def _spawn_fleet(ckpt_dir, world=4, steps=20, cfg=None, fault_specs=None,
                 save_every=5, jax=False, init=None, pause=0.0):
    """Build `world` identical worker programs, then run each worker's
    FleetGuard.train in a thread; the port's workers start from `init`
    ({name: array}) when given."""
    fl, fw, un, ex, el = ((jfluid, jframework, junique_name, jexecutor, JE)
                          if jax else (fluid, framework, unique_name,
                                       executor_mod, E))
    store = el.InMemoryStore()
    cfg = cfg or _cfg()
    fault_specs = fault_specs or {}
    guards, starts = [], []
    for w in range(world):
        fw.switch_main_program(fw.Program())
        fw.switch_startup_program(fw.Program())
        old_gen = un.switch()
        scope = ex.Scope()
        loss = _worker_net(fl)
        exe = fl.Executor(fl.CPUPlace())
        exe.run(fl.default_startup_program(), scope=scope)
        for n, v in (init or {}).items():
            scope.set(n, torch.from_numpy(v.copy()))
        params = [p.name for p in fl.default_main_program()
                  .global_block().all_parameters()]
        starts.append({n: np.asarray(scope.find_value(n)).copy()
                       for n in params})
        kw = {} if jax else {"devices": [torch.device("cpu", i)
                                         for i in range(world)]}
        guards.append(el.FleetGuard(
            exe, program=fl.default_main_program(), store=store,
            worker_index=w, world_size=world, config=cfg,
            ckpt_dir=ckpt_dir, fetch_list=[loss], feed_fn=_feed_fn,
            scope=scope, save_every=save_every, sync_every=1,
            fault_spec=fault_specs.get(w), **kw))
        guards[-1]._feed_pause = pause
        un.switch(old_gen)
    results, errors = {}, {}

    def run(w):
        try:
            results[w] = guards[w].train(num_steps=steps)
        except BaseException as e:  # noqa: BLE001 — collected for asserts
            errors[w] = e

    threads = [threading.Thread(target=run, args=(w,), name="worker-%d" % w)
               for w in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "fleet wedged"
    return guards, results, errors, starts


def test_elastic_end_to_end_kill_detect_shrink_resume(tmp_path):
    """4 workers, worker 1 killed mid-run via the heartbeat fault site;
    survivors detect within the miss threshold, shrink to {0, 2, 3},
    restore the last fleet-consistent checkpoint, and finish with finite
    loss — no host wait outliving its deadline."""
    cfg = _cfg(heartbeat_interval=0.05, miss_threshold=4,
               collective_timeout=5.0, startup_grace=2.0)
    guards, results, errors, _ = _spawn_fleet(
        str(tmp_path / "ck"), world=4, steps=20, cfg=cfg,
        fault_specs={1: "heartbeat:at=40:RuntimeError"}, save_every=5,
        pause=0.05)
    assert set(errors) == {1}, errors
    assert "injected fault" in str(errors[1])
    survivors = [0, 2, 3]
    assert set(results) == set(survivors)
    for w in survivors:
        summary = results[w]
        assert summary["final_step"] == 20
        assert summary["members"] == survivors
        assert summary["generation"] >= 1
        c = summary["counters"]
        assert c["worker_dead"] >= 1 and c["shrink"] >= 1
        assert c["restore"] >= 1 and c["resume"] >= 1
        misses = [e for e in summary["events"]
                  if e["kind"] == "heartbeat_miss" and e["worker"] == 1]
        assert misses, "no heartbeat_miss recorded for the victim"
        assert min(m["silent"] for m in misses) <= cfg.dead_after + 1.0
        assert [e["worker"] for e in summary["events"]
                if e["kind"] == "worker_dead"] == [1]
        shrink_ev = [e for e in summary["events"]
                     if e["kind"] == "shrink"][0]
        assert shrink_ev["dead"] == [1]
        assert shrink_ev["survivors"] == survivors
        worst = max(s for _, s in guards[w].block_log)
        assert worst <= cfg.collective_timeout + 1.0
        assert summary["max_blocked"] == pytest.approx(worst)
        assert np.isfinite(np.asarray(guards[w].last_report[0])).all()
        assert guards[w].mesh.shape == {"dp": 3}
        live = list(np.asarray(guards[w].mesh.devices).flat)
        assert guards[w]._device_of[1] not in live
    p0 = np.asarray(guards[0]._scope.find_value(
        guards[0]._sync_names(guards[0]._program)[0]))
    for w in (2, 3):
        pw = np.asarray(guards[w]._scope.find_value(
            guards[w]._sync_names(guards[w]._program)[0]))
        np.testing.assert_allclose(pw, p0, rtol=1e-6, atol=1e-7)


def test_elastic_fleet_clean_run_no_faults(tmp_path):
    """With no faults the fleet finishes at generation 0 with full
    membership, and its parameters are the JAX package's fleet's from
    the same start (the JAX fleet saves nothing here: two orbax managers
    saving from threads of one process race in its test run)."""
    jguards, jres, jerr, jstarts = _spawn_fleet(
        None, world=2, steps=6, save_every=3, jax=True)
    guards, results, errors, _ = _spawn_fleet(
        str(tmp_path / "ck"), world=2, steps=6, save_every=3,
        init=jstarts[0])
    assert errors == {} and jerr == {}
    for w in range(2):
        s = results[w]
        assert s["final_step"] == 6 and s["generation"] == 0
        assert s["members"] == [0, 1]
        assert "shrink" not in s["counters"]
        assert s["counters"]["save"] == 2     # steps 3 and 6
        assert "save" not in jres[w]["counters"]
        for k in ("final_step", "generation", "members"):
            assert s[k] == jres[w][k]
        for n in jstarts[0]:
            want = np.asarray(jguards[w]._scope.find_value(n))
            got = np.asarray(guards[w]._scope.find_value(n))
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=1e-6 * max(1.0, float(np.abs(want).max())))
    assert ckpt.latest_consensus_step(str(tmp_path / "ck")) == 6


def test_elastic_chaos_survives_aggressive_faults(tmp_path):
    """Transient run-site faults on every worker PLUS a mid-run death:
    guarded retries absorb the transients, the shrink path the death,
    and the watchdog bound still holds."""
    cfg = _cfg(heartbeat_interval=0.05, miss_threshold=5,
               collective_timeout=8.0, startup_grace=3.0)
    guards, results, errors, _ = _spawn_fleet(
        str(tmp_path / "ck"), world=4, steps=24, cfg=cfg,
        fault_specs={
            0: "run:every=9:ConnectionError",
            1: "heartbeat:at=70:RuntimeError",
            2: "run:every=11:OSError",
            3: "run:every=13:ConnectionError",
        }, save_every=4, pause=0.08)
    finished = set(results)
    assert finished >= {0, 2, 3}, (finished, errors)
    for w in finished:
        assert results[w]["final_step"] == 24
        assert np.isfinite(np.asarray(guards[w].last_report[0])).all()
    for g in guards:
        if g.block_log:
            assert max(s for _, s in g.block_log) \
                <= cfg.collective_timeout + 1.5


# ---------------------------------------------------------------------------
# worker processes on a FileStore, one of them sent SIGKILL
# ---------------------------------------------------------------------------

_WORKER = r"""
import json, os, sys, time

import numpy as np
import torch
torch.set_num_threads(1)

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.parallel import elastic as E

w, world = int(sys.argv[1]), int(sys.argv[2])
root, steps = sys.argv[3], int(sys.argv[4])

fluid.default_startup_program().random_seed = 7
fluid.default_main_program().random_seed = 7
x = fluid.data("mx", shape=[None, 4], dtype="float32")
y = fluid.data("my", shape=[None, 1], dtype="float32")
p = fluid.layers.fc(x, 1)
loss = fluid.layers.reduce_mean(fluid.layers.square_error_cost(p, y))
fluid.optimizer.SGD(0.05).minimize(loss)
exe = fluid.Executor(fluid.CPUPlace())
exe.run(fluid.default_startup_program())


def feed(step, guard=None):
    time.sleep(0.1)     # paced: the parent kills a worker mid-run
    rng = np.random.default_rng(1000 + step)
    xv = rng.standard_normal((8, 4)).astype("float32")
    return {"mx": xv,
            "my": (xv.sum(1, keepdims=True) * 0.5).astype("float32")}


cfg = E.ElasticConfig(heartbeat_interval=0.1, miss_threshold=20,
                      collective_timeout=60.0, startup_grace=60.0)
guard = E.FleetGuard(
    exe, store=E.FileStore(os.path.join(root, "store")),
    worker_index=w, world_size=world, config=cfg,
    ckpt_dir=os.path.join(root, "ck"), fetch_list=[loss],
    feed_fn=feed, save_every=3, sync_every=1)
summary = guard.train(num_steps=steps)
summary["max_blocked_ok"] = summary["max_blocked"] <= 61.0
summary.pop("events")
print("SUMMARY " + json.dumps(summary), flush=True)
"""


def _read_beacon(root, worker):
    path = os.path.join(root, "store", "heartbeat", "%d.json" % worker)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def test_process_fleet_survives_sigkill(tmp_path):
    """3 worker processes; the parent sends SIGKILL to worker 1 after it
    trained past the first consensus save — no atexit, no leave(). The
    survivors detect, shrink, consensus-restore and finish."""
    root = str(tmp_path)
    world, steps, victim = 3, 10, 1
    env = dict(os.environ)
    env.pop("PADDLE_TPU_FAULT_SPEC", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(w), str(world), root,
             str(steps)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO)
        for w in range(world)
    ]
    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            rec = _read_beacon(root, victim)
            if rec and rec.get("step", 0) >= 5:
                break
            if procs[victim].poll() is not None:
                pytest.fail("victim exited before it could be killed:\n%s"
                            % procs[victim].communicate()[0])
            time.sleep(0.1)
        else:
            pytest.fail("victim never reached step 5")
        assert ckpt.latest_consensus_step(os.path.join(root, "ck")) >= 3
        procs[victim].send_signal(signal.SIGKILL)
        outs = {}
        for w, p in enumerate(procs):
            out, _ = p.communicate(timeout=150)
            outs[w] = out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert procs[victim].returncode == -signal.SIGKILL
    survivors = [w for w in range(world) if w != victim]
    for w in survivors:
        assert procs[w].returncode == 0, (
            "worker %d failed:\n%s" % (w, outs[w]))
        line = [ln for ln in outs[w].splitlines()
                if ln.startswith("SUMMARY ")]
        assert line, "worker %d printed no summary:\n%s" % (w, outs[w])
        summary = json.loads(line[-1][len("SUMMARY "):])
        assert summary["final_step"] == steps
        assert summary["members"] == survivors
        assert summary["generation"] >= 1
        assert summary["counters"].get("worker_dead", 0) >= 1
        assert summary["counters"].get("shrink", 0) >= 1
        assert summary["counters"].get("restore", 0) >= 1
        assert summary["max_blocked_ok"], summary["max_blocked"]
