"""The port's step-managed checkpoints (paddle_tpu_torch/parallel/
checkpoint.py) against the JAX package's.

The JAX package writes its steps through orbax; the port's store is its
own (one ``.npy`` a tensor plus an index, renamed into place), with the
same API and contract. Each case runs the same scenario through both
packages' ``checkpoint`` and compares what each gives back: the read
path on missing, empty and garbage directories, re-saves, retention,
background saves joined by ``finalize``/``Executor.close``, the digest
manifests, corrupt and torn steps and the fallback past them, and the
consensus markers of an elastic fleet. Ported from
tests/test_resilience.py (:349-423), tests/test_integrity.py (:256-390)
and tests/test_elastic.py (:444-536).

Added here: a background save whose tensors the caller overwrites in
place right after the call (the step and its manifest keep the values
as they were at the save); a step directory the JAX package wrote
through orbax, read by the port under the contract; a bfloat16 state.
"""
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import resilience as JR
from paddle_tpu.parallel import checkpoint as jckpt

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.fluid import resilience as R
from paddle_tpu_torch.integrity import digest as dg
from paddle_tpu_torch.integrity import envelope as env
from paddle_tpu_torch.parallel import checkpoint as ckpt

import torch_ranks as tr

BOTH = (("jax", jckpt, JR), ("port", ckpt, R))


@pytest.fixture(autouse=True)
def _fresh():
    tr.fresh_port_state()
    for r in (R, JR):
        r.FaultInjector.uninstall()
    yield
    for r in (R, JR):
        r.FaultInjector.uninstall()
    ckpt.finalize()
    jckpt.finalize()


def _state(fill):
    rng = np.random.default_rng(fill)
    return {"w": rng.standard_normal((64, 64)).astype(np.float32),
            "b": rng.standard_normal(64).astype(np.float32)}


def _flip_port_data_byte(dirname, step):
    """Bitflip the middle byte of the largest tensor file of a step."""
    victims = []
    step_dir = os.path.join(dirname, str(step))
    for f in os.listdir(step_dir):
        if f.endswith(".npy"):
            p = os.path.join(step_dir, f)
            victims.append((os.path.getsize(p), p))
    size, path = max(victims)
    with open(path, "r+b") as fh:
        fh.seek(size // 2)
        byte = fh.read(1)
        fh.seek(size // 2)
        fh.write(bytes([byte[0] ^ 0x01]))
    return path


# ---------------------------------------------------------------------------
# read path, close, resume (tests/test_resilience.py :349-423)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p[0])
def test_latest_step_and_load_on_missing_or_empty_dir(tmp_path, pkg):
    _, c, _ = pkg
    missing = str(tmp_path / "never_created")
    assert c.latest_step(missing) is None
    with pytest.raises(IOError, match="never_created"):
        c.load_checkpoint(missing)
    assert not os.path.exists(missing)     # the read path creates nothing
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    assert c.latest_step(empty) is None
    with pytest.raises(IOError, match="no complete"):
        c.load_checkpoint(empty)
    assert c.restore_latest(empty) is None
    garbage = str(tmp_path / "garbage")
    os.makedirs(os.path.join(garbage, "notes"))
    with open(os.path.join(garbage, "junk.bin"), "wb") as f:
        f.write(b"\x00junk")
    assert c.latest_step(garbage) is None
    assert c.restore_latest(garbage) is None
    c.finalize(empty)


def test_executor_close_flushes_async_saves_and_is_idempotent(tmp_path):
    got = {}
    for name, c, fl in (("jax", jckpt, jfluid), ("port", ckpt, fluid)):
        d = str(tmp_path / name)
        state = {"w": np.arange(6, dtype="float32").reshape(2, 3)}
        c.save_checkpoint(d, state, step=3, wait=False)
        exe = fl.Executor(fl.CPUPlace())
        exe.close()                        # must flush the pending write
        exe.close()                        # idempotent
        assert c.latest_step(d) == 3
        got[name] = np.asarray(c.load_checkpoint(d)["w"])
        c.finalize()
        c.finalize()                       # finalize idempotent too
        with pytest.raises(RuntimeError, match="closed"):
            exe.run(fl.default_main_program())
    np.testing.assert_array_equal(got["port"], got["jax"])


def _sgd_net(fl, seed=42):
    fl.default_startup_program().random_seed = seed
    x = fl.data(name="x", shape=[None, 4], dtype="float32")
    y = fl.layers.fc(input=x, size=3, param_attr=fl.ParamAttr(name="w"),
                     bias_attr=fl.ParamAttr(name="b"))
    loss = fl.layers.mean(y)
    fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _feed(step, rows=2):
    rng = np.random.RandomState(step)
    return {"x": rng.rand(rows, 4).astype("float32")}


def _start(fl, loss, params=None):
    exe = fl.Executor(fl.CPUPlace())
    exe.run(fl.default_startup_program())
    if params is not None:
        for n, v in params.items():
            fl.global_scope().set(n, torch.from_numpy(v.copy())
                                  if fl is fluid else v)
    return exe


def _params(fl):
    return {n: np.asarray(fl.global_scope().find_value(n)).copy()
            for n in ("w", "b")}


def test_midsave_crash_keeps_last_complete_checkpoint(tmp_path):
    """Kill during save: latest_step still points at the last COMPLETE
    checkpoint and TrainGuard resumes from it, in both packages, to the
    same parameters."""
    out = {}
    params = None
    for name, c, r, fl in (("jax", jckpt, JR, jfluid),
                           ("port", ckpt, R, fluid)):
        d = str(tmp_path / name)
        with fl.program_guard(fl.Program(), fl.Program()):
            with fl.unique_name.guard():
                loss = _sgd_net(fl)
                exe = _start(fl, loss, params)
                params = params or _params(fl)
                r.FaultInjector.install("save:at=2:OSError")
                tg = r.TrainGuard(exe, ckpt_dir=d, fetch_list=[loss],
                                  feed_fn=_feed, save_every=2)
                with pytest.raises(OSError, match="injected fault"):
                    tg.train(num_steps=6)  # save @2 ok, save @4 dies
                r.FaultInjector.uninstall()
                assert c.latest_step(d) == 2
                assert tg.log.counters["save"] == 1
                tg2 = r.TrainGuard(exe, ckpt_dir=d, fetch_list=[loss],
                                   feed_fn=_feed, save_every=2)
                summary = tg2.train(num_steps=6)
                assert summary["resumed_from"] == 2
                assert summary["final_step"] == 6
                assert c.latest_step(d) == 6
                out[name] = _params(fl)
    for n in ("w", "b"):
        np.testing.assert_allclose(out["port"][n], out["jax"][n],
                                   rtol=0, atol=1e-6)


def test_load_latest_persistables_roundtrip(tmp_path):
    saved = {}
    for name, fl in (("jax", jfluid), ("port", fluid)):
        d = str(tmp_path / name)
        with fl.program_guard(fl.Program(), fl.Program()):
            with fl.unique_name.guard():
                loss = _sgd_net(fl)
                exe = _start(fl, loss, saved.get("init"))
                saved.setdefault("init", _params(fl))
                assert fl.io.load_latest_persistables(exe, d) is None
                exe.run(feed=_feed(1), fetch_list=[loss])
                w_saved = _params(fl)["w"]
                fl.io.save_persistables(exe, d, use_orbax=True, step=7)
                fl.global_scope().set("w", np.zeros_like(w_saved))
                assert fl.io.load_latest_persistables(exe, d) == 7
                np.testing.assert_array_equal(_params(fl)["w"], w_saved)
                fl.global_scope().set("w", np.zeros_like(w_saved))
                fl.io.load_persistables(exe, d, use_orbax=True)
                np.testing.assert_array_equal(_params(fl)["w"], w_saved)
                saved[name] = w_saved
    np.testing.assert_allclose(saved["port"], saved["jax"], rtol=0,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# digests (tests/test_integrity.py :256-390)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p[0])
def test_checkpoint_save_writes_manifest_and_returns_digests(tmp_path, pkg):
    _, c, _ = pkg
    d = str(tmp_path / "ck")
    digests = c.save_checkpoint(d, _state(1), step=1, wait=True)
    assert sorted(digests) == ["b", "w"]
    m = env.read_manifest(c.manifest_path(d, 1))
    assert m["digests"] == digests and m["step"] == 1
    assert c.verify_checkpoint(d, 1)
    assert c.verify_checkpoint(d, 1, state=_state(1))
    assert not c.verify_checkpoint(d, 1, state=_state(2))
    state = c.load_checkpoint(d, step=1)
    np.testing.assert_array_equal(state["w"], _state(1)["w"])
    c.finalize(d)


def test_the_digests_are_the_reference_s(tmp_path):
    want = jckpt.save_checkpoint(str(tmp_path / "j"), _state(1), step=1)
    got = ckpt.save_checkpoint(str(tmp_path / "p"), _state(1), step=1)
    assert got == want == dg.digest_state(_state(1))


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p[0])
def test_checkpoint_digest_opt_out(tmp_path, monkeypatch, pkg):
    _, c, _ = pkg
    monkeypatch.setenv(c._DIGEST_ENV, "0")
    d = str(tmp_path / "ck")
    assert c.save_checkpoint(d, _state(1), step=1, wait=True) is None
    assert not os.path.exists(c.manifest_path(d, 1))
    c.finalize(d)


def test_checkpoint_bitflip_caught_with_tensor_attribution(tmp_path):
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, _state(1), step=1, wait=True)
    ckpt.save_checkpoint(d, _state(2), step=2, wait=True)
    ckpt.finalize(d)
    _flip_port_data_byte(d, 2)
    obs.reset()
    with pytest.raises(dg.IntegrityError) as ei:
        ckpt.load_checkpoint(d, step=2)
    msg = str(ei.value)
    assert "step 2" in msg and "failed digest verification" in msg
    assert ei.value.tensor == "w"          # the largest file is w's
    c = obs.snapshot()["counters"]
    assert c["integrity.checkpoint_digest_mismatch"] >= 1
    # resume falls back to step 1, bit-identically
    with pytest.warns(UserWarning, match="falling back"):
        step, state = ckpt.restore_latest(d)
    assert step == 1
    np.testing.assert_array_equal(state["w"], _state(1)["w"])
    np.testing.assert_array_equal(state["b"], _state(1)["b"])


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p[0])
def test_manifest_tamper_fails_verify_and_falls_back(tmp_path, pkg):
    _, c, _ = pkg
    d = str(tmp_path / "ck")
    c.save_checkpoint(d, _state(1), step=1, wait=True)
    c.save_checkpoint(d, _state(2), step=2, wait=True)
    c.finalize(d)
    with open(c.manifest_path(d, 2), "r+b") as fh:
        fh.seek(os.path.getsize(c.manifest_path(d, 2)) // 2)
        fh.write(b"\x00")
    with pytest.warns(UserWarning, match="corrupt digest manifest"):
        assert not c.verify_checkpoint(d, 2)
    with pytest.warns(UserWarning):
        state = c.load_checkpoint(d)
    np.testing.assert_array_equal(state["w"], _state(1)["w"])
    c.finalize(d)


def test_consensus_restore_falls_back_past_digest_failing_step(tmp_path):
    d = str(tmp_path)
    w = 0
    wdir = ckpt.worker_dir(d, w)
    for step, fill in ((1, 1), (2, 2)):
        digests = ckpt.save_checkpoint(wdir, _state(fill), step=step,
                                       wait=True)
        ckpt.mark_save_complete(d, step, w, world_size=1, digests=digests)
    # rot the newest shard AND rewrite its manifest to match (bit rot
    # after consensus formed): the done-marker's digests still catch it
    _flip_port_data_byte(wdir, 2)
    rotted = ckpt._read_step(wdir, 2)
    env.write_manifest(
        ckpt.manifest_path(wdir, 2),
        env.make_manifest(dg.digest_state(rotted), kind="checkpoint",
                          step=2))
    obs.reset()
    with pytest.warns(UserWarning, match="done-marker digests"):
        step, state = ckpt.restore_latest_consensus(d, worker_index=w)
    assert step == 1
    np.testing.assert_array_equal(state["w"], _state(1)["w"])
    c = obs.snapshot()["counters"]
    assert c["integrity.checkpoint_digest_mismatch"] >= 1


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p[0])
def test_save_load_fault_arms_on_manifest_path(tmp_path, pkg):
    _, c, r = pkg
    d = str(tmp_path / "ck1")
    r.FaultInjector.install("save:at=1:corrupt=bitflip")
    c.save_checkpoint(d, _state(1), step=1, wait=True)
    r.FaultInjector.uninstall()
    with pytest.raises(IOError) as e:
        c.load_checkpoint(d, step=1)
    assert type(e.value).__name__ == "IntegrityError"
    d2 = str(tmp_path / "ck2")
    c.save_checkpoint(d2, _state(1), step=1, wait=True)
    r.FaultInjector.install("load:at=1:corrupt=bitflip")
    with pytest.raises(IOError) as e:
        c.load_checkpoint(d2, step=1)
    assert type(e.value).__name__ == "IntegrityError"
    r.FaultInjector.uninstall()
    c.finalize(d2)


# ---------------------------------------------------------------------------
# consensus markers + corruption fallback (tests/test_elastic.py :444-536)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p[0])
def test_consensus_markers_full_set_required(tmp_path, pkg):
    _, c, _ = pkg
    d = str(tmp_path)
    assert c.latest_consensus_step(d) is None
    c.mark_save_complete(d, 5, 0, world_size=2)
    assert c.latest_consensus_step(d) is None      # worker 1 missing
    marker = c.mark_save_complete(d, 5, 1, world_size=2)
    assert c.latest_consensus_step(d) == 5
    with open(marker) as f:
        rec = json.load(f)
    assert rec["worker"] == 1 and rec["world"] == 2 and rec["step"] == 5
    assert rec["members"] == [0, 1]
    c.mark_save_complete(d, 7, 0, world_size=2)
    assert c.latest_consensus_step(d) == 5
    assert c.latest_consensus_step(d, world_size=2) == 5


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p[0])
def test_consensus_with_non_contiguous_survivor_set(tmp_path, pkg):
    _, c, _ = pkg
    d = str(tmp_path)
    for w in (0, 2, 3):
        c.mark_save_complete(d, 9, w, world_size=4, members=[0, 2, 3])
    assert c.latest_consensus_step(d) == 9
    assert c.latest_consensus_step(d, world_size=4) is None


def test_restore_latest_consensus_round_trip(tmp_path):
    got = {}
    for name, c in (("jax", jckpt), ("port", ckpt)):
        d = str(tmp_path / name)
        for w in range(2):
            state = {"w0": np.full((2, 2), float(w)), "b0": np.arange(3.0)}
            c.save_checkpoint(c.worker_dir(d, w), state, step=3, wait=True)
            c.mark_save_complete(d, 3, w, world_size=2)
        step, state = c.restore_latest_consensus(d, worker_index=1)
        assert step == 3
        got[name] = {k: np.asarray(v) for k, v in state.items()}
        for w in range(2):
            c.finalize(c.worker_dir(d, w))
    assert sorted(got["port"]) == sorted(got["jax"])
    for k in got["jax"]:
        np.testing.assert_array_equal(got["port"][k], got["jax"][k])
        assert got["port"][k].dtype == got["jax"][k].dtype


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p[0])
def test_corrupt_checkpoint_skipped_with_fallback(tmp_path, pkg):
    _, c, _ = pkg
    d = str(tmp_path / "ck")
    c.save_checkpoint(d, {"w": np.full(4, 1.0)}, step=1, wait=True)
    c.save_checkpoint(d, {"w": np.full(4, 2.0)}, step=2, wait=True)
    assert c.all_steps(d) == [2, 1]
    assert c.verify_checkpoint(d, 1) and c.verify_checkpoint(d, 2)
    # a step dir that passes the cheap probe but cannot restore
    fake = os.path.join(d, "3")
    os.makedirs(fake)
    with open(os.path.join(fake, "garbage.bin"), "wb") as f:
        f.write(b"\x00not a checkpoint")
    assert c.verify_checkpoint(d, 3)       # probe can't tell
    with pytest.warns(UserWarning, match="failed to restore"):
        step, state = c.restore_latest(d)
    assert step == 2
    np.testing.assert_array_equal(state["w"], np.full(4, 2.0))
    # truncated payload in step 2: the probe rejects it
    for root, _dirs, files in os.walk(os.path.join(d, "2")):
        for fname in files:
            p = os.path.join(root, fname)
            if os.path.getsize(p) > 0:
                with open(p, "w"):
                    pass
    assert not c.verify_checkpoint(d, 2)
    with pytest.warns(UserWarning, match="corrupt/incomplete"):
        step, state = c.restore_latest(d)
    assert step == 1
    np.testing.assert_array_equal(state["w"], np.full(4, 1.0))
    c.finalize(d)


@pytest.mark.parametrize("pkg", BOTH, ids=lambda p: p[0])
def test_interrupted_atomic_save_detected(tmp_path, pkg):
    _, c, _ = pkg
    d = str(tmp_path / "ck")
    c.save_checkpoint(d, {"w": np.ones(2)}, step=1, wait=True)
    os.makedirs(os.path.join(d, "1", "state.orbax-checkpoint-tmp-123"))
    assert not c.verify_checkpoint(d, 1)
    with pytest.warns(UserWarning, match="corrupt/incomplete"):
        assert c.restore_latest(d) is None
    c.finalize(d)


# ---------------------------------------------------------------------------
# the port's own: re-save, retention, a save that dies, in-place writes,
# orbax directories, bfloat16
# ---------------------------------------------------------------------------


def test_resave_replaces_and_max_to_keep_prunes_in_both(tmp_path):
    got = {}
    for name, c in (("jax", jckpt), ("port", ckpt)):
        d = str(tmp_path / name)
        for step in (1, 2, 3):
            c.save_checkpoint(d, _state(step), step=step, max_to_keep=2)
        c.save_checkpoint(d, _state(9), step=3, max_to_keep=2)
        c.finalize(d)
        got[name] = (c.all_steps(d), c.latest_step(d),
                     np.asarray(c.load_checkpoint(d)["w"]))
    assert got["port"][:2] == got["jax"][:2] == ([3, 2], 3)
    np.testing.assert_array_equal(got["port"][2], got["jax"][2])
    np.testing.assert_array_equal(got["port"][2], _state(9)["w"])


def test_a_save_that_dies_leaves_no_step(tmp_path, monkeypatch):
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, _state(1), step=1)

    def die(*a, **k):
        raise OSError("disk went away")

    monkeypatch.setattr(np, "save", die)
    with pytest.raises(OSError, match="disk went away"):
        ckpt.save_checkpoint(d, _state(2), step=2)
    monkeypatch.undo()
    assert ckpt.all_steps(d) == [1] and ckpt.latest_step(d) == 1
    assert any(".tmp-" in e for e in os.listdir(d))
    assert not os.path.exists(ckpt.manifest_path(d, 2))
    step, state = ckpt.restore_latest(d)
    assert step == 1
    np.testing.assert_array_equal(state["w"], _state(1)["w"])


def test_background_save_keeps_the_values_of_the_moment_of_the_save(
        tmp_path, monkeypatch):
    """A wait=False save copies the state before it returns: tensors
    overwritten in place right after the call (as an update op, a
    pruning mask or a ZeRO gather does) leave the step and its manifest
    with the values as they were at the save."""
    import threading

    d = str(tmp_path / "ck")
    state = {"w": torch.ones(64, 64), "b": torch.arange(64.0),
             "bf": torch.linspace(-1, 1, 32).to(torch.bfloat16)}
    want = {k: v.clone() for k, v in state.items()}
    gate = threading.Event()
    real_write = ckpt._write_step

    def held_write(*a):
        gate.wait(10)                     # the write starts only after
        return real_write(*a)             # the caller's in-place writes

    monkeypatch.setattr(ckpt, "_write_step", held_write)
    assert ckpt.save_checkpoint(d, state, step=5, wait=False) is None
    state["w"].mul_(3.0)
    state["b"].zero_()
    state["bf"].neg_()
    gate.set()
    ckpt.finalize(d)
    got = ckpt.load_checkpoint(d, step=5)
    np.testing.assert_array_equal(got["w"], want["w"].numpy())
    np.testing.assert_array_equal(got["b"], want["b"].numpy())
    assert got["bf"].dtype == torch.bfloat16
    assert torch.equal(got["bf"], want["bf"])
    m = env.read_manifest(ckpt.manifest_path(d, 5))
    assert m["digests"] == dg.digest_state(ckpt._host_view(want))
    assert ckpt.verify_checkpoint(d, 5, state=want)
    assert not ckpt.verify_checkpoint(d, 5, state=state)


def test_a_background_save_error_is_raised_by_finalize(tmp_path,
                                                        monkeypatch):
    d = str(tmp_path / "ck")

    def die(*a, **k):
        raise OSError("disk went away")

    monkeypatch.setattr(ckpt, "_write_step", die)
    ckpt.save_checkpoint(d, _state(1), step=1, wait=False)
    with pytest.raises(OSError, match="disk went away"):
        ckpt.finalize(d)
    ckpt.finalize(d)                      # raised once, then forgotten


def test_a_jax_written_orbax_directory_under_the_contract(tmp_path):
    """Neither package reads the other's step directories. On the JAX
    package's orbax steps the port's read path gives None or the
    IOError of the contract, naming the directory — nothing else."""
    d = str(tmp_path / "orbax")
    jckpt.save_checkpoint(d, _state(1), step=1)
    jckpt.save_checkpoint(d, _state(2), step=2)
    jckpt.finalize(d)
    assert ckpt.latest_step(d) in (None, 2)
    with pytest.raises(IOError, match="orbax") as e:
        ckpt.load_checkpoint(d, step=2)
    assert d in str(e.value)
    with pytest.raises(IOError) as e:
        ckpt.load_checkpoint(d)
    assert d in str(e.value)
    with pytest.warns(UserWarning, match="failed to restore"):
        assert ckpt.restore_latest(d) is None
    # and the other way: orbax finds no step of the port's
    p = str(tmp_path / "port")
    ckpt.save_checkpoint(p, _state(1), step=1)
    with pytest.raises(IOError):
        jckpt.load_checkpoint(p, step=1)
    jckpt.finalize(p)


def test_a_bfloat16_state_round_trips(tmp_path):
    d = str(tmp_path / "ck")
    g = torch.Generator().manual_seed(3)
    state = {"w": torch.randn(16, 8, generator=g).to(torch.bfloat16),
             "m": torch.randn(16, 8, generator=g),
             "step": torch.tensor([7], dtype=torch.int64)}
    digests = ckpt.save_checkpoint(d, state, step=1)
    got = ckpt.load_checkpoint(d)
    assert got["w"].dtype == torch.bfloat16 and torch.equal(got["w"],
                                                            state["w"])
    np.testing.assert_array_equal(got["m"], state["m"].numpy())
    np.testing.assert_array_equal(got["step"], [7])
    assert digests == dg.digest_state(ckpt._host_view(state))
    # the stored bits are fluid.io's: a bfloat16 value as V2
    assert np.load(os.path.join(d, "1", json.load(open(os.path.join(
        d, "1", "tensors.json")))["tensors"]["w"])).dtype.str == "|V2"
