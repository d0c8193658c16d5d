"""Step-managed checkpoints (port of paddle_tpu/parallel/checkpoint.py).

The JAX package writes its steps through orbax, which imports jax; this
store is the port's own and keeps the same API and contract:

- each step is a directory ``<dirname>/<step>/`` holding one ``.npy``
  file a tensor and ``tensors.json``, the index from names to files. A
  value is stored as ``fluid.io`` stores it (a host array; a bfloat16
  value as its bits under numpy's ``V2``), and loads back as
  ``fluid.io`` loads it (numpy arrays; ``V2`` as a bfloat16 tensor);
- a step is written into a temporary sibling (``<step>.tmp-...``) and
  renamed into place, so a save that dies leaves no step directory and
  the previous complete step stays the resume point. A re-save of a
  step REPLACES it (a trainer overwriting its own step means newer
  state); ``max_to_keep`` prunes the oldest steps;
- ``wait=False`` copies the state to the host before it returns (the
  scope's tensors are updated in place by the next step, so the write
  cannot read them later, as orbax reads an immutable jax array) and
  writes in a background thread; :func:`finalize` (and
  ``Executor.close``) joins it;
- each step gets a per-tensor digest manifest under ``integrity/``
  (``paddle_tpu_torch/integrity``), checked on every restore.

Neither package reads the other's step directories: orbax's layout
needs orbax, and the port's ``.npy`` steps are not orbax's. On a
directory the JAX package wrote, :func:`latest_step` gives its newest
step and :func:`load_checkpoint` raises the ``IOError`` of the contract
(ROADMAP.md Queue 3). ``fluid.io``'s ``.npz`` files move both ways.

Used directly, through ``fluid.io.save_persistables(...,
use_orbax=True)`` / ``load_persistables(..., use_orbax=True)`` /
``load_latest_persistables``, or via ``fluid.resilience.TrainGuard``
(periodic auto-save + crash-resume) and ``parallel.elastic.FleetGuard``
(consensus checkpoints).

Read-path contract (the resume path must never explode on a fresh run
directory): ``latest_step`` on a missing/empty/garbage directory returns
None; ``load_checkpoint`` raises an IOError naming the directory.
"""
import json
import os
import shutil
import threading
import time
import uuid
import warnings

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "restore_latest", "finalize", "verify_checkpoint", "all_steps",
           "worker_dir", "mark_save_complete", "latest_consensus_step",
           "restore_latest_consensus", "CONSENSUS_DIR",
           "compile_cache_dir", "COMPILE_CACHE_SUBDIR",
           "INTEGRITY_SUBDIR", "manifest_path"]

# background writers of wait=False saves (dir -> threads) and what they
# raised (dir -> errors); finalize() joins the one and raises the other
_pending = {}
_errors = {}
_errors_lock = threading.Lock()

# A compile cache co-located with the checkpoints it warm-starts (the
# JAX package's layout; the port's compile cache waits for ROADMAP.md
# Queue 1 item 11). Non-numeric, so the step scanners skip it.
COMPILE_CACHE_SUBDIR = "compile-cache"

# Per-step content-digest manifests live in a non-numeric sibling of the
# step dirs, so the step scanners skip it.
# PADDLE_TPU_CHECKPOINT_DIGEST=0 opts a save out.
INTEGRITY_SUBDIR = "integrity"
_DIGEST_ENV = "PADDLE_TPU_CHECKPOINT_DIGEST"

_INDEX = "tensors.json"
_FORMAT = "paddle-tpu-torch-checkpoint"


def manifest_path(dirname, step):
    """Path of the per-tensor digest manifest for checkpoint `step`."""
    return os.path.join(dirname, INTEGRITY_SUBDIR,
                        "step%012d.json" % int(step))


def _digests_enabled():
    return os.environ.get(_DIGEST_ENV, "1") not in ("0", "off", "")


def compile_cache_dir(dirname):
    """The co-located compile-cache directory for checkpoint root
    `dirname`. Layout helper only — nothing is created."""
    return os.path.join(dirname, COMPILE_CACHE_SUBDIR)


def _key(dirname):
    return os.path.abspath(dirname)


def _join(dirname):
    """Wait for this directory's background saves (their errors stay
    for :func:`finalize`)."""
    for t in _pending.pop(_key(dirname), ()):
        t.join()


def finalize(dirname=None):
    """Join pending ``wait=False`` saves (of `dirname`, or of every
    directory) and raise the first error one of them met. Idempotent —
    unknown dirnames and repeat calls are no-ops."""
    keys = ([_key(dirname)] if dirname
            else list(set(_pending) | set(_errors)))
    for k in keys:
        for t in _pending.pop(k, ()):
            t.join()
    first = None
    with _errors_lock:
        for k in keys:
            errs = _errors.pop(k, ())
            if errs and first is None:
                first = errs[0]
    if first is not None:
        raise first


def _host(value):
    from ..fluid.io import _host as io_host

    return io_host(value)


def _snapshot(state):
    """Host copies of `state` that nothing the caller does later can
    change: a tensor on the card is copied by the transfer, one on the
    CPU (whose ``numpy()`` shares memory) is cloned first."""
    out = {}
    for k, v in state.items():
        if isinstance(v, torch.Tensor):
            v = v.detach()
            if v.device.type == "cpu":
                v = v.clone()
            out[str(k)] = _host(v)
        else:
            out[str(k)] = np.array(_host(v), copy=True)
    return out


def _host_view(state):
    """`state` as host arrays, for digests (no copy where none is
    needed; a bfloat16 tensor as its ``V2`` bits)."""
    return {str(k): _host(v) for k, v in state.items()}


def _write_step(dirname, step, host):
    """Write the step into a temporary sibling and rename it into
    place; a step already there is replaced."""
    os.makedirs(dirname, exist_ok=True)
    final = os.path.join(dirname, str(int(step)))
    tag = "%d-%s" % (os.getpid(), uuid.uuid4().hex[:8])
    tmp = os.path.join(dirname, "%d.tmp-%s" % (int(step), tag))
    os.makedirs(tmp)
    index = {}
    for i, name in enumerate(sorted(host)):
        fname = "t%05d.npy" % i
        np.save(os.path.join(tmp, fname), host[name], allow_pickle=False)
        index[name] = fname
    with open(os.path.join(tmp, _INDEX), "w") as f:
        json.dump({"fmt": _FORMAT, "v": 1, "step": int(step),
                   "tensors": index}, f)
    if os.path.isdir(final):
        old = os.path.join(dirname, "%d.old-tmp-%s" % (int(step), tag))
        os.rename(final, old)
        os.rename(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.rename(tmp, final)


def _prune(dirname, max_to_keep):
    if not max_to_keep:
        return
    for step in all_steps(dirname)[int(max_to_keep):]:
        shutil.rmtree(os.path.join(dirname, str(step)), ignore_errors=True)
        try:
            os.remove(manifest_path(dirname, step))
        except OSError:
            pass


def _read_step(dirname, step):
    """The host arrays of one step, unverified (IOError when the step
    is not one of this store's)."""
    step_dir = os.path.join(dirname, str(int(step)))
    try:
        with open(os.path.join(step_dir, _INDEX)) as f:
            index = json.load(f)
    except OSError as e:
        raise IOError(
            "checkpoint step %s under %r has no %s: not a "
            "paddle_tpu_torch checkpoint step (a directory written "
            "through orbax by the JAX package cannot be read here), or "
            "an incomplete one (%s)" % (step, dirname, _INDEX, e)) from e
    if not isinstance(index, dict) or index.get("fmt") != _FORMAT:
        raise IOError("checkpoint step %s under %r: %s is not a "
                      "paddle_tpu_torch index" % (step, dirname, _INDEX))
    return {name: np.load(os.path.join(step_dir, fname), allow_pickle=False)
            for name, fname in index["tensors"].items()}


def save_checkpoint(dirname, state, step=0, max_to_keep=None, wait=True):
    """Write `state` (a flat dict name -> tensor or array; tensors may
    live on the card) as checkpoint `step` under `dirname`. Re-saving an
    existing step REPLACES it. With wait=False the state is copied to
    the host before the call returns and written in the background —
    call finalize()/a later save to join it.

    Unless ``PADDLE_TPU_CHECKPOINT_DIGEST=0``, per-tensor sha256
    digests of the saved values are recorded in a per-step integrity
    manifest (see :func:`manifest_path`), computed concurrently with the
    write. Returns the digest dict (feed it to
    :func:`mark_save_complete`) for blocking saves; None for
    ``wait=False``."""
    from .. import observability as obs
    from ..fluid.resilience import fault_check

    # fault-injection hook (site "save"): BEFORE anything touches disk,
    # modeling a process killed mid-save — the previous complete
    # checkpoint must stay the resume point
    fault_check("save")
    t0 = time.monotonic()
    _join(dirname)  # one write a directory at a time, in call order
    host = _snapshot(state)
    digesting = _digests_enabled()

    def _write():
        box = {}
        digest_thread = None
        if digesting:
            from ..integrity.digest import digest_state

            def _digest():
                td0 = time.monotonic()
                try:
                    box["digests"] = digest_state(host)
                except Exception as e:  # noqa: BLE001 — re-raised below
                    box["error"] = e
                obs.observe("integrity.checkpoint_digest_seconds",
                            time.monotonic() - td0)

            digest_thread = threading.Thread(
                target=_digest, daemon=True, name="checkpoint-digest")
            digest_thread.start()
        try:
            _write_step(dirname, step, host)
        finally:
            if digest_thread is not None:
                digest_thread.join()
        digests = None
        if digesting:
            if "error" in box:
                raise box["error"]
            from ..integrity import envelope

            # the manifest is written only after the step is in place,
            # so a manifest never outlives a step that was never written
            envelope.write_manifest(
                manifest_path(dirname, step),
                envelope.make_manifest(box["digests"], kind="checkpoint",
                                       step=int(step), time=time.time()))
            obs.inc("integrity.checkpoint_manifests_written")
            digests = box["digests"]
        _prune(dirname, max_to_keep)
        return digests

    if wait:
        digests = _write()
    else:
        def _background():
            try:
                _write()
            except BaseException as e:  # noqa: BLE001 — raised at finalize
                with _errors_lock:
                    _errors.setdefault(_key(dirname), []).append(e)

        t = threading.Thread(target=_background, daemon=True,
                             name="checkpoint-write")
        t.start()
        _pending.setdefault(_key(dirname), []).append(t)
        digests = None
    # with wait=False this measures the host copy, not the disk write
    obs.observe("checkpoint.save_seconds", time.monotonic() - t0)
    return digests


def latest_step(dirname):
    """The newest checkpoint step under `dirname`, or None. A missing,
    empty, or unreadable directory is "no checkpoint yet" (None) — the
    resume path must survive a fresh run directory."""
    if not os.path.isdir(dirname):
        return None
    try:
        _join(dirname)
        steps = all_steps(dirname)
    except Exception:  # noqa: BLE001 — unreadable layout == no checkpoint
        return None
    return steps[0] if steps else None


def load_checkpoint(dirname, step=None):
    """Restore the state dict saved at `step` (newest VERIFIED step when
    None — steps failing :func:`verify_checkpoint` are skipped with a
    warning). Raises IOError naming `dirname` when the directory is
    missing or holds no (readable) checkpoint."""
    from .. import observability as obs
    from ..fluid.io import _restored

    if not os.path.isdir(dirname):
        raise IOError(
            "no checkpoint directory %r (nothing was ever saved there, "
            "or the path is wrong)" % dirname)
    t0 = time.monotonic()
    try:
        _join(dirname)
        if step is None:
            for cand in all_steps(dirname):
                if verify_checkpoint(dirname, cand):
                    step = cand
                    break
                warnings.warn(
                    "skipping corrupt/incomplete checkpoint step %d "
                    "under %r" % (cand, dirname))
        if step is None:
            raise IOError(
                "checkpoint directory %r contains no complete "
                "checkpoint" % dirname)
        host = _read_step(dirname, step)
    except IOError:
        raise
    except Exception as e:  # noqa: BLE001 — reader internals stay internal
        raise IOError(
            "failed to restore checkpoint step %s from %r (%s: %s)"
            % (step, dirname, type(e).__name__, e)) from e
    # digest verification of what actually came off the disk; an
    # IntegrityError is an IOError, so every fallback path
    # (restore_latest & co) skips past the lying step
    from ..integrity import envelope

    manifest = envelope.read_manifest(manifest_path(dirname, step))
    if manifest is not None:
        td0 = time.monotonic()
        _verify_digests(host, manifest, dirname, step, raising=True)
        obs.observe("integrity.checkpoint_verify_seconds",
                    time.monotonic() - td0)
    obs.observe("checkpoint.restore_seconds", time.monotonic() - t0)
    return {k: _restored(v) for k, v in host.items()}


def all_steps(dirname):
    """Step numbers present under `dirname` (complete or not), newest
    first. Reads the directory layout directly."""
    if not os.path.isdir(dirname):
        return []
    steps = []
    for entry in os.listdir(dirname):
        if entry.isdigit() and os.path.isdir(os.path.join(dirname, entry)):
            steps.append(int(entry))
    return sorted(steps, reverse=True)


def verify_checkpoint(dirname, step, state=None):
    """Integrity verification for checkpoint `step`.

    Always runs the structural probe (step directory exists, holds at
    least one regular file, no leftover tmp entries from an interrupted
    save, no zero-byte payload file), then upgrades to digest
    verification where the evidence exists: a present-but-unreadable
    digest manifest fails the step (a manifest that cannot be trusted
    must not silently disable verification), and when the restored
    ``state`` dict is passed, every tensor is verified against its
    recorded sha256. Used by every restore path before a step is
    trusted; without ``state`` a True result still does not guarantee a
    readable payload — restore failures (and post-restore digest
    mismatches, see :func:`load_checkpoint`) fall back to older
    steps."""
    from .. import observability as obs
    from ..integrity import envelope
    from ..integrity.digest import IntegrityError

    step_dir = os.path.join(dirname, str(int(step)))
    if not os.path.isdir(step_dir):
        return False
    saw_file = False
    for root, dirs, files in os.walk(step_dir):
        if any("tmp" in d.lower() for d in dirs):
            return False
        for f in files:
            if "tmp" in f.lower():
                return False
            saw_file = True
            try:
                size = os.path.getsize(os.path.join(root, f))
            except OSError:
                return False
            # zero-byte markers are legitimate (orbax commit sentinels,
            # in a directory the JAX package wrote); zero-byte DATA is
            # truncation
            if size == 0 and not (f.startswith("commit")
                                  or f.startswith(".")):
                return False
    if not saw_file:
        return False
    mpath = manifest_path(dirname, step)
    try:
        manifest = envelope.read_manifest(mpath)
    except IntegrityError as e:
        obs.inc("integrity.checkpoint_manifest_corrupt")
        obs.event("integrity_violation", source="checkpoint",
                  path=mpath, step=int(step), check="manifest",
                  error=str(e))
        warnings.warn(
            "checkpoint step %d under %r has a corrupt digest manifest "
            "(%s)" % (int(step), dirname, e))
        return False
    if manifest is not None and state is not None:
        bad = _verify_digests(_host_view(state), manifest, dirname, step,
                              raising=False)
        if bad:
            return False
    return True


def _verify_digests(host, manifest, dirname, step, raising=True):
    """Compare host arrays against their manifest; attribute the first
    mismatch to its tensor and file. Returns the mismatch list
    (``raising=False``) or raises IntegrityError."""
    from .. import observability as obs
    from ..integrity.digest import IntegrityError, state_mismatches

    mism = state_mismatches(host, manifest.get("digests", {}))
    if not mism:
        obs.inc("integrity.checkpoint_verified")
        return []
    name, want, got = mism[0]
    mpath = manifest_path(dirname, step)
    obs.inc("integrity.checkpoint_digest_mismatch", len(mism))
    obs.event("integrity_violation", source="checkpoint",
              path=os.path.join(dirname, str(int(step))),
              step=int(step), check="digest", tensor=name,
              mismatches=len(mism))
    if not raising:
        return mism
    raise IntegrityError(
        "checkpoint step %d under %r failed digest verification: "
        "tensor %r want %s got %s (%d tensor(s) total; manifest %s)"
        % (int(step), dirname, name, want, got, len(mism), mpath),
        path=os.path.join(dirname, str(int(step))), tensor=name,
        want=want, got=got)


def restore_latest(dirname):
    """Resume helper: ``(step, state)`` for the newest complete
    checkpoint under `dirname`, or None when there is nothing to resume
    from. A corrupt or partially-written newest step (failed integrity
    probe OR failed restore) is skipped with a warning and the previous
    step is used — a crash mid-save must never cost more than one
    checkpoint interval."""
    for step in all_steps(dirname):
        if not verify_checkpoint(dirname, step):
            warnings.warn(
                "skipping corrupt/incomplete checkpoint step %d under "
                "%r" % (step, dirname))
            continue
        try:
            return int(step), load_checkpoint(dirname, step=step)
        except IOError as e:
            warnings.warn(
                "checkpoint step %d under %r failed to restore (%s); "
                "falling back to the previous step" % (step, dirname, e))
    return None


# ---------------------------------------------------------------------------
# fleet-consistent (consensus) checkpoints
# ---------------------------------------------------------------------------
#
# A checkpoint only counts for elastic resume once EVERY worker finished
# its save of that step: a step some worker never wrote would
# desynchronise the fleet on restore. Each worker writes payload under
# worker_dir(dirname, i) and then an atomic per-worker done-marker; the
# newest step with a full marker set is the fleet-consistent resume
# point. Markers record the membership at save time, so survivors of a
# shrink still recognise pre-failure checkpoints as complete.

CONSENSUS_DIR = "fleet-consensus"


def worker_dir(dirname, worker_index):
    """Per-worker checkpoint payload root under a shared `dirname` —
    the one place the elastic on-disk layout is defined."""
    return os.path.join(dirname, "worker%05d" % int(worker_index))


def mark_save_complete(dirname, step, worker_index, world_size,
                       members=None, digests=None):
    """Atomically record that `worker_index` finished saving `step`.
    `members` is the fleet membership at save time (worker indices;
    default ``range(world_size)``) — after an elastic shrink the
    survivors are NOT a contiguous range, and consensus requires a
    marker from exactly the members that were supposed to save.
    `digests` (what :func:`save_checkpoint` returned) rides in the
    marker so the consensus restore verifies this worker's shard
    against the digests recorded at the moment consensus formed. Call
    only AFTER the save was flushed (``save_checkpoint(..., wait=True)``
    or ``finalize()``)."""
    d = os.path.join(dirname, CONSENSUS_DIR, "%012d" % int(step))
    os.makedirs(d, exist_ok=True)
    marker = os.path.join(d, "worker%05d.done" % int(worker_index))
    tmp = marker + ".tmp"
    if members is None:
        members = range(int(world_size))
    doc = {"worker": int(worker_index), "world": int(world_size),
           "members": sorted(int(m) for m in members),
           "step": int(step), "time": time.time()}
    if digests:
        doc["digests"] = dict(digests)
    with open(tmp, "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, marker)
    return marker


def _consensus_required(markers, world_size):
    """The worker set whose markers make a step fleet-consistent."""
    if world_size is not None:
        return set(range(int(world_size)))
    for m in markers:
        if m.get("members"):
            return set(m["members"])
    world = max(m.get("world", 0) for m in markers)
    return set(range(int(world))) if world else None


def _consensus_markers(dirname, step):
    d = os.path.join(dirname, CONSENSUS_DIR, "%012d" % int(step))
    if not os.path.isdir(d):
        return []
    out = []
    for entry in sorted(os.listdir(d)):
        if not entry.endswith(".done"):
            continue
        try:
            with open(os.path.join(d, entry)) as f:
                out.append(json.load(f))
        except (OSError, ValueError):
            continue  # torn marker == not written
    return out


def _consensus_steps(dirname):
    root = os.path.join(dirname, CONSENSUS_DIR)
    if not os.path.isdir(root):
        return []
    return sorted((int(e) for e in os.listdir(root) if e.isdigit()),
                  reverse=True)


def latest_consensus_step(dirname, world_size=None):
    """Newest step for which all workers wrote done-markers, or None.
    With `world_size` None the required set comes from the markers
    themselves (the membership recorded at save time) — so a shrunken
    fleet can still find checkpoints saved by the larger pre-failure
    fleet."""
    for step in _consensus_steps(dirname):
        markers = _consensus_markers(dirname, step)
        if not markers:
            continue
        need = _consensus_required(markers, world_size)
        have = {m.get("worker") for m in markers}
        if need and have >= need:
            return step
    return None


def restore_latest_consensus(dirname, worker_index, world_size=None):
    """Elastic resume: ``(step, state)`` for this worker's payload at
    the newest fleet-consistent step, or None. Consensus steps whose
    payload fails the integrity probe or the restore are skipped with a
    warning (same fallback contract as :func:`restore_latest`)."""
    wdir = worker_dir(dirname, worker_index)
    for step in _consensus_steps(dirname):
        markers = _consensus_markers(dirname, step)
        if not markers:
            continue
        need = _consensus_required(markers, world_size)
        have = {m.get("worker") for m in markers}
        if not need or not have >= need:
            continue
        if not verify_checkpoint(wdir, step):
            warnings.warn(
                "consensus step %d: worker %d payload under %r failed "
                "the integrity probe; trying an older consensus step"
                % (step, worker_index, wdir))
            continue
        try:
            state = load_checkpoint(wdir, step=step)
        except IOError as e:
            warnings.warn(
                "consensus step %d: worker %d restore failed (%s); "
                "trying an older consensus step"
                % (step, worker_index, e))
            continue
        # the done-marker may carry the digests recorded when consensus
        # formed — a shard that drifted since (bit rot, tampering)
        # fails here even if its own manifest was rewritten with it
        mine = next((m for m in markers
                     if m.get("worker") == int(worker_index)), None)
        if mine and mine.get("digests"):
            from .. import observability as obs
            from ..integrity.digest import state_mismatches

            mism = state_mismatches(_host_view(state), mine["digests"])
            if mism:
                name = mism[0][0]
                obs.inc("integrity.checkpoint_digest_mismatch",
                        len(mism))
                obs.event("integrity_violation", source="checkpoint",
                          path=wdir, step=int(step), check="done-marker",
                          tensor=name, mismatches=len(mism))
                warnings.warn(
                    "consensus step %d: worker %d shard disagrees with "
                    "its done-marker digests (first mismatch: tensor %r "
                    "under %r); trying an older consensus step"
                    % (step, worker_index, name, wdir))
                continue
        return int(step), state
    return None
