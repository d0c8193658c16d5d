"""The feed and dispatch surface of the port against the JAX package, on
the CPU: ``Executor.run_pipelined`` (fluid/async_pipeline.py), the
program-attached ``py_reader`` with device staging, the reader auto-feed
of ``Executor.run``, and the ``run`` and ``feed`` fault-injection sites.

- The JAX package's six cases of tests/test_async_pipeline.py, run on
  the port (without the lock sanitizer, which waits for ROADMAP Queue 1
  item 11). The overlap case decides without a race: the stager's
  staging of batch 2 and the consumer's run of batch 1 each wait for the
  other to begin (a bounded ``Event.wait``), so their spans overlap.
- Across the packages, from the same parameters: the JAX package's
  ``run`` loop and the port's ``run_pipelined`` give losses within 1e-6
  relative, and the port's pipelined run is bit-identical to its own run
  loop, parameters included; ``py_reader`` ends the epoch with
  ``core.EOFException`` after N batches in both; a decorated reader
  never started raises ``ReaderNotStartedError`` in both; a producer's
  error surfaces at the consumer in both; the reader's gauge and
  histogram have the same names.
- ``PADDLE_TPU_FAULT_SPEC`` naming the ``run`` or the ``feed`` site
  fires at the same step in both packages.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import observability as jobs
from paddle_tpu.fluid import resilience as jres
from paddle_tpu.fluid import unique_name as jax_unique_name
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import resilience as pres
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.executor import Scope
from paddle_tpu_torch.fluid.io import params_from_numpy

LOSS_RTOL = 1e-6
WAIT = 60.0     # s: the bound of every wait in these tests


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, name generator and scope of the port, and
    both packages' hubs and fault injectors."""
    old_main = pt_framework.switch_main_program(pt_framework.Program())
    old_startup = pt_framework.switch_startup_program(pt_framework.Program())
    old_gen = pt_unique_name.switch()
    old_scopes = pt_executor._scope_stack[:]
    pt_executor._scope_stack[:] = [pt_executor.Scope()]
    obs.reset()
    jobs.reset()
    yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)
    pt_executor._scope_stack[:] = old_scopes
    obs.reset()
    jobs.reset()
    pres.FaultInjector.uninstall()
    jres.FaultInjector.uninstall()


def _train_net(pkg=fluid, width=8):
    x = pkg.data("x", [None, width], dtype="float32")
    y = pkg.layers.fc(x, size=width)
    y = pkg.layers.fc(y, size=width)
    y = pkg.layers.fc(y, size=1)
    loss = pkg.layers.reduce_mean(y)
    pkg.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return loss


def _feeds(n, batch, width, dtype="float32", seed=7):
    rng = np.random.RandomState(seed)
    return [{"x": rng.uniform(-1, 1, (batch, width)).astype(dtype)}
            for _ in range(n)]


# ---------------------------------------------------------------------------
# the JAX package's cases (tests/test_async_pipeline.py), on the port
# ---------------------------------------------------------------------------
def test_pipelined_losses_bit_identical_to_sync():
    """Same program, two fresh scopes: the pipelined loop produces the
    exact loss byte sequence of the sync loop, and the same weights."""
    loss = _train_net()
    feeds = _feeds(6, 4, 8)
    exe1 = fluid.Executor(fluid.CPUPlace())
    s1 = Scope()
    exe1.run(fluid.default_startup_program(), scope=s1)
    sync = [exe1.run(feed=f, fetch_list=[loss], scope=s1)[0] for f in feeds]
    exe2 = fluid.Executor(fluid.CPUPlace())
    s2 = Scope()
    exe2.run(fluid.default_startup_program(), scope=s2)
    runner = exe2.run_pipelined(feeds=feeds, fetch_list=[loss], scope=s2)
    piped = [out[0] for out in runner]
    assert len(piped) == len(sync) == runner.steps
    for a, b in zip(sync, piped):
        np.testing.assert_array_equal(a, b)
    params = [p.name for p in fluid.default_main_program().all_parameters()]
    assert len(params) == 6
    for n in params:
        assert torch.equal(s1[n], s2[n]), n


class _HandshakeExecutor(fluid.Executor):
    """Once armed, the stager's staging of batch 2 and the consumer's run
    of batch 1 each wait, inside their spans, until the other has
    begun."""

    def __init__(self, place):
        super().__init__(place)
        self.stage_in, self.run_in = threading.Event(), threading.Event()
        self.armed = False
        self.staged = 0
        self.waits = []

    def _prepare_feeds(self, program, feed, non_blocking=False):
        on_main = threading.current_thread() is threading.main_thread()
        if self.armed and on_main:
            if not self.run_in.is_set():
                self.run_in.set()
                self.waits.append(self.stage_in.wait(WAIT))
        elif self.armed:
            self.staged += 1
            if self.staged == 2:
                self.stage_in.set()
                self.waits.append(self.run_in.wait(WAIT))
        return super()._prepare_feeds(program, feed, non_blocking)


def test_overlap_shown_by_span_timestamps(monkeypatch):
    """Trace-mode flight recording: an ``executor.stage_feed`` span (the
    stager thread) overlaps an in-flight ``executor.run`` span (the
    consumer) in wall-clock, and the summary gauge agrees."""
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY", "trace")
    loss = _train_net(width=16)
    feeds = _feeds(6, 64, 16, dtype="float64")
    exe = _HandshakeExecutor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    obs.reset()
    exe.armed = True
    runner = exe.run_pipelined(feeds=feeds, fetch_list=[loss], depth=2,
                               window=2)
    results = list(runner)
    assert len(results) == 6 and exe.waits == [True, True]

    def intervals(name):
        # span events record exit ts + duration: interval = [ts-dt, ts]
        return [(ev["ts"] - ev["seconds"], ev["ts"])
                for ev in obs.get_recorder().of("span")
                if ev["name"] == name]

    stage = intervals("executor.stage_feed")
    runs = intervals("executor.run")
    assert len(stage) == 6 and len(runs) == 6
    overlapped = sum(1 for s0, s1 in stage for r0, r1 in runs
                     if min(s1, r1) > max(s0, r0))
    assert overlapped >= 1
    assert runner.overlap_ratio() > 0.0
    assert obs.gauge("executor.overlap_ratio") > 0.0


def test_runner_is_single_use_and_close_discards(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY", "on")
    loss = _train_net()
    feeds = _feeds(8, 4, 8)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    runner = exe.run_pipelined(feeds=feeds, fetch_list=[loss])
    it = iter(runner)
    next(it)
    next(it)
    it.close()  # GeneratorExit -> runner.close(): stager stopped
    assert runner._stop.is_set()
    runner.close()  # idempotent
    with pytest.raises(RuntimeError):
        iter(runner)


def test_pipelined_from_py_reader_until_eof():
    """feeds=None pulls from the program's started py_reader and ends
    cleanly at EOF instead of raising."""
    reader = fluid.layers.py_reader(
        capacity=4, shapes=[(4, 8)], dtypes=["float32"], name="prd")
    x = fluid.layers.read_file(reader)
    y = fluid.layers.fc(x, size=1)
    loss = fluid.layers.reduce_mean(y)
    fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    batches = [{"prd_slot0": f["x"]} for f in _feeds(5, 4, 8, seed=11)]
    reader.decorate_batch_generator(lambda: iter(batches))
    reader.start()
    runner = exe.run_pipelined(fetch_list=[loss])
    out = [o[0] for o in runner]
    assert len(out) == 5
    assert all(np.isfinite(v).all() for v in out)


def test_pipelined_without_reader_raises():
    _train_net()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    runner = exe.run_pipelined()  # no feeds, no started reader
    with pytest.raises(fluid.core.ReaderNotStartedError):
        list(runner)


def test_reader_prefetch_to_device_stages_arrays():
    """prefetch_to_device: the consumer pops tensors on the place's device,
    and reset() invalidates staged batches (generation bump)."""
    reader = fluid.layers.py_reader(
        capacity=4, shapes=[(2, 4)], dtypes=["float32"], name="st")
    batches = [{"st_slot0": np.full((2, 4), i, "float32")}
               for i in range(4)]
    reader.decorate_batch_generator(lambda: iter(batches))
    reader.prefetch_to_device(fluid.CPUPlace())
    reader.start()
    first = reader._next_feed()
    v = first["st_slot0"]
    assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
    np.testing.assert_array_equal(v.numpy(), batches[0]["st_slot0"])
    reader.reset()
    assert reader._staged is None
    # restart delivers the epoch from the top, staged again
    reader.start()
    first2 = reader._next_feed()
    assert isinstance(first2["st_slot0"], torch.Tensor)
    np.testing.assert_array_equal(first2["st_slot0"].numpy(),
                                  batches[0]["st_slot0"])
    reader.reset()


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------
def _both_nets():
    """The fc net in each package, same names; the port's scope holds the
    JAX package's startup values."""
    jax_unique_name.switch()
    jmain, jstart = jfluid.Program(), jfluid.Program()
    jstart.random_seed = 5
    with jfluid.program_guard(jmain, jstart):
        jloss = _train_net(jfluid)
    pt_unique_name.switch()
    pmain, pstart = fluid.Program(), fluid.Program()
    with fluid.program_guard(pmain, pstart):
        ploss = _train_net(fluid)
    jscope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=jscope)
    names = [v.name for v in pmain.global_block().vars.values()
             if v.persistable]
    init = {n: np.array(jscope.find_value(n)) for n in names
            if jscope.find_value(n) is not None}
    return (jmain, jloss, jscope), (pmain, ploss, init)


def _port_scope(init):
    scope = Scope()
    for n, t in params_from_numpy(init, torch.device("cpu")).items():
        scope.set(n, t)
    return scope


def test_pipelined_against_the_jax_run_loop():
    (jmain, jloss, jscope), (pmain, ploss, init) = _both_nets()
    feeds = _feeds(6, 4, 8, seed=3)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    want = [float(np.asarray(jexe.run(jmain, feed=f, fetch_list=[jloss],
                                      scope=jscope)[0])) for f in feeds]
    s_loop, s_pipe = _port_scope(init), _port_scope(init)
    exe = fluid.Executor(fluid.CPUPlace())
    loop = [exe.run(pmain, feed=f, fetch_list=[ploss], scope=s_loop)[0]
            for f in feeds]
    exe = fluid.Executor(fluid.CPUPlace())
    piped = [o[0] for o in exe.run_pipelined(
        pmain, feeds=feeds, fetch_list=[ploss], scope=s_pipe)]
    np.testing.assert_allclose([float(v) for v in piped], want,
                               rtol=LOSS_RTOL)
    assert [v.tobytes() for v in piped] == [v.tobytes() for v in loop]
    for n in init:
        assert torch.equal(s_loop[n], s_pipe[n]), n


def _reader_net(pkg, n_batches, fail_after=None):
    """A py_reader feeding fc + mean; its generator yields `n_batches`
    batches, or raises ValueError after `fail_after`."""
    reader = pkg.layers.py_reader(capacity=2, shapes=[(4, 8)],
                                  dtypes=["float32"], name="rd")
    x = pkg.layers.read_file(reader)
    loss = pkg.layers.reduce_mean(pkg.layers.fc(x, size=1))
    batches = [[f["x"]] for f in _feeds(n_batches, 4, 8, seed=1)]

    def gen():
        for i, b in enumerate(batches):
            if fail_after is not None and i == fail_after:
                raise ValueError("producer failed at batch %d" % i)
            yield b

    reader.decorate_batch_generator(gen)
    return reader, loss


def _both(fn):
    """fn(pkg) in each package's fresh default programs and scope."""
    out = {}
    jax_unique_name.switch()
    jmain, jstart = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(jmain, jstart), \
            jfluid.scope_guard(jfluid.Scope()):
        out["jax"] = fn(jfluid)
    pt_unique_name.switch()
    pmain, pstart = fluid.Program(), fluid.Program()
    with fluid.program_guard(pmain, pstart), fluid.scope_guard(Scope()):
        out["port"] = fn(fluid)
    return out


def _steps_until(pkg, loss, exc):
    exe = pkg.Executor(pkg.CPUPlace())
    exe.run(pkg.default_startup_program())
    n = 0
    with pytest.raises(exc) as info:
        while True:
            exe.run(fetch_list=[loss])
            n += 1
    return n, str(info.value)


def test_py_reader_eof_after_n_batches():
    def run(pkg):
        reader, loss = _reader_net(pkg, 5)
        reader.start()
        n, _ = _steps_until(pkg, loss, pkg.core.EOFException)
        # a second epoch after reset() + start()
        reader.reset()
        reader.start()
        m, _ = _steps_until(pkg, loss, pkg.core.EOFException)
        return n, m, reader.thread_alive()

    got = _both(run)
    assert got["port"] == got["jax"] == (5, 5, False)


def test_unstarted_reader_raises_in_both():
    def run(pkg):
        reader, loss = _reader_net(pkg, 3)
        exe = pkg.Executor(pkg.CPUPlace())
        exe.run(pkg.default_startup_program())
        with pytest.raises(pkg.core.ReaderNotStartedError) as info:
            exe.run(fetch_list=[loss])
        return str(info.value)

    got = _both(run)
    assert got["port"] == got["jax"]
    assert "rd_slot0" in got["port"] and "reader.start()" in got["port"]


def test_producer_error_surfaces_at_the_consumer():
    def run(pkg):
        reader, loss = _reader_net(pkg, 4, fail_after=2)
        reader.start()
        return _steps_until(pkg, loss, ValueError)

    got = _both(run)
    assert got["port"] == got["jax"] == (2, "producer failed at batch 2")


def test_reader_metric_names():
    def run(pkg):
        hub = jobs if pkg is jfluid else obs
        reader, _ = _reader_net(pkg, 3)
        reader.start()
        for _ in range(3):
            assert reader._next_feed() is not None
        snap = hub.snapshot()
        return (sorted(n for n in snap["gauges"] if n.startswith("reader")),
                {n: h["count"] for n, h in snap["histograms"].items()
                 if n.startswith("reader")})

    got = _both(run)
    assert got["port"] == got["jax"] == (
        ["reader.queue_depth"], {"reader.pop_wait_seconds": 3})


@pytest.mark.parametrize("spec, fed", [
    ("run:at=3:RuntimeError", True),
    ("run:at=3:RuntimeError", False),
    ("feed:at=2:RuntimeError", False),
], ids=["run-feed-dict", "run-reader", "feed-reader"])
def test_fault_sites_fire_at_the_same_step(monkeypatch, spec, fed):
    """A spec naming the ``run`` site fires at the 3rd ``Executor.run``
    (the startup run counts) and one naming ``feed`` at the 2nd reader
    pop, in both packages."""
    def run(pkg):
        reader, loss = _reader_net(pkg, 5)
        exe = pkg.Executor(pkg.CPUPlace())
        feeds = _feeds(5, 4, 8, seed=1)
        if not fed:
            reader.start()
        (pres if pkg is fluid else jres).FaultInjector.uninstall()
        monkeypatch.setenv("PADDLE_TPU_FAULT_SPEC", spec)
        runs = 0
        try:
            exe.run(pkg.default_startup_program())
            runs += 1
            for f in feeds:
                exe.run(feed={"rd_slot0": f["x"]} if fed else None,
                        fetch_list=[loss])
                runs += 1
        except RuntimeError as e:
            return runs, str(e)
        finally:
            monkeypatch.delenv("PADDLE_TPU_FAULT_SPEC")
            reader.reset()
        return runs, None

    got = _both(run)
    assert got["port"] == got["jax"]
    # the startup run and one step ran before the fault
    assert got["port"][0] == 2 and got["port"][1] is not None
