"""Guarded execution of the port (paddle_tpu_torch/fluid/resilience.py)
against the JAX package's, as parity runs.

Ported from tests/test_resilience.py (:109-347, :424-547): retry with
backoff, ``NEVER_RETRY`` (graph errors, EOF), the non-finite guard and
AMP's managed skip, the injected NaN fetch, the watchdog, ``run_guarded``,
py_reader EOF and feeder restarts, and the end-to-end TrainGuard crash
and resume. Each scenario runs in both packages: the same program from
the same parameters (the JAX package's startup values copied into the
port's scope), under the same fault spec. The event logs (retried,
skipped and saved steps, restores, EOFs, reader restarts, the summary's
``resumed_from``/``first_step``/``final_step``) must be equal, and the
parameters within 1e-6 of max|param|.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import core as jcore
from paddle_tpu.fluid import resilience as JR
from paddle_tpu.parallel import checkpoint as jckpt

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import core
from paddle_tpu_torch.fluid import resilience as R
from paddle_tpu_torch.parallel import checkpoint as ckpt

import torch_elastic_ranks as ter
import torch_ranks as tr

PKGS = {"jax": (jfluid, JR, jcore, jckpt), "port": (fluid, R, core, ckpt)}
LOGGED = ("step", "retry", "skip", "save", "restore", "eof",
          "reader_restart", "staging_invalidate", "rollback", "final")
KEYS = ("step", "skipped", "retries", "attempt", "consecutive", "managed",
        "vars", "reason", "readers", "skipped_steps", "lr_scale", "lr")


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


def _events(log):
    out = []
    for ev in log.events:
        if ev["kind"] not in LOGGED:
            continue
        rec = [ev["kind"]]
        for k in KEYS:
            if k in ev:
                v = ev[k]
                if k == "reason":
                    v = v.split(":")[0]
                rec.append((k, v))
        out.append(tuple(rec))
    return out


def _summary(s):
    return {k: s[k] for k in ("resumed_from", "first_step", "final_step",
                              "steps_run", "last_saved")}


def _run_both(scenario, *args):
    """scenario(fl, R, core, ckpt, init, *args) -> (record, params) in
    each package under fresh programs; `init` is None for the JAX
    package's run and its startup parameters for the port's."""
    out = {}
    init = None
    for name in ("jax", "port"):
        fl, r, c, k = PKGS[name]
        with fl.program_guard(fl.Program(), fl.Program()):
            with fl.unique_name.guard():
                rec, params = scenario(fl, r, c, k, init, *args)
        r.FaultInjector.uninstall()
        if name == "jax":
            init = params["__init__"]
        out[name] = (rec, params)
    (jrec, jp), (prec, pp) = out["jax"], out["port"]
    assert prec == jrec
    for n in jp:
        if n == "__init__":
            continue
        want, got = np.asarray(jp[n]), np.asarray(pp[n])
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)
    return prec


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().float().numpy().copy()
    return np.asarray(v).copy()


def _start(fl, init, scope=None, names=()):
    """Executor on the CPU, startup run, then the JAX package's startup
    values when given; returns (exe, the startup values)."""
    scope = scope if scope is not None else fl.global_scope()
    exe = fl.Executor(fl.CPUPlace())
    exe.run(fl.default_startup_program(), scope=scope)
    if init is not None:
        for n, v in init.items():
            scope.set(n, torch.from_numpy(v.copy()))
    start = {n: _host(scope.find_value(n)) for n in names}
    return exe, start


def _sgd_net(fl, lr=0.1):
    fl.default_startup_program().random_seed = 42
    x = fl.data(name="x", shape=[None, 4], dtype="float32")
    y = fl.layers.fc(input=x, size=3, param_attr=fl.ParamAttr(name="w"),
                     bias_attr=fl.ParamAttr(name="b"))
    loss = fl.layers.mean(y)
    fl.optimizer.SGD(learning_rate=lr).minimize(loss)
    return loss


def _feed(step, rows=2):
    rng = np.random.RandomState(step)
    return {"x": rng.rand(rows, 4).astype("float32")}


def _params(fl, names=("w", "b"), scope=None):
    scope = scope if scope is not None else fl.global_scope()
    return {n: _host(scope.find_value(n)) for n in names}


# ---------------------------------------------------------------------------
# GuardedExecutor
# ---------------------------------------------------------------------------


def _retries(fl, r, c, k, init):
    loss = _sgd_net(fl)
    exe, start = _start(fl, init, names=("w", "b"))
    r.FaultInjector.install("run:every=3:RuntimeError")
    guard = r.GuardedExecutor(exe, max_retries=2, backoff_base=0.001)
    reports = [guard.run(feed=_feed(s), fetch_list=[loss])
               for s in range(1, 6)]
    assert all(np.isfinite(np.asarray(x[0])).all() for x in reports)
    rec = ([x.retries for x in reports], dict(guard.counters),
           [float(np.asarray(x[0])) for x in reports])
    return rec[:2], dict(_params(fl), __init__=start,
                         losses=np.array(rec[2]))


def test_guarded_retries_transient_run_faults():
    retries, counters = _run_both(_retries)
    assert retries.count(1) >= 1 and counters["retry"] >= 1


def _gives_up(fl, r, c, k, init):
    loss = _sgd_net(fl)
    exe, start = _start(fl, init, names=("w", "b"))
    r.FaultInjector.install("run:every=1:RuntimeError")
    guard = r.GuardedExecutor(exe, max_retries=2, backoff_base=0.001)
    with pytest.raises(RuntimeError, match="injected fault"):
        guard.run(feed=_feed(1), fetch_list=[loss])
    return dict(guard.counters), dict(_params(fl), __init__=start)


def test_guarded_gives_up_after_max_retries():
    assert _run_both(_gives_up) == {"retry": 2}


def _graph_error(fl, r, c, k, init):
    loss = _sgd_net(fl)
    exe, start = _start(fl, init, names=("w", "b"))
    guard = r.GuardedExecutor(exe, max_retries=3, backoff_base=0.001)
    lowering = __import__(fl.__name__ + ".lowering",
                          fromlist=["OpLoweringError"])
    with pytest.raises(lowering.OpLoweringError):
        guard.run(feed={}, fetch_list=[loss])
    return dict(guard.counters), dict(_params(fl), __init__=start)


def test_guarded_does_not_retry_graph_errors():
    """OpLoweringError is a RuntimeError subclass but a GRAPH error —
    retrying can't fix a missing feed."""
    assert _run_both(_graph_error) == {}


def _forward_net(fl):
    """No optimizer: a NaN feed must not poison persistable state."""
    x = fl.data(name="x", shape=[None, 4], dtype="float32")
    return fl.layers.mean(fl.layers.fc(
        input=x, size=3, param_attr=fl.ParamAttr(name="w"),
        bias_attr=fl.ParamAttr(name="b")))


def _nonfinite(fl, r, c, k, init):
    loss = _forward_net(fl)
    exe, start = _start(fl, init, names=("w", "b"))
    guard = r.GuardedExecutor(exe, max_consecutive_nonfinite=3)
    nan_feed = {"x": np.full((2, 4), np.nan, "float32")}
    seen = []
    for feed in (nan_feed, nan_feed, _feed(1), nan_feed, nan_feed):
        rep = guard.run(feed=feed, fetch_list=[loss])
        seen.append((rep.skipped, rep.nonfinite, rep.managed))
    with pytest.raises(r.NonFiniteError, match="3 consecutive"):
        guard.run(feed=nan_feed, fetch_list=[loss])
    return (seen, dict(guard.counters)), dict(_params(fl), __init__=start)


def test_nonfinite_guard_skips_then_raises():
    seen, counters = _run_both(_nonfinite)
    assert [s[0] for s in seen] == [True, True, False, True, True]
    assert counters["skip"] == 4


def _raise_fast(fl, r, c, k, init):
    loss = _forward_net(fl)
    exe, start = _start(fl, init, names=("w", "b"))
    guard = r.GuardedExecutor(exe, nonfinite_action="raise")
    with pytest.raises(r.NonFiniteError):
        guard.run(feed={"x": np.full((2, 4), np.inf, "float32")},
                  fetch_list=[loss])
    with pytest.raises(ValueError, match="nonfinite_action"):
        r.GuardedExecutor(exe, nonfinite_action="ignore")
    return dict(guard.counters), dict(_params(fl), __init__=start)


def test_nonfinite_action_raise_fails_fast():
    assert _run_both(_raise_fast) == {}


def _nan_fetch(fl, r, c, k, init, return_numpy):
    loss = _sgd_net(fl)
    exe, start = _start(fl, init, names=("w", "b"))
    r.FaultInjector.install("fetch:at=2:nan")
    guard = r.GuardedExecutor(exe)
    kw = {} if return_numpy else {"return_numpy": False}
    if fl is jfluid:
        kw = {}
    flags = []
    for s in (1, 2, 3):
        rep = guard.run(feed=_feed(s), fetch_list=[loss], **kw)
        flags.append((rep.skipped, bool(np.isnan(_host(rep[0])).any())))
    return flags, dict(_params(fl), __init__=start)


@pytest.mark.parametrize("return_numpy", [True, False])
def test_injected_nan_fetch_trips_the_guard(return_numpy):
    """The port's return_numpy=False keeps the fetch a tensor: the
    guard reduces it where it lives."""
    assert _run_both(_nan_fetch, return_numpy) == [
        (False, False), (True, True), (False, False)]


def test_timeout_watchdog_raises_and_does_not_retry():
    """The abandoned dispatch thread is released and joined before the
    test ends, so no thread outlives it in its worker."""
    for r in (JR, R):
        release = threading.Event()

        class SlowExecutor:
            calls = 0

            def run(self, *a, **k):
                SlowExecutor.calls += 1
                release.wait(10)

        guard = r.GuardedExecutor(SlowExecutor(), timeout=0.15,
                                  max_retries=3)
        t0 = time.time()
        with pytest.raises(r.StepTimeoutError, match="wall-clock") as e:
            guard.run(feed={}, fetch_list=[])
        assert time.time() - t0 < 2.0
        assert SlowExecutor.calls == 1        # no blind re-dispatch
        assert guard.counters["timeout"] == 1
        if r is R:
            assert "may still be writing" in str(e.value)
        release.set()
        for t in threading.enumerate():
            if t.name == "paddle_tpu-guarded-run":
                t.join(10)
                assert not t.is_alive()


def _oneshot(fl, r, c, k, init):
    loss = _sgd_net(fl)
    exe, start = _start(fl, init, names=("w", "b"))
    r.FaultInjector.install("run:every=2:RuntimeError")
    out = r.run_guarded(exe, feed=_feed(1), fetch_list=[loss],
                        max_retries=1, backoff_base=0.001,
                        scope=fl.global_scope())
    assert np.isfinite(np.asarray(out[0])).all()
    return out.retries, dict(_params(fl), __init__=start,
                             loss=np.asarray(out[0]))


def test_run_guarded_oneshot():
    assert _run_both(_oneshot) == 0


# ---------------------------------------------------------------------------
# py_reader EOF / restart paths
# ---------------------------------------------------------------------------


def _reader_net(fl, n_batches=3, name="rr"):
    x = fl.data(name="%s_x" % name, shape=[2, 3], dtype="float32")
    reader = fl.layers.create_py_reader_by_data(
        capacity=4, feed_list=[x], name=name)
    out = fl.layers.reduce_mean(fl.layers.scale(x, scale=2.0))

    def gen():
        for i in range(n_batches):
            yield {"%s_x" % name: np.full((2, 3), float(i), "float32")}

    reader.decorate_tensor_provider(gen)
    return reader, out


def _eof(fl, r, c, k, init):
    reader, out = _reader_net(fl, n_batches=2)
    exe, start = _start(fl, None)
    reader.start()
    seen = 0
    try:
        while True:
            exe.run(feed=None, fetch_list=[out])
            seen += 1
    except c.EOFException:
        pass
    with pytest.raises(c.ReaderNotStartedError, match="reader.start"):
        exe.run(feed=None, fetch_list=[out])
    reader.restart()
    v = exe.run(feed=None, fetch_list=[out])[0]
    reader.reset()
    return seen, {"__init__": start, "v": np.asarray(v)}


def test_eof_propagates_cleanly_through_run():
    assert _run_both(_eof) == 2


def _never_retry_eof(fl, r, c, k, init):
    reader, out = _reader_net(fl, n_batches=1)
    exe, start = _start(fl, None)
    reader.start()
    guard = r.GuardedExecutor(exe, max_retries=5, backoff_base=0.001)
    guard.run(feed=None, fetch_list=[out])
    with pytest.raises(c.EOFException):
        guard.run(feed=None, fetch_list=[out])
    reader.reset()
    assert c.EOFException in r.GuardedExecutor.NEVER_RETRY
    return dict(guard.counters), {"__init__": start}


def test_guarded_never_retries_eof():
    assert _run_both(_never_retry_eof) == {}


def _dead_feeder(fl, r, c, k, init):
    x = fl.data(name="fx", shape=[1], dtype="float32")
    reader = fl.layers.create_py_reader_by_data(
        capacity=2, feed_list=[x], name="flaky")
    out = fl.layers.reduce_mean(x)
    exe, start = _start(fl, None)
    attempts = []

    def flaky_gen():
        attempts.append(1)
        for i in range(8):
            if len(attempts) == 1 and i == 2:
                raise RuntimeError("feeder died")
            yield {"fx": np.array([float(i)], "float32")}

    reader.decorate_tensor_provider(flaky_gen)
    reader.start()
    tg = r.TrainGuard(exe, fetch_list=[out], readers=[reader],
                      reader_restarts=2, max_retries=1,
                      backoff_base=0.001)
    summary = tg.train(num_steps=5)
    reader.reset()
    assert len(attempts) >= 2              # the generator was re-opened
    return (_summary(summary), _events(tg.log)), {"__init__": start}


def test_trainguard_restarts_dead_feeder_thread():
    summary, events = _run_both(_dead_feeder)
    assert summary["final_step"] == 5
    assert [e for e in events if e[0] == "reader_restart"]


def _epochs(fl, r, c, k, init):
    reader, out = _reader_net(fl, n_batches=3, name="ep")
    exe, start = _start(fl, None)
    reader.start()
    tg = r.TrainGuard(exe, fetch_list=[out], readers=[reader])
    summary = tg.train(num_steps=7)        # 3 batches/epoch -> 3 epochs
    reader.reset()
    return ((_summary(summary), _events(tg.log),
             tg.log.counters["eof"], tg.log.counters["reader_restart"]),
            {"__init__": start})


def test_trainguard_rolls_epochs_on_eof():
    summary, _, eofs, restarts = _run_both(_epochs)
    assert summary["final_step"] == 7 and eofs == 2 and restarts == 2


def test_retry_reader_fast_forwards_past_failures():
    from paddle_tpu.reader import decorator as jdec
    from paddle_tpu_torch.reader import decorator as pdec

    got = []
    for rdec in (jdec, pdec):
        opens = []

        def source():
            opens.append(1)
            for i in range(6):
                if len(opens) == 1 and i == 3:
                    raise IOError("flaky storage")
                yield i

        got.append((list(rdec.retry_reader(source, retries=1)()),
                    len(opens)))

        def always_bad():
            raise IOError("dead")
            yield  # pragma: no cover

        with pytest.raises(IOError, match="dead"):
            list(rdec.retry_reader(always_bad, retries=2)())
    assert got[0] == got[1] == ([0, 1, 2, 3, 4, 5], 2)


# ---------------------------------------------------------------------------
# AMP cooperation
# ---------------------------------------------------------------------------


def _amp(fl, r, c, k, init):
    mp = __import__(fl.__name__ + ".contrib.mixed_precision",
                    fromlist=["decorate"])
    fl.default_startup_program().random_seed = 7
    x = fl.data(name="x", shape=[None, 4], dtype="float32")
    y = fl.layers.fc(input=x, size=3, param_attr=fl.ParamAttr(name="w"),
                     bias_attr=fl.ParamAttr(name="b"))
    loss = fl.layers.mean(y)
    opt = mp.decorate(
        fl.optimizer.SGD(learning_rate=0.1), use_bf16=False,
        init_loss_scaling=2.0**10, use_dynamic_loss_scaling=True,
        decr_every_n_nan_or_inf=1, decr_ratio=0.5)
    opt.minimize(loss)
    assert opt.get_finite_flag() is not None
    exe, start = _start(fl, init, names=("w", "b"))
    guard = r.GuardedExecutor(exe, amp_optimizer=opt,
                              max_consecutive_nonfinite=4)
    w0 = _params(fl)["w"]
    bad = guard.run(feed={"x": np.full((2, 4), np.nan, "float32")},
                    fetch_list=[loss])
    np.testing.assert_array_equal(_params(fl)["w"], w0)
    ok = guard.run(feed=_feed(1), fetch_list=[loss])
    assert not np.array_equal(_params(fl)["w"], w0)
    scale = _host(fl.global_scope().find_value(
        opt.get_loss_scaling().name))
    return ((bad.skipped, bad.managed, ok.skipped, dict(guard.counters)),
            dict(_params(fl), __init__=start, scale=scale))


def test_amp_dynamic_scaling_skip_cooperation():
    """fp16 dynamic loss scaling: an overflow step is skip-gated
    in-graph (params untouched) and the guard reports it as a managed
    skip instead of raising; the loss scale halves in both packages."""
    bad_skipped, managed, ok_skipped, counters = _run_both(_amp)
    assert bad_skipped and managed and not ok_skipped
    assert counters == {"skip": 1}


# ---------------------------------------------------------------------------
# acceptance: end-to-end recovery
# ---------------------------------------------------------------------------

MLP = ("mlp_w1", "mlp_b1", "mlp_w2", "mlp_b2")


def _mlp(fl, scope, init, seed=11):
    fl.default_startup_program().random_seed = seed
    fl.default_main_program().random_seed = seed
    img = fl.data(name="img", shape=[None, 8], dtype="float32")
    label = fl.data(name="label", shape=[None, 1], dtype="int64")
    h = fl.layers.fc(input=img, size=8, act="relu",
                     param_attr=fl.ParamAttr(name="mlp_w1"),
                     bias_attr=fl.ParamAttr(name="mlp_b1"))
    logits = fl.layers.fc(input=h, size=3,
                          param_attr=fl.ParamAttr(name="mlp_w2"),
                          bias_attr=fl.ParamAttr(name="mlp_b2"))
    loss = fl.layers.mean(
        fl.layers.softmax_with_cross_entropy(logits, label))
    fl.optimizer.SGD(learning_rate=0.1).minimize(loss)
    exe, start = _start(fl, init, scope=scope, names=MLP)
    return exe, loss, fl.default_main_program(), start


def _mlp_feed(step):
    rng = np.random.RandomState(1000 + step)
    return {"img": rng.rand(4, 8).astype("float32"),
            "label": rng.randint(0, 3, (4, 1)).astype("int64")}


def _recovery(fl, r, c, k, init, tmp_path, save_wait):
    d = str(tmp_path / fl.__name__)
    scope = fl.Scope()
    exe, loss, prog, start = _mlp(fl, scope, init)
    # run-site checks: steps 1-4 = 1-4; check 5 fires (step 5 retries via
    # check 6); checks 7-9 = steps 6-8; check 10 fires (step 9); check 11
    # = the hard crash, still step 9 — after the step-8 checkpoint
    r.FaultInjector.install(
        "run:every=5:RuntimeError;fetch:at=7:nan;run:at=11:ZeroDivisionError")
    kw = {} if fl is jfluid else {"save_wait": save_wait}
    tg1 = r.TrainGuard(exe, program=prog, ckpt_dir=d, fetch_list=[loss],
                       feed_fn=_mlp_feed, save_every=4, scope=scope,
                       max_retries=2, backoff_base=0.001, **kw)
    with pytest.raises(ZeroDivisionError):
        tg1.train(num_steps=12)
    r.FaultInjector.uninstall()
    k.finalize(d)
    first = (_events(tg1.log), k.latest_step(d))
    tg2 = r.TrainGuard(exe, program=prog, ckpt_dir=d, fetch_list=[loss],
                       feed_fn=_mlp_feed, save_every=4, scope=scope,
                       max_retries=2, backoff_base=0.001, **kw)
    summary = tg2.train(num_steps=12)
    k.finalize(d)
    second = (_summary(summary), _events(tg2.log), k.latest_step(d))
    # ground truth: the same 12 steps with no faults and no crash
    clean_scope = fl.Scope()
    with fl.program_guard(fl.Program(), fl.Program()):
        with fl.unique_name.guard():
            cexe, closs, cprog, _ = _mlp(fl, clean_scope, init)
        ctg = r.TrainGuard(cexe, program=cprog, fetch_list=[closs],
                           feed_fn=_mlp_feed, scope=clean_scope)
        assert ctg.train(num_steps=12)["final_step"] == 12
    for n in MLP:
        np.testing.assert_array_equal(_host(scope.find_value(n)),
                                      _host(clean_scope.find_value(n)))
    return (first, second), dict(_params(fl, MLP, scope), __init__=start)


@pytest.mark.parametrize("save_wait", [True, False])
def test_trainguard_end_to_end_recovery(tmp_path, save_wait):
    """The acceptance scenario: retried run faults, one injected NaN loss
    (a counted skip), a hard crash after the step-8 checkpoint; a second
    TrainGuard resumes from it, re-runs no completed step, and lands
    bit-identical to an uninterrupted run — in both packages, with the
    same event logs. The port also runs it with background saves."""
    (events1, latest1), (summary, events2, latest2) = _run_both(
        _recovery, tmp_path, save_wait)
    assert [e[1][1] for e in events1 if e[0] == "step"
            and ("skipped", True) in e] == [7]
    assert [e[1][1] for e in events1 if e[0] == "save"] == [4, 8]
    assert latest1 == 8 and latest2 == 12
    assert summary["resumed_from"] == 8 and summary["first_step"] == 9
    assert summary["final_step"] == 12
    assert [e[1][1] for e in events2 if e[0] == "step"] == [9, 10, 11, 12]


# ---------------------------------------------------------------------------
# rollback, staging, and what waits for item 11
# ---------------------------------------------------------------------------


def _rollback(fl, r, c, k, init, tmp_path):
    d = str(tmp_path / ("rb-" + fl.__name__))
    loss = _sgd_net(fl)
    lr = [v for v in fl.default_main_program().list_vars()
          if v.persistable and "learning_rate" in v.name][0]
    exe, start = _start(fl, init, names=("w", "b"))
    tg = r.TrainGuard(exe, ckpt_dir=d, fetch_list=[loss], feed_fn=_feed,
                      save_every=2, lr_var=lr, final_save=False)
    tg.train(num_steps=4)
    # poison the newest step: the rollback walks past it
    scope = fl.global_scope()
    scope.set("w", np.full((4, 3), np.nan, "float32"))
    tg.save(6)
    k.finalize(d)
    out = tg.rollback_to_last_finite(lr_scale=0.5)
    return ((out["step"], out["skipped_steps"], out["lr"],
             _events(tg.log)), dict(_params(fl), __init__=start))


def test_rollback_to_last_finite_walks_past_nan_and_cuts_lr(tmp_path):
    step, skipped, lr, _ = _run_both(_rollback, tmp_path)
    assert step == 4 and skipped == [6] and lr == pytest.approx(0.05)


def test_trainguard_stage_to_device_and_what_waits_for_item_11():
    reader, out = _reader_net(fluid, n_batches=3, name="st")
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    reader.start()
    tg = R.TrainGuard(exe, fetch_list=[out], readers=[reader],
                      stage_to_device=True)
    assert tg.train(num_steps=4)["final_step"] == 4
    reader.reset()
    for kw in ({"runhealth": object()}, {"compile_cache": True}):
        with pytest.raises(NotImplementedError, match="item 11"):
            R.TrainGuard(exe, **kw)
    assert R.GuardedExecutor(exe)._analyze_failure(None, {}, []) == {}


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    """ter.guard_resume on 2 gloo ranks, for each case."""
    return {case: tr.run_ranks(
        ter.guard_resume, 2, tmp_path_factory.mktemp(case),
        args=(case, str(tmp_path_factory.mktemp(case + "_ckpt"))),
        timeout=240) for case in ("tp", "zero", "stacked")}


@pytest.mark.parametrize("case", ["tp", "zero"])
def test_trainguard_saves_split_state_once_and_resumes_it(split_runs, case):
    """BERT-tiny at tp = 2 and under ZeRO-1 at dp = 2: a TrainGuard's
    checkpoint holds the global values, written once into the directory
    both ranks share; after a crash at the second save a second
    TrainGuard resumes from the first and lands bit for bit on the
    uninterrupted run, losses and state. A one-member FleetGuard on each
    rank does the same in a directory of the rank's own; a two-member
    one refuses to shrink, before it changes anything, a program whose
    rank group cannot be rebuilt without the dead rank."""
    runs = split_runs[case]
    for out in runs:
        u = out["U_state"]
        assert out["split"], "no state was split over the ranks"
        assert "injected fault" in out["C_error"]
        assert out["C_latest"] == 2
        assert [e for e in out["C_listing"] if e.isdigit()] == ["2"]
        assert not [e for e in out["C_listing"] if "tmp" in e]
        for shapes in (out["C_step2_shapes"], out["F_step2_shapes"]):
            assert shapes == {n: u[n].shape for n in shapes}
            assert set(out["split"]) <= set(shapes)
        assert out["C_losses"] == out["U_losses"][:4]
        assert out["R"] == (2, 3, 5)
        assert out["R_losses"] == out["U_losses"][2:]
        assert "injected fault" in out["F_error"]
        assert out["F"] == (2, 5)
        assert out["F_losses"] == out["U_losses"][:4] + out["U_losses"][2:]
        for got in (out["R_state"], out["F_state"]):
            assert sorted(got) == sorted(u)
            for n in u:
                np.testing.assert_array_equal(got[n], u[n], err_msg=n)
    for n in runs[0]["R_state"]:
        np.testing.assert_array_equal(runs[0]["R_state"][n],
                                      runs[1]["R_state"][n])
    msg, generation, members = runs[0]["shrink_refusal"]
    assert "shrink_dp" in msg and (generation, members) == (0, [0, 1])


def test_trainguard_refuses_a_program_whose_ranks_keep_their_own_state(
        split_runs):
    """A GradSyncProgram's ranks each keep their own copy of the state:
    a TrainGuard with a checkpoint directory refuses it before a step
    runs or anything is written."""
    for out in split_runs["stacked"]:
        assert "keeps state of its own" in out["refusal"]
        assert not out["wrote"]
