"""fluid.metrics, fluid.evaluator and fluid.input in the port against the
JAX package, on the CPU.

- ``fluid/metrics.py`` is a copy of the JAX package's (numpy only): each
  class takes the same seeded updates in both packages and evaluates to
  the same values, its state and ``reset`` included; ``Accuracy`` is fed
  from ``layers.accuracy`` in a program each package runs, and
  ``DetectionMAP`` streams its in-graph running mean
  (tests/test_rcnn_detection.py's own test, run against the port).
- ``fluid.evaluator``'s deprecated wrappers warn and build the same
  Program; their protocol (fetch the batch value, ``update``, ``eval``,
  ``reset``) gives the same numbers.
- ``fluid.one_hot`` and ``fluid.embedding`` (the v2 layers of
  ``fluid/input.py``) keep a trailing id dim of 1: the same Program JSON
  and the same values as the JAX package's.
"""
import inspect
import json
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from test_torch_rcnn import reference_tests


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, name generator and scope of the port."""
    old_main = pt_framework.switch_main_program(pt_framework.Program())
    old_startup = pt_framework.switch_startup_program(pt_framework.Program())
    old_gen = pt_unique_name.switch()
    old_scopes = pt_executor._scope_stack[:]
    pt_executor._scope_stack[:] = [pt_executor.Scope()]
    yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)
    pt_executor._scope_stack[:] = old_scopes


def test_metrics_is_a_copy():
    from paddle_tpu.fluid import metrics as jm
    from paddle_tpu_torch.fluid import metrics as pm

    assert inspect.getsource(pm) == inspect.getsource(jm)
    assert pm.__all__ == jm.__all__


def _updates(name, rng):
    """Three batches of seeded updates for metric class `name`."""
    out = []
    for _ in range(3):
        if name in ("Precision", "Recall", "CompositeMetric"):
            out.append((rng.uniform(size=(16, 1)),
                        rng.integers(0, 2, size=(16, 1))))
        elif name == "Accuracy":
            out.append((np.array([rng.uniform()], np.float32),
                        int(rng.integers(1, 40))))
        elif name == "ChunkEvaluator":
            out.append(tuple(np.array([v]) for v in sorted(
                rng.integers(0, 30, size=3))[::-1]))
        elif name == "EditDistance":
            d = rng.integers(0, 4, size=(8, 1)).astype(np.float32)
            out.append((d, 8))
        elif name == "Auc":
            p = rng.uniform(size=(32, 1))
            out.append((np.concatenate([1 - p, p], axis=1),
                        rng.integers(0, 2, size=(32, 1))))
    return out


METRICS = ("Precision", "Recall", "Accuracy", "ChunkEvaluator",
           "EditDistance", "Auc", "CompositeMetric")


def _make(mod, name):
    if name == "CompositeMetric":
        m = mod.CompositeMetric()
        m.add_metric(mod.Precision())
        m.add_metric(mod.Recall())
        return m
    if name == "Auc":
        return mod.Auc("auc", num_thresholds=200)
    return getattr(mod, name)()


def _same(a, b):
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("name", METRICS)
def test_metric_class_matches_jax_package(name):
    from paddle_tpu.fluid import metrics as jm

    rng = np.random.default_rng(len(name))
    ups = _updates(name, rng)
    a, b = _make(fluid.metrics, name), _make(jm, name)
    assert str(a) == str(b)
    for u in ups:
        a.update(*u)
        b.update(*u)
        _same(a.eval(), b.eval())
    _same(a.get_config(), b.get_config())
    a.reset()
    b.reset()
    _same(a.get_config(), b.get_config())


def test_metric_errors_match():
    from paddle_tpu.fluid import metrics as jm

    for mod in (fluid.metrics, jm):
        with pytest.raises(ValueError):
            mod.Accuracy().eval()
        with pytest.raises(ValueError):
            mod.Accuracy().update("x", 1)
        with pytest.raises(ValueError):
            mod.EditDistance().eval()
        with pytest.raises(ValueError):
            mod.CompositeMetric().add_metric(object())
        assert mod.Auc().eval() == 0.5


def _classifier(fl):
    x = fl.data(name="x", shape=[None, 8], dtype="float32")
    label = fl.data(name="label", shape=[None, 1], dtype="int64")
    predict = fl.layers.fc(input=x, size=4, act="softmax")
    return x, label, predict


def _build_classifier(fl, un, build):
    """(main, startup, what build returned) of a 4-class fc classifier
    with `build(fl, predict, label)` appended, startup seed 5."""
    un.switch()
    main, start = fl.Program(), fl.Program()
    start.random_seed = 5
    with fl.program_guard(main, start):
        x, label, predict = _classifier(fl)
        made = build(fl, predict, label)
    return main, start, made


def _same_program(build):
    progs = []
    for fl, un in ((jfluid, jax_unique_name), (fluid, pt_unique_name)):
        main, start, made = _build_classifier(fl, un, build)
        progs.append((main, start, made))
    (jm, js, jmade), (pm, ps, pmade) = progs
    assert json.loads(pm.to_json()) == json.loads(jm.to_json())
    assert json.loads(ps.to_json()) == json.loads(js.to_json())
    return progs


def _batches(n=3, rows=16):
    rng = np.random.default_rng(4)
    return [{"x": rng.normal(size=(rows, 8)).astype(np.float32),
             "label": rng.integers(0, 4, size=(rows, 1)).astype(np.int64)}
            for _ in range(n)]


def _run_both(progs, fetch_of):
    """Each package's program on _batches() from the JAX startup's
    values; returns [jax fetches, port fetches] per batch."""
    (jm, js, jmade), (pm, ps, pmade) = progs
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(js, scope=jscope)
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    for p in jm.all_parameters():
        scope.set(p.name, torch.from_numpy(np.array(jscope[p.name])))
    out = []
    for feed in _batches():
        j = jexe.run(jm, feed=feed, scope=jscope, fetch_list=fetch_of(jmade))
        p = exe.run(pm, feed=feed, scope=scope, fetch_list=fetch_of(pmade))
        out.append(([np.asarray(v) for v in j], [np.asarray(v) for v in p]))
    return out


def test_accuracy_fed_from_layers_accuracy():
    """fluid.metrics.Accuracy accumulates layers.accuracy's batch values
    to the same pass accuracy in both packages, equal to the accuracy of
    the pooled predictions."""
    def build(fl, predict, label):
        return fl.layers.accuracy(input=predict, label=label), predict

    progs = _same_program(build)
    from paddle_tpu.fluid import metrics as jm

    acc_p, acc_j = fluid.metrics.Accuracy(), jm.Accuracy()
    hits = n = 0
    for (j, p), feed in zip(_run_both(progs, lambda m: list(m)), _batches()):
        np.testing.assert_allclose(p[0], j[0], rtol=1e-6)
        acc_p.update(value=p[0], weight=len(feed["x"]))
        acc_j.update(value=j[0], weight=len(feed["x"]))
        hits += int((p[1].argmax(-1) == feed["label"][:, 0]).sum())
        n += len(feed["x"])
    assert abs(acc_p.eval() - acc_j.eval()) < 1e-6
    assert abs(acc_p.eval() - hits / n) < 1e-6


def test_evaluator_accuracy_wraps_the_metric():
    def build(fl, predict, label):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            ev = fl.evaluator.Accuracy(input=predict, label=label)
        assert any(issubclass(x.category, DeprecationWarning) for x in w)
        return ev

    progs = _same_program(build)
    jev, pev = progs[0][2], progs[1][2]
    with pytest.raises(RuntimeError):
        pev.eval()
    for (j, p), feed in zip(_run_both(progs, lambda ev: ev.metrics),
                            _batches()):
        pev.update(p[0], len(feed["x"]))
        jev.update(j[0], len(feed["x"]))
    assert abs(pev.eval() - jev.eval()) < 1e-6
    pev.reset()
    with pytest.raises(RuntimeError):
        pev.eval()


@pytest.mark.parametrize("name", ("ChunkEvaluator", "EditDistance"))
def test_evaluator_wrappers_delegate(name):
    from paddle_tpu.fluid import evaluator as jev

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        a, b = getattr(fluid.evaluator, name)(), getattr(jev, name)()
    assert sum(issubclass(x.category, DeprecationWarning) for x in w) == 2
    ups = ([(np.array([5]), np.array([6]), np.array([4]))] * 2
           if name == "ChunkEvaluator"
           else [(np.array([[0.0], [2.0], [1.0]]), 3)] * 2)
    for u in ups:
        a.update(*u)
        b.update(*u)
    _same(a.eval(), b.eval())
    assert sorted(fluid.evaluator.__all__) == sorted(jev.__all__)


def test_detection_map_streams_on_the_port():
    """tests/test_rcnn_detection.py's DetectionMAP test, run as it is with
    its fluid bound to the port's."""
    reference_tests("test_rcnn_detection").test_metrics_detection_map_streams()


def _input_layers(fl):
    ids = fl.data(name="ids", shape=[None, 1], dtype="int64")
    seq = fl.data(name="seq", shape=[None, 3], dtype="int64")
    outs = [fl.one_hot(ids, depth=6), fl.one_hot(seq, depth=6),
            fl.embedding(ids, size=[6, 4]),
            fl.embedding(seq, size=[6, 4], padding_idx=2,
                         param_attr=fl.ParamAttr(name="emb_w")),
            fl.embedding(seq, size=[6, 4], padding_idx=-1),
            fl.layers.one_hot(ids, depth=6),
            fl.layers.embedding(ids, size=[6, 4])]
    return outs


def test_fluid_input_layers_match_jax_package():
    """The v2 layers keep a trailing id dim of 1 ((B, 1) ids give (B, 1,
    depth)), where layers.one_hot and layers.embedding drop it."""
    res = []
    feed = {"ids": np.array([[0], [5], [3], [2]], np.int64),
            "seq": np.array([[1, 2, 5], [2, 0, 0], [4, 4, 3], [5, 2, 1]],
                            np.int64)}
    for fl, un in ((jfluid, jax_unique_name), (fluid, pt_unique_name)):
        un.switch()
        main, start = fl.Program(), fl.Program()
        start.random_seed = 2
        with fl.program_guard(main, start):
            outs = _input_layers(fl)
        exe, scope = fl.Executor(fl.CPUPlace()), fl.Scope()
        exe.run(start, scope=scope)
        if fl is jfluid:
            params = {p.name: np.array(scope[p.name])
                      for p in main.all_parameters()}
        else:
            for n, v in params.items():
                scope.set(n, torch.from_numpy(v))
        got = exe.run(main, feed=feed, scope=scope, fetch_list=outs)
        res.append((main, start, [o.shape for o in outs],
                    [np.asarray(g) for g in got]))
    (jm, js, jsh, jv), (pm, ps, psh, pv) = res
    assert json.loads(pm.to_json()) == json.loads(jm.to_json())
    assert json.loads(ps.to_json()) == json.loads(js.to_json())
    assert psh == jsh
    assert [v.shape for v in pv] == [(4, 1, 6), (4, 3, 6), (4, 1, 4),
                                     (4, 3, 4), (4, 3, 4), (4, 6), (4, 4)]
    for a, w in zip(pv, jv):
        np.testing.assert_array_equal(a, w)
    assert not pv[3][1, 0].any() and pv[3][0, 0].any()     # padding_idx 2
