"""``fluid.profiler`` of the port (on torch.profiler) against the JAX
package's (on jax.profiler), on the CPU.

- One start/stop session in each package leaves the same event kinds,
  counter names and histogram names in its hub; a failed start warns
  the same way and leaves the same state and counter in both.
- ``profile_op_stats`` gives the same op-type keys and call counts on the
  same training program (fc + SGD, a ``backward`` op included), and every
  row's keys.
- ``profiler()`` around a run writes a Chrome trace (JSON with
  ``traceEvents``) under the requested path, which it creates.
- An uncreatable ``profile_path`` falls back to the default directory
  with the same warning in both packages.
"""
import json
import os
import re
import warnings

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu import observability as jobs
from paddle_tpu.fluid import profiler as jprof
from paddle_tpu.fluid import unique_name as jax_unique_name
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import profiler as pprof
from paddle_tpu_torch.fluid import unique_name as pt_unique_name


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, name generator and scope of the port, and
    both packages' hubs."""
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


def _names(hub):
    """The profiler's counter, histogram and event names in `hub` (other
    threads of the process may write their own meanwhile)."""
    snap = hub.snapshot()
    return (sorted(n for n in snap["counters"] if n.startswith("profiler.")),
            sorted(n for n in snap["histograms"]
                   if n.startswith("profiler.")),
            sorted(ev["kind"] for ev in hub.get_recorder().events
                   if ev.get("source") == "profiler"))


def test_session_names_match(tmp_path):
    got = {}
    for name, prof, hub in (("jax", jprof, jobs), ("port", pprof, obs)):
        target = str(tmp_path / name / "not" / "yet" / "there")
        prof.start_profiler("All", profile_path=target)
        try:
            assert os.path.isdir(target)
        finally:
            prof.stop_profiler(profile_path=target)
        assert prof._trace_dir is None and prof._start_time is None
        got[name] = _names(hub)
    assert got["port"] == got["jax"]
    counters, hists, kinds = got["port"]
    assert "profiler.trace_start" in counters
    assert "profiler.trace_stop" in counters
    assert hists == ["profiler.trace_seconds"]
    assert kinds == ["trace_start", "trace_stop"]


def test_start_failure_is_loud_and_consistent(monkeypatch, tmp_path):
    import jax
    import torch.profiler

    def _boom(*args, **kwargs):
        raise RuntimeError("profiler backend unavailable")

    monkeypatch.setattr(jax.profiler, "start_trace", _boom)
    monkeypatch.setattr(torch.profiler, "profile", _boom)
    got = {}
    for name, prof, hub in (("jax", jprof, jobs), ("port", pprof, obs)):
        with pytest.warns(UserWarning, match="start_trace") as rec:
            prof.start_profiler("All", profile_path=str(tmp_path / name))
        assert prof._trace_dir is None and prof._start_time is None
        prof.stop_profiler()    # after a failed start: a clean no-op
        msg = str(rec[0].message).replace(str(tmp_path / name), "<path>")
        got[name] = (_names(hub), hub.counter("profiler.trace_error"),
                     re.sub(r"jax\.profiler\.|torch\.profiler ", "", msg))
    assert got["port"] == got["jax"]
    assert got["port"][1] == 1


def test_fallback_for_an_uncreatable_path(monkeypatch, tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("not a directory")
    got = {}
    for name, prof in (("jax", jprof), ("port", pprof)):
        fallback = str(tmp_path / ("fallback_" + name))
        monkeypatch.setattr(prof, "_FALLBACK_DIR", fallback)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            prof.start_profiler("CPU", profile_path=str(blocker / "sub"))
        try:
            assert prof._trace_dir == fallback and os.path.isdir(fallback)
        finally:
            prof.stop_profiler()
        msgs = [str(w.message).replace(fallback, "<fallback>")
                for w in rec if "cannot create" in str(w.message)]
        got[name] = msgs
    assert got["port"] == got["jax"] and len(got["port"]) == 1
    assert "NotADirectoryError" in got["port"][0]


def test_trace_file_written(tmp_path):
    x = fluid.data("x", [None, 4], dtype="float32")
    loss = fluid.layers.reduce_mean(fluid.layers.fc(x, size=2))
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    path = str(tmp_path / "trace")
    with fluid.profiler.profiler("All", profile_path=path):
        exe.run(feed={"x": np.ones((2, 4), np.float32)}, fetch_list=[loss])
    names = os.listdir(path)
    assert len(names) == 1 and names[0].endswith(".pt.trace.json")
    with open(os.path.join(path, names[0])) as f:
        doc = json.load(f)
    names = {ev.get("name") for ev in doc["traceEvents"]}
    assert "aten::mm" in names or "aten::addmm" in names


def _stats_program(pkg, un):
    un.switch()
    main, startup = pkg.Program(), pkg.Program()
    startup.random_seed = 3
    with pkg.program_guard(main, startup):
        x = pkg.data("x", [None, 8], dtype="float32")
        h = pkg.layers.fc(x, size=8, act="relu")
        loss = pkg.layers.reduce_mean(pkg.layers.fc(h, size=1))
        pkg.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup


def test_profile_op_stats_keys_and_calls():
    feed = {"x": np.random.default_rng(0).uniform(
        -1, 1, (4, 8)).astype(np.float32)}
    got = {}
    for name, pkg, un, kw in (
            ("jax", jfluid, jax_unique_name, {}),
            ("port", fluid, pt_unique_name, {"place": fluid.CPUPlace()})):
        main, startup = _stats_program(pkg, un)
        scope = pkg.Scope()
        pkg.Executor(pkg.CPUPlace()).run(startup, scope=scope)
        before = {n: np.array(scope.find_value(n)) for n in scope.keys()}
        stats = pkg.profiler.profile_op_stats(
            main, feed=feed, scope=scope, steps=2, warmup=1,
            print_table=False, **kw)
        for n, v in before.items():     # nothing written back
            np.testing.assert_array_equal(np.array(scope.find_value(n)), v)
        got[name] = {t: s["calls"] for t, s in stats.items()}
        assert all(set(s) == {"calls", "total", "min", "max", "avg",
                              "ratio"} for s in stats.values())
        assert abs(sum(s["ratio"] for s in stats.values()) - 1.0) < 1e-9
    assert got["port"] == got["jax"]
    assert got["port"]["backward"] == 2 and got["port"]["sgd"] == 8
