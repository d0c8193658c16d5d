"""The port's telemetry and tracing hub on the CPU, against the JAX
package's.

The same scripted session (counters, gauges, fixed histogram values,
events, spans, ``PADDLE_TPU_TELEMETRY=off``) goes through
``paddle_tpu.observability`` and ``paddle_tpu_torch.observability``; both
hubs must hold the same snapshot and render the same Prometheus text,
leaving out span timings and timestamps. Trace contexts, the stride
sampler, the flight recorder's ring and crash dump, span export and
collection, fleet federation and SLO burn rates, and the tenancy
priorities are held the same way. Then each package's ``ServingEngine``
(an fc model) and ``DecodeEngine`` (gpt_tiny) serve the same scripted
load on the CPU, and must report the same set of ``serving.*`` metric
names and ``serving`` event kinds. Every blocking wait has a timeout.
"""
import json
import os
import re

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import observability as jobs
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.fluid.inference import Predictor as JaxPredictor
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import distributed as jdist
from paddle_tpu.observability import recorder as jrecorder
from paddle_tpu.serving import BucketSpec as JaxBucketSpec
from paddle_tpu.serving import DecodeEngine as JaxDecodeEngine
from paddle_tpu.serving import ServingEngine as JaxServingEngine
from paddle_tpu.serving.disagg import tenancy as jtenancy
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.fluid.inference import Predictor
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability import distributed as pdist
from paddle_tpu_torch.observability import recorder as precorder
from paddle_tpu_torch.serving import BucketSpec, DecodeEngine, ServingEngine
from paddle_tpu_torch.serving.disagg import tenancy as ptenancy

WAIT = 60.0          # seconds: the bound of every blocking wait
ENV = ("PADDLE_TPU_TELEMETRY", "PADDLE_TPU_PROM_STYLE",
       "PADDLE_TPU_TRACE_DIR", "PADDLE_TPU_TRACE_SAMPLE",
       "PADDLE_TPU_TRACE_PROC", "PADDLE_TPU_CRASH_DUMP")


@pytest.fixture(autouse=True)
def _fresh_hubs(monkeypatch):
    """Both packages' hubs and event rings empty, the telemetry and trace
    switches unset, and both stride samplers at their first request."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for mod in (jobs, obs):
        mod.reset()
    for dist in (jdist, pdist):
        monkeypatch.setattr(dist, "_sample_n", 0)
        monkeypatch.setattr(dist, "_proc_label", None)
    yield
    for mod in (jobs, obs):
        mod.reset()


# ---------------------------------------------------------------------------
# the hub
# ---------------------------------------------------------------------------
def _session(o, monkeypatch):
    """One scripted session through a package's facade."""
    o.inc("executor.cache_hit")
    o.inc("executor.cache_hit", 4)
    o.inc("serving.shed", 2)
    o.set_gauge("serving.queue_depth.bert", 3)
    o.set_gauge("serving.queue_depth.bert", 2.5)
    o.set_gauge("serving.decode.slot_utilization.gpt", 0.125)
    for v in (0.0004, 0.001, 0.003, 0.2, 7.0, 100.0, 0.05, 0.05):
        o.observe("serving.request_seconds", v)
    o.observe("serving.padding_waste", 0.25)
    o.event("shed", source="serving", model="bert", rows=2)
    o.event("warmup", source="serving", count=False, model="bert",
            engines=4)
    o.event("plain", detail="x")
    with o.span("outer", phase=1):
        with o.span("inner"):
            pass
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY", "off")
    o.inc("executor.cache_hit", 100)
    o.set_gauge("serving.queue_depth.bert", 99)
    o.observe("serving.request_seconds", 1.0)
    assert o.event("shed", source="serving") is None
    with o.span("off_span"):
        pass
    assert not o.enabled() and not o.trace_enabled()
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY", "trace")
    assert o.enabled() and o.trace_enabled()
    with o.span("traced", step=3):
        pass
    monkeypatch.delenv("PADDLE_TPU_TELEMETRY")


def _events(o):
    """The ring's events without their clocks (and a span's seconds)."""
    out = []
    for ev in o.get_recorder().tail():
        ev = {k: v for k, v in ev.items()
              if k not in ("seq", "ts", "wall", "seconds")}
        out.append(ev)
    return out


def _without_span_times(snap):
    snap = json.loads(json.dumps(snap))
    for name, h in snap["histograms"].items():
        if name.startswith("span."):
            snap["histograms"][name] = {"count": h["count"]}
    return snap


def _prom_without_span_values(text):
    return [line for line in text.splitlines()
            if not line.startswith("paddle_tpu_span_")]


@pytest.mark.parametrize("style", ["histogram", "summary"])
def test_hub_session_matches_jax(monkeypatch, style):
    _session(jobs, monkeypatch)
    _session(obs, monkeypatch)
    jsnap, psnap = jobs.snapshot(), obs.snapshot()
    assert psnap["counters"]["executor.cache_hit"] == 5
    assert _without_span_times(psnap) == _without_span_times(jsnap)
    assert set(psnap["histograms"]) >= {
        "span.outer.seconds", "span.inner.seconds", "span.traced.seconds"}
    assert "span.off_span.seconds" not in psnap["histograms"]
    jprom, pprom = jobs.render_prom(style), obs.render_prom(style)
    assert _prom_without_span_values(pprom) == \
        _prom_without_span_values(jprom)
    assert "paddle_tpu_serving_request_seconds" in pprom
    monkeypatch.setenv("PADDLE_TPU_PROM_STYLE", style)
    assert _prom_without_span_values(obs.render_prom()) == \
        _prom_without_span_values(pprom)
    assert _events(obs) == _events(jobs)
    assert [e["kind"] for e in _events(obs)] == [
        "shed", "warmup", "plain", "span"]
    for name in ("executor.cache_hit", "serving.nothing"):
        assert obs.counter(name) == jobs.counter(name)
    for name in ("serving.queue_depth.bert", "none"):
        assert obs.gauge(name) == jobs.gauge(name)
    for name in ("serving.request_seconds", "none"):
        assert obs.histogram(name) == jobs.histogram(name)


@pytest.mark.parametrize("value", [
    None, "off", "0", "false", " NO ", "none", "disabled", "on", "1",
    "trace", "TRACE", "bogus", ""])
def test_mode_parse_matches_jax(monkeypatch, value):
    if value is not None:
        monkeypatch.setenv("PADDLE_TPU_TELEMETRY", value)
    assert obs.mode() == jobs.mode()
    assert obs.enabled() == jobs.enabled()
    assert obs.snapshot()["mode"] == jobs.snapshot()["mode"]


def test_histogram_buckets_and_federation_match_jax():
    assert obs.telemetry.DEFAULT_BUCKETS == jobs.telemetry.DEFAULT_BUCKETS
    hubs = []
    for o in (jobs, obs):
        hub = o.Telemetry(reservoir_cap=4)
        for v in (0.002, 0.5, 3.0, 70.0, 0.02):
            hub.observe("serving.request_seconds", v)
        hub.inc("serving.requests", 5)
        hub.set_gauge("other.gauge", 1.5)
        hubs.append(hub)
    jdoc = hubs[0].federation_doc(reservoir_cap=2, prefix="serving.")
    pdoc = hubs[1].federation_doc(reservoir_cap=2, prefix="serving.")
    assert pdoc == jdoc and "other.gauge" not in pdoc["gauges"]
    assert hubs[1].reservoir("serving.request_seconds") == [
        0.5, 3.0, 70.0, 0.02]
    merged = [o.Histogram.from_docs([jdoc["histograms"][
        "serving.request_seconds"]] * 2, cap=8).summary()
        for o in (jobs, obs)]
    assert merged[1] == merged[0] and merged[1]["count"] == 10


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("header", [
    "00-%s-%s-01" % ("ab" * 16, "cd" * 8),
    "00-%s-%s-00" % ("ab" * 16, "cd" * 8),
    " 00-%s-%s-03 " % ("0f" * 16, "12" * 8),
    "00-%s-%s-01" % ("ab" * 15, "cd" * 8),       # short trace id
    "00-%s-%s-01" % ("zz" * 16, "cd" * 8),       # not hex
    "00-%s-%s" % ("ab" * 16, "cd" * 8),          # three parts
    "00-%s-%s-xy" % ("ab" * 16, "cd" * 8),       # bad flags
    "", None, 7])
def test_trace_context_header_matches_jax(header):
    j = jobs.TraceContext.from_header(header)
    p = obs.TraceContext.from_header(header)
    assert (p is None) == (j is None)
    if p is not None:
        assert (p.trace_id, p.span_id, p.sampled, p.parent) == \
            (j.trace_id, j.span_id, j.sampled, j.parent)
        assert p.to_header() == j.to_header()
        assert p.to_doc() == j.to_doc()
        q = obs.TraceContext.from_doc(j.to_doc())
        assert q.to_header() == p.to_header()
        child = p.child()
        assert child.trace_id == p.trace_id
        assert child.parent == p.span_id and child.span_id != p.span_id
        assert repr(p) == repr(j)


def test_trace_context_new_and_docs():
    ctx = obs.TraceContext.new()
    assert re.fullmatch(r"00-[0-9a-f]{32}-[0-9a-f]{16}-01", ctx.to_header())
    assert not obs.TraceContext.new(sampled=False).sampled
    for doc in (None, [], {}, {"trace_id": "a"}, {"span_id": "b"}):
        assert obs.TraceContext.from_doc(doc) is None
        assert jobs.TraceContext.from_doc(doc) is None


@pytest.mark.parametrize("rate", [None, "0", "0.25", "0.5", "0.3", "1",
                                  "2", "bad"])
def test_sample_request_stride_matches_jax(monkeypatch, tmp_path, rate):
    monkeypatch.setenv("PADDLE_TPU_TRACE_DIR", str(tmp_path))
    if rate is not None:
        monkeypatch.setenv("PADDLE_TPU_TRACE_SAMPLE", rate)
    jd = [jobs.sample_request() is not None for _ in range(20)]
    pd = [obs.sample_request() is not None for _ in range(20)]
    assert pd == jd
    want = {None: 0, "0": 0, "0.25": 5, "0.5": 10, "0.3": 6, "1": 20,
            "2": 20, "bad": 0}[rate]
    assert sum(pd) == want


def test_sample_request_needs_a_trace_dir(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_TRACE_SAMPLE", "1")
    assert obs.sample_request() is None and jobs.sample_request() is None


def _export(o, monkeypatch, d):
    monkeypatch.setenv("PADDLE_TPU_TRACE_DIR", str(d))
    monkeypatch.setenv("PADDLE_TPU_TRACE_PROC", "http")
    root = o.TraceContext("ab" * 16, "cd" * 8, True)
    child = o.TraceContext("ab" * 16, "ef" * 8, True, parent="cd" * 8)
    assert o.export_span("http.generate", root, 100.0, 0.5,
                         {"model": "gpt", "none": None})
    assert o.export_span("decode.prefill", child, 100.1, 0.2,
                         {"proc": "decode:gpt", "predicted_s": 0.1})
    assert o.export_span("decode.token", root.child(), 100.3, 0.01,
                         {"proc": "decode:gpt"})
    assert not o.export_span("x", o.TraceContext("ab" * 16, "11" * 8,
                                                 False), 0.0, 0.1)
    assert not o.export_span("x", None, 0.0, 0.1)
    with open(os.path.join(str(d), "trace-%d.jsonl" % os.getpid()),
              "a") as f:
        f.write('{"torn": \n')
    with o.span("http.request", ctx=root.child()) as sp:
        assert sp.ctx.parent is not None
    spans = o.read_spans(str(d))
    monkeypatch.delenv("PADDLE_TPU_TRACE_DIR")
    return spans


def _stable(spans):
    return sorted((s["name"], s["proc"], s.get("parent") is not None,
                   json.dumps(s.get("args"), sort_keys=True))
                  for s in spans)


def test_span_export_and_collect_match_jax(monkeypatch, tmp_path):
    jspans = _export(jobs, monkeypatch, tmp_path / "jax")
    pspans = _export(obs, monkeypatch, tmp_path / "port")
    assert _stable(pspans) == _stable(jspans)
    assert len(pspans) == 4
    assert obs.counter("trace.spans_exported") == \
        jobs.counter("trace.spans_exported") == 4
    assert obs.counter("integrity.jsonl_dropped") == \
        jobs.counter("integrity.jsonl_dropped") == 1
    fixed = [s for s in jspans if s["name"] != "http.request"]
    jdoc = jobs.chrome_trace(fixed)
    pdoc = obs.chrome_trace(fixed)
    assert pdoc == jdoc
    assert pdoc["otherData"]["flows"] == 2
    assert obs.phase_breakdown(fixed) == jobs.phase_breakdown(fixed)
    out = tmp_path / "merged.json"
    doc = obs.collect_trace(str(tmp_path / "port"), out=str(out))
    assert json.loads(out.read_text()) == doc
    assert obs.read_spans(str(tmp_path / "missing")) == []


def test_fleet_metrics_and_slo_monitor_match_jax():
    docs = {
        "decode-0": {"counters": {"requests": 3, "flag": True},
                     "gauges": {"queue_depth": 2},
                     "histograms": {"serving.disagg.per_token_seconds.chat":
                                    {"count": 2, "sum": 0.3,
                                     "buckets": [0] * 17,
                                     "reservoir": [0.1, 0.2]}}},
        "decode-1": {"counters": {"requests": 4},
                     "gauges": {"queue_depth": 5}},
    }
    outs = []
    for o, ten in ((jobs, jtenancy), (obs, ptenancy)):
        fm = o.FleetMetrics()
        fm.ingest_beacons({r: {"metrics": d} for r, d in docs.items()})
        fm.ingest("gone", {"counters": {"requests": 100}})
        fm.prune(["decode-0", "decode-1"])
        table = ten.TenantTable([ten.TenantSpec("chat", priority=0,
                                                per_token_slo_ms=150)])
        slo = o.SLOMonitor(table).tick(reservoirs={
            "serving.disagg.per_token_seconds.chat": [0.1, 0.2, 0.3]})
        merged = fm.merged()
        merged.pop("_hist_objs")
        outs.append((merged, fm.render_prom(), slo,
                     o.replica_metrics_doc({"a": 1, "b": "x"}, 3,
                                           {"g": 0.5})))
    assert outs[1] == outs[0]
    assert outs[1][0]["counters"] == {"requests": 7}
    assert obs.gauge("fleet.slo_burn_per_token.chat") == \
        jobs.gauge("fleet.slo_burn_per_token.chat")
    with pytest.raises(ValueError):
        obs.SLOMonitor(None, budget=0)


@pytest.mark.parametrize("priority", [
    None, 0, 1, 2, 3, -1, "interactive", "standard", "batch", "urgent",
    True, 1.0, "1"])
def test_resolve_priority_matches_jax(priority):
    def run(fn):
        try:
            return fn(priority, default=2)
        except ValueError as e:
            return "ValueError: %s" % e
    assert run(ptenancy.resolve_priority) == run(jtenancy.resolve_priority)


def test_tenant_table_matches_jax():
    outs = []
    for o, ten in ((jobs, jtenancy), (obs, ptenancy)):
        table = ten.TenantTable([ten.TenantSpec("chat", max_live=1)],
                                model="gpt")
        table.acquire("chat")
        with pytest.raises(Exception) as e:
            table.acquire("chat")
        table.acquire("anon")
        table.release("chat")
        table.reweight("anon", priority=9, max_live=2)
        spec = table.resolve("anon")
        outs.append((type(e.value).__name__, str(e.value), table.stats(),
                     table.live(), spec.priority, spec.max_live,
                     sorted(s.name for s in table.specs()),
                     o.snapshot()["counters"], o.snapshot()["gauges"]))
    assert outs[1] == outs[0]
    assert outs[1][0] == "ShedError"


# ---------------------------------------------------------------------------
# the flight recorder
# ---------------------------------------------------------------------------
def _ring(rec_mod, path):
    rec = rec_mod.FlightRecorder(maxlen=4)
    for i in range(6):
        rec.record("tick" if i % 2 else "tock", i=i,
                   arr=np.arange(3), big=np.zeros(100),
                   scalar=np.float32(1.5))
    sink = rec.sink("resilience")
    sink({"kind": "retry", "attempt": 2})
    rec.dump_jsonl(str(path))
    lines = [json.loads(line) for line in open(str(path))]
    strip = [{k: v for k, v in ev.items() if k not in ("ts", "wall")}
             for ev in lines]
    return (strip, [e["i"] for e in rec.of("tock")],
            [e["kind"] for e in rec.tail(2)])


def test_recorder_ring_matches_jax(tmp_path):
    j = _ring(jrecorder, tmp_path / "j.jsonl")
    p = _ring(precorder, tmp_path / "p.jsonl")
    assert p == j
    assert [e["seq"] for e in p[0]] == [3, 4, 5, 6]
    assert p[0][-1]["source"] == "resilience"
    assert p[0][0]["big"].startswith("array(")
    disabled = precorder.FlightRecorder(enabled=False)
    assert disabled.record("x") is None and not disabled.events


@pytest.mark.parametrize("value", [
    None, True, 3, 2.5, "s", [1, (2, 3)], {"a": {1: 2}}, {1, 2} - {1},
    np.int64(7), np.float32(0.5), np.arange(4), np.zeros((10, 10)),
    ValueError("boom"), object])
def test_san_matches_jax(value):
    assert precorder._san(value) == jrecorder._san(value)


def test_san_reads_torch_tensors():
    assert precorder._san(torch.tensor(2.5)) == 2.5
    assert precorder._san(torch.arange(3)) == [0, 1, 2]
    assert precorder._san(torch.zeros(100)).startswith("tensor(")


def _dump(o, rec_mod, monkeypatch, path):
    monkeypatch.setenv("PADDLE_TPU_CRASH_DUMP", str(path))
    o.event("shed", source="serving", model="m")
    o.inc("compile_cache.disk_hit", 2)
    try:
        raise RuntimeError("seeded crash")
    except RuntimeError as e:
        out = o.get_recorder().crash_dump(exc=e)
    assert out == str(path)
    doc = json.loads(path.read_text())
    # the global ring's seq runs on across the process's tests
    doc["events"] = [{k: v for k, v in ev.items()
                      if k not in ("seq", "ts", "wall")}
                     for ev in doc["events"]]
    doc["exception"].pop("traceback")
    for k in ("wall", "pid", "active_spans"):
        doc.pop(k)
    per_pid = rec_mod.crash_dump_path(per_pid=True)
    assert per_pid == str(path.with_suffix("")) + ".%d.json" % os.getpid()
    assert rec_mod.crash_dump_path(per_pid=True) == per_pid
    return doc


def test_crash_dump_matches_jax(monkeypatch, tmp_path):
    jdoc = _dump(jobs, jrecorder, monkeypatch, tmp_path / "j.json")
    pdoc = _dump(obs, precorder, monkeypatch, tmp_path / "p.json")
    # the executable ledger and run health come with ROADMAP.md item 11:
    # the port keeps their keys, empty
    jdoc["executables"], jdoc["runhealth"] = [], None
    assert pdoc == jdoc
    assert pdoc["compile_cache"]["disk_hit"] == 2
    assert pdoc["exception"] == {"type": "RuntimeError",
                                 "message": "seeded crash"}
    monkeypatch.delenv("PADDLE_TPU_CRASH_DUMP")
    assert precorder.crash_dump_path() == jrecorder.crash_dump_path()
    assert obs.get_recorder().crash_dump(
        path=str(tmp_path / "no" / "\0bad")) is None


# ---------------------------------------------------------------------------
# the engines' metric names
# ---------------------------------------------------------------------------
def _serving_names(o, source="serving", prefix="serving."):
    snap = o.snapshot()
    names = set()
    for kind in ("counters", "gauges", "histograms"):
        names |= {(kind, n) for n in snap[kind] if n.startswith(prefix)}
    kinds = sorted({ev["kind"] for ev in o.get_recorder().tail()
                    if ev.get("source") == source})
    return names, kinds


def _save_fc(dirname):
    main, start = jfluid.Program(), jfluid.Program()
    start.random_seed = 5
    with jfluid.program_guard(main, start), jax_unique_name.guard():
        x = jfluid.data(name="x", shape=[None, 6], dtype="float32")
        h = jfluid.layers.fc(x, size=12, act="relu")
        out = jfluid.layers.fc(h, size=3, act="softmax")
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(start)      # the test's own global scope (conftest)
    jfluid.io.save_inference_model(str(dirname), ["x"], [out], exe,
                                   main_program=main)


def _serving_load(engine, warmup):
    """A load with one of each outcome, decided without races: the engine
    is not started while requests queue (capacity 2), so the third sheds;
    one of the queued requests' deadlines is already past."""
    x = np.ones((2, 6), np.float32)
    warmup()
    ok = engine.submit({"x": x})
    late = engine.submit({"x": x}, deadline_ms=-1000)
    with pytest.raises(Exception) as shed:
        engine.submit({"x": x})
    engine.start()
    out = ok.result(WAIT)[0]
    with pytest.raises(Exception) as missed:
        late.result(WAIT)
    engine.stop(drain=True, timeout=WAIT)
    return out, type(shed.value).__name__, type(missed.value).__name__


def test_serving_engine_metric_names_match_jax(tmp_path):
    _save_fc(tmp_path)
    spec = dict(shapes={"x": (6,)}, batch_sizes=(2, 4))
    jeng = JaxServingEngine(JaxPredictor.from_model(str(tmp_path)),
                            buckets=[JaxBucketSpec(**spec)], name="fc",
                            queue_capacity=2, auto_start=False)
    peng = ServingEngine(
        Predictor.from_model(str(tmp_path), place=fluid.CPUPlace()),
        buckets=[BucketSpec(**spec)], name="fc", queue_capacity=2,
        auto_start=False)
    # the JAX engine's HBM admission (check_hbm_budget) comes with item 11
    jout = _serving_load(jeng, lambda: jeng.warmup(check_hbm=False))
    pout = _serving_load(peng, peng.warmup)
    np.testing.assert_allclose(pout[0], jout[0], rtol=1e-5, atol=1e-6)
    assert pout[1:] == jout[1:] == ("ShedError", "DeadlineExceededError")
    jnames, jkinds = _serving_names(jobs)
    pnames, pkinds = _serving_names(obs)
    assert pnames == jnames
    assert pkinds == jkinds
    assert ("histograms", "serving.padding_waste") in pnames
    assert ("gauges", "serving.queue_depth.fc") in pnames
    assert pkinds == ["deadline_miss", "engine_stop", "shed", "warmup"]
    assert obs.counter("serving.shed") == 1
    assert obs.counter("serving.deadline_miss") == 1


def test_serving_engine_batch_error_reported(tmp_path):
    """A dispatch that fails reports batch_error, as the JAX engine does,
    and the engine keeps serving."""
    _save_fc(tmp_path)
    pred = Predictor.from_model(str(tmp_path), place=fluid.CPUPlace())
    eng = ServingEngine(pred, name="fc", auto_start=False)
    real_run = pred.run
    pred.run = lambda *a, **k: (_ for _ in ()).throw(
        RuntimeError("seeded dispatch failure"))
    fut = eng.submit({"x": np.ones((1, 6), np.float32)})
    eng.start()
    with pytest.raises(RuntimeError, match="seeded"):
        fut.result(WAIT)
    pred.run = real_run
    assert eng.predict({"x": np.ones((1, 6), np.float32)},
                       timeout=WAIT)[0].shape == (1, 3)
    eng.stop(timeout=WAIT)
    errs = obs.get_recorder().of("batch_error")
    assert len(errs) == 1 and "seeded" in errs[0]["error"]
    assert obs.counter("serving.batch_error") == 1


def test_telemetry_off_engine_reports_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_TPU_TELEMETRY", "off")
    _save_fc(tmp_path)
    eng = ServingEngine(
        Predictor.from_model(str(tmp_path), place=fluid.CPUPlace()),
        name="fc")
    eng.predict({"x": np.ones((2, 6), np.float32)}, timeout=WAIT)
    eng.stop(timeout=WAIT)
    snap = obs.snapshot()
    assert not snap["counters"] and not snap["gauges"]
    assert not snap["histograms"] and not obs.get_recorder().tail()
    assert eng.stats()["batches"] == 1


@pytest.fixture(scope="module")
def gpt_params():
    cfg = jgpt.gpt_tiny(vocab=97, max_len=64)
    main, start = jfluid.Program(), jfluid.Program()
    start.random_seed = 7
    with jfluid.program_guard(main, start), jax_unique_name.guard():
        jgpt.build_gpt_lm(cfg, 16)
    scope = jfluid.Scope()
    jfluid.Executor(jfluid.CPUPlace()).run(start, scope=scope)
    return {p.name: np.array(scope[p.name]) for p in main.all_parameters()}


def _decode_load(eng):
    """Admission with one of each outcome (engine not started while the
    queue of 3 fills: the fourth sheds; one queued request's deadline is
    past, one is cancelled before its prefill), then a stream to its end
    and one cancelled mid-stream."""
    p = np.arange(1, 6, dtype=np.int64)
    ok = eng.submit(p, max_new=4, tenant="chat", priority=0)
    late = eng.submit(p, max_new=4, deadline_ms=-1000)
    gone = eng.submit(p, max_new=4)
    gone.cancel()
    with pytest.raises(Exception) as shed:
        eng.submit(p, max_new=4)
    eng.start()
    toks = ok.result(WAIT)
    with pytest.raises(Exception) as missed:
        late.result(WAIT)
    long = eng.submit(p, max_new=56)     # cancelled long before its end
    next(iter(long.tokens(timeout=WAIT)))
    long.cancel()
    assert long._done.wait(WAIT)
    eng.stop(drain=True, timeout=WAIT)
    return (toks, gone.finish_reason, long.finish_reason,
            type(shed.value).__name__, type(missed.value).__name__)


def test_decode_engine_metric_names_match_jax(gpt_params):
    kw = dict(slots=2, cache_len=64, prompt_buckets=(8,), name="gpt",
              queue_capacity=3, auto_start=False)
    jeng = JaxDecodeEngine(jgpt.gpt_tiny(vocab=97, max_len=64), gpt_params,
                           **kw)
    peng = DecodeEngine(gpt.gpt_tiny(vocab=97, max_len=64), gpt_params,
                        place=fluid.CPUPlace(), **kw)
    assert peng.engine_kind == jeng.engine_kind == "decode"
    jout = _decode_load(jeng)
    pout = _decode_load(peng)
    assert pout == jout
    assert pout[1:] == ("cancelled", "cancelled", "ShedError",
                        "DeadlineExceededError")
    jnames, jkinds = _serving_names(jobs)
    pnames, pkinds = _serving_names(obs)
    assert pnames == jnames
    assert pkinds == jkinds
    assert {("counters", "serving.decode.%s" % k) for k in (
        "tokens", "requests", "retired", "shed", "deadline_miss",
        "cancelled", "prefills", "steps")} <= pnames
    assert {("gauges", "serving.decode.slot_utilization.gpt"),
            ("gauges", "serving.decode.cache_occupancy.gpt"),
            ("histograms", "serving.decode.ttft_seconds"),
            ("histograms", "serving.decode.step_seconds")} <= pnames
    # how many tokens the stream cancelled mid-way got is a race: each
    # hub is held to its own engine's count
    assert obs.counter("serving.decode.tokens") == peng.stats()["tokens"]
    assert jobs.counter("serving.decode.tokens") == jeng.stats()["tokens"]
    assert obs.counter("serving.decode.cancelled") == \
        jobs.counter("serving.decode.cancelled") == 2
    assert peng.reuse_info() == jeng.reuse_info()


def test_decode_trace_spans_match_jax(gpt_params, monkeypatch, tmp_path):
    """A sampled request exports the same spans from either engine."""
    names = []
    for o, eng_cls, cfg_mod, place in (
            (jobs, JaxDecodeEngine, jgpt, {}),
            (obs, DecodeEngine, gpt, {"place": fluid.CPUPlace()})):
        d = tmp_path / cfg_mod.__name__
        monkeypatch.setenv("PADDLE_TPU_TRACE_DIR", str(d))
        eng = eng_cls(cfg_mod.gpt_tiny(vocab=97, max_len=64), gpt_params,
                      slots=1, cache_len=16, prompt_buckets=(8,),
                      name="gpt", **place)
        ctx = o.TraceContext.new()
        eng.submit(np.arange(1, 4, dtype=np.int64), max_new=3,
                   trace_ctx=ctx, tenant="chat").result(WAIT)
        eng.stop(timeout=WAIT)
        spans = o.read_spans(str(d))
        assert {s["trace"] for s in spans} == {ctx.trace_id}
        names.append(sorted(s["name"] for s in spans))
    assert names[1] == names[0]
    assert names[1] == ["decode.prefill", "decode.queue", "decode.stream",
                        "decode.token", "decode.token", "decode.token"]
