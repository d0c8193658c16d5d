"""The port's serving front door on the CPU, against the JAX package:
``AnalysisConfig``/``create_paddle_predictor``, ``ModelRegistry`` and the
HTTP server.

- One saved bert_tiny (seq 16, saved by the JAX package) sits behind the
  JAX ``ServingServer`` and behind the port's (on ``CPUPlace()``). The same
  JSON requests must get the same statuses, headers and bodies: 200 (the
  logits at rtol/atol 1e-4, as tests/test_torch_serving.py holds them),
  400 (bad JSON, missing or wrong feeds, the wrong engine kind), 404, 429
  with ``Retry-After``, 503 after ``stop`` and 504 (a deadline already
  past, a wait of 0 s on an engine not started). ``/healthz`` has the same
  keys and ``/metrics`` the same ``serving`` metric names after the same
  traffic. Every status is decided without a race.
- A gpt_tiny ``DecodeEngine`` in each package, built from the same
  JAX-trained parameters (tests/test_torch_decode_serving.py's fixture),
  is published behind each server: the same prompts stream the same token
  ids and the same ``done`` line, streamed and not; the same malformed
  requests get the same statuses; a client that hangs up frees its slot.
- The registry mirrors tests/test_serving.py's: isolation of two models,
  a hot reload under traffic, a failed reload that leaves the old version
  serving.
- The CLI (``python -m paddle_tpu_torch.serving.http``) exits as the JAX
  one does for ``--help`` and for bad arguments.

Every blocking wait has a timeout.
"""
import json
import re
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import observability as jobs
from paddle_tpu import serving as jserving
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.fluid.inference import AnalysisConfig as JaxAnalysisConfig
from paddle_tpu.fluid.inference import \
    create_paddle_predictor as jax_create_paddle_predictor
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.observability import distributed as jdist
from paddle_tpu.serving import http as jhttp
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability import distributed as pdist
from paddle_tpu_torch.serving import registry as registry_mod

SEQ = 16
VOCAB, MAX_LEN = 97, 256
WAIT = 60.0          # seconds: the bound of every blocking wait
REPO = __file__.rsplit("/tests/", 1)[0]
ENV = ("PADDLE_TPU_TELEMETRY", "PADDLE_TPU_PROM_STYLE",
       "PADDLE_TPU_TRACE_DIR", "PADDLE_TPU_TRACE_SAMPLE",
       "PADDLE_TPU_TRACE_PROC")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Both packages' hubs empty, the trace switches unset, both stride
    samplers at their first request; fresh default programs, name
    generator and scope of the port."""
    for name in ENV:
        monkeypatch.delenv(name, raising=False)
    for mod in (jobs, obs):
        mod.reset()
    for dist in (jdist, pdist):
        monkeypatch.setattr(dist, "_sample_n", 0)
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
    for mod in (jobs, obs):
        mod.reset()


def _ids(rows, seed=0):
    return np.random.default_rng(seed).integers(
        0, 1024, size=(rows, SEQ)).astype(np.int64)


def _request(url, body=None, headers=None, method=None, timeout=WAIT):
    """(status, headers, body bytes) of one request; HTTP errors are
    answers here, not exceptions."""
    if isinstance(body, (dict, list)):
        body = json.dumps(body).encode()
    req = urllib.request.Request(
        url, data=body, method=method,
        headers=dict({"Content-Type": "application/json"},
                     **(headers or {})))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.headers, e.read()


def _both(srv, path, body=None, **kw):
    return (_request(srv["jax"].url + path, body, **kw),
            _request(srv["port"].url + path, body, **kw))


def _close_outputs(jdoc, pdoc):
    assert len(pdoc["outputs"]) == len(jdoc["outputs"])
    for j, p in zip(jdoc["outputs"], pdoc["outputs"]):
        assert (p["shape"], p["dtype"]) == (j["shape"], j["dtype"])
        np.testing.assert_allclose(np.asarray(p["data"], np.float32),
                                   np.asarray(j["data"], np.float32),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the same saved bert_tiny behind both servers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bert_dir(tmp_path_factory):
    """bert_tiny at seq 16, pruned to its logits, saved by the JAX
    package (startup seed 5)."""
    d = tmp_path_factory.mktemp("bert")
    main, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = 5
    with jfluid.program_guard(main, startup), jax_unique_name.guard():
        io = jbert.build_bert_pretrain(jbert.bert_tiny(SEQ), SEQ,
                                       is_test=True)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        jfluid.io.save_inference_model(str(d), ["input_ids"],
                                       [io["logits"]], exe,
                                       main_program=main)
    return str(d)


def _bucket(mod):
    return [mod.BucketSpec({"input_ids": (SEQ,)},
                           dtypes={"input_ids": "int64"},
                           batch_sizes=(1, 2, 4))]


@pytest.fixture(scope="module")
def srv(bert_dir):
    """Both servers, each with "bert" loaded from the same directory."""
    jreg = jserving.ModelRegistry(max_wait_ms=1.0)
    jreg.load("bert", bert_dir, buckets=_bucket(jserving))
    preg = serving.ModelRegistry(max_wait_ms=1.0)
    preg.load("bert", bert_dir, buckets=_bucket(serving),
              predictor_opts={"place": fluid.CPUPlace()})
    servers = {"jax": jserving.ServingServer(jreg).start(),
               "port": serving.ServingServer(preg).start()}
    servers["jreg"], servers["preg"] = jreg, preg
    yield servers
    servers["jax"].stop(close_registry=True)
    servers["port"].stop(close_registry=True)


_MASK_MS = re.compile(rb"after [0-9.]+ ms")

PREDICT_CASES = {
    "ok_2_rows": ("/v1/models/bert:predict",
                  {"feeds": {"input_ids": _ids(2).tolist()}}, 200),
    "ok_1_row_dtypes": ("/v1/models/bert:predict",
                        {"feeds": {"input_ids": _ids(1, 3).tolist()},
                         "dtypes": {"input_ids": "int64"}}, 200),
    "ok_3_rows_timeout": ("/v1/models/bert:predict",
                          {"feeds": {"input_ids": _ids(3, 4).tolist()},
                           "timeout_s": 30}, 200),
    "bad_json": ("/v1/models/bert:predict", b"not json", 400),
    "no_feeds": ("/v1/models/bert:predict", {"oops": 1}, 400),
    "wrong_feed": ("/v1/models/bert:predict",
                   {"feeds": {"wrong": _ids(1).tolist()}}, 400),
    "ragged_feed": ("/v1/models/bert:predict",
                    {"feeds": {"input_ids": [[1, 2], [3]]}}, 400),
    "bad_dtype": ("/v1/models/bert:predict",
                  {"feeds": {"input_ids": [[1]]},
                   "dtypes": {"input_ids": "nope"}}, 400),
    "unknown_model": ("/v1/models/nope:predict",
                      {"feeds": {"input_ids": [[1]]}}, 404),
    "bad_path": ("/v1/predict", {}, 404),
    "generate_on_predict": ("/v1/models/bert:generate", {"prompt": [1]},
                            400),
    "lookup_on_predict": ("/v1/models/bert:lookup", {"ids": [1]}, 400),
    "search_on_predict": ("/v1/models/bert:search", {"query": [[1.0]]},
                          400),
    "unknown_generate": ("/v1/models/nope:generate", {"prompt": [1]}, 404),
    "unknown_lookup": ("/v1/models/nope:lookup", {"ids": [1]}, 404),
    "past_deadline": ("/v1/models/bert:predict",
                      {"feeds": {"input_ids": _ids(1).tolist()},
                       "deadline_ms": -1000}, 504),
}


@pytest.mark.parametrize("case", sorted(PREDICT_CASES))
def test_predict_status_and_body_match_jax(srv, case):
    path, body, status = PREDICT_CASES[case]
    (jc, jh, jb), (pc, ph, pb) = _both(srv, path, body)
    assert pc == jc == status, (pb, jb)
    assert ph["Content-Type"] == jh["Content-Type"] == "application/json"
    if status == 200:
        _close_outputs(json.loads(jb), json.loads(pb))
    else:
        # the wait in a deadline message is the only number in a body
        assert _MASK_MS.sub(b"", pb) == _MASK_MS.sub(b"", jb)


def test_predict_matches_a_solo_port_predictor(srv, bert_dir):
    """A reply is the same rows through the port's own Predictor."""
    ids = _ids(2, seed=9)
    _, _, body = _request(srv["port"].url + "/v1/models/bert:predict",
                          {"feeds": {"input_ids": ids.tolist()}})
    out = json.loads(body)["outputs"][0]
    got = np.asarray(out["data"], dtype=out["dtype"]).reshape(out["shape"])
    solo = fluid.Predictor.from_model(bert_dir, place=fluid.CPUPlace())
    np.testing.assert_array_equal(got, solo.run({"input_ids": ids})[0])


def _tiny(reg, name, bert_dir, mod, **kw):
    opts = {"place": fluid.CPUPlace()} if mod is serving else {}
    return reg.load(name, bert_dir, warm=False, predictor_opts=opts, **kw)


def test_shed_429_retry_after_matches_jax(srv, bert_dir):
    """A full queue (capacity 1, engine not started) sheds with the same
    body and a ``Retry-After`` from the engine's drain rate."""
    for side, mod in (("jreg", jserving), ("preg", serving)):
        eng = _tiny(srv[side], "shed", bert_dir, mod, queue_capacity=1,
                    auto_start=False)
        eng.submit({"input_ids": _ids(1)})
        # (depth 1 + 1) / 0.5 req/s = 4 s
        eng.drain_rate = lambda: 0.5
    try:
        (jc, jh, jb), (pc, ph, pb) = _both(
            srv, "/v1/models/shed:predict",
            {"feeds": {"input_ids": _ids(1).tolist()}})
        assert pc == jc == 429
        assert ph["Retry-After"] == jh["Retry-After"] == "4"
        assert pb == jb
        doc = json.loads(pb)
        assert doc["model"] == "shed" and doc["replica"] is None
        assert doc["retry_after_s"] == 4.0 and "queue full" in doc["error"]
        assert obs.counter("serving.shed") == jobs.counter("serving.shed") \
            == 1
    finally:
        for side in ("jreg", "preg"):
            srv[side].unload("shed", drain=False)


def test_stopped_503_and_wait_timeout_504_match_jax(srv, bert_dir):
    for side, mod in (("jreg", jserving), ("preg", serving)):
        _tiny(srv[side], "stopped", bert_dir, mod).stop()
        _tiny(srv[side], "idle", bert_dir, mod, auto_start=False)
    body = {"feeds": {"input_ids": _ids(1).tolist()}}
    try:
        (jc, _, jb), (pc, _, pb) = _both(srv, "/v1/models/stopped:predict",
                                         body)
        assert pc == jc == 503 and pb == jb
        assert json.loads(pb) == {
            "error": "engine 'stopped' is draining/stopped",
            "model": "stopped"}
        (jc, _, jb), (pc, _, pb) = _both(
            srv, "/v1/models/idle:predict", dict(body, timeout_s=0))
        assert pc == jc == 504 and pb == jb
        assert json.loads(pb)["error"] == \
            "timed out waiting for model 'idle'"
    finally:
        for side in ("jreg", "preg"):
            srv[side].unload("stopped")
            srv[side].unload("idle", drain=False)


def test_healthz_has_the_same_keys(srv):
    (jc, _, jb), (pc, _, pb) = _both(srv, "/healthz", method="GET")
    assert pc == jc == 200
    jdoc, pdoc = json.loads(jb), json.loads(pb)
    assert pdoc.keys() == jdoc.keys() and pdoc["status"] == "ok"
    assert pdoc["models"].keys() == jdoc["models"].keys() == {"bert"}
    j, p = jdoc["models"]["bert"], pdoc["models"]["bert"]
    assert p.keys() == j.keys()
    assert p["stats"].keys() == j["stats"].keys()
    assert (p["kind"], p["version"], p["dirname"]) == \
        (j["kind"], j["version"], j["dirname"]) == \
        ("predict", 1, j["dirname"])
    (jc, _, _), (pc, _, pb) = _both(srv, "/nothing", method="GET")
    assert pc == jc == 404 and b"not found" in pb


def _prom_names(text, prefix="paddle_tpu_serving_"):
    return sorted(line.split()[2] for line in text.decode().splitlines()
                  if line.startswith("# TYPE " + prefix))


def test_metrics_same_names_after_same_traffic(srv):
    ok = {"feeds": {"input_ids": _ids(2).tolist()}}
    for body in (ok, {"feeds": {"input_ids": _ids(1).tolist()},
                      "deadline_ms": -1000}, ok):
        _both(srv, "/v1/models/bert:predict", body)
    (jc, jh, jb), (pc, ph, pb) = _both(srv, "/metrics", method="GET")
    assert pc == jc == 200
    assert ph["Content-Type"] == jh["Content-Type"]
    names = _prom_names(pb)
    assert names == _prom_names(jb)
    assert {"paddle_tpu_serving_request_seconds",
            "paddle_tpu_serving_padding_waste",
            "paddle_tpu_serving_queue_wait_seconds",
            "paddle_tpu_serving_deadline_miss",
            "paddle_tpu_serving_queue_depth_bert"} <= set(names)
    assert b'paddle_tpu_serving_request_seconds_bucket{le="+Inf"} 2' in pb
    # a registry of lone engines answers the fleet scope with its own hub
    (_, _, jf), (_, _, pf) = _both(srv, "/metrics?scope=fleet",
                                   method="GET")
    assert _prom_names(pf) == _prom_names(jf) == names


def test_traced_predict_exports_the_same_spans(srv, monkeypatch, tmp_path):
    names = []
    for side, o in (("jax", jobs), ("port", obs)):
        d = tmp_path / side
        monkeypatch.setenv("PADDLE_TPU_TRACE_DIR", str(d))
        parent = o.TraceContext.new()
        code, _, _ = _request(srv[side].url + "/v1/models/bert:predict",
                              {"feeds": {"input_ids": _ids(1).tolist()}},
                              headers={"traceparent": parent.to_header()})
        assert code == 200
        deadline = time.monotonic() + WAIT
        while len(o.read_spans(str(d))) < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        spans = o.read_spans(str(d))
        assert {s["trace"] for s in spans} == {parent.trace_id}
        names.append(sorted(s["name"] for s in spans))
    assert names[1] == names[0] == ["http.predict", "serving.predict"]


# ---------------------------------------------------------------------------
# AnalysisConfig / create_paddle_predictor
# ---------------------------------------------------------------------------
def test_create_paddle_predictor_on_the_cpu_matches_jax(bert_dir):
    ids = _ids(2, seed=5)
    jcfg = JaxAnalysisConfig(bert_dir)
    want = jax_create_paddle_predictor(jcfg).run({"input_ids": ids})[0]
    cfg = fluid.core.AnalysisConfig(bert_dir)
    cfg.disable_gpu()
    cfg.switch_ir_optim(True)
    cfg.enable_mkldnn()
    pred = fluid.core.create_paddle_predictor(cfg)
    assert pred.place == fluid.CPUPlace()
    got = pred.run({"input_ids": ids})[0]
    assert got.shape == want.shape == (2, SEQ, 1024)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_analysis_config_uses_the_card_unless_told(bert_dir):
    """A fresh config asks for the card (the JAX package's for the CPU:
    a difference kept on purpose); disable_gpu() is the CPU."""
    cfg = fluid.core.AnalysisConfig(bert_dir)
    assert cfg.use_gpu() and not JaxAnalysisConfig(bert_dir).use_gpu()
    assert cfg._place() == fluid.CUDAPlace(0)
    cfg.enable_use_gpu(memory_pool_init_size_mb=500, device_id=1)
    assert cfg.gpu_device_id() == 1 and cfg._place() == fluid.CUDAPlace(1)
    cfg.disable_gpu()
    assert not cfg.use_gpu() and cfg._place() == fluid.CPUPlace()
    for name, args, key, value in (
            ("switch_ir_optim", (False,), "ir_optim", False),
            ("enable_tensorrt_engine", (), "tensorrt", {}),
            ("enable_mkldnn", (), "mkldnn", True),
            ("switch_use_feed_fetch_ops", (False,), "feed_fetch_ops", False),
            ("switch_specify_input_names", (True,), "specify_input_names",
             True),
            ("set_cpu_math_library_num_threads", (4,), "cpu_threads", 4)):
        getattr(cfg, name)(*args)
        assert cfg._switches[key] == value
    assert cfg._switches.keys() == {
        "ir_optim", "tensorrt", "mkldnn", "feed_fetch_ops",
        "specify_input_names", "cpu_threads"}


def test_create_paddle_predictor_needs_a_card_unless_disabled(
        bert_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        fluid.core.create_paddle_predictor(
            fluid.core.AnalysisConfig(bert_dir))
    with pytest.raises(RuntimeError, match="CPUPlace"):
        fluid.core.create_paddle_predictor(bert_dir)
    with pytest.raises(ValueError, match="model_dir"):
        fluid.core.create_paddle_predictor(fluid.core.AnalysisConfig())
    with pytest.raises(TypeError):
        fluid.core.create_paddle_predictor(3)
    with pytest.raises(AttributeError):
        fluid.core.NoSuchThing  # noqa: B018


# ---------------------------------------------------------------------------
# the registry (tests/test_serving.py's, on the port)
# ---------------------------------------------------------------------------
def _save_fc(dirname, seed):
    """A tiny 2-layer softmax model saved by the port; weights per
    `seed`."""
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = seed
    with fluid.program_guard(main, startup):
        x = fluid.data(name="x", shape=[None, 6], dtype="float32")
        h = fluid.layers.fc(x, size=12, act="relu")
        out = fluid.layers.fc(h, size=3, act="softmax")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(str(dirname), ["x"], [out], exe,
                                  main_program=main, scope=scope)


CPU = {"predictor_opts": {"place": fluid.CPUPlace()}}
FC_BUCKETS = [serving.BucketSpec({"x": (6,)}, batch_sizes=(2, 4))]


def test_registry_multi_model_isolation(tmp_path):
    d1, d2 = tmp_path / "a", tmp_path / "b"
    _save_fc(d1, seed=7)
    _save_fc(d2, seed=11)
    reg = serving.ModelRegistry(max_wait_ms=1.0)
    reg.load("a", d1, buckets=FC_BUCKETS, **CPU)
    reg.load("b", d2, buckets=FC_BUCKETS, **CPU)
    assert reg.names() == ["a", "b"]
    xv = np.ones((2, 6), np.float32)
    oa = reg.get("a").predict({"x": xv})[0]
    ob = reg.get("b").predict({"x": xv})[0]
    assert not np.allclose(oa, ob)
    info = reg.info()
    assert info["a"]["version"] == 1 and info["a"]["stats"]["requests"] == 1
    assert info["a"]["kind"] == "predict"
    assert reg.get("missing") is None and reg.version("missing") is None
    with pytest.raises(KeyError):
        reg.reload("missing")
    with pytest.raises(KeyError):
        reg.unload("missing")
    engine_a = reg.get("a")
    reg.close()
    assert engine_a.closed and reg.names() == []
    with pytest.raises(serving.EngineClosedError):
        engine_a.submit({"x": xv})
    kinds = [e["kind"] for e in obs.get_recorder().tail()
             if e.get("source") == "serving"]
    assert kinds.count("model_load") == 2


def test_hot_reload_swaps_mid_traffic(tmp_path):
    """Traffic hammers model `m` while v2 (other weights) swaps in: no
    request errors, outputs flip from v1's to v2's, the version bumps,
    and the old engine drains."""
    d1, d2 = tmp_path / "v1", tmp_path / "v2"
    _save_fc(d1, seed=7)
    _save_fc(d2, seed=11)
    reg = serving.ModelRegistry(max_wait_ms=1.0)
    reg.load("m", d1, **CPU)
    xv = np.ones((2, 6), np.float32)
    ref1 = reg.get("m").predict({"x": xv})[0]
    old_engine = reg.get("m")
    stop = threading.Event()
    outs, errs = [], []

    def hammer():
        while not stop.is_set():
            try:
                outs.append(reg.get("m").predict({"x": xv})[0])
            except serving.EngineClosedError:
                pass  # benign: raced the swap into a draining engine
            except Exception as e:  # noqa: BLE001
                errs.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(3)]
    for t in threads:
        t.start()
    time.sleep(0.05)
    reg.reload("m", d2)
    ref2 = reg.get("m").predict({"x": xv})[0]
    time.sleep(0.1)
    stop.set()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    assert not errs, errs[:3]
    assert reg.version("m") == 2
    assert not np.allclose(ref1, ref2)
    assert all(np.array_equal(o, ref1) or np.array_equal(o, ref2)
               for o in outs), "a request saw a half-loaded model"
    deadline = time.monotonic() + WAIT
    while not old_engine.closed and time.monotonic() < deadline:
        time.sleep(0.01)
    assert old_engine.closed, "old version was not drained"
    reg.close()


def test_reload_failure_leaves_current_version_serving(
        tmp_path, monkeypatch):
    """A reload whose replacement fails to build (no such dir) or to warm
    up leaves v1 published and serving: the same engine, the same
    version, no request errors."""
    d1 = tmp_path / "v1"
    _save_fc(d1, seed=7)
    reg = serving.ModelRegistry(max_wait_ms=1.0)
    reg.load("m", d1, buckets=FC_BUCKETS, **CPU)
    v1_engine = reg.get("m")
    xv = np.ones((2, 6), np.float32)
    ref1 = v1_engine.predict({"x": xv})[0]
    stop, errs = threading.Event(), []

    def hammer():
        while not stop.is_set():
            try:
                out = reg.get("m").predict({"x": xv})[0]
                np.testing.assert_array_equal(out, ref1)
            except Exception as e:  # noqa: BLE001
                errs.append(e)
                return

    threads = [threading.Thread(target=hammer, daemon=True)
               for _ in range(2)]
    for t in threads:
        t.start()
    with pytest.raises(Exception):
        reg.reload("m", tmp_path / "no-such-dir")
    assert reg.version("m") == 1 and reg.get("m") is v1_engine

    class BoomEngine(serving.ServingEngine):
        def warmup(self):
            raise RuntimeError("seeded warmup failure")

    monkeypatch.setattr(registry_mod, "ServingEngine", BoomEngine)
    obs.reset()
    with pytest.raises(RuntimeError, match="seeded warmup failure"):
        reg.reload("m", d1)
    assert obs.get_recorder().of("model_load_failed")
    monkeypatch.undo()
    assert reg.version("m") == 1
    assert reg.get("m") is v1_engine and not v1_engine.closed
    time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    assert not errs, errs[:3]
    reg.reload("m", d1)
    assert reg.version("m") == 2
    reg.close()


def test_publish_swaps_and_unload_stops():
    class Fake:
        engine_kind = "decode"

        def __init__(self):
            self.stopped = threading.Event()

        def stop(self, drain=True):
            self.stopped.set()

        def queue_depth(self):
            return 0

        def stats(self):
            return {"requests": 0}

    reg = serving.ModelRegistry()
    a, b = Fake(), Fake()
    reg.publish("g", a)
    reg.publish("g", b)
    assert reg.get("g") is b and reg.version("g") == 2
    assert a.stopped.wait(WAIT)
    assert reg.info()["g"]["kind"] == "decode"
    with pytest.raises(ValueError, match="publish"):
        reg.reload("g")
    reg.unload("g")
    assert b.stopped.is_set() and reg.names() == []


# ---------------------------------------------------------------------------
# :generate, gpt_tiny behind both servers
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gen(tmp_path_factory):
    """tests/test_torch_decode_serving.py's model: gpt_tiny (vocab 97,
    max_len 256) trained 30 Adam steps in the JAX package (seed 7); a
    2-slot engine of each package on its parameters (cache_len 64, one
    prompt bucket of 8), published as "gpt" behind each server."""
    cfg = jgpt.gpt_tiny(vocab=VOCAB, max_len=MAX_LEN)
    main, start = jfluid.Program(), jfluid.Program()
    start.random_seed = 7
    with jfluid.program_guard(main, start), jax_unique_name.guard():
        vs = jgpt.build_gpt_lm(cfg, 16)
        jfluid.optimizer.Adam(5e-3).minimize(vs["loss"])
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(start, scope=scope)
    ids, labels = jgpt.synthetic_lm_batch(cfg, 16, 16)
    for _ in range(30):
        exe.run(main, feed={"gpt_ids": ids, "gpt_labels": labels},
                fetch_list=[vs["loss"]], scope=scope)
    params = {p.name: np.array(scope[p.name]) for p in main.all_parameters()}
    kw = dict(slots=2, cache_len=64, prompt_buckets=(8,), name="gpt")
    jeng = jserving.DecodeEngine(cfg, params, **kw)
    peng = serving.DecodeEngine(gpt.gpt_tiny(vocab=VOCAB, max_len=MAX_LEN),
                                params, place=fluid.CPUPlace(), **kw)
    jreg, preg = jserving.ModelRegistry(), serving.ModelRegistry()
    jreg.publish("gpt", jeng)
    preg.publish("gpt", peng)
    out = {"jax": jserving.ServingServer(jreg).start(),
           "port": serving.ServingServer(preg).start(),
           "jreg": jreg, "preg": preg, "params": params,
           "jeng": jeng, "peng": peng}
    yield out
    for side in ("jax", "port"):
        out[side].stop(close_registry=True)


def _prompt(n, seed=11):
    rng = np.random.default_rng(seed + n)
    return rng.integers(1, VOCAB, n).astype("int64").tolist()


def _stream(url, body, timeout=WAIT):
    """(status, token ids from the chunks, the last line) of a streamed
    :generate."""
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    toks, last = [], None
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.headers["Transfer-Encoding"] == "chunked"
        assert resp.headers["Content-Type"] == "application/jsonl"
        for i, line in enumerate(resp):
            doc = json.loads(line)
            if "token" in doc:
                assert doc["index"] == i
                toks.append(doc["token"])
            else:
                last = doc
        return resp.status, toks, last


@pytest.mark.parametrize("plen", [3, 6, 8])
def test_generate_streams_match_jax(gen, plen):
    body = {"prompt": _prompt(plen), "max_new_tokens": 7,
            "tenant": "chat", "priority": "interactive"}
    j = _stream(gen["jax"].url + "/v1/models/gpt:generate", body)
    p = _stream(gen["port"].url + "/v1/models/gpt:generate", body)
    assert p == j
    status, toks, done = p
    assert status == 200 and len(toks) == 7
    assert done == {"done": True, "finish_reason": "length",
                    "tokens": toks, "n_tokens": 7}


def test_concurrent_streams_match_jax(gen):
    """Four clients at once through the port's two slots: each stream is
    the JAX server's stream of the same prompt."""
    lens = (3, 5, 7, 8)
    want = {n: _stream(gen["jax"].url + "/v1/models/gpt:generate",
                       {"prompt": _prompt(n), "max_new_tokens": 9})[1]
            for n in lens}
    got, errors = {}, []

    def client(n):
        try:
            got[n] = _stream(gen["port"].url + "/v1/models/gpt:generate",
                             {"prompt": _prompt(n), "max_new_tokens": 9})[1]
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(n,)) for n in lens]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive()
    assert not errors, errors
    assert got == want


@pytest.mark.parametrize("max_new", [1, 5])
def test_generate_non_stream_matches_jax(gen, max_new):
    body = {"prompt": _prompt(6), "max_new_tokens": max_new,
            "stream": False, "timeout_s": 30}
    (jc, _, jb), (pc, _, pb) = _both(gen, "/v1/models/gpt:generate", body)
    assert pc == jc == 200
    assert json.loads(pb) == json.loads(jb)
    doc = json.loads(pb)
    assert doc["n_tokens"] == max_new and doc["finish_reason"] == "length"
    assert doc["model"] == "gpt" and doc["trace_id"] is None


GENERATE_CASES = {
    "empty_tenant": ({"prompt": [1, 2], "tenant": " "}, 400),
    "int_tenant": ({"prompt": [1, 2], "tenant": 5}, 400),
    "named_priority_unknown": ({"prompt": [1, 2], "priority": "urgent"},
                               400),
    "priority_out_of_range": ({"prompt": [1, 2], "priority": 7}, 400),
    "priority_bool": ({"prompt": [1, 2], "priority": True}, 400),
    "no_prompt": ({"max_new_tokens": 3}, 400),
    "prompt_too_long": ({"prompt": list(range(1, 20))}, 400),
    "token_out_of_range": ({"prompt": [1, 500]}, 400),
    "empty_prompt": ({"prompt": []}, 400),
    "zero_max_new": ({"prompt": [1, 2], "max_new_tokens": 0}, 400),
    "context_too_long": ({"prompt": [1, 2], "max_new_tokens": 64}, 400),
    "empty_session": ({"prompt": [1, 2], "session": ""}, 400),
    "past_deadline": ({"prompt": [1, 2], "deadline_ms": -1000}, 504),
    "past_deadline_no_stream": ({"prompt": [1, 2], "deadline_ms": -1000,
                                 "stream": False}, 504),
}


@pytest.mark.parametrize("case", sorted(GENERATE_CASES))
def test_generate_status_and_body_match_jax(gen, case):
    body, status = GENERATE_CASES[case]
    (jc, _, jb), (pc, _, pb) = _both(gen, "/v1/models/gpt:generate", body)
    assert pc == jc == status, (pb, jb)
    assert _MASK_MS.sub(b"", pb) == _MASK_MS.sub(b"", jb)


@pytest.mark.parametrize("path,body", [
    ("/v1/models/gpt:predict", {"feeds": {"x": [[1]]}}),
    ("/v1/models/gpt:search", {"query": [[1.0]]}),
    ("/v1/models/gpt:generate", b"{not json"),
])
def test_generate_engine_wrong_verb_matches_jax(gen, path, body):
    (jc, _, jb), (pc, _, pb) = _both(gen, path, body)
    assert pc == jc == 400 and pb == jb


def test_generate_shed_and_stopped_match_jax(gen):
    """A full decode queue (capacity 1, not started) answers 429 with
    ``Retry-After``; a stopped engine 503 with ``Retry-After``."""
    for side, mod, place in (("jreg", jserving, {}),
                             ("preg", serving,
                              {"place": fluid.CPUPlace()})):
        cfg = (jgpt if mod is jserving else gpt).gpt_tiny(
            vocab=VOCAB, max_len=MAX_LEN)
        full = mod.DecodeEngine(cfg, gen["params"], slots=1, cache_len=16,
                                prompt_buckets=(8,), name="full",
                                queue_capacity=1, auto_start=False, **place)
        full.submit([1, 2], max_new=2)
        full.drain_rate = lambda: 0.5
        gen[side].publish("full", full)
        gone = mod.DecodeEngine(cfg, gen["params"], slots=1, cache_len=16,
                                prompt_buckets=(8,), name="gone", **place)
        gone.stop()
        gen[side].publish("gone", gone)
    try:
        for stream in (True, False):
            body = {"prompt": [1, 2], "max_new_tokens": 2,
                    "stream": stream}
            (jc, jh, jb), (pc, ph, pb) = _both(
                gen, "/v1/models/full:generate", body)
            assert pc == jc == 429 and pb == jb
            assert ph["Retry-After"] == jh["Retry-After"] == "4"
            (jc, jh, jb), (pc, ph, pb) = _both(
                gen, "/v1/models/gone:generate", body)
            assert pc == jc == 503 and pb == jb
            assert ph["Retry-After"] == jh["Retry-After"] == "1"
    finally:
        for side in ("jreg", "preg"):
            gen[side].unload("full", drain=False)
            gen[side].unload("gone")


def test_generate_session_names_its_item(gen):
    """Resumable sessions come with the session tier (ROADMAP.md item
    7.4): the port's engine refuses them, and the server says why."""
    code, _, body = _request(gen["port"].url + "/v1/models/gpt:generate",
                             {"prompt": [1, 2], "session": "chat-1"})
    assert code == 500
    assert "NotImplementedError" in json.loads(body)["error"]
    assert "item 7.4" in json.loads(body)["error"]


def test_client_disconnect_frees_the_slot(gen):
    """Hanging up mid-stream cancels the request: the slot is free at the
    next dispatch iteration instead of decoding the rest to nobody."""
    eng = serving.DecodeEngine(
        gpt.gpt_tiny(vocab=VOCAB, max_len=MAX_LEN), gen["params"], slots=1,
        cache_len=256, prompt_buckets=(8,), name="gpt-disc",
        place=fluid.CPUPlace())
    gen["preg"].publish("disc", eng)
    try:
        body = json.dumps({"prompt": _prompt(4),
                           "max_new_tokens": 240}).encode()
        raw = socket.create_connection(
            (gen["port"].host, gen["port"].port), timeout=WAIT)
        raw.sendall(b"POST /v1/models/disc:generate HTTP/1.1\r\n"
                    b"Host: t\r\nContent-Type: application/json\r\n"
                    b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
        assert raw.recv(1024).startswith(b"HTTP/1.1 200")
        raw.close()
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            st = eng.stats()
            if st["cancelled"] >= 1 and st["live_slots"] == 0:
                break
            time.sleep(0.02)
        st = eng.stats()
        assert st["cancelled"] == 1 and st["live_slots"] == 0, st
        assert st["tokens"] < 240
        assert obs.get_recorder().of("client_disconnect")
        assert obs.counter("serving.decode.cancelled") == 1
    finally:
        gen["preg"].unload("disc", drain=False)


def test_traced_generate_spans_match_jax(gen, monkeypatch, tmp_path):
    """``"trace": true`` with a trace dir: the span file holds
    ``http.generate`` and the engine's ``decode.queue`` and
    ``decode.prefill`` spans under one trace id, in both packages."""
    names = []
    for side, o in (("jax", jobs), ("port", obs)):
        d = tmp_path / side
        monkeypatch.setenv("PADDLE_TPU_TRACE_DIR", str(d))
        _, toks, done = _stream(gen[side].url + "/v1/models/gpt:generate",
                                {"prompt": _prompt(5), "max_new_tokens": 3,
                                 "trace": True})
        assert len(toks) == 3 and len(done["trace_id"]) == 32
        # the engine exports its decode.stream span just after it ends
        # the stream: wait for it rather than race it
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline and "decode.stream" not in {
                s["name"] for s in o.read_spans(str(d))}:
            time.sleep(0.01)
        spans = o.read_spans(str(d))
        assert {s["trace"] for s in spans} == {done["trace_id"]}
        names.append(sorted(s["name"] for s in spans))
    assert names[1] == names[0]
    assert {"http.generate", "decode.queue", "decode.prefill"} <= \
        set(names[1])


def test_generate_healthz_and_metrics_match_jax(gen):
    _both(gen, "/v1/models/gpt:generate",
          {"prompt": _prompt(4), "max_new_tokens": 3, "stream": False})
    (_, _, jb), (_, _, pb) = _both(gen, "/healthz", method="GET")
    j, p = json.loads(jb)["models"]["gpt"], json.loads(pb)["models"]["gpt"]
    assert p.keys() == j.keys() and p["kind"] == j["kind"] == "decode"
    assert p["reuse"] == j["reuse"]
    (_, _, jb), (_, _, pb) = _both(gen, "/metrics", method="GET")
    names = _prom_names(pb)
    assert names == _prom_names(jb)
    assert "paddle_tpu_serving_decode_slot_utilization_gpt" in names


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("argv", [
    ["--help"], [], ["--model", "no-equals-sign"], ["--model", "=dir"],
    ["--model", "m=d", "--port", "eighty"]])
def test_cli_exit_code_matches_jax(argv):
    with pytest.raises(SystemExit) as e:
        jhttp.main(argv)
    want = e.value.code
    r = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.serving.http"] + argv,
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == want, r.stderr
    if argv == ["--help"]:
        assert want == 0 and "NAME=DIR" in r.stdout
        assert "paddle_tpu_torch.serving.http" in r.stdout
    else:
        assert want == 2 and "error" in r.stderr
