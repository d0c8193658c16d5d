"""The BERT inference slice of the port, end to end on the CPU, against
the JAX package: the same Program, saved models that move both ways, the
same logits, and the ServingEngine's coalescing contract.

Logits are compared at rtol 1e-4 / atol 1e-4 in f32: both packages run the
same f32 graph, but matmul and softmax sum in different orders.
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.inference import Predictor as JaxPredictor
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.inference import Predictor
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.serving import BucketSpec, ServingEngine

SEQ = 32
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def _ids(rows, seed=0, vocab=1024):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(rows, SEQ)).astype(np.int64)


def _build_port(is_test=True):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        io = bert.build_bert_pretrain(bert.bert_tiny(SEQ), SEQ,
                                      is_test=is_test)
    return main, startup, io


def _build_jax(is_test=True):
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        io = jbert.build_bert_pretrain(jbert.bert_tiny(SEQ), SEQ,
                                       is_test=is_test)
    return main, startup, io


def _save_jax_model(dirname):
    main, startup, io = _build_jax()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(startup)
    jfluid.io.save_inference_model(dirname, ["input_ids"], [io["logits"]],
                                   exe, main_program=main)


def _save_port_model(dirname):
    main, startup, io = _build_port()
    startup.random_seed = 5
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    fluid.io.save_inference_model(dirname, ["input_ids"], [io["logits"]],
                                  exe, main_program=main, scope=scope)
    return scope


@pytest.mark.parametrize("is_test", [True, False])
def test_bert_program_parity(is_test):
    """Same layer calls -> the same Program JSON (ops, var names, shapes,
    dtypes, attrs) in both packages, main and startup."""
    jmain, jstart, _ = _build_jax(is_test)
    pmain, pstart, _ = _build_port(is_test)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert json.loads(pstart.to_json()) == json.loads(jstart.to_json())
    ops = {op.type for op in pmain.global_block().ops}
    assert {"fused_multihead_attention", "layer_norm"} <= ops


def test_pruned_program_parity():
    jmain, _, jio = _build_jax()
    pmain, _, pio = _build_port()
    jp = jmain._prune([jio["logits"]])
    pp = pmain._prune([pio["logits"]])
    assert json.loads(pp.to_json()) == json.loads(jp.to_json())
    assert len(pp.global_block().ops) == 56


def test_jax_saved_model_served_by_port(tmp_path):
    _save_jax_model(str(tmp_path))
    ids = _ids(3)
    want, = JaxPredictor.from_model(str(tmp_path)).run({"input_ids": ids})
    pred = Predictor.from_model(str(tmp_path), place=fluid.CPUPlace())
    got, = pred.run({"input_ids": ids})
    assert got.shape == (3, SEQ, 1024) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_port_saved_model_served_by_jax(tmp_path):
    _save_port_model(str(tmp_path))
    ids = _ids(2, seed=1)
    got, = Predictor.from_model(str(tmp_path),
                                place=fluid.CPUPlace()).run(
        {"input_ids": ids})
    want, = JaxPredictor.from_model(str(tmp_path)).run({"input_ids": ids})
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_jax_scope_copied_by_name_matches(tmp_path):
    """params_from_numpy: a JAX scope copied into a port scope by name, run
    through the port's Executor on the pruned program."""
    jmain, jstart, jio = _build_jax()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart)
    jscope = jfluid.global_scope()
    ids = _ids(2, seed=2)
    jprog = jmain._prune([jio["logits"]])
    want, = jexe.run(jprog, feed={"input_ids": ids},
                     fetch_list=[jio["logits"]])
    pmain, _, pio = _build_port()
    named = {p.name: np.asarray(jscope[p.name])
             for p in pmain.all_parameters()}
    scope = fluid.Scope()
    for n, t in params_from_numpy(named, torch.device("cpu")).items():
        scope.set(n, t)
    got, = fluid.Executor(fluid.CPUPlace()).run(
        pmain._prune([pio["logits"]]), feed={"input_ids": ids},
        fetch_list=[pio["logits"]], scope=scope)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_bfloat16_policy_close_to_f32(tmp_path):
    _save_port_model(str(tmp_path))
    ids = _ids(2, seed=3)
    f32, = Predictor.from_model(str(tmp_path), place=fluid.CPUPlace()).run(
        {"input_ids": ids})
    bf16, = Predictor.from_model(str(tmp_path), place=fluid.CPUPlace(),
                                 dtype_policy="bfloat16").run(
        {"input_ids": ids})
    assert bf16.dtype == np.float32 and np.isfinite(bf16).all()
    rel = np.abs(bf16 - f32).max() / np.abs(f32).max()
    assert rel <= 5e-2, rel


def _engine(tmp_path, **kw):
    _save_port_model(str(tmp_path))
    pred = Predictor.from_model(str(tmp_path), place=fluid.CPUPlace())
    spec = BucketSpec({"input_ids": (SEQ,)}, dtypes={"input_ids": "int64"},
                      batch_sizes=(8,))
    return ServingEngine(pred, buckets=[spec], **kw), pred


def test_engine_coalesces_bit_identical(tmp_path):
    """4 concurrent submits coalesce into one dispatch; each request's
    rows are bit-identical to the same request served alone (both padded
    to the one declared bucket)."""
    engine, _ = _engine(tmp_path, max_batch_size=8, max_wait_ms=60.0,
                        auto_start=False)
    reqs = [_ids(2, seed=10 + i) for i in range(4)]
    futs = [None] * 4

    def client(i):
        futs[i] = engine.submit({"input_ids": reqs[i]})

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    engine.start()  # everything queued first -> coalescing is guaranteed
    outs = [f.result(timeout=60)[0] for f in futs]
    stats = engine.stats()
    assert stats["requests"] == 4 and stats["batches"] == 1
    assert stats["coalesced"] == 1 and stats["rows"] == 8
    for req, out in zip(reqs, outs):
        solo, = engine.predict({"input_ids": req}, timeout=60)
        assert out.shape == (2, SEQ, 1024)
        np.testing.assert_array_equal(out, solo)
    engine.stop()
    assert engine.stats()["batches"] == 5


def test_engine_sheds_and_drains(tmp_path):
    from paddle_tpu_torch.serving import EngineClosedError, ShedError

    engine, _ = _engine(tmp_path, queue_capacity=2, auto_start=False)
    ids = _ids(1)
    f1 = engine.submit({"input_ids": ids})
    f2 = engine.submit({"input_ids": ids})
    with pytest.raises(ShedError):
        engine.submit({"input_ids": ids})
    engine.start()
    engine.stop(drain=True)
    assert f1.result(timeout=30)[0].shape == (1, SEQ, 1024)
    assert f2.result(timeout=30)[0].shape == (1, SEQ, 1024)
    with pytest.raises(EngineClosedError):
        engine.submit({"input_ids": ids})
    assert engine.stats()["shed"] == 1


def test_engine_deadline_expires_in_queue(tmp_path):
    import time

    from paddle_tpu_torch.serving import DeadlineExceededError

    engine, _ = _engine(tmp_path, auto_start=False)
    late = engine.submit({"input_ids": _ids(1)}, deadline_ms=1.0)
    on_time = engine.submit({"input_ids": _ids(1, seed=1)})
    time.sleep(0.02)
    engine.start()
    with pytest.raises(DeadlineExceededError):
        late.result(timeout=30)
    assert on_time.result(timeout=30)[0].shape == (1, SEQ, 1024)
    engine.stop()
    assert engine.stats()["deadline_miss"] == 1


def test_entry_points_need_a_place_without_cuda(tmp_path, monkeypatch):
    """With no place argument and no CUDA device the entry points raise
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _save_port_model(str(tmp_path))
    with pytest.raises(RuntimeError, match="CPUPlace"):
        Predictor.from_model(str(tmp_path))
    with pytest.raises(RuntimeError, match="CPUPlace"):
        fluid.Executor()


def test_backward_op_names_the_training_slice():
    """A backward op that asks for recompute (non-empty checkpoints) is
    not ported yet and says which slice brings it."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [None, 4])
        y = fluid.layers.fc(x, 3)
    w = main.all_parameters()[0].name
    main.global_block().append_op(
        type="backward", inputs={"Loss": [y]},
        outputs={"Grads": [w + "@GRAD"]},
        attrs={"targets": [w], "checkpoints": [y.name]})
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(NotImplementedError, match="training slice"):
        exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                fetch_list=[y], scope=scope)


def test_port_imports_no_jax():
    """Importing every module of paddle_tpu_torch leaves jax and every
    paddle_tpu module out of sys.modules."""
    code = r"""
import importlib, pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k.startswith("jaxlib")
             or k == "paddle_tpu" or k.startswith("paddle_tpu."))
print(len([k for k in sys.modules if k.startswith("paddle_tpu_torch")]))
print(bad)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n_mods, bad = r.stdout.strip().splitlines()
    assert int(n_mods) >= 20
    assert bad == "[]"


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py, which runs on the card's machine, imports neither jax
    nor the JAX package (read from its source: running it needs CUDA)."""
    import ast

    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "jax" not in roots and "paddle_tpu" not in roots, roots
    assert "paddle_tpu_torch" in roots
