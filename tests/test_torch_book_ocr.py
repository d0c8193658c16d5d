"""The CRNN-CTC text recogniser (PaddlePaddle/models,
PaddleCV/ocr_recognition/crnn_ctc_model.py; paddle_tpu_torch/models/
crnn_ctc.py) in the port against the JAX package, on the CPU.

The model file is built by both packages: the port's module as it is,
and the same file loaded afresh with its ``fluid`` bound to the JAX
package's. Two adaptations to the padded convention, in both: the
``im2sequence`` rows are reshaped to (B, T, C·h) for the fcs, and the
label is an int32 (B, L) batch padded with the blank plus a
``label_length`` feed.

- Reduced size ((1, 48, 64) images, so T = 8; GRU hidden 16; 11 classes;
  batch 4; labels of 2-6 ids): the same Program JSON, startup and the
  cloned inference program included; 5 Momentum steps from the JAX
  startup's values carried over by ``params_from_numpy``: every loss
  within 1e-5 relative, the first step's gradient of every parameter
  within 1e-4 of its largest JAX gradient (the conv biases, whose sum
  goes straight into a batch norm, have an exact gradient of 0: both
  packages' within 1e-4 of the largest gradient of any parameter); then
  the greedy paths, their lengths and the edit distances of the
  ``ctc_infer`` program on the trained JAX parameters equal.
- The published width ((1, 48, 512), hidden 200, 95 classes, labels up to
  24): the same Program JSON for the training, inference-clone and
  ``ctc_infer`` programs. The published width trains and serves on the
  card (chip_smoke.py phase 19).
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.models import crnn_ctc
from test_torch_book_vision_rec import (_biases_under_batch_norm,  # noqa
                                        _fresh_port_state)

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEPS = 5
SMALL = dict(image_shape=(1, 48, 64), num_classes=11, rnn_hidden=16,
             batch=4, min_label=2, max_label=6)


def _on_jax():
    """crnn_ctc.py loaded afresh with its fluid the JAX package's."""
    spec = importlib.util.spec_from_file_location(
        "paddle_tpu_torch.models._crnn_ctc_on_jax",
        os.path.abspath(crnn_ctc.__file__))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.fluid = jfluid
    return mod


def _build(fl, un, mod, fn, cfg, seed=3):
    un.switch()
    main, start = fl.Program(), fl.Program()
    start.random_seed = seed
    with fl.program_guard(main, start):
        vs = getattr(mod, fn)(mod.CRNNConfig(**cfg))
    return main, start, vs


def _both(fn, cfg):
    j = _build(jfluid, jax_unique_name, _on_jax(), fn, cfg)
    p = _build(fluid, pt_unique_name, crnn_ctc, fn, cfg)
    for a, b in ((p[0], j[0]), (p[1], j[1])):
        assert json.loads(a.to_json()) == json.loads(b.to_json())
    if "inference_program" in j[2]:
        assert json.loads(p[2]["inference_program"].to_json()) == \
            json.loads(j[2]["inference_program"].to_json())
    return j, p


def _feed(cfg, step):
    c = crnn_ctc.CRNNConfig(**cfg)
    return crnn_ctc.synthetic_batch(c, c.batch,
                                    np.random.default_rng(100 + step))


def _port_scope(jscope, start):
    persist = [v.name for v in start.global_block().vars.values()
               if v.persistable]
    scope = fluid.Scope()
    for n, t in params_from_numpy({n: np.array(jscope[n]) for n in persist},
                                  torch.device("cpu")).items():
        scope.set(n, t)
    return scope


def test_reduced_crnn_trains_and_decodes_like_the_jax_package():
    (jmain, jstart, jvs), (pmain, _, pvs) = _both("ctc_train_net", SMALL)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    scope = _port_scope(jscope, jstart)
    exe = fluid.Executor(fluid.CPUPlace())
    params = sorted(p.name for p in pmain.all_parameters() if p.trainable)
    grads = [p + "@GRAD" for p in params]
    zero = _biases_under_batch_norm(pmain)
    assert len(zero) == 8
    losses = []
    for step in range(STEPS):
        feed = _feed(SMALL, step)
        fetch = grads if step == 0 else []
        jout = jexe.run(jmain, feed=feed, scope=jscope,
                        fetch_list=[jvs["loss"]] + fetch)
        pout = exe.run(pmain, feed=feed, scope=scope,
                       fetch_list=[pvs["loss"]] + fetch)
        jl, pl = float(np.asarray(jout[0])), float(pout[0])
        assert np.isfinite(pl) and abs(pl - jl) <= LOSS_TOL * abs(jl), (
            step, pl, jl)
        losses.append(pl)
        if not fetch:
            continue
        largest = max(float(np.abs(np.asarray(w)).max()) for w in jout[1:])
        for name, a, w in zip(params, pout[1:], jout[1:]):
            w = np.asarray(w)
            assert a.shape == w.shape and np.isfinite(a).all(), name
            if name in zero:
                assert max(float(np.abs(a).max()), float(np.abs(w).max())) \
                    <= GRAD_TOL * largest, name
                continue
            assert float(np.abs(a - w).max()) <= GRAD_TOL * max(
                float(np.abs(w).max()), 1e-30), name
    assert len(losses) == STEPS

    # ctc_infer on the trained JAX parameters
    (jim, _, jivs), (pim, _, pivs) = _both("ctc_infer", SMALL)
    iscope = _port_scope(jscope, jstart)
    feed = _feed(SMALL, 99)
    names = ("decoded", "out_len", "distance")
    jres = jexe.run(jim, feed=feed, scope=jscope,
                    fetch_list=[jivs[k] for k in names])
    pres = exe.run(pim, feed=feed, scope=iscope,
                   fetch_list=[pivs[k] for k in names])
    for k, a, w in zip(names, pres, jres):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(w), k)


@pytest.mark.parametrize("fn", ["ctc_train_net", "ctc_infer"])
def test_published_width_builds_the_same_programs(fn):
    j, p = _both(fn, {})
    cfg = crnn_ctc.CRNNConfig()
    assert cfg.steps == 64
    assert tuple(p[2]["fc_out"].shape) == (-1, 64, 96)
    assert tuple(j[2]["fc_out"].shape) == (-1, 64, 96)
    seq = [op for op in p[0].global_block().ops if op.type == "im2sequence"]
    assert seq[0].attrs["kernels"] == [6, 1]


def test_synthetic_batch_has_the_published_schema():
    cfg = crnn_ctc.CRNNConfig()
    assert cfg.batch == 32
    feed = crnn_ctc.synthetic_batch(cfg, cfg.batch, np.random.default_rng(0))
    assert feed["pixel"].shape == (32, 1, 48, 512)
    assert feed["pixel"].dtype == np.float32
    assert feed["label"].shape == (32, 24) and feed["label"].dtype == np.int32
    n = feed["label_length"]
    assert n.min() >= 4 and n.max() <= 24
    for row, k in zip(feed["label"], n):
        assert (row[:k] < 95).all() and (row[k:] == 95).all()
