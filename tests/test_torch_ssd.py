"""models/ssd.py in the port against the JAX package, on the CPU.

- ``build_ssd_train`` (with ``Adam.minimize``) and ``build_ssd_infer``
  build the same Program JSON in both packages, startup included.
- Training as examples/train_ssd.py trains (``Adam(2e-3)``, startup seed
  3, ``synthetic_batch`` scenes from ``default_rng(0)``), STEPS steps in
  each package from the JAX startup's values carried into the port by
  ``params_from_numpy``: every loss within LOSS_TOL (1e-5) relative, the
  first step's gradient of every parameter within GRAD_TOL (1e-5) of its
  largest JAX gradient.
- The NMS inference program on the trained parameters gives the same
  detections in both packages: labels and row order equal up to the
  first near-tie of scores (a gap below NEAR_TIE, where f32 rounding may
  order two candidates either way), scores and boxes within DET_TOL
  (1e-5) before it.
- An SSD inference model saved by either package and served by the
  other's ``Predictor`` gives the same detections, by the same rule.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.fluid.inference import Predictor as JaxPredictor
from paddle_tpu.models import ssd as jssd
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.inference import Predictor
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.models import ssd

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
DET_TOL = 1e-5
NEAR_TIE = 1e-5
STEPS = 5
KEEP = 10


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


def _train_prog(fl, model):
    main, start = fl.Program(), fl.Program()
    start.random_seed = 3
    with fl.program_guard(main, start):
        vs = model.build_ssd_train(num_classes=4, image_size=64)
        fl.optimizer.Adam(learning_rate=2e-3).minimize(vs["loss"])
    return main, start, vs


def _infer_prog(fl, model):
    main, start = fl.Program(), fl.Program()
    with fl.program_guard(main, start):
        vs = model.build_ssd_infer(num_classes=4, image_size=64,
                                   keep_top_k=KEEP)
    return main, start, vs


def _both(build):
    jax_unique_name.switch()
    j = build(jfluid, jssd)
    pt_unique_name.switch()
    p = build(fluid, ssd)
    return j, p


def _batches(n):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        img, boxes, labels = ssd.synthetic_batch(rng)
        out.append({"image": img, "gt_box": boxes, "gt_label": labels})
    return out


def test_synthetic_batch_is_the_reference_s():
    a = ssd.synthetic_batch(np.random.default_rng(4))
    b = jssd.synthetic_batch(np.random.default_rng(4))
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("build", [_train_prog, _infer_prog],
                         ids=["train", "infer"])
def test_ssd_program_parity(build):
    (jmain, jstart, _), (pmain, pstart, _) = _both(build)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert json.loads(pstart.to_json()) == json.loads(jstart.to_json())


def _first_near_tie(scores):
    """Index of the first row whose score is within NEAR_TIE of the next
    row's (len(scores) when none is)."""
    gaps = np.abs(np.diff(scores))
    hits = np.nonzero(gaps < NEAR_TIE)[0]
    return int(hits[0]) if len(hits) else len(scores)


def assert_same_detections(got, want):
    """(N, K, 6) NMS rows: labels and order equal up to the first near-tie
    of the reference's scores; scores and boxes within DET_TOL there."""
    assert got.shape == want.shape
    for g, w in zip(got, want):
        k = _first_near_tie(w[w[:, 0] >= 0][:, 1])
        np.testing.assert_array_equal(g[:k, 0], w[:k, 0])
        assert float(np.abs(g[:k, 1:] - w[:k, 1:]).max(initial=0.0)) \
            <= DET_TOL


def _train_both():
    """STEPS steps in each package from the JAX startup's values; returns
    (parameter names, each step's (port fetches, JAX fetches): the loss,
    and at step 1 every parameter's gradient, JAX scope, port scope)."""
    (jmain, jstart, jvs), (pmain, _, pvs) = _both(_train_prog)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    # the global scope: the JAX package's save_inference_model reads it
    jscope = jfluid.global_scope()
    jexe.run(jstart, scope=jscope)
    persist = [v.name for v in jstart.global_block().vars.values()
               if v.persistable]
    scope = fluid.Scope()
    for n, t in params_from_numpy(
            {n: np.array(jscope[n]) for n in persist},
            torch.device("cpu")).items():
        scope.set(n, t)
    exe = fluid.Executor(fluid.CPUPlace())
    params = sorted(p.name for p in pmain.all_parameters())
    grads = [p + "@GRAD" for p in params]
    out = []
    for step, feed in enumerate(_batches(STEPS)):
        fetch = [pvs["loss"]] + (grads if step == 0 else [])
        jout = jexe.run(jmain, feed=feed, scope=jscope,
                        fetch_list=[jvs["loss"]] + fetch[1:])
        pout = exe.run(pmain, feed=feed, scope=scope, fetch_list=fetch)
        out.append((pout, jout))
    return params, out, jscope, scope


def test_ssd_trains_like_jax_and_detects_alike(tmp_path):
    params, out, jscope, scope = _train_both()
    losses = []
    for step, (pout, jout) in enumerate(out):
        pl, jl = float(pout[0]), float(np.asarray(jout[0]))
        assert np.isfinite(pl) and abs(pl - jl) <= LOSS_TOL * abs(jl), (
            step, pl, jl)
        losses.append(pl)
    pout, jout = out[0]
    for name, a, w in zip(params, pout[1:], jout[1:]):
        w = np.asarray(w)
        assert a.shape == w.shape and np.isfinite(a).all(), name
        assert float(np.abs(a - w).max()) <= GRAD_TOL * max(
            float(np.abs(w).max()), 1e-30), name

    # the NMS head on the trained parameters, shared by name
    (jmain, _, jvs), (pmain, _, pvs) = _both(_infer_prog)
    img = _batches(STEPS + 1)[-1]["image"]
    want, = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed={"image": img}, scope=jscope,
        fetch_list=[jvs["detections"]])
    got, = fluid.Executor(fluid.CPUPlace()).run(
        pmain, feed={"image": img}, scope=scope,
        fetch_list=[pvs["detections"]])
    want = np.asarray(want)
    assert got.shape == (1, KEEP, 6) and (got[0, :, 0] >= 0).any()
    assert_same_detections(got, want)

    # saved by each package, served by the other
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jfluid.io.save_inference_model(jdir, ["image"], [jvs["detections"]],
                                   jfluid.Executor(jfluid.CPUPlace()),
                                   main_program=jmain)
    fluid.io.save_inference_model(pdir, ["image"], [pvs["detections"]],
                                  fluid.Executor(fluid.CPUPlace()),
                                  main_program=pmain, scope=scope)
    by_port, = Predictor.from_model(jdir, place=fluid.CPUPlace()).run(
        {"image": img})
    by_jax, = JaxPredictor.from_model(pdir).run({"image": img})
    assert_same_detections(by_port, want)
    assert_same_detections(got, np.asarray(by_jax))
