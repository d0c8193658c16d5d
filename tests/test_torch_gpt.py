"""GPT in the port against the JAX package, on the CPU with gpt_tiny.

- The three programs of the slice (``build_gpt_lm``, ``build_gpt_prefill``,
  ``build_gpt_decode_step``) build the same Program JSON, op for op and
  name for name, main and startup, at gpt_tiny and at the full width of
  ``GPTConfig()``.
- The prefill and step programs on the same JAX-trained parameters (seed 7,
  30 Adam steps, as tests/test_decode_serving.py trains them), carried
  across by name with ``fluid.io.params_from_numpy``: next tokens equal,
  logits within 1e-5·max|logit| and KV caches within 1e-5·max|kv|. Both
  packages run the same f32 graph; matmul and softmax sum in other orders,
  which over 2 layers moves the last bits only (measured: under 1e-6 of
  the scale), so 1e-5 leaves ten times room and still fails on any wrong
  mask, position or cache row.
- 3 Adam steps of ``build_gpt_lm`` in both packages from the same
  parameters: losses within 1e-5 relative at every step, step-1 gradients
  within 1e-4·max|grad| of each parameter's (the BERT training bound,
  tests/test_torch_train.py), and each parameter's 3-step update within
  1e-3·max|update| of the JAX package's. The key biases' exact gradient is
  0 (softmax cancels them), so both packages' are held to rounding noise
  instead.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.models import gpt as jgpt
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.inference import Predictor
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.models import gpt

VOCAB, MAX_LEN = 97, 256
CACHE_LEN, BUCKET = 64, 8
OUT_TOL = 1e-5
UPDATE_TOL = 1e-3
LR = 5e-3


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


@pytest.fixture(scope="module")
def trained():
    """gpt_tiny trained 30 Adam steps in the JAX package (seed 7), as
    tests/test_decode_serving.py trains it; its parameters as numpy."""
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
    return {"cfg": cfg, "exe": exe, "scope": scope, "params": params}


def _build(fl, g, un, builder, cfg_name, *args):
    un.switch()
    main, start = fl.Program(), fl.Program()
    with fl.program_guard(main, start):
        vs = getattr(g, builder)(getattr(g, cfg_name)(), *args)
    return main, start, vs


@pytest.mark.parametrize("cfg_name", ["gpt_tiny", "GPTConfig"])
@pytest.mark.parametrize("builder,args", [
    ("build_gpt_lm", (16,)),
    ("build_gpt_prefill", (BUCKET, CACHE_LEN)),
    ("build_gpt_decode_step", (CACHE_LEN,)),
])
def test_program_parity(builder, args, cfg_name):
    jmain, jstart, _ = _build(jfluid, jgpt, jax_unique_name, builder,
                              cfg_name, *args)
    pmain, pstart, _ = _build(fluid, gpt, pt_unique_name, builder,
                              cfg_name, *args)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert json.loads(pstart.to_json()) == json.loads(jstart.to_json())


def test_decode_step_program_has_24_layer_norms_at_full_width():
    main, _, _ = _build(fluid, gpt, pt_unique_name, "build_gpt_decode_step",
                        "GPTConfig", 1024)
    types = [op.type for op in main.global_block().ops]
    assert types.count("layer_norm") == 24
    assert types.count("decode_cache_write") == 24
    assert "fused_multihead_attention" not in types


def _jax_program(builder, *args):
    main, start = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, start), jax_unique_name.guard():
        vs = builder(jgpt.gpt_tiny(vocab=VOCAB, max_len=MAX_LEN), *args)
    return main, vs


def _port_predictor(params, builder, *args):
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        vs = builder(gpt.gpt_tiny(vocab=VOCAB, max_len=MAX_LEN), *args)
    fetch = [vs["next"], vs["logits"], vs["k"], vs["v"]]
    return Predictor(main, vs["feed_names"], fetch, scope=params,
                     place=fluid.CPUPlace())


def _assert_outputs(got, want):
    nxt, logits, k, v = got
    jn, jl, jk, jv = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(nxt, jn)
    for a, w in ((logits, jl), (k, jk), (v, jv)):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert np.isfinite(a).all()
        assert float(np.abs(a - w).max()) <= OUT_TOL * float(
            np.abs(w).max())


def _prompts(n, seed=11):
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, BUCKET + 1, n)
    ids = rng.integers(1, VOCAB, (n, BUCKET)).astype(np.int64)
    return ids, lens.reshape(-1, 1).astype(np.int64)


def test_prefill_matches_jax(trained):
    jmain, jvs = _jax_program(jgpt.build_gpt_prefill, BUCKET, CACHE_LEN)
    pred = _port_predictor(params_from_numpy(trained["params"], "cpu"),
                           gpt.build_gpt_prefill, BUCKET, CACHE_LEN)
    ids, lens = _prompts(4)
    feed = {"gpt_prefill_ids": ids, "gpt_prefill_len": lens}
    want = trained["exe"].run(
        jmain, feed=feed, scope=trained["scope"],
        fetch_list=[jvs["next"], jvs["logits"], jvs["k"], jvs["v"]])
    got = pred.run(feed)
    _assert_outputs(got, want)
    # rows at or past each prompt's length are zero
    for b, n in enumerate(lens[:, 0]):
        assert not got[2][b, :, n:].any() and not got[3][b, :, n:].any()


def test_decode_steps_match_jax(trained):
    """Five steps of 4 slots at their own positions (one slot dead at 0),
    each step's inputs JAX's outputs of the step before, so every step is
    compared on the same inputs."""
    params = params_from_numpy(trained["params"], "cpu")
    jpre, jpv = _jax_program(jgpt.build_gpt_prefill, BUCKET, CACHE_LEN)
    jstep, jsv = _jax_program(jgpt.build_gpt_decode_step, CACHE_LEN)
    pred = _port_predictor(params, gpt.build_gpt_decode_step, CACHE_LEN)
    ids, lens = _prompts(4, seed=12)
    lens[3, 0] = 0                               # a dead slot
    nxt, k, v = trained["exe"].run(
        jpre, feed={"gpt_prefill_ids": ids,
                    "gpt_prefill_len": np.maximum(lens, 1)},
        fetch_list=[jpv["next"], jpv["k"], jpv["v"]],
        scope=trained["scope"])
    tok, pos = np.asarray(nxt), lens.copy()
    k, v = np.asarray(k), np.asarray(v)
    for _ in range(5):
        feed = {"gpt_step_tok": tok, "gpt_step_pos": pos,
                "gpt_step_k": k, "gpt_step_v": v}
        want = trained["exe"].run(
            jstep, feed=feed, scope=trained["scope"],
            fetch_list=[jsv["next"], jsv["logits"], jsv["k"], jsv["v"]])
        _assert_outputs(pred.run(feed), want)
        tok = np.asarray(want[0]).astype(np.int64)
        k, v = np.asarray(want[2]), np.asarray(want[3])
        pos = pos + 1
        pos[3, 0] = 0


def _exact_zero_grad(name):
    """The key bias adds q·b_k to every score of a row, which softmax
    cancels: its exact gradient is 0, and each package computes its own
    rounding noise (~1e-10 against gradients of ~1e-2)."""
    return name.endswith(".self.k.b")


def _lm_program(fl, g, un):
    un.switch()
    main, start = fl.Program(), fl.Program()
    with fl.program_guard(main, start):
        vs = g.build_gpt_lm(g.gpt_tiny(vocab=VOCAB, max_len=MAX_LEN), 16)
        fl.optimizer.Adam(LR).minimize(vs["loss"])
    return main, start, vs


def test_lm_adam_steps_match_jax():
    jmain, jstart, jvs = _lm_program(jfluid, jgpt, jax_unique_name)
    pmain, _, pvs = _lm_program(fluid, gpt, pt_unique_name)
    jstart.random_seed = 7
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    scope = fluid.Scope()
    persist = [v.name for v in jstart.global_block().vars.values()
               if v.persistable]
    init = {n: np.array(jscope[n]) for n in persist}
    for n, t in params_from_numpy(init, torch.device("cpu")).items():
        scope.set(n, t)
    exe = fluid.Executor(fluid.CPUPlace())
    ids, labels = gpt.synthetic_lm_batch(gpt.gpt_tiny(vocab=VOCAB), 8, 16,
                                         seed=3)
    feed = {"gpt_ids": ids, "gpt_labels": labels}
    params = sorted(p.name for p in pmain.all_parameters())
    grads = [p + "@GRAD" for p in params]
    for step in range(3):
        jout = jexe.run(jmain, feed=feed, scope=jscope,
                        fetch_list=[jvs["loss"]] + grads)
        pout = exe.run(pmain, feed=feed, scope=scope,
                       fetch_list=[pvs["loss"]] + grads)
        jl, pl = float(np.asarray(jout[0])), float(pout[0])
        assert np.isfinite(pl) and abs(pl - jl) <= 1e-5 * abs(jl), (
            step, pl, jl)
        if step == 0:
            top = max(float(np.abs(np.asarray(w)).max()) for w in jout[1:])
            for name, a, w in zip(params, pout[1:], jout[1:]):
                w = np.asarray(w)
                assert a.shape == w.shape and np.isfinite(a).all(), name
                if _exact_zero_grad(name):
                    for g in (a, w):
                        assert float(np.abs(g).max()) <= 1e-7 * top, name
                    continue
                assert float(np.abs(a - w).max()) <= 1e-4 * float(
                    np.abs(w).max()), name
    # each parameter's 3-step update against the JAX package's
    for n in params:
        moved = scope[n].numpy() - init[n]
        want = np.asarray(jscope[n]) - init[n]
        if _exact_zero_grad(n):
            # Adam turns the rounding noise into steps of up to ~1e-2 lr
            for upd in (moved, want):
                assert float(np.abs(upd).max()) <= 3 * 2e-2 * LR, n
            continue
        scale = float(np.abs(want).max())
        assert scale > 0, n
        assert float(np.abs(moved - want).max()) <= UPDATE_TOL * scale, n
