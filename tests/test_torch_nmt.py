"""Transformer NMT and GPT's solo generator in the port against the JAX
package, on the CPU.

- Program JSON parity, sub-blocks included: ``build_transformer_nmt``
  with ``Adam.minimize``, ``build_transformer_beam_decode`` (a small
  ``NMTConfig`` and bench.py's full width) and ``build_gpt_generate``
  (greedy and top-k), main and startup.
- The beam program through ``save_inference_model`` in both directions:
  saved by one package, served by the other, the ids equal to the saving
  package's run and the scores within 1e-5·max|score|.
- Beam translation at a small ``NMTConfig`` on JAX-initialised parameters
  (startup seed 7) carried by ``params_from_numpy``: ids equal, final
  scores within 1e-5·max|score| (both packages run the same f32 graph;
  matmul, softmax and log sum in other orders, which moves the last bits
  only — measured 1.1e-7 — and a wrong mask, cache row or parent pointer
  moves a score by far more).
- 3 Adam steps of ``build_transformer_nmt`` from the same parameters:
  losses within 1e-5 relative at every step, step-1 gradients within
  1e-3·max|grad| of each parameter's (measured: losses 1.2e-7,
  gradients 7.7e-7). The attention key biases' exact gradient is 0
  (softmax cancels them), so both packages' are held to rounding noise,
  1e-7 of the largest gradient, instead (measured 6.6e-9).
- Liveness: the beam program's fetched ids and scores are bit-identical
  with the pruned op list and the full one; at bench.py's width the run
  skips 24 global ops and stacks 3 of ``static_rnn``'s 16 step outputs
  (none of the 8 KV caches).
- ``build_gpt_generate`` at gpt_tiny on JAX-initialised parameters:
  greedy ids equal to the JAX package's; top-k with k = 1 gives the
  greedy ids through ``sampling_id``; top-k with k = 3 is deterministic
  under a seed and every generated id lies in the vocabulary.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.fluid.inference import Predictor as JaxPredictor
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.models import transformer_nmt as jnmt
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import lowering as pt_lowering
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.inference import Predictor
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.models import transformer_nmt as nmt

SRC_LEN, TGT_LEN, MAX_OUT, BEAM = 8, 8, 6, 3
SCORE_TOL = 1e-5
LOSS_TOL = 1e-5
GRAD_TOL = 1e-3
BENCH = dict(src_vocab=32000, tgt_vocab=32000, hidden=512, heads=8,
             ffn=2048, enc_layers=4, dec_layers=4, dropout=0.0)


def _small(pkg):
    return pkg.NMTConfig(src_vocab=53, tgt_vocab=61, hidden=32, heads=4,
                         ffn=64, enc_layers=2, dec_layers=2, max_len=16,
                         dropout=0.0)


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


def _build(fl, un, fn, seed=7):
    un.switch()
    main, start = fl.Program(), fl.Program()
    start.random_seed = seed
    with fl.program_guard(main, start):
        vs = fn()
    return main, start, vs


def _nmt_train(pkg, fl, cfg):
    def fn():
        vs = pkg.build_transformer_nmt(cfg, SRC_LEN, TGT_LEN)
        fl.optimizer.Adam(1e-3).minimize(vs["loss"])
        return vs
    return fn


def _beam(pkg, cfg, src_len=SRC_LEN, max_out=MAX_OUT, beam=BEAM):
    return lambda: pkg.build_transformer_beam_decode(cfg, src_len, max_out,
                                                     beam)


def _generate(pkg, mode="greedy", topk=10):
    return lambda: pkg.build_gpt_generate(pkg.gpt_tiny(), 4, 5, mode=mode,
                                          topk=topk)


def _both(jfn, pfn):
    jmain, jstart, jvs = _build(jfluid, jax_unique_name, jfn)
    pmain, pstart, pvs = _build(fluid, pt_unique_name, pfn)
    return (jmain, jstart, jvs), (pmain, pstart, pvs)


def _same_json(a, b):
    assert json.loads(a.to_json()) == json.loads(b.to_json())


@pytest.mark.parametrize("case", [
    "nmt_train", "beam_small", "beam_bench", "generate_greedy",
    "generate_topk"])
def test_program_parity(case):
    """Same layer calls -> the same Program JSON, every block, in both
    packages."""
    jfn, pfn = {
        "nmt_train": (_nmt_train(jnmt, jfluid, _small(jnmt)),
                      _nmt_train(nmt, fluid, _small(nmt))),
        "beam_small": (_beam(jnmt, _small(jnmt)), _beam(nmt, _small(nmt))),
        "beam_bench": (_beam(jnmt, jnmt.NMTConfig(**BENCH), 32, 48, 4),
                       _beam(nmt, nmt.NMTConfig(**BENCH), 32, 48, 4)),
        "generate_greedy": (_generate(jgpt), _generate(gpt)),
        "generate_topk": (_generate(jgpt, "topk"), _generate(gpt, "topk")),
    }[case]
    (jmain, jstart, _), (pmain, pstart, _) = _both(jfn, pfn)
    _same_json(pmain, jmain)
    _same_json(pstart, jstart)
    if case != "nmt_train":
        assert len(pmain.blocks) == 2
        assert [op.type for op in pmain.global_block().ops].count(
            "static_rnn") == 1


def test_beam_program_has_12_layer_norms_a_step_at_bench_width():
    """bench.py's translation: 8 encoder LayerNorms, 12 in the step
    block (run once per output position), no fused attention."""
    pmain, _, _ = _build(fluid, pt_unique_name,
                         _beam(nmt, nmt.NMTConfig(**BENCH), 32, 48, 4))
    outer = [op.type for op in pmain.global_block().ops]
    step = [op.type for op in pmain.block(1).ops]
    assert outer.count("layer_norm") == 8 and step.count("layer_norm") == 12
    assert outer.count("static_rnn") == 1
    assert "fused_multihead_attention" not in outer + step


def _jax_state(start, main):
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(start, scope=scope)
    params = {p.name: np.array(scope[p.name]) for p in main.all_parameters()}
    return exe, scope, params


def _port_scope(params):
    scope = fluid.Scope()
    for n, t in params_from_numpy(params, torch.device("cpu")).items():
        scope.set(n, t)
    return scope


def _src(cfg, batch=3, seed=0):
    return np.random.default_rng(seed).integers(
        cfg.pad_id + 1, cfg.src_vocab, size=(batch, SRC_LEN)).astype(np.int64)


def _assert_beams(ids, scores, want_ids, want_scores):
    want_ids, want_scores = np.asarray(want_ids), np.asarray(want_scores)
    assert ids.shape == want_ids.shape == (3, MAX_OUT, BEAM)
    assert ids.dtype == np.int64          # the reference: int32 (no x64)
    np.testing.assert_array_equal(ids, want_ids)
    assert scores.shape == want_scores.shape and np.isfinite(scores).all()
    assert float(np.abs(scores - want_scores).max()) <= SCORE_TOL * float(
        np.abs(want_scores).max())


def test_beam_translation_matches_jax():
    (jmain, jstart, jvs), (pmain, _, pvs) = _both(
        _beam(jnmt, _small(jnmt)), _beam(nmt, _small(nmt)))
    jexe, jscope, params = _jax_state(jstart, jmain)
    feed = {"src_ids": _src(_small(nmt))}
    want = jexe.run(jmain, feed=feed, fetch_list=[jvs["ids"], jvs["scores"]],
                    scope=jscope)
    got = fluid.Executor(fluid.CPUPlace()).run(
        pmain, feed=feed, fetch_list=[pvs["ids"], pvs["scores"]],
        scope=_port_scope(params))
    _assert_beams(*got, *want)
    # beams keep their score order, and finished beams stay finished
    assert (np.diff(got[1], axis=1) <= 0).all()


def test_pruned_beam_program_is_bit_identical_to_the_full_one(
        monkeypatch):
    pmain, pstart, pvs = _build(fluid, pt_unique_name,
                                _beam(nmt, _small(nmt)))
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(pstart, scope=scope)
    feed = {"src_ids": _src(_small(nmt), seed=4)}
    fetch = [pvs["ids"], pvs["scores"]]
    pruned = exe.run(pmain, feed=feed, fetch_list=fetch, scope=scope)
    monkeypatch.setattr(pt_lowering, "live_plan", lambda p, f: None)
    full = exe.run(pmain, feed=feed, fetch_list=fetch, scope=scope)
    for a, b in zip(pruned, full):
        np.testing.assert_array_equal(a, b)


def test_bench_beam_program_skips_the_unread_states():
    pmain, _, pvs = _build(fluid, pt_unique_name,
                           _beam(nmt, nmt.NMTConfig(**BENCH), 32, 48, 4))
    plan = pt_lowering.live_plan(pmain, [pvs["ids"].name,
                                         pvs["scores"].name])
    ops = pmain.global_block().ops
    dead = [op.type for op in ops if op not in plan.ops[0]]
    assert len(ops) == 224 and sorted(set(dead)) == ["slice", "squeeze2"]
    assert len(dead) == 24
    rnn = next(op for op in ops if op.type == "static_rnn")
    outs, mems = plan.rnn[id(rnn)]
    assert len(rnn.output("Out")) == 16 and sorted(outs) == [1, 2, 13]
    assert len(plan.ops[1]) == 314 and len(pmain.block(1).ops) == 331
    # the 8 KV caches (two per decoder layer) are carried, never stacked
    caches = [i for i, n in enumerate(rnn.attrs["mem_names"])
              if any(n in op.input("X") for op in pmain.block(1).ops
                     if op.type == "decode_cache_write")]
    assert len(mems) == 12 and not outs & set(caches)


def test_jax_saved_beam_program_served_by_port(tmp_path):
    jmain, jstart, jvs = _build(jfluid, jax_unique_name,
                                _beam(jnmt, _small(jnmt)))
    jexe, jscope, _ = _jax_state(jstart, jmain)
    with jfluid.scope_guard(jscope):
        jfluid.io.save_inference_model(
            str(tmp_path), ["src_ids"], [jvs["ids"], jvs["scores"]], jexe,
            main_program=jmain)
    feed = {"src_ids": _src(_small(nmt), seed=1)}
    want = JaxPredictor.from_model(str(tmp_path)).run(feed)
    got = Predictor.from_model(str(tmp_path), place=fluid.CPUPlace()).run(
        feed)
    _assert_beams(*got, *want)


def test_port_saved_beam_program_served_by_jax(tmp_path):
    pmain, pstart, pvs = _build(fluid, pt_unique_name,
                                _beam(nmt, _small(nmt)))
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(pstart, scope=scope)
    fluid.io.save_inference_model(
        str(tmp_path), ["src_ids"], [pvs["ids"], pvs["scores"]], exe,
        main_program=pmain, scope=scope)
    feed = {"src_ids": _src(_small(nmt), seed=2)}
    got = Predictor.from_model(str(tmp_path), place=fluid.CPUPlace()).run(
        feed)
    want = JaxPredictor.from_model(str(tmp_path)).run(feed)
    _assert_beams(*got, *want)
    # the saved program keeps its step block, and runs through Executor too
    prog, feeds, fetches = fluid.io.load_inference_model(
        str(tmp_path), exe, scope=fluid.Scope())
    assert len(prog.blocks) == 2 and feeds == ["src_ids"]


def _exact_zero_grad(name):
    """A key bias adds q·b_k to every score of a row, which softmax
    cancels: its exact gradient is 0, and each package computes its own
    rounding noise."""
    return name.endswith(".k.b") and (".self." in name or ".cross." in name)


def test_nmt_adam_steps_match_jax():
    (jmain, jstart, jvs), (pmain, _, pvs) = _both(
        _nmt_train(jnmt, jfluid, _small(jnmt)),
        _nmt_train(nmt, fluid, _small(nmt)))
    jexe, jscope, _ = _jax_state(jstart, jmain)
    persist = [v.name for v in jstart.global_block().vars.values()
               if v.persistable]
    scope = _port_scope({n: np.array(jscope[n]) for n in persist})
    exe = fluid.Executor(fluid.CPUPlace())
    src, tgt, labels = nmt.synthetic_pair_batch(_small(nmt), 4, SRC_LEN,
                                                TGT_LEN, seed=3)
    feed = {"src_ids": src, "tgt_ids": tgt, "tgt_labels": labels}
    params = sorted(p.name for p in pmain.all_parameters())
    grads = [p + "@GRAD" for p in params]
    for step in range(3):
        jout = jexe.run(jmain, feed=feed, scope=jscope,
                        fetch_list=[jvs["loss"]] + grads)
        pout = exe.run(pmain, feed=feed, scope=scope,
                       fetch_list=[pvs["loss"]] + grads)
        jl, pl = float(np.asarray(jout[0])), float(pout[0])
        assert np.isfinite(pl) and abs(pl - jl) <= LOSS_TOL * abs(jl), (
            step, pl, jl)
        if step:
            continue
        top = max(float(np.abs(np.asarray(w)).max()) for w in jout[1:])
        for name, a, w in zip(params, pout[1:], jout[1:]):
            w = np.asarray(w)
            assert a.shape == w.shape and np.isfinite(a).all(), name
            if _exact_zero_grad(name):
                for g in (a, w):
                    assert float(np.abs(g).max()) <= 1e-7 * top, name
                continue
            assert float(np.abs(a - w).max()) <= GRAD_TOL * float(
                np.abs(w).max()), name


def _generate_both(mode="greedy", topk=10, seed=0):
    (jmain, jstart, jvs), (pmain, _, pvs) = _both(
        _generate(jgpt, mode, topk), _generate(gpt, mode, topk))
    jexe, jscope, params = _jax_state(jstart, jmain)
    prompt = np.random.default_rng(seed).integers(
        0, 211, size=(2, 4)).astype(np.int64)
    return (jexe, jscope, jmain, jvs), (pmain, pvs, params), prompt


def test_generate_greedy_matches_jax():
    (jexe, jscope, jmain, jvs), (pmain, pvs, params), prompt = \
        _generate_both()
    feed = {"gpt_prompt": prompt}
    want, = jexe.run(jmain, feed=feed, fetch_list=[jvs["ids"]], scope=jscope)
    got, = fluid.Executor(fluid.CPUPlace()).run(
        pmain, feed=feed, fetch_list=[pvs["ids"]], scope=_port_scope(params))
    assert got.shape == (2, 4 + 5 - 1) and got.dtype == np.int64
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got[:, :3], prompt[:, 1:])


def test_generate_topk_one_is_greedy():
    """k = 1: softmax of one value is 1, so ``sampling_id`` draws index 0
    and the top-k path picks the argmax, as greedy does."""
    (jexe, jscope, jmain, jvs), (_, _, params), prompt = _generate_both(
        seed=1)
    want, = jexe.run(jmain, feed={"gpt_prompt": prompt},
                     fetch_list=[jvs["ids"]], scope=jscope)
    pmain, _, pvs = _build(fluid, pt_unique_name, _generate(gpt, "topk", 1))
    got, = fluid.Executor(fluid.CPUPlace()).run(
        pmain, feed={"gpt_prompt": prompt}, fetch_list=[pvs["ids"]],
        scope=_port_scope(params))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_generate_topk_is_seeded():
    _, (pmain, pvs, params), prompt = _generate_both("topk", 3, seed=2)
    pmain.random_seed = 11
    runs = [fluid.Executor(fluid.CPUPlace()).run(
        pmain, feed={"gpt_prompt": prompt}, fetch_list=[pvs["ids"]],
        scope=_port_scope(params))[0] for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < 211)).all()
    np.testing.assert_array_equal(runs[0][:, :3], prompt[:, 1:])
