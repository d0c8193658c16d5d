"""KV reuse and speculative decoding in the port, against the JAX package.

Setup, as tests/test_spec_prefix.py trains it: gpt_tiny (vocab 97,
max_len 128) trained 30 Adam steps in the JAX package (seed 9) as the
target, and a separately trained draft (hidden 16, 1 layer, seed 13) in
its own scope, both carried across by name as numpy. Every engine of the
port runs on ``CPUPlace()``.

- ``build_gpt_prefill_delta`` and ``build_gpt_verify_block`` build the
  JAX package's Program JSON, op for op and name for name, at gpt_tiny
  and at ``GPTConfig()``; on the same numpy params and feeds through both
  packages, ``next`` is equal and logits, k and v are within
  1e-5·max|ref| (tests/test_torch_gpt.py's bound: matmul and softmax
  sum in other orders).
- Exactness bar for every stream: speculative (k = 1..4, EOS inside a
  block, a draft rejected at position 0 every round, an early-exit draft
  on the target's own params), prefix-adopted and resumed streams equal
  the JAX package's solo ``build_gpt_generate`` greedy tokens, with no
  tolerance.
- ``PrefixPool`` (LRU, ``min_tokens``, int8 entries byte for byte the
  JAX package's, ``prefix_digest``), ``SessionTier`` (fp32 wire bit-exact,
  int8 wire equal to the JAX engine's), ``PrefillEngine(prefix_pool=)``,
  the registry's ``reuse`` block, ``/healthz`` and
  ``DisaggRouter.reuse_info``, and bench.py:1472's three legs at gpt_tiny.
Every blocking wait has its own timeout.
"""
import json
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import observability as jobs
from paddle_tpu import serving as jserving
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.models import gpt as jgpt
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.inference import Predictor
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import (
    DecodeEngine, DraftModel, ModelRegistry, PrefillEngine, PrefixPool,
    SessionTier, prefix_digest,
)
from paddle_tpu_torch.serving.disagg import (
    DisaggReplica, DisaggRouter, kv_wire,
)

VOCAB, MAX_LEN = 97, 128
CACHE_LEN = 64
OUT_TOL = 1e-5
CPU = fluid.CPUPlace()
WAIT = 60.0          # seconds: the bound of every blocking wait


@pytest.fixture(autouse=True)
def _fresh_state():
    """Fresh default programs, name generator and scope of the port, and
    both packages' hubs (process-global)."""
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


def _train(cfg, seed, steps=30):
    """One tiny GPT trained in the JAX package into its own scope (target
    and draft must not share params: a draft that IS the target accepts
    everything and proves nothing)."""
    main, start = jfluid.Program(), jfluid.Program()
    start.random_seed = seed
    with jfluid.program_guard(main, start), jax_unique_name.guard():
        vs = jgpt.build_gpt_lm(cfg, 16)
        jfluid.optimizer.Adam(5e-3).minimize(vs["loss"])
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(start, scope=scope)
    ids, labels = jgpt.synthetic_lm_batch(cfg, 16, 16, seed=seed)
    for _ in range(steps):
        exe.run(main, feed={"gpt_ids": ids, "gpt_labels": labels},
                fetch_list=[vs["loss"]], scope=scope)
    params = {p.name: np.array(scope[p.name]) for p in main.all_parameters()}
    return exe, scope, params


def _draft_cfg(g):
    return g.GPTConfig(vocab=VOCAB, hidden=16, num_layers=1, heads=2,
                       ffn=32, max_len=MAX_LEN, dropout=0.0)


@pytest.fixture(scope="module")
def m():
    jcfg = jgpt.gpt_tiny(vocab=VOCAB, max_len=MAX_LEN)
    exe, scope, params = _train(jcfg, seed=9)
    _, dscope, dparams = _train(_draft_cfg(jgpt), seed=13)
    return {"jcfg": jcfg, "cfg": gpt.gpt_tiny(vocab=VOCAB, max_len=MAX_LEN),
            "dcfg": _draft_cfg(gpt), "jdcfg": _draft_cfg(jgpt), "exe": exe,
            "scope": scope, "dscope": dscope, "params": params,
            "dparams": dparams, "solo": {}}


def _solo(m, prompt, n_new):
    """Reference: the JAX package's solo build_gpt_generate greedy tokens
    for `prompt` (memoised per prompt and length)."""
    key = (tuple(int(t) for t in prompt), int(n_new))
    if key not in m["solo"]:
        g_prog, g_st = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(g_prog, g_st), jax_unique_name.guard():
            gen = jgpt.build_gpt_generate(m["jcfg"], len(prompt), n_new,
                                          mode="greedy")
        out = np.asarray(m["exe"].run(
            g_prog, feed={"gpt_prompt": np.asarray(prompt).reshape(1, -1)},
            fetch_list=[gen["ids"]], scope=m["scope"])[0])
        m["solo"][key] = [int(t) for t in out[0, len(prompt) - 1:]]
    return m["solo"][key]


def _prompt(n, seed=11):
    rng = np.random.default_rng(seed + n)
    return rng.integers(1, VOCAB, n).astype("int64")


def _engine(m, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("prompt_buckets", (8, 16, 32))
    kw.setdefault("name", "spec-test")
    kw.setdefault("place", CPU)
    return DecodeEngine(m["cfg"], m["params"], **kw)


def _draft(m, k, name="draft"):
    return DraftModel(m["dcfg"], m["dparams"], k=k, name=name)


# ---------------------------------------------------------------------------
# the two new programs against the JAX package
# ---------------------------------------------------------------------------
def _build(fl, g, un, builder, cfg_name, *args):
    un.switch()
    main, start = fl.Program(), fl.Program()
    with fl.program_guard(main, start):
        vs = getattr(g, builder)(getattr(g, cfg_name)(), *args)
    return main, start, vs


@pytest.mark.parametrize("cfg_name", ["gpt_tiny", "GPTConfig"])
@pytest.mark.parametrize("builder,args", [
    ("build_gpt_prefill_delta", (8, CACHE_LEN)),
    ("build_gpt_verify_block", (5, CACHE_LEN)),
    ("build_gpt_verify_block", (1, CACHE_LEN)),
])
def test_program_parity(builder, args, cfg_name):
    jmain, jstart, _ = _build(jfluid, jgpt, jax_unique_name, builder,
                              cfg_name, *args)
    pmain, pstart, _ = _build(fluid, gpt, pt_unique_name, builder,
                              cfg_name, *args)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert json.loads(pstart.to_json()) == json.loads(jstart.to_json())


def test_new_programs_run_24_layer_norms_and_no_attention_kernel():
    for builder, args in (("build_gpt_prefill_delta", (8, 1024)),
                          ("build_gpt_verify_block", (5, 1024))):
        main, _, _ = _build(fluid, gpt, pt_unique_name, builder,
                            "GPTConfig", *args)
        types = [op.type for op in main.global_block().ops]
        assert types.count("layer_norm") == 24, builder
        assert types.count("decode_cache_write") == 24, builder
        assert "fused_multihead_attention" not in types, builder


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
                     place=CPU)


def _assert_outputs(got, want):
    nxt, logits, k, v = got
    jn, jl, jk, jv = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(nxt, jn)
    for a, w in ((logits, jl), (k, jk), (v, jv)):
        assert a.shape == w.shape and a.dtype == w.dtype
        assert np.isfinite(a).all()
        assert float(np.abs(a - w).max()) <= OUT_TOL * float(
            np.abs(w).max())


def _jax_cold(m, prompts, bucket):
    """The JAX package's cold prefill of right-padded `prompts`:
    (next, k, v) as numpy."""
    jmain, jvs = _jax_program(jgpt.build_gpt_prefill, bucket, CACHE_LEN)
    ids = np.zeros((len(prompts), bucket), np.int64)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = p
    lens = np.asarray([[len(p)] for p in prompts], np.int64)
    out = m["exe"].run(jmain, feed={"gpt_prefill_ids": ids,
                                    "gpt_prefill_len": lens},
                       fetch_list=[jvs["next"], jvs["k"], jvs["v"]],
                       scope=m["scope"])
    return [np.asarray(o) for o in out]


def test_delta_prefill_matches_jax(m):
    """Three rows, each adopting its own prefix (3, 9 and 16 rows) from
    the JAX package's cold prefill and extending it by 2-8 suffix
    tokens."""
    starts, slens = (3, 9, 16), (8, 2, 5)
    heads = [_prompt(s, seed=40 + s) for s in starts]
    _, k0, v0 = _jax_cold(m, heads, 16)
    ids = np.zeros((3, 8), np.int64)
    for i, n in enumerate(slens):
        ids[i, :n] = _prompt(n, seed=50 + i)
    feed = {"gpt_dpre_ids": ids,
            "gpt_dpre_len": np.asarray(slens, np.int64).reshape(-1, 1),
            "gpt_dpre_start": np.asarray(starts, np.int64).reshape(-1, 1),
            "gpt_dpre_k": k0, "gpt_dpre_v": v0}
    jmain, jvs = _jax_program(jgpt.build_gpt_prefill_delta, 8, CACHE_LEN)
    want = m["exe"].run(
        jmain, feed=feed, scope=m["scope"],
        fetch_list=[jvs["next"], jvs["logits"], jvs["k"], jvs["v"]])
    pred = _port_predictor(params_from_numpy(m["params"], "cpu"),
                           gpt.build_gpt_prefill_delta, 8, CACHE_LEN)
    got = pred.run(feed)
    _assert_outputs(got, want)
    # adopted rows pass through untouched; rows past start + len are zero
    for b, (s, n) in enumerate(zip(starts, slens)):
        np.testing.assert_array_equal(got[2][b, :, :s], k0[b, :, :s])
        assert not got[2][b, :, s + n:].any()
        assert not got[3][b, :, s + n:].any()


def test_verify_block_matches_jax(m):
    """Two slots at their own positions feed a 5-token block."""
    heads = [_prompt(7, seed=60), _prompt(12, seed=61)]
    nxt, k0, v0 = _jax_cold(m, heads, 16)
    tok = np.concatenate([nxt.astype(np.int64),
                          np.stack([_prompt(4, seed=62 + i)
                                    for i in range(2)])], axis=1)
    feed = {"gpt_vrf_tok": tok,
            "gpt_vrf_pos": np.asarray([[7], [12]], np.int64),
            "gpt_vrf_k": k0, "gpt_vrf_v": v0}
    jmain, jvs = _jax_program(jgpt.build_gpt_verify_block, 5, CACHE_LEN)
    want = m["exe"].run(
        jmain, feed=feed, scope=m["scope"],
        fetch_list=[jvs["next"], jvs["logits"], jvs["k"], jvs["v"]])
    pred = _port_predictor(params_from_numpy(m["params"], "cpu"),
                           gpt.build_gpt_verify_block, 5, CACHE_LEN)
    _assert_outputs(pred.run(feed), want)


def test_verify_column0_is_the_step_and_delta_is_the_cold_prefill(m):
    """In the port alone: verify column 0 gives the single-token step's
    token, and a prefix prefilled cold then extended by a delta pass
    gives the cold prefill of the whole prompt, within the parity bound
    (the docstrings promise bits; the port's CPU sums keep the tokens)."""
    params = params_from_numpy(m["params"], "cpu")
    cold = _port_predictor(params, gpt.build_gpt_prefill, 32, CACHE_LEN)
    step = _port_predictor(params, gpt.build_gpt_decode_step, CACHE_LEN)
    verify = _port_predictor(params, gpt.build_gpt_verify_block, 5,
                             CACHE_LEN)
    delta = _port_predictor(params, gpt.build_gpt_prefill_delta, 8,
                            CACHE_LEN)
    prompt = _prompt(27, seed=70)
    ids = np.zeros((1, 32), np.int64)
    ids[0, :27] = prompt
    full = cold.run({"gpt_prefill_ids": ids,
                     "gpt_prefill_len": np.asarray([[27]], np.int64)})
    ids[0, 21:] = 0
    head = cold.run({"gpt_prefill_ids": ids,
                     "gpt_prefill_len": np.asarray([[21]], np.int64)})
    sfx = np.zeros((1, 8), np.int64)
    sfx[0, :6] = prompt[21:]
    dl = delta.run({"gpt_dpre_ids": sfx,
                    "gpt_dpre_len": np.asarray([[6]], np.int64),
                    "gpt_dpre_start": np.asarray([[21]], np.int64),
                    "gpt_dpre_k": head[2], "gpt_dpre_v": head[3]})
    np.testing.assert_array_equal(dl[0], full[0])
    for a, w in zip(dl[2:], full[2:]):
        assert float(np.abs(a - w).max()) <= OUT_TOL * float(
            np.abs(w).max())
    tok = full[0].astype(np.int64)
    st = step.run({"gpt_step_tok": tok,
                   "gpt_step_pos": np.asarray([[27]], np.int64),
                   "gpt_step_k": full[2], "gpt_step_v": full[3]})
    block = np.concatenate([tok, _prompt(4, seed=71)[None]], axis=1)
    vr = verify.run({"gpt_vrf_tok": block,
                     "gpt_vrf_pos": np.asarray([[27]], np.int64),
                     "gpt_vrf_k": full[2], "gpt_vrf_v": full[3]})
    assert vr[0][0, 0] == st[0][0, 0]
    assert float(np.abs(vr[1][0, 0] - st[1][0]).max()) <= OUT_TOL * float(
        np.abs(st[1]).max())


# ---------------------------------------------------------------------------
# speculative decoding: bit-exactness
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_spec_bit_exact(m, k):
    """Block width k: mixed prompt lengths through a 2-slot speculative
    engine equal the JAX package's solo greedy decode token for token,
    and speculation actually ran (rounds and proposals recorded,
    acceptance in [0, 1])."""
    eng = _engine(m, draft=_draft(m, k, "d%d" % k), name="spec-k%d" % k)
    try:
        handles = [(p, eng.submit(_prompt(p), max_new=16)) for p in (5, 8)]
        for p, h in handles:
            assert h.result(WAIT) == _solo(m, _prompt(p), 16), (k, p)
        st = eng.stats()
        assert st["spec_rounds"] >= 1, st
        assert st["spec_proposed"] >= k * st["spec_rounds"] // 2, st
        assert 0.0 <= st["spec_accept_rate"] <= 1.0, st
        assert st["steps"] == st["spec_fallback_steps"], st
    finally:
        eng.stop(drain=False, timeout=WAIT)


def test_spec_eos_inside_block_stops_exactly(m):
    """EOS produced mid-block retires the slot at the EOS token: no
    dirty over-speculated token after it is ever emitted."""
    p = _prompt(6)
    ref = _solo(m, p, 12)
    j = next(i for i in range(1, len(ref)) if ref[i] not in ref[:i])
    eng = _engine(m, draft=_draft(m, 4, "d-eos"), name="spec-eos")
    try:
        h = eng.submit(p, max_new=12, eos_id=ref[j])
        assert h.result(WAIT) == ref[:j + 1]
        assert h.finish_reason == "eos"
    finally:
        eng.stop(drain=False, timeout=WAIT)


class _SaboteurDraft(DraftModel):
    """Draft whose every proposal is shifted off the greedy chain —
    the target must reject at position 0 every round."""

    def propose(self, tok, pos):
        return (super().propose(tok, pos) + 1) % self.cfg.vocab


def test_spec_rejection_at_position_0_still_bit_exact(m):
    p = _prompt(7)
    eng = _engine(m, slots=1, name="spec-sab",
                  draft=_SaboteurDraft(m["dcfg"], m["dparams"], k=4,
                                       name="d-sab"))
    try:
        assert eng.generate(p, max_new=6, timeout=WAIT) == _solo(m, p, 6)
        st = eng.stats()
        assert st["spec_accepted"] == 0, st
        # prefill emits token 1; each round then emits exactly ONE token
        assert st["spec_rounds"] == 5, st
    finally:
        eng.stop(drain=False, timeout=WAIT)


def test_early_exit_draft_reads_the_targets_params(m):
    """A draft of the target's first layer (GPTConfig(num_layers=1) on
    the target's own params, no second weight set) proposes; the stream
    is the solo one. A cache-edge request runs fallback steps, mirrored
    into the draft."""
    dcfg = gpt.gpt_tiny(vocab=VOCAB, max_len=MAX_LEN)
    dcfg.num_layers = 1
    draft = DraftModel(dcfg, m["params"], k=3, name="early-exit")
    eng = _engine(m, slots=1, draft=draft, name="spec-early")
    try:
        p = _prompt(8, seed=5)
        assert eng.generate(p, max_new=12, timeout=WAIT) == _solo(m, p, 12)
        # 32 prompt tokens + 33 new fill the 64-row cache: the last
        # rounds lack k + 1 rows of headroom
        q = _prompt(32, seed=6)
        assert eng.generate(q, max_new=33, timeout=WAIT) == \
            _solo(m, q, 33)
        st = eng.stats()
        assert st["spec_rounds"] >= 1 and st["spec_fallback_steps"] >= 1
        assert st["spec_accepted"] >= 1, st
    finally:
        eng.stop(drain=False, timeout=WAIT)


def test_draft_bind_checks(m):
    bad = gpt.GPTConfig(vocab=VOCAB + 1, hidden=16, num_layers=1, heads=2,
                        ffn=32, max_len=MAX_LEN, dropout=0.0)
    with pytest.raises(ValueError, match="vocab"):
        _engine(m, draft=DraftModel(bad, m["dparams"]), auto_start=False)
    short = _draft_cfg(gpt)
    short.max_len = 32
    with pytest.raises(ValueError, match="max_len"):
        _engine(m, draft=DraftModel(short, m["dparams"]), auto_start=False)
    params = dict(m["dparams"])
    del params["gpt_out.w"]
    with pytest.raises(KeyError, match="gpt_out.w"):
        _engine(m, draft=DraftModel(m["dcfg"], params), auto_start=False)
    with pytest.raises(ValueError, match="k must be"):
        DraftModel(m["dcfg"], m["dparams"], k=0)
    d = _draft(m, 2)
    eng = _engine(m, draft=d, auto_start=False)
    assert d.bind(eng) is d
    with pytest.raises(RuntimeError, match="already bound"):
        _engine(m, draft=d, auto_start=False)
    with pytest.raises(ValueError, match="fp32-resident"):
        _engine(m, draft=_draft(m, 2), kv_dtype="int8", auto_start=False)
    for kw in ({"prefix_pool": PrefixPool()},
               {"session_tier": SessionTier()}):
        with pytest.raises(ValueError, match="decode-role"):
            _engine(m, role="decode", auto_start=False, **kw)
    eng.stop(timeout=WAIT)


def test_warmup_runs_delta_verify_and_draft_programs(m):
    eng = _engine(m, prompt_buckets=(8, 16), draft=_draft(m, 2, "d-warm"),
                  prefix_pool=PrefixPool(), session_tier=SessionTier(),
                  name="spec-warm", auto_start=False)
    report = eng.warmup()
    assert [(r["program"], r.get("bucket")) for r in report] == [
        ("step", None), ("prefill", 8), ("prefill", 16),
        ("delta_prefill", 8), ("delta_prefill", 16), ("verify", None),
        ("draft_step", None)] + [("draft_prefill", b)
                                 for b in (8, 16, 32, 64)]
    assert [r["block"] for r in report if r["program"] == "verify"] == [3]
    assert not eng._k.any() and not eng._draft._k_buf.any()
    # every program reads the engine's one parameter copy
    preds = ([eng._step_pred, eng._verify_pred]
             + list(eng._prefill_preds.values())
             + list(eng._delta_preds.values()))
    for pred in preds:
        for n, t in pred._state.items():
            assert t is eng._params[n], n
    eng.stop(timeout=WAIT)


# ---------------------------------------------------------------------------
# prefix pool
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("placement,store", [
    ("host", "fp32"), ("hbm", "fp32"), ("host", "int8")])
def test_prefix_adopt_then_delta_matches_cold(m, placement, store):
    """Shared 16-token head: the first (cold) request banks it, the
    second adopts it and delta-prefills only its unique tail, a repeat of
    the first adopts with ZERO prefill dispatch. fp32 entries give the
    solo streams; int8 entries the JAX engine's on the same pool."""
    pool = PrefixPool(prefix_lens=(16,), placement=placement,
                      store_dtype=store, name="t-pool")
    eng = _engine(m, prefix_pool=pool, name="spec-pool")
    head = _prompt(16, seed=3)
    pa = np.concatenate([head, _prompt(4, seed=5)])
    pb = np.concatenate([head, _prompt(8, seed=6)])
    try:
        got = [eng.generate(p, max_new=8, timeout=WAIT)
               for p in (pa, pb, pa)]
        st = eng.stats()
    finally:
        eng.stop(drain=False, timeout=WAIT)
    if store == "fp32":
        want = [_solo(m, p, 8) for p in (pa, pb, pa)]
    else:
        jeng = jserving.DecodeEngine(
            m["jcfg"], m["scope"], slots=2, cache_len=CACHE_LEN,
            prompt_buckets=(8, 16, 32), name="jspec-pool",
            prefix_pool=jserving.PrefixPool(prefix_lens=(16,),
                                            store_dtype="int8"))
        try:
            want = [jeng.generate(p, max_new=8, timeout=WAIT)
                    for p in (pa, pb, pa)]
        finally:
            jeng.stop(drain=False)
    assert got == want
    assert st["prefills"] == 1 and st["delta_prefills"] == 1, st
    assert st["prefix_full_hits"] == 1, st
    assert st["prefill_rows_computed"] == 32 + 8, st
    assert st["prefill_rows_saved"] == 16 + 20, st
    info = pool.stats()
    assert info["hits"] == 2 and info["misses"] == 1, info
    kind = torch.Tensor if placement == "hbm" else np.ndarray
    assert all(isinstance(e.k, kind) for e in pool._entries.values())


def test_prefix_pool_lru_eviction_and_min_tokens():
    """Byte-budget LRU: inserting past capacity evicts the coldest
    entry; trivially short prefixes are never cached."""
    L, T, H = 2, 32, 8
    k = np.ones((L, T, H), np.float32)
    v = np.ones((L, T, H), np.float32)
    nbytes = 2 * k.nbytes  # one fp32 entry
    pool = PrefixPool(capacity_bytes=2 * nbytes, min_tokens=4, name="lru")
    prompts = [_prompt(8, seed=s) for s in (1, 2, 3)]
    for p in prompts:
        assert pool.put(p, k, v, next_token=1) == 1
    st = pool.stats()
    assert len(pool) == 2 and st["evictions"] == 1, st
    assert pool.lookup(prompts[0]) is None          # evicted (oldest)
    hit = pool.lookup(prompts[2])
    assert hit is not None and hit.plen == 8
    assert hit.digest == prefix_digest(prompts[2])
    assert pool.put(_prompt(2, seed=4), k, v) == 0  # below min_tokens
    st = pool.stats()
    assert st["hits"] == 1 and st["misses"] == 1, st
    # an entry larger than the whole budget is not stored
    assert PrefixPool(capacity_bytes=nbytes - 1).put(prompts[0], k, v) == 0
    with pytest.raises(ValueError, match="store_dtype"):
        PrefixPool(store_dtype="fp16")
    with pytest.raises(ValueError, match="placement"):
        PrefixPool(placement="disk")


def test_pool_entries_digests_and_metrics_equal_jax():
    """The same puts and lookups through both packages' pools: digests,
    int8 payloads and scales byte for byte, fp32 rows zeroed past each
    length, the ladder's entries, stats and the serving.prefix.* and
    serving.tier.* metrics all equal."""
    rng = np.random.default_rng(3)
    L, T, H = 2, 32, 16
    toks = rng.integers(0, VOCAB, 20).astype(np.int64)
    k = rng.standard_normal((1, L, T, H)).astype(np.float32)
    v = rng.standard_normal((1, L, T, H)).astype(np.float32)
    for t in (toks, toks[:3], [], [5]):
        assert prefix_digest(t) == jserving.prefix_digest(t)
    for store in ("fp32", "int8"):
        kw = dict(capacity_bytes=1 << 20, store_dtype=store,
                  prefix_lens=(8, 16), name="eq")
        pp, jp = PrefixPool(**kw), jserving.PrefixPool(**kw)
        assert pp.put(toks, k, v, next_token=7) == \
            jp.put(toks, k, v, next_token=7) == 3
        assert list(pp._entries) == list(jp._entries)
        for d in pp._entries:
            pe, je = pp._entries[d], jp._entries[d]
            assert (pe.plen, pe.next_token, pe.nbytes) == \
                (je.plen, je.next_token, je.nbytes)
            for a in ("k", "v", "k_scales", "v_scales"):
                pa, ja = getattr(pe, a), getattr(je, a)
                assert (pa is None) == (ja is None)
                if pa is not None:
                    assert pa.dtype == np.asarray(ja).dtype
                    assert pa.tobytes() == np.asarray(ja).tobytes()
            for a, b in zip(pe.dense(), je.dense()):
                np.testing.assert_array_equal(a, np.asarray(b))
        for probe in (toks, toks[:12], toks[:5], toks[:16]):
            pe, je = pp.lookup(probe), jp.lookup(probe)
            assert (pe is None) == (je is None)
            if pe is not None:
                assert pe.digest == je.digest
        assert pp.stats() == jp.stats()
    h = kv_wire.encode_kv(k, v, 3, 20, toks, wire_dtype="int8")
    pt, jt = SessionTier(capacity_bytes=h.wire_bytes(), name="eq"), \
        jserving.SessionTier(capacity_bytes=h.wire_bytes(), name="eq")
    for tier in (pt, jt):
        tier.hibernate("a", h)
        tier.hibernate("b", h)          # evicts "a"
        assert tier.resume("a") is None and tier.resume("b") is h
    assert pt.stats() == jt.stats()
    names = ("serving.prefix.hits", "serving.prefix.misses",
             "serving.prefix.inserts", "serving.tier.hibernated",
             "serving.tier.resumed", "serving.tier.evictions")
    assert [obs.counter(n) for n in names] == \
        [jobs.counter(n) for n in names]
    assert obs.counter("serving.prefix.inserts") == 6


# ---------------------------------------------------------------------------
# session tiering
# ---------------------------------------------------------------------------
def test_session_resume_bit_exact_fp32_wire(m):
    """Turn 2 of a hibernated-and-resumed session equals the JAX
    package's cold greedy decode of the full transcript (fp32 wire)."""
    tier = SessionTier(wire_dtype="fp32", name="t-fp32")
    eng = _engine(m, slots=1, session_tier=tier, name="spec-sess")
    try:
        p1, p2 = _prompt(8, seed=21), _prompt(4, seed=22)
        t1 = eng.submit(p1, max_new=4, session="conv").result(WAIT)
        assert len(tier) == 1
        assert tier.stats()["hibernated"] == 1
        h = tier.peek("conv")
        assert h.plen == 8 + 3 and h.next_token == t1[-1]
        t2 = eng.submit(p2, max_new=4, session="conv").result(WAIT)
        transcript = np.concatenate([p1, np.asarray(t1, np.int64), p2])
        assert t1 == _solo(m, p1, 4)
        assert t2 == _solo(m, transcript, 4)
        st = eng.stats()
        assert st["resumed"] == 1 and st["hibernated"] == 2, st
        assert st["delta_prefills"] == 1 and st["prefills"] == 1, st
        assert tier.stats()["resumed"] == 1
    finally:
        eng.stop(drain=False, timeout=WAIT)


def test_session_resume_int8_wire_equals_jax_engine(m):
    """Default int8 wire: hibernate/resume round-trips and serves turn 2,
    the JAX engine's tokens on the same conversation."""
    p1, p2 = _prompt(8, seed=31), _prompt(4, seed=32)
    out = []
    for pkg, kw in ((serving, {"place": CPU}), (jserving, {})):
        cfg, params = ((m["cfg"], m["params"]) if pkg is serving
                       else (m["jcfg"], m["scope"]))
        tier = pkg.SessionTier(name="t-int8")
        eng = pkg.DecodeEngine(cfg, params, slots=1, cache_len=CACHE_LEN,
                               prompt_buckets=(8, 16, 32),
                               name="spec-sess8", session_tier=tier, **kw)
        try:
            t1 = eng.submit(p1, max_new=4, session="c8").result(WAIT)
            t2 = eng.submit(p2, max_new=4, session="c8").result(WAIT)
            out.append((t1, t2, eng.stats()["resumed"],
                        tier.stats()["wire_dtype"], tier.stats()["bytes"]))
        finally:
            eng.stop(drain=False)
    assert out[0] == out[1]
    assert out[0][2] == 1 and out[0][3] == "int8" and out[0][4] > 0


def test_failed_resume_keeps_the_session(m):
    tier = SessionTier(wire_dtype="fp32")
    eng = _engine(m, slots=1, session_tier=tier, name="spec-keep",
                  prompt_buckets=(8, 16, 64))
    try:
        eng.submit(_prompt(8), max_new=3, session="s").result(WAIT)
        with pytest.raises(ValueError, match="cache_len"):
            eng.submit(_prompt(4), max_new=60, session="s")
        assert tier.peek("s") is not None
        # a suffix whose delta bucket (64) would run off the cache from
        # row 10 replays the whole transcript cold
        h = tier.peek("s")
        t2 = eng.submit(_prompt(30, seed=2), max_new=3,
                        session="s").result(WAIT)
        transcript = np.concatenate([np.asarray(h.prompt, np.int64),
                                     [h.next_token], _prompt(30, seed=2)])
        assert t2 == _solo(m, transcript, 3)
        assert eng.stats()["prefills"] == 2
    finally:
        eng.stop(drain=False, timeout=WAIT)


def test_submit_prefilled_session_hibernates(m):
    """A handoff adopted with a session id hibernates at retire, and the
    next turn resumes it on the same engine."""
    pre = PrefillEngine(m["cfg"], m["params"], cache_len=CACHE_LEN,
                        prompt_buckets=(8, 16), wire_dtype="fp32",
                        place=CPU, name="pre-sess")
    tier = SessionTier(wire_dtype="fp32")
    eng = _engine(m, slots=1, session_tier=tier, name="spec-adopt")
    try:
        p1, p2 = _prompt(6, seed=81), _prompt(3, seed=82)
        h = pre.prefill(p1, timeout=WAIT)
        t1 = eng.submit_prefilled(h, max_new=5, session="x").result(WAIT)
        t2 = eng.submit(p2, max_new=5, session="x").result(WAIT)
        transcript = np.concatenate([p1, np.asarray(t1, np.int64), p2])
        assert t1 == _solo(m, p1, 5)
        assert t2 == _solo(m, transcript, 5)
        assert eng.stats()["resumed"] == 1
        # a session on an engine with no tier is carried and ignored
        plain = _engine(m, slots=1, name="spec-plain")
        assert plain.submit_prefilled(h, max_new=2,
                                      session="y").result(WAIT) == t1[:2]
        plain.stop(timeout=WAIT)
    finally:
        pre.stop(drain=False)
        eng.stop(drain=False, timeout=WAIT)


# ---------------------------------------------------------------------------
# the prefill engine's pool, the registry, /healthz and the disagg router
# ---------------------------------------------------------------------------
def test_prefill_engine_prefix_pool(m):
    """Cold, delta and full-hit handoffs of a pooled prefill replica carry
    the cold handoff's first token and rows; adopted, they stream the
    solo tokens. reuse_info()["prefix_pool"] is the pool's stats."""
    pool = PrefixPool(prefix_lens=(16,), name="pre-pool")
    pre = PrefillEngine(m["cfg"], m["params"], cache_len=CACHE_LEN,
                        prompt_buckets=(8, 16, 32), wire_dtype="fp32",
                        place=CPU, name="pre-pool", prefix_pool=pool)
    cold = PrefillEngine(m["cfg"], m["params"], cache_len=CACHE_LEN,
                         prompt_buckets=(8, 16, 32), wire_dtype="fp32",
                         place=CPU, name="pre-cold")
    eng = _engine(m, name="pre-adopt")
    head = _prompt(16, seed=3)
    pa = np.concatenate([head, _prompt(4, seed=5)])
    pb = np.concatenate([head, _prompt(8, seed=6)])
    try:
        report = pre.warmup()
        assert [r["program"] for r in report] == \
            ["prefill"] * 3 + ["delta_prefill"] * 3
        for p in (pa, pb, pa):
            h = pre.prefill(p, timeout=WAIT)
            c = cold.prefill(p, timeout=WAIT)
            assert h.next_token == c.next_token
            assert h.plen == c.plen == len(p)
            for a, w in zip(h.dense(), c.dense()):
                assert float(np.abs(a - w).max()) <= OUT_TOL * float(
                    np.abs(w).max())
            assert eng.submit_prefilled(h, max_new=6).result(WAIT) == \
                _solo(m, p, 6)
        st = pre.stats()
        assert (st["prefills"], st["delta_prefills"],
                st["prefix_full_hits"]) == (3, 1, 1), st
        info = pre.reuse_info()
        assert info["prefix_pool"] == pool.stats()
        assert info["prefill_rows_saved"] == 16 + 20
        assert info["prefill_rows_computed"] == 32 + 8
    finally:
        pre.stop(drain=False)
        cold.stop(drain=False)
        eng.stop(drain=False, timeout=WAIT)


def test_registry_reuse_block_healthz_and_disagg_router(m):
    """/healthz reaches reuse_info(): draft attachment, pool and tier
    stats and the prefill-rows ledger ride the registry doc, equal to the
    JAX package's for the same attachments; DisaggRouter.reuse_info sums
    a pooled prefill replica's."""
    def attachments(pkg, dcfg, dscope):
        return dict(prefix_pool=pkg.PrefixPool(name="r-pool"),
                    session_tier=pkg.SessionTier(name="r-tier"),
                    draft=pkg.DraftModel(dcfg, dscope, k=2, name="d-reg"))

    kw = dict(slots=2, cache_len=CACHE_LEN, prompt_buckets=(8, 16, 32),
              name="spec-reg", auto_start=False)
    peng = DecodeEngine(m["cfg"], m["params"], place=CPU,
                        **attachments(serving, m["dcfg"], m["dparams"]),
                        **kw)
    jeng = jserving.DecodeEngine(
        m["jcfg"], m["scope"],
        **attachments(jserving, m["jdcfg"], m["dscope"]), **kw)
    reg = ModelRegistry()
    reg.publish("gpt-spec", peng)
    jreg = jserving.ModelRegistry()
    jreg.publish("gpt-spec", jeng)
    srv = serving.ServingServer(reg).start()
    try:
        doc = reg.info()["gpt-spec"]
        assert doc["reuse"] == jreg.info()["gpt-spec"]["reuse"]
        assert doc["reuse"]["draft"]["k"] == 2
        assert doc["reuse"]["prefix_pool"]["entries"] == 0
        assert doc["reuse"]["session_tier"]["sessions"] == 0
        assert doc["reuse"]["prefill_rows_computed"] == 0
        with urllib.request.urlopen(srv.url + "/healthz",
                                    timeout=WAIT) as r:
            health = json.loads(r.read())
        assert health["models"]["gpt-spec"]["reuse"] == doc["reuse"]
    finally:
        srv.stop(close_registry=True)
        jeng.stop(drain=False)

    pool = PrefixPool(prefix_lens=(16,), name="fleet-pool")
    pre = PrefillEngine(m["cfg"], m["params"], cache_len=CACHE_LEN,
                        prompt_buckets=(8, 16, 32), wire_dtype="fp32",
                        place=CPU, name="d-pre", prefix_pool=pool)
    dec = DecodeEngine(m["cfg"], m["params"], slots=2, cache_len=CACHE_LEN,
                       prompt_buckets=(8, 16, 32), role="decode", place=CPU,
                       name="d-dec")
    from paddle_tpu_torch.parallel.elastic import ElasticConfig, InMemoryStore
    store = InMemoryStore()
    config = ElasticConfig(heartbeat_interval=0.05)
    router = DisaggRouter(
        [DisaggReplica(0, pre, store, name="gpt", config=config)],
        [DisaggReplica(1, dec, store, name="gpt", config=config)],
        store=store, name="gpt", config=config, request_timeout_s=WAIT)
    try:
        head = _prompt(16, seed=3)
        for tail in (4, 8):
            p = np.concatenate([head, _prompt(tail, seed=tail)])
            assert router.submit(p, max_new=4).result(WAIT) == \
                _solo(m, p, 4)
        info = router.reuse_info()
        assert info["replicas"][0]["prefix_pool"] == pool.stats()
        assert info["prefill_rows_saved"] == 16
        assert info["prefill_rows_computed"] == 32 + 8
        assert info["prefill_rows_saved_pct"] == pytest.approx(
            100.0 * 16 / (16 + 40))
    finally:
        router.stop(drain=False)


# ---------------------------------------------------------------------------
# bench.py:1472's lane at gpt_tiny
# ---------------------------------------------------------------------------
def test_bench_spec_lane_three_legs(m):
    """_measure_spec_serving's three legs through the port: 12 clients of
    a shared 24-token prompt + unique 4-8 token tails, 12 new tokens, 2
    slots; leg 2 (PrefixPool(prefix_lens=(24,)) + DraftModel(k=4)) saves
    more than half the prefill rows and equals leg 1 bit for bit (and the
    JAX package's solo tokens); leg 3 resumes 6 two-turn conversations on
    2 slots, each turn 2 equal to a cold replay of its transcript."""
    clients, max_new, shared_len = 12, 12, 24
    kw = dict(slots=2, cache_len=CACHE_LEN, prompt_buckets=(8, 32),
              queue_capacity=256, place=CPU)
    rng = np.random.default_rng(0)
    shared = rng.integers(1, VOCAB, shared_len).astype("int64")
    prompts = [np.concatenate([shared, rng.integers(
        1, VOCAB, 4 + (c % 5)).astype("int64")]) for c in range(clients)]

    def drive(eng):
        handles = [eng.submit(p, max_new=max_new) for p in prompts]
        return [h.result(WAIT) for h in handles]

    base = DecodeEngine(m["cfg"], m["params"], name="spec-base", **kw)
    try:
        ref = drive(base)
    finally:
        base.stop(timeout=WAIT)
    for p, toks in zip(prompts[:3], ref):
        assert toks == _solo(m, p, max_new)
    reuse = DecodeEngine(
        m["cfg"], m["params"], name="spec-reuse",
        draft=DraftModel(m["dcfg"], m["dparams"], k=4, name="spec-draft"),
        prefix_pool=PrefixPool(prefix_lens=(shared_len,), name="spec-bench"),
        **kw)
    try:
        assert drive(reuse) == ref      # seeds the pool
        assert drive(reuse) == ref      # full hits
        info = reuse.reuse_info()
        st = reuse.stats()
    finally:
        reuse.stop(timeout=WAIT)
    assert info["prefill_rows_saved_pct"] > 50.0, info
    assert st["spec_rounds"] > 0 and st["delta_prefills"] == clients - 1
    assert st["prefix_full_hits"] == clients

    n_sessions = 6
    tier = SessionTier(wire_dtype="fp32", name="spec-bench")
    sess = DecodeEngine(m["cfg"], m["params"], name="spec-sess",
                        session_tier=tier, **kw)
    turn1 = {c: prompts[c][:6 + (c % 3)] for c in range(n_sessions)}
    turn2 = {c: rng.integers(1, VOCAB, 4).astype("int64")
             for c in range(n_sessions)}
    try:
        first = {c: sess.submit(turn1[c], max_new=6,
                                session="conv%d" % c).result(WAIT)
                 for c in range(n_sessions)}
        second = {c: sess.submit(turn2[c], max_new=6,
                                 session="conv%d" % c).result(WAIT)
                  for c in range(n_sessions)}
        sst = sess.stats()
    finally:
        sess.stop(timeout=WAIT)
    assert sst["resumed"] == n_sessions, sst
    assert tier.stats()["sessions"] == n_sessions
    cold = DecodeEngine(m["cfg"], m["params"], name="spec-cold", **kw)
    try:
        for c in range(n_sessions):
            transcript = np.concatenate(
                [turn1[c], np.asarray(first[c], np.int64), turn2[c]])
            assert cold.generate(transcript, max_new=6,
                                 timeout=WAIT) == second[c], c
    finally:
        cold.stop(timeout=WAIT)
