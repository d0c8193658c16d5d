"""The port's DecodeEngine on the CPU, against the JAX package.

Setup: gpt_tiny (vocab 97, max_len 256) trained 30 Adam steps in the JAX
package (seed 7), as tests/test_decode_serving.py trains it, carried
across by name; the port's engine on ``CPUPlace()`` with 2 slots,
cache_len 64 and one prompt bucket of 8.

Exactness bar: every token streamed out of the engine — mixed prompt
lengths sharing one slot batch, requests admitted into freed slots
mid-generation — must equal the JAX package's solo ``build_gpt_generate``
greedy tokens of the same prompt. Then the engine's semantics as
tests/test_decode_serving.py holds them (EOS, in-flight admission,
deadlines, shedding, validation, cancel), ``barrier=True`` scheduling, the
parts left for later slices, and one device copy of the parameters for
every program. The HBM budget and the compile cache are not ported; HTTP
and the registry are held in tests/test_torch_http.py, the engine's
telemetry in tests/test_torch_observability.py. Every blocking wait has
its own timeout.
"""
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.models import gpt as jgpt
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import (
    DeadlineExceededError, DecodeEngine, EngineClosedError, ShedError,
    default_prompt_buckets, kv_slot_bytes,
)

VOCAB, MAX_LEN = 97, 256
WAIT = 60.0          # seconds: the bound of every blocking wait


@pytest.fixture(scope="module")
def m():
    """The JAX-trained tiny GPT, its executor and scope (for the solo
    reference), its parameters as numpy, and a 2-slot port engine."""
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
    pcfg = gpt.gpt_tiny(vocab=VOCAB, max_len=MAX_LEN)
    eng = DecodeEngine(pcfg, params, slots=2, cache_len=64,
                       prompt_buckets=(8,), name="gpt-dec",
                       queue_capacity=64, place=fluid.CPUPlace())
    state = {"jcfg": cfg, "cfg": pcfg, "exe": exe, "scope": scope,
             "params": params, "eng": eng, "solo": {}}
    yield state
    eng.stop(drain=False, timeout=WAIT)


def _engine(m, **kw):
    kw.setdefault("prompt_buckets", (8,))
    kw.setdefault("place", fluid.CPUPlace())
    return DecodeEngine(m["cfg"], m["params"], **kw)


def _solo(m, prompt, n_new):
    """Reference: the JAX package's solo build_gpt_generate greedy tokens
    for `prompt` (memoised per prompt and length)."""
    key = (tuple(int(t) for t in prompt), n_new)
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


def _wait_for(cond, timeout=WAIT):
    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.01)
    return cond()


# ---------------------------------------------------------------------------
# continuous batching against the JAX package
# ---------------------------------------------------------------------------
def test_mixed_concurrent_streams_match_jax_solo_generate(m):
    """6 concurrent clients, prompt lengths 3/6/8 interleaved through 2
    slots, streamed token by token: every stream must equal the JAX
    package's solo generate of its prompt, token for token."""
    lens = (3, 6, 8)
    n_new = 12
    results, errors = {}, []

    def client(cid):
        plen = lens[cid % len(lens)]
        try:
            h = m["eng"].submit(_prompt(plen), max_new=n_new)
            toks = list(h.tokens(timeout=WAIT))
            assert h.finish_reason == "length"
            assert h.result(WAIT) == toks
            results[cid] = (plen, toks)
        except Exception as e:  # noqa: BLE001
            errors.append((cid, repr(e)))

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * WAIT)
        assert not t.is_alive()
    assert not errors, errors
    assert len(results) == 6
    for cid, (plen, toks) in results.items():
        assert toks == _solo(m, _prompt(plen), n_new), (cid, plen)


def test_eos_retires_slot_same_step(m):
    """A sequence hitting EOS frees its slot the step the token is
    emitted — the EOS token itself is delivered, then the stream ends."""
    eng = m["eng"]
    p = _prompt(6)
    first = eng.generate(p, max_new=4, timeout=WAIT)[0]
    h = eng.submit(p, max_new=8, eos_id=int(first))
    assert h.result(WAIT) == [first]
    assert h.finish_reason == "eos"
    assert _wait_for(lambda: eng.stats()["live_slots"] == 0)


def test_queued_request_admitted_in_flight_no_barrier(m):
    """With both slots busy, a queued request is prefilled into the FIRST
    freed slot while the other slot is still mid-generation — no
    full-batch barrier — and every result equals the JAX solo run."""
    eng = _engine(m, slots=2, cache_len=64, name="gpt-inflight",
                  auto_start=False)
    p_long, p_a, p_b = _prompt(8), _prompt(3), _prompt(6)
    h_long = eng.submit(p_long, max_new=50)   # holds a slot ~50 steps
    h_a = eng.submit(p_a, max_new=3)          # second slot, retires fast
    h_b = eng.submit(p_b, max_new=3)          # queued behind both
    eng.start()
    try:
        out_b = h_b.result(WAIT)
        # b finished while the long request was STILL generating
        assert not h_long.done
        assert out_b == _solo(m, p_b, 3)
        assert h_a.result(WAIT) == _solo(m, p_a, 3)
        assert h_long.result(WAIT) == _solo(m, p_long, 50)
    finally:
        eng.stop(drain=False, timeout=WAIT)


def test_barrier_mode_waits_for_every_slot(m):
    """``barrier=True``: a queued request is admitted only once EVERY slot
    has retired, so the short request's freed slot stays empty until the
    long one ends; the tokens are the same."""
    eng = _engine(m, slots=2, cache_len=128, name="gpt-barrier",
                  barrier=True, auto_start=False)
    p_long, p_a, p_b = _prompt(8), _prompt(3), _prompt(6)
    h_long = eng.submit(p_long, max_new=100)
    h_a = eng.submit(p_a, max_new=3)
    h_b = eng.submit(p_b, max_new=3)
    eng.start()
    try:
        assert h_a.result(WAIT) == _solo(m, p_a, 3)
        # while the long stream runs, b gets no token (read b first: if
        # long is not done after, it was not done before either)
        checks = 0
        while True:
            b_tokens = h_b.so_far()
            if h_long.done:
                break
            assert b_tokens == []
            checks += 1
            time.sleep(0.001)
        assert checks > 0
        assert h_long.result(WAIT) == _solo(m, p_long, 100)
        assert h_b.result(WAIT) == _solo(m, p_b, 3)
        assert eng.stats()["prefills"] == 3
    finally:
        eng.stop(drain=False, timeout=WAIT)


def test_deadline_expired_queued_request_shed_before_prefill(m):
    eng = _engine(m, slots=1, cache_len=24, name="gpt-deadline",
                  auto_start=False)
    ok = eng.submit(_prompt(4), max_new=3)
    doomed = eng.submit(_prompt(5), max_new=3, deadline_ms=1)
    time.sleep(0.05)  # let the deadline lapse while still queued
    eng.start()
    try:
        assert ok.result(WAIT) == _solo(m, _prompt(4), 3)
        with pytest.raises(DeadlineExceededError):
            doomed.result(WAIT)
        st = eng.stats()
        assert st["deadline_miss"] == 1
        assert st["prefills"] == 1  # the doomed request never took a slot
    finally:
        eng.stop(timeout=WAIT)


def test_queue_full_sheds_with_retry_after(m):
    eng = _engine(m, slots=1, cache_len=24, name="gpt-shed",
                  queue_capacity=1, auto_start=False)
    eng.submit(_prompt(4), max_new=2)
    with pytest.raises(ShedError) as e:
        eng.submit(_prompt(4), max_new=2)
    assert e.value.retry_after is not None
    assert eng.stats()["shed"] == 1
    eng.stop(drain=False, timeout=WAIT)
    assert eng.closed
    with pytest.raises(EngineClosedError):
        eng.submit(_prompt(4), max_new=2)


def test_submit_validation(m):
    eng = m["eng"]
    with pytest.raises(ValueError, match="prompt bucket"):
        eng.submit(_prompt(9), max_new=2)   # largest bucket is 8
    with pytest.raises(ValueError, match="cache_len"):
        eng.submit(_prompt(8), max_new=64)  # 8 + 64 - 1 > 64
    with pytest.raises(ValueError, match="range"):
        eng.submit([0, 1, 200], max_new=2)  # vocab is 97
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], max_new=2)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(_prompt(3), max_new=0)


def test_stream_cancel_frees_slot(m):
    eng = m["eng"]
    h = eng.submit(_prompt(4), max_new=50)
    for _ in h.tokens(timeout=WAIT):
        h.cancel()
        break
    assert _wait_for(lambda: h.done)
    assert h.finish_reason == "cancelled"
    assert len(h.so_far()) < 50
    assert _wait_for(lambda: eng.stats()["live_slots"] == 0)


def test_stop_drains_or_aborts(m):
    eng = _engine(m, slots=1, cache_len=24, name="gpt-stop",
                  auto_start=False)
    a = eng.submit(_prompt(4), max_new=5)
    b = eng.submit(_prompt(5), max_new=5)
    eng.start()
    eng.stop(drain=True, timeout=WAIT)      # finishes both
    assert a.result(WAIT) == _solo(m, _prompt(4), 5)
    assert b.result(WAIT) == _solo(m, _prompt(5), 5)
    eng2 = _engine(m, slots=1, cache_len=24, name="gpt-abort",
                   auto_start=False)
    c = eng2.submit(_prompt(4), max_new=5)
    eng2.stop(drain=False, timeout=WAIT)
    with pytest.raises(EngineClosedError):
        c.result(WAIT)


# ---------------------------------------------------------------------------
# construction, sharing, what waits for later slices
# ---------------------------------------------------------------------------
def test_programs_share_one_device_copy_of_the_params(m):
    eng = m["eng"]
    preds = [eng._step_pred] + list(eng._prefill_preds.values())
    for pred in preds:
        for n, t in pred._state.items():
            assert t is eng._params[n], n
    # a snapshot: the caller's arrays are not aliased
    name = "gpt_tok_emb"
    assert not np.shares_memory(eng._params[name].numpy(),
                                m["params"][name])


def test_from_dir_loads_a_saved_jax_model(m, tmp_path):
    np.savez(str(tmp_path / "__params__.npz"), **m["params"])
    eng = DecodeEngine.from_dir(m["cfg"], str(tmp_path), slots=1,
                                cache_len=24, prompt_buckets=(8,),
                                place=fluid.CPUPlace(), name="gpt-dir")
    try:
        assert eng.generate(_prompt(6), max_new=4, timeout=WAIT) == \
            _solo(m, _prompt(6), 4)
    finally:
        eng.stop(timeout=WAIT)
    with pytest.raises(FileNotFoundError):
        DecodeEngine.from_dir(m["cfg"], str(tmp_path / "none"))


def test_missing_param_names_it(m):
    params = dict(m["params"])
    del params["gpt_out.w"]
    with pytest.raises(KeyError, match="gpt_out.w"):
        DecodeEngine(m["cfg"], params, place=fluid.CPUPlace(),
                     auto_start=False)


def test_warmup_runs_each_program_and_leaves_the_slots(m):
    eng = _engine(m, slots=2, cache_len=24, prompt_buckets=(4, 8),
                  name="gpt-warm", auto_start=False)
    report = eng.warmup()
    assert [(r["program"], r.get("bucket")) for r in report] == [
        ("step", None), ("prefill", 4), ("prefill", 8)]
    assert not eng._k.any() and not eng._v.any()
    assert eng.stats()["steps"] == 0
    eng.stop(timeout=WAIT)


def test_slot_geometry_and_stats(m):
    eng = m["eng"]
    cfg = m["cfg"]
    assert eng.slot_bytes() == kv_slot_bytes(cfg, 64) == \
        2 * cfg.num_layers * 64 * cfg.hidden * 4
    assert kv_slot_bytes(gpt.GPTConfig(), 1024) == 75497472
    assert eng._k.shape == (2, cfg.num_layers, 64, cfg.hidden)
    assert default_prompt_buckets(1024) == (
        8, 16, 32, 64, 128, 256, 512, 1024)
    assert default_prompt_buckets(5) == (5,)
    st = eng.stats()
    for k in ("requests", "tokens", "prefills", "steps", "retired",
              "shed", "deadline_miss", "cancelled"):
        assert k in st
    assert st["slots"] == 2 and st["kv_dtype"] == "fp32"
    assert eng.queue_depth() == 0
    assert 1.0 <= eng.retry_after_hint() <= 60.0


@pytest.mark.parametrize("kw,item", [
    ({"kv_dtype": "int8"}, "7.3"),
    ({"role": "decode"}, "7.3"),
    ({"draft": object()}, "7.4"),
    ({"prefix_pool": object()}, "7.4"),
    ({"session_tier": object()}, "7.4"),
    ({"session": "chat-1"}, "7.4"),
])
def test_later_options_raise(m, kw, item):
    with pytest.raises(NotImplementedError, match="item %s" % item):
        if "session" in kw:     # a submit option, not an engine one
            m["eng"].submit(_prompt(3), max_new=1, **kw)
        else:
            _engine(m, auto_start=False, **kw)


@pytest.mark.parametrize("call,item", [
    (lambda e: e.submit_prefilled(None), "7.3"),
    (lambda e: e.attach_sentinel(None), "11"),
    (lambda e: e.check_hbm_budget(), "11"),
    (lambda e: e.check_ladder(), "11"),
    (lambda e: e.warmup(check_hbm=True), "11"),
])
def test_later_methods_raise(m, call, item):
    with pytest.raises(NotImplementedError, match="item %s" % item):
        call(m["eng"])


def test_bad_options_raise(m):
    with pytest.raises(ValueError, match="kv_dtype"):
        _engine(m, kv_dtype="fp16", auto_start=False)
    with pytest.raises(ValueError, match="role"):
        _engine(m, role="prefill", auto_start=False)
    with pytest.raises(ValueError, match="cache_len"):
        _engine(m, cache_len=8, prompt_buckets=(16,), auto_start=False)


def test_runs_on_the_card_unless_told(m, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        DecodeEngine(m["cfg"], m["params"], auto_start=False)
