"""The port's disaggregated serving on the CPU, against the JAX package:
the three ops the int8 step adds, the block codec and the KV handoff
wire, the int8-resident step program, the PrefillEngine, the decode
engine's adoption and roles, and the DisaggRouter fleet.

Setup: gpt_tiny (vocab 97, max_len 256) trained 30 Adam steps in the JAX
package (seed 7), as tests/test_disagg_serving.py trains it, carried
across by name; every port engine runs on ``CPUPlace()``.

Exactness bars:

- the codec and the wire are bit for bit the JAX package's: the same
  numpy cache gives the same int8 payloads, fp32 scales and digest, and
  a handoff sealed by either package verifies and decodes in the other;
- with the lossless ``wire_dtype="fp32"`` handoff and fp32-resident
  decode replicas, every token a port fleet streams — migrated streams
  included — equals the JAX package's solo ``build_gpt_generate``;
- the int8 wire and int8 residency get the reference's bounds (scale/2
  per row; the first token exact), and the int8 step program is held
  to the JAX step on the same inputs: next tokens equal, payloads off by
  at most 1 on at most 1e-4 of the elements, scales within 1e-6
  relative (the two packages' f32 projections differ in the last bits,
  which can move a value across a rounding boundary).

Every blocking wait has its own timeout; the chaos kill is gated on
tokens already delivered, not on a sleep.
"""
import json
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
from paddle_tpu.ops.registry import get_lowering as jax_lowering
from paddle_tpu.parallel.comms import quantize as JQ
from paddle_tpu.serving.disagg import kv_wire as jwire
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch import serving
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.inference import Predictor
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.fluid.resilience import FaultInjector
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.ops.registry import LowerContext
from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering
from paddle_tpu_torch.parallel.comms import quantize as PQ
from paddle_tpu_torch.serving import (
    DeadlineExceededError, DecodeEngine, EngineClosedError, ModelRegistry,
    ServingServer, ShedError, kv_slot_bytes,
)
from paddle_tpu_torch.serving.disagg import (
    KVHandoff, PrefillEngine, TenantSpec, TenantTable, dequantize_rows,
    disagg_fleet, encode_kv, handoff_compression, handoff_wire_bytes,
    kv_wire, quantize_rows,
)

VOCAB, MAX_LEN = 97, 256
CPU = fluid.CPUPlace()
WAIT = 120.0         # seconds: the bound of every blocking wait


@pytest.fixture(scope="module")
def m():
    """The JAX-trained tiny GPT: its executor and scope (for the solo
    reference) and its parameters as numpy (for the port's engines)."""
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
    return {"jcfg": cfg, "cfg": gpt.gpt_tiny(vocab=VOCAB, max_len=MAX_LEN),
            "exe": exe, "scope": scope, "params": params, "ref": {}}


@pytest.fixture(autouse=True)
def _reset():
    """The hub and the fault injector are process-global."""
    obs.reset()
    FaultInjector.uninstall()
    yield
    FaultInjector.uninstall()


def _solo(m, prompt, n_new):
    """Reference: the JAX package's solo build_gpt_generate greedy tokens
    for `prompt` (memoised per prompt and length)."""
    key = (tuple(int(t) for t in prompt), int(n_new))
    if key not in m["ref"]:
        g_prog, g_st = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(g_prog, g_st), jax_unique_name.guard():
            gen = jgpt.build_gpt_generate(m["jcfg"], len(prompt), n_new,
                                          mode="greedy")
        out = np.asarray(m["exe"].run(
            g_prog, feed={"gpt_prompt": np.asarray(prompt).reshape(1, -1)},
            fetch_list=[gen["ids"]], scope=m["scope"])[0])
        m["ref"][key] = [int(t) for t in out[0, len(prompt) - 1:]]
    return m["ref"][key]


def _prompt(n, seed=11):
    rng = np.random.default_rng(seed + n)
    return rng.integers(1, VOCAB, n).astype("int64")


def _prefill(m, **kw):
    kw.setdefault("cache_len", 64)
    kw.setdefault("prompt_buckets", (8,))
    kw.setdefault("place", CPU)
    return PrefillEngine(m["cfg"], m["params"], **kw)


def _engine(m, **kw):
    kw.setdefault("cache_len", 64)
    kw.setdefault("prompt_buckets", (8,))
    kw.setdefault("place", CPU)
    return DecodeEngine(m["cfg"], m["params"], **kw)


def _fleet(m, **kw):
    kw.setdefault("cache_len", 64)
    kw.setdefault("place", CPU)
    return disagg_fleet(m["cfg"], m["params"], **kw)


# ---------------------------------------------------------------------------
# the three ops of the int8 step, against the JAX lowerings
# ---------------------------------------------------------------------------

def _run_both(op_type, x, attrs):
    pt = pt_lowering(op_type)(
        LowerContext(torch.device("cpu"), generator=torch.Generator()),
        {"X": [torch.from_numpy(np.ascontiguousarray(x))]}, dict(attrs))
    jx = jax_lowering(op_type)(
        JaxLowerContext(rng=jax.random.PRNGKey(0), platform="cpu"),
        {"X": [jnp.asarray(x)]}, dict(attrs))
    return pt["Out"][0].numpy(), np.asarray(jx["Out"][0])


@pytest.mark.parametrize("attrs", [
    {"dim": [3], "keep_dim": True, "reduce_all": False},
    {"dim": [-1], "keep_dim": False, "reduce_all": False},
    {"dim": [0, 2], "keep_dim": True, "reduce_all": False},
    {"dim": None, "keep_dim": False, "reduce_all": True},
    {"dim": None, "keep_dim": True, "reduce_all": True},
])
def test_reduce_max_matches_jax(attrs):
    x = np.random.default_rng(0).normal(size=(2, 3, 4, 5)).astype(np.float32)
    got, want = _run_both("reduce_max", x, attrs)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_abs_matches_jax():
    x = np.random.default_rng(1).normal(size=(3, 7)).astype(np.float32)
    x[0, :3] = [-0.0, 0.0, -np.inf]
    got, want = _run_both("abs", x, {})
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_round_is_half_even_bit_for_bit():
    halves = np.arange(-8, 8, dtype=np.float32) + 0.5
    x = np.concatenate([
        halves, np.nextafter(halves, np.float32(np.inf)),
        np.nextafter(halves, np.float32(-np.inf)),
        np.float32([-0.0, 0.0, 126.5, -126.5, 1e9, -2.4999998]),
        np.random.default_rng(2).normal(size=64).astype(np.float32) * 200,
    ]).astype(np.float32)
    got, want = _run_both("round", x, {})
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    assert got[:16].tolist() == [-8, -6, -6, -4, -4, -2, -2, 0, 0, 2, 2, 4,
                                 4, 6, 6, 8]


@pytest.mark.parametrize("layer", ["reduce_max", "abs", "round"])
def test_op_layers_program_parity(layer):
    def build(fl, un):
        un.switch()
        main, start = fl.Program(), fl.Program()
        with fl.program_guard(main, start):
            x = fl.data("x", shape=[None, 4, 8], dtype="float32")
            if layer == "reduce_max":
                fl.layers.reduce_max(x, dim=2, keep_dim=True)
            else:
                getattr(fl.layers, layer)(x)
        return json.loads(main.to_json())

    assert build(fluid, pt_unique_name) == build(jfluid, jax_unique_name)


# ---------------------------------------------------------------------------
# the codec and the KV wire, bit for bit against the JAX package
# ---------------------------------------------------------------------------

def _cache(seed, shape=(2, 16, 32)):
    rng = np.random.default_rng(seed)
    # rows of wildly different magnitudes, and some all-zero rows
    mag = np.exp(rng.uniform(-4.0, 4.0, shape[:-1] + (1,)))
    cache = (rng.standard_normal(shape) * mag).astype(np.float32)
    cache[:, -3:] = 0.0
    return cache


@pytest.mark.parametrize("wire_dtype", ["int8", "fp8_e4m3"])
def test_quantize_blocks_bit_for_bit(wire_dtype):
    flat = _cache(0).reshape(-1)
    pp, ps = PQ.quantize_blocks(flat, block_size=32, wire_dtype=wire_dtype)
    jp, js = JQ.quantize_blocks(flat, block_size=32, wire_dtype=wire_dtype)
    assert ps.numpy().tobytes() == np.asarray(js).tobytes()
    if wire_dtype == "int8":
        assert pp.numpy().tobytes() == np.asarray(jp).tobytes()
    else:
        np.testing.assert_array_equal(pp.float().numpy(),
                                      np.asarray(jp).astype(np.float32))
    np.testing.assert_array_equal(
        PQ.dequantize_blocks(pp, ps, 32).numpy(),
        np.asarray(JQ.dequantize_blocks(jp, js, 32)))
    assert PQ.wire_bytes(flat.size, 32, wire_dtype) == JQ.wire_bytes(
        flat.size, 32, wire_dtype)
    assert PQ.compression_ratio(4096) == JQ.compression_ratio(4096)
    padded, n = PQ.pad_flat(flat[:50], 32)
    assert n == 50 and padded.shape[0] == 64 and not padded[50:].any()


def test_quantize_rows_bit_for_bit_and_idempotent():
    cache = _cache(1, (3, 24, 48))
    payload, scales = quantize_rows(cache)
    jp, js = jwire.quantize_rows(cache)
    assert payload.dtype == np.int8 and scales.dtype == np.float32
    assert payload.tobytes() == np.asarray(jp).tobytes()
    assert scales.tobytes() == np.asarray(js).tobytes()
    dec = dequantize_rows(payload, scales)
    assert dec.tobytes() == np.asarray(jwire.dequantize_rows(jp, js)).tobytes()
    assert (np.abs(dec - cache) <= scales * 0.5 + 1e-7).all()
    # re-encoding the decoded cache is a fixed point (the int8-resident
    # step requantizes untouched rows every step on this)
    p2, s2 = quantize_rows(dec)
    assert (p2 == payload).all()
    np.testing.assert_allclose(s2, scales, rtol=1e-6, atol=0.0)
    # all-zero rows: the clamp keeps the scale finite, decode stays 0
    assert (payload[:, -3:] == 0).all() and (scales > 0).all()
    assert (dec[:, -3:] == 0).all()


@pytest.mark.parametrize("wire_dtype", ["int8", "fp32"])
@pytest.mark.parametrize("sealer", ["port", "jax"])
def test_handoff_crosses_packages(wire_dtype, sealer):
    """A handoff sealed by one package verifies and decodes in the other:
    the same wire doc, the same digest, the same dense cache."""
    k, v = _cache(2), _cache(3)
    prompt = _prompt(5)
    mine = encode_kv(k, v, 42, 5, prompt, wire_dtype=wire_dtype)
    theirs = jwire.encode_kv(k, v, 42, 5, prompt, wire_dtype=wire_dtype)
    assert mine.digest == theirs.digest
    assert mine.to_wire() == theirs.to_wire()
    src = mine if sealer == "port" else theirs
    dst_cls = jwire.KVHandoff if sealer == "port" else KVHandoff
    got = dst_cls.from_wire(src.to_wire())
    got.verify()
    assert got.digest == src.digest == got.content_digest()
    for a, b in zip(got.dense(), src.dense()):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
    assert got.wire_bytes() == src.wire_bytes()
    # a flipped payload bit no longer verifies, on either side
    doc = src.to_wire()
    raw = bytearray(doc["k"])
    raw[len(raw) // 2] ^= 1
    doc["k"] = bytes(raw)
    for cls in (KVHandoff, jwire.KVHandoff):
        with pytest.raises(IOError, match="digest mismatch"):
            cls.from_wire(doc).verify()


def test_kv_handoff_serialization_and_compression():
    L, T, H = 2, 16, 32
    k, v = _cache(4, (L, T, H)), _cache(5, (L, T, H))
    prompt = _prompt(5)
    h = encode_kv(torch.from_numpy(k), torch.from_numpy(v), 42, 5, prompt)
    assert h.shape == (L, T, H) and h.next_token == 42 and h.plen == 5
    h2 = KVHandoff.from_wire(h.to_wire())
    assert (h2.k == h.k).all() and (h2.v_scales == h.v_scales).all()
    assert (h2.prompt == prompt).all()
    assert (h2.next_token, h2.plen, h2.wire_dtype) == (42, 5, "int8")
    hf = encode_kv(k, v, 42, 5, prompt, wire_dtype="fp32")
    kd, vd = hf.dense()
    assert (kd == k).all() and (vd == v).all() and hf.k_scales is None
    assert handoff_compression(L, T, H, "int8") > 3.0
    assert hf.wire_bytes() > 3.0 * h.wire_bytes()
    for args in ((12, 1024, 768, "int8"), (2, 16, 32, "fp32")):
        assert handoff_wire_bytes(*args) == jwire.handoff_wire_bytes(*args)
        assert handoff_compression(*args) == jwire.handoff_compression(
            *args)
    # ~3.9x at GPT-2 small width, as the issue's numbers say
    assert 3.9 < handoff_compression(12, 1024, 768) < 4.0
    assert handoff_wire_bytes(12, 1024, 768) == 2 * (12 * 1024 * 768
                                                     + 12 * 1024 * 4)
    # fp8 rides the same codec; its payload travels as e4m3 bits
    h8 = KVHandoff.from_wire(encode_kv(k, v, 1, 5, prompt,
                                       wire_dtype="fp8_e4m3").to_wire())
    h8.verify()
    assert h8.k.dtype == np.uint8
    kd8, _ = h8.dense()
    assert (np.abs(kd8 - k) <= np.abs(k) / 8 + h8.k_scales).all()
    with pytest.raises(ValueError, match="batch"):
        encode_kv(np.zeros((2, L, T, H), np.float32),
                  np.zeros((2, L, T, H), np.float32), 0, 1, [1])


# ---------------------------------------------------------------------------
# the int8-resident step program against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg_name", ["gpt_tiny", "GPTConfig"])
def test_decode_step_q_program_parity(cfg_name):
    def build(fl, g, un):
        un.switch()
        main, start = fl.Program(), fl.Program()
        with fl.program_guard(main, start):
            g.build_gpt_decode_step_q(getattr(g, cfg_name)(), 64)
        return json.loads(main.to_json()), json.loads(start.to_json())

    assert build(fluid, gpt, pt_unique_name) == build(
        jfluid, jgpt, jax_unique_name)


def test_int8_steps_match_jax(m):
    """Five int8-resident steps of 4 slots (one dead at 0), each step's
    inputs the JAX package's outputs of the step before."""
    cache_len, bucket = 64, 8

    def jprog(builder, *args):
        main, start = jfluid.Program(), jfluid.Program()
        with jfluid.program_guard(main, start), jax_unique_name.guard():
            vs = builder(m["jcfg"], *args)
        return main, vs

    jpre, jpv = jprog(jgpt.build_gpt_prefill, bucket, cache_len)
    jstep, jsv = jprog(jgpt.build_gpt_decode_step_q, cache_len)
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        sv = gpt.build_gpt_decode_step_q(m["cfg"], cache_len)
    pred = Predictor(main, sv["feed_names"], sv["fetch_vars"],
                     scope=params_from_numpy(m["params"], "cpu"), place=CPU)
    rng = np.random.default_rng(12)
    ids = rng.integers(1, VOCAB, (4, bucket)).astype(np.int64)
    lens = rng.integers(1, bucket + 1, (4, 1)).astype(np.int64)
    lens[3, 0] = 0
    nxt, k, v = m["exe"].run(
        jpre, feed={"gpt_prefill_ids": ids,
                    "gpt_prefill_len": np.maximum(lens, 1)},
        fetch_list=[jpv["next"], jpv["k"], jpv["v"]], scope=m["scope"])
    kq, ks = jwire.quantize_rows(np.asarray(k))
    vq, vs = jwire.quantize_rows(np.asarray(v))
    tok, pos = np.asarray(nxt), lens.copy()
    off = total = 0
    for _ in range(5):
        feed = {"gpt_step_tok": tok, "gpt_step_pos": pos,
                "gpt_step_k": np.asarray(kq), "gpt_step_v": np.asarray(vq),
                "gpt_step_kscale": np.asarray(ks),
                "gpt_step_vscale": np.asarray(vs)}
        want = [np.asarray(w) for w in m["exe"].run(
            jstep, feed=feed, scope=m["scope"],
            fetch_list=jsv["fetch_vars"])]
        got = pred.run(feed)
        np.testing.assert_array_equal(got[0], want[0])
        for g, w in zip(got[1:3], want[1:3]):
            assert g.dtype == w.dtype == np.int8
            d = np.abs(g.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1
            off += int((d > 0).sum())
            total += d.size
        for g, w in zip(got[3:], want[3:]):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        tok, kq, vq, ks, vs = want[0].astype(np.int64), *want[1:]
        pos = pos + 1
        pos[3, 0] = 0
    assert off <= 1e-4 * total, (off, total)


# ---------------------------------------------------------------------------
# PrefillEngine: priority queue, deadlines, shed, handoff product
# ---------------------------------------------------------------------------

def test_prefill_priority_queue_deadline_and_shed(m):
    pre = _prefill(m, wire_dtype="int8", name="pre-prio", auto_start=False)
    t_batch = pre.submit(_prompt(4), priority=2)
    t_std = pre.submit(_prompt(5), priority=1)
    t_int = pre.submit(_prompt(6), priority=0)
    doomed = pre.submit(_prompt(7), priority=0, deadline_ms=1)
    # min-heap: the interactive request runs first despite arriving
    # third; its priority-0 peer queued later loses the FIFO tie
    assert pre._heap[0][2].ticket is t_int
    assert pre.queue_depth() == 4
    time.sleep(0.05)  # the doomed deadline lapses while still queued
    pre.start()
    h = t_int.result(WAIT)
    assert isinstance(h, KVHandoff)
    assert h.plen == 6 and h.wire_dtype == "int8"
    assert h.k_scales is not None and (h.prompt == _prompt(6)).all()
    assert h.next_token == _solo(m, _prompt(6), 1)[0]
    assert t_std.result(WAIT).plen == 5
    assert t_batch.result(WAIT).plen == 4
    with pytest.raises(DeadlineExceededError):
        doomed.result(WAIT)
    st = pre.stats()
    assert st["prefills"] == 3 and st["deadline_miss"] == 1
    assert st["prefill_rows_computed"] == 24
    assert obs.counter("serving.disagg.handoffs") == 3
    pre.stop()
    with pytest.raises(EngineClosedError):
        pre.submit(_prompt(4))

    # admission: a full queue fast-rejects with a Retry-After hint, and
    # stop(drain=False) fails still-queued tickets
    tiny = _prefill(m, queue_capacity=1, name="pre-shed", auto_start=False)
    queued = tiny.submit(_prompt(4))
    with pytest.raises(ShedError) as e:
        tiny.submit(_prompt(4))
    assert e.value.retry_after is not None
    assert tiny.stats()["shed"] == 1
    with pytest.raises(ValueError, match="prompt bucket"):
        tiny.submit(_prompt(9))
    tiny.stop(drain=False)
    with pytest.raises(EngineClosedError):
        queued.result(5.0)


def test_prefill_engine_later_parts_and_place(m, monkeypatch):
    with pytest.raises(NotImplementedError, match="item 7.4"):
        _prefill(m, prefix_pool=object(), auto_start=False)
    pre = _prefill(m, auto_start=False)
    assert [r["program"] for r in pre.warmup()] == ["prefill"]
    assert pre.reuse_info()["prefix_pool"] is None
    pre.stop()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        PrefillEngine(m["cfg"], m["params"], cache_len=64,
                      prompt_buckets=(8,), auto_start=False)
    with pytest.raises(RuntimeError, match="CPUPlace"):
        disagg_fleet(m["cfg"], m["params"], cache_len=64,
                     prompt_buckets=(8,))


# ---------------------------------------------------------------------------
# handoff adoption on a DecodeEngine
# ---------------------------------------------------------------------------

def test_fp32_handoff_adoption_bit_identical(m):
    """prefill replica -> lossless handoff -> submit_prefilled on another
    engine streams the JAX package's solo-generate tokens, with zero
    local prefills."""
    pre = _prefill(m, wire_dtype="fp32", name="pre-exact")
    eng = _engine(m, slots=2, name="gpt-adopt")
    try:
        for plen in (3, 8):
            p = _prompt(plen)
            h = pre.prefill(p, timeout=WAIT)
            toks = eng.submit_prefilled(h, max_new=8).result(WAIT)
            assert toks == _solo(m, p, 8), plen
            assert toks[0] == h.next_token
        st = eng.stats()
        assert st["adopts"] == 2 and st["prefills"] == 0
        # validation: geometry, plen range, cache fit
        L, H = m["cfg"].num_layers, m["cfg"].hidden
        small = np.zeros((L, 32, H), np.float32)
        with pytest.raises(ValueError, match="geometry"):
            eng.submit_prefilled(
                encode_kv(small, small, 1, 4, [1, 2, 3, 4],
                          wire_dtype="fp32"), max_new=2)
        full = np.zeros((L, 64, H), np.float32)
        with pytest.raises(ValueError, match="plen"):
            eng.submit_prefilled(
                encode_kv(full, full, 1, 0, [], wire_dtype="fp32"),
                max_new=2)
        with pytest.raises(ValueError, match="cache_len"):
            eng.submit_prefilled(
                encode_kv(full, full, 1, 60, _prompt(8),
                          wire_dtype="fp32"), max_new=8)
        with pytest.raises(NotImplementedError, match="item 7.4"):
            eng.submit_prefilled(h, max_new=2, session="s")
    finally:
        pre.stop(drain=False)
        eng.stop(drain=False)


def test_jax_sealed_handoff_adopts_in_the_port(m):
    """The JAX package's PrefillEngine seals a lossless handoff; it
    crosses as a wire doc and the port's decode engine adopts it."""
    from paddle_tpu.serving.disagg import PrefillEngine as JaxPrefill

    jpre = JaxPrefill(m["jcfg"], m["scope"], cache_len=64,
                      prompt_buckets=(8,), wire_dtype="fp32",
                      name="jpre")
    eng = _engine(m, slots=1, name="gpt-cross")
    try:
        p = _prompt(6)
        doc = jpre.prefill(p, timeout=WAIT).to_wire()
        toks = eng.submit_prefilled(KVHandoff.from_wire(doc),
                                    max_new=8).result(WAIT)
        assert toks == _solo(m, p, 8)
    finally:
        jpre.stop(drain=False)
        eng.stop(drain=False)


def test_int8_handoff_tolerance_and_adoption(m):
    """The int8 wire is lossy but bounded: the dequantized cache sits
    within scale/2 of the lossless handoff's, the first token (computed
    in fp32 at prefill) is exact, adoption streams a full sequence, and
    on an int8-resident engine the handoff's payload lands unchanged."""
    pre32 = _prefill(m, wire_dtype="fp32", name="pre-f32")
    pre8 = _prefill(m, wire_dtype="int8", name="pre-i8")
    eng = _engine(m, slots=1, name="gpt-adopt8")
    engq = _engine(m, slots=1, name="gpt-adoptq", kv_dtype="int8",
                   role="decode")
    try:
        p = _prompt(7)
        h32 = pre32.prefill(p, timeout=WAIT)
        h8 = pre8.prefill(p, timeout=WAIT)
        assert h8.next_token == h32.next_token == _solo(m, p, 1)[0]
        k32, _ = h32.dense()
        k8, _ = h8.dense()
        assert (np.abs(k8 - k32) <= h8.k_scales * 0.5 + 1e-7).all()
        toks = eng.submit_prefilled(h8, max_new=6).result(WAIT)
        assert len(toks) == 6 and toks[0] == h32.next_token
        assert all(0 <= t < VOCAB for t in toks)
        engq.stop(drain=True)  # park the loop: the slot stays readable
        engq._closed = False
        engq._stop_event.clear()
        engq.submit_prefilled(h8, max_new=1)
        engq._admit()
        assert (engq._k[0].numpy() == h8.k).all()
        assert (engq._kscale[0].numpy() == h8.k_scales).all()
    finally:
        for e in (pre32, pre8, eng, engq):
            e.stop(drain=False)


# ---------------------------------------------------------------------------
# int8-resident decode + phase-specialized roles
# ---------------------------------------------------------------------------

def test_int8_resident_kv_multiplies_slots(m):
    """int8 residency prices one slot at >3.5x fewer bytes than fp32
    (hidden 32; ~3.9x at GPT-2 small width), its buffers are int8 +
    per-row fp32 scales, and the engine still decodes with the first
    token exact. (The device-memory admission check waits for item
    11.)"""
    cfg = m["cfg"]
    ratio = (kv_slot_bytes(cfg, 64, "fp32")
             / float(kv_slot_bytes(cfg, 64, "int8")))
    assert 3.5 < ratio < 4.0
    full = gpt.GPTConfig()
    assert 3.9 < kv_slot_bytes(full, 1024) / float(
        kv_slot_bytes(full, 1024, "int8")) < 4.0
    with pytest.raises(ValueError, match="kv_dtype"):
        kv_slot_bytes(cfg, 64, "fp4")
    eng8 = _engine(m, slots=2, name="gpt-q", kv_dtype="int8")
    try:
        assert eng8.slot_bytes() == kv_slot_bytes(cfg, 64, "int8")
        assert eng8._k.dtype == torch.int8
        assert eng8._kscale.shape == (2, cfg.num_layers, 64, 1)
        p = _prompt(6)
        toks = eng8.generate(p, max_new=10, timeout=WAIT)
        assert toks[0] == _solo(m, p, 10)[0]
        assert len(toks) == 10 and all(0 <= t < VOCAB for t in toks)
        st = eng8.stats()
        assert st["kv_dtype"] == "int8" and st["role"] == "colocated"
        assert [r["kv_dtype"] for r in eng8.warmup()
                if r["program"] == "step"] == ["int8"]
    finally:
        eng8.stop(drain=False)


def test_decode_role_is_step_only(m):
    eng = _engine(m, slots=1, cache_len=24, role="decode",
                  name="gpt-steponly", auto_start=False)
    with pytest.raises(RuntimeError, match="submit_prefilled"):
        eng.submit(_prompt(3), max_new=2)
    assert eng.stats()["role"] == "decode"
    assert eng._prefill_preds == {}
    # no prefill program exists to warm: the step is the whole ladder
    report = eng.warmup(check_hbm=False)
    assert [r["program"] for r in report] == ["step"]
    eng.stop(drain=False)


# ---------------------------------------------------------------------------
# the disaggregated fleet
# ---------------------------------------------------------------------------

def test_disagg_fleet_bit_identical_and_tenancy(m):
    """1 prefill + 2 decode replicas over the lossless wire: six
    concurrent sessions stream the JAX package's solo tokens, tenant
    quotas shed with 429 semantics, and a malformed priority releases
    the quota token it briefly held."""
    tenants = TenantTable(
        specs=[TenantSpec("capped", max_live=1)], model="dfleet")
    router = _fleet(m, n_prefill=1, n_decode=2, slots=2,
                    prompt_buckets=(8,), kv_dtype="fp32", wire_dtype="fp32",
                    tenants=tenants, name="dfleet")
    try:
        lens = (3, 6, 8)
        n_new = 10
        handles = [(plen, router.submit(_prompt(plen), max_new=n_new,
                                        tenant="t%d" % i,
                                        priority="interactive"))
                   for i, plen in enumerate(lens * 2)]
        for plen, h in handles:
            assert h.result(WAIT) == _solo(m, _prompt(plen), n_new)
        st = router.stats()
        assert st["sessions"] == 6 and st["failed_streams"] == 0
        assert st["migrations"] == 0
        assert st["prefill_live"] == 1 and st["decode_live"] == 2
        assert st["adopts"] == 6 and st["prefills"] >= 6
        assert router.queue_depth() == 0
        # tenant quota: one live session caps the "capped" tenant
        slow = router.submit(_prompt(8), max_new=40, tenant="capped")
        with pytest.raises(ShedError, match="quota"):
            router.submit(_prompt(3), max_new=2, tenant="capped")
        # a malformed priority is a 400-class error AND returns the
        # tenant token (the follow-up submit would shed otherwise)
        with pytest.raises(ValueError, match="priority"):
            router.submit(_prompt(3), max_new=2, tenant="t9",
                          priority="vip")
        assert router.tenants.live("t9") == 0
        assert slow.result(WAIT) == _solo(m, _prompt(8), 40)
        # ladder validation happens at the router door
        with pytest.raises(ValueError, match="prompt bucket"):
            router.submit(_prompt(9), max_new=2)
        with pytest.raises(ValueError, match="cache_len"):
            router.submit(_prompt(8), max_new=64)
        for call in (lambda: router.attach_sentinel(None),
                     lambda: router.quarantine_replica(1)):
            with pytest.raises(NotImplementedError, match="item 11"):
                call()
    finally:
        router.stop(drain=False, timeout=10.0)
    with pytest.raises(EngineClosedError):
        router.submit(_prompt(3), max_new=2)


@pytest.mark.chaos
def test_chaos_decode_replica_kill_migrates_streams_exactly(
        m, tmp_path, monkeypatch):
    """A kill of a decode replica mid-stream: every live session
    re-prefills ``prompt + so_far()`` and finishes on the survivor with
    the solo tokens — zero failed streams. Traced: the re-prefill legs
    keep the ORIGINAL trace_id and carry a ``migration`` annotation."""
    monkeypatch.setenv(obs.TRACE_DIR_ENV, str(tmp_path))
    router = _fleet(m, n_prefill=1, n_decode=2, slots=2, kv_dtype="fp32",
                    wire_dtype="fp32", name="chaos-fleet")
    try:
        lens = (3, 5, 6, 8)
        n_new = 50
        traces = {plen: obs.TraceContext.new() for plen in lens}
        handles = [(plen, router.submit(_prompt(plen), max_new=n_new,
                                        trace_ctx=traces[plen]))
                   for plen in lens]
        # gate: every session adopted (first token out) before the kill
        end = time.monotonic() + WAIT
        while time.monotonic() < end and not all(
                len(h.so_far()) >= 1 for _, h in handles):
            time.sleep(0.002)
        assert all(len(h.so_far()) >= 1 for _, h in handles)
        with router._lock:
            victim = max(router._sessions,
                         key=lambda r: len(router._sessions[r]))
            assert len(router._sessions[victim]) >= 1
        router.kill_replica(victim)
        for plen, h in handles:
            assert h.result(WAIT) == _solo(m, _prompt(plen), n_new), plen
        st = router.stats()
        assert st["failed_streams"] == 0
        assert st["migrations"] >= 1
        assert st["replica_dead"] >= 1 and st["decode_live"] == 1
        assert st["adopts"] >= len(lens) + st["migrations"]
        spans = obs.read_spans(str(tmp_path))
        want = {t.trace_id for t in traces.values()}
        assert want <= {s["trace"] for s in spans}
        legs = [s for s in spans if s["name"] == "disagg.prefill_leg"]
        migrated = [s for s in legs
                    if (s.get("args") or {}).get("migration", 0) >= 1]
        assert len(migrated) >= st["migrations"]
        assert all(s["trace"] in want for s in migrated)
    finally:
        router.stop(drain=False, timeout=10.0)


@pytest.mark.chaos
def test_chaos_corrupted_handoff_reprefills_bit_exact(m):
    """A bitflipped KV handoff (``wire:at=1:corrupt=bitflip``) is caught
    by its sealed digest at adoption, the inner stream fails, and the
    migration path re-prefills: the client sees the solo tokens and
    ``failed_streams`` stays 0."""
    router = _fleet(m, n_prefill=1, n_decode=2, slots=2,
                    prompt_buckets=(8, 32), kv_dtype="fp32",
                    wire_dtype="fp32", name="integ-wire")
    try:
        ref = _solo(m, _prompt(6), 10)
        FaultInjector.install("wire:at=1:corrupt=bitflip")
        got = router.submit(_prompt(6), max_new=10).result(WAIT)
        st = router.stats()
        assert got == ref
        assert st["failed_streams"] == 0 and st["migrations"] >= 1
        assert st["adopt_errors"] == 1
        c = obs.snapshot()["counters"]
        assert c["integrity.handoff_digest_mismatch"] == 1
        assert c["integrity.fault_corrupt_fired"] == 1
        FaultInjector.uninstall()
        ref2 = _solo(m, _prompt(5), 8)
        assert router.submit(_prompt(5), max_new=8).result(WAIT) == ref2
        assert router.stats()["failed_streams"] == 0
    finally:
        FaultInjector.uninstall()
        router.stop(drain=False, timeout=10.0)


def test_int8_fleet_serves_and_federates(m):
    """The int8 wire into int8-resident decode replicas: first tokens
    exact, streams whole; the fleet's beacons carry each replica's
    metrics doc, merged into the ``fleet`` exposition."""
    tenants = TenantTable(specs=[
        TenantSpec("latency", priority="interactive", per_token_slo_ms=250),
        TenantSpec("bulk", priority="batch")], model="q8")
    router = _fleet(m, n_prefill=1, n_decode=2, slots=2,
                    prompt_buckets=(8,), kv_dtype="int8", wire_dtype="int8",
                    tenants=tenants, name="q8")
    try:
        hs = [(n, router.submit(_prompt(n), max_new=6,
                                tenant="latency" if n % 2 else "bulk"))
              for n in (3, 4, 5, 8)]
        for n, h in hs:
            toks = h.result(WAIT)
            assert len(toks) == 6 and toks[0] == _solo(m, _prompt(n), 1)[0]
        st = router.stats()
        assert st["adopts"] == 4 and st["failed_streams"] == 0
        assert {r.engine.kv_dtype for r in router._decode.values()} == {
            "int8"}
        assert obs.histogram("serving.disagg.per_token_seconds.latency")
        # a beat after the load, so every beacon carries the counters
        for rep in list(router._prefill.values()) + list(
                router._decode.values()):
            rep._beat_once()
        prom = router.fleet_render_prom()
        assert "paddle_tpu_fleet_replicas" in prom
        burn = [ln.split()[0] for ln in prom.splitlines()
                if ln.startswith("paddle_tpu_fleet_slo_burn")]
        assert any(n.endswith("_latency") for n in burn), burn
    finally:
        router.stop(drain=False, timeout=10.0)


# ---------------------------------------------------------------------------
# HTTP frontend: tenancy fields + Retry-After on the disagg statuses
# ---------------------------------------------------------------------------

def test_http_generate_disagg_statuses_and_tenancy(m):
    tenants = TenantTable(
        specs=[TenantSpec("capped", max_live=0)], model="gptdis")
    router = _fleet(m, n_prefill=1, n_decode=1, slots=2,
                    prompt_buckets=(8,), kv_dtype="fp32", wire_dtype="fp32",
                    tenants=tenants, name="gptdis")
    reg = ModelRegistry()
    reg.publish("gptdis", router)
    srv = ServingServer(reg).start()

    def post(doc):
        req = urllib.request.Request(
            srv.url + "/v1/models/gptdis:generate",
            data=json.dumps(doc).encode(),
            headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=WAIT)

    try:
        p = _prompt(5)
        doc = json.load(post({"prompt": p.tolist(), "max_new_tokens": 4,
                              "stream": False, "tenant": "chat",
                              "priority": "interactive"}))
        assert doc["tokens"] == _solo(m, p, 4)
        # streamed: one JSON line per token, then the done line
        with post({"prompt": p.tolist(), "max_new_tokens": 4,
                   "tenant": "chat", "priority": 0}) as r:
            lines = [json.loads(ln) for ln in r.read().splitlines()]
        assert [d["token"] for d in lines[:-1]] == _solo(m, p, 4)
        assert lines[-1]["done"] is True
        health = json.load(urllib.request.urlopen(
            srv.url + "/healthz", timeout=30))
        assert health["models"]["gptdis"]["kind"] == "decode"
        for bad in ({"tenant": ""}, {"priority": "vip"},
                    {"priority": 7}, {"priority": True}):
            body = dict({"prompt": p.tolist(), "max_new_tokens": 2}, **bad)
            with pytest.raises(urllib.error.HTTPError) as e:
                post(body)
            assert e.value.code == 400, bad
        with pytest.raises(urllib.error.HTTPError) as e:
            post({"prompt": p.tolist(), "max_new_tokens": 2,
                  "tenant": "capped"})
        assert e.value.code == 429
        assert int(e.value.headers["Retry-After"]) >= 1
        fleet = urllib.request.urlopen(
            srv.url + "/metrics?scope=fleet", timeout=30).read().decode()
        assert "paddle_tpu_fleet_replicas" in fleet
        assert "fleet_slo_burn" in fleet
        router.stop(drain=False, timeout=5.0)
        with pytest.raises(urllib.error.HTTPError) as e:
            post({"prompt": p.tolist(), "max_new_tokens": 2})
        assert e.value.code == 503
        assert int(e.value.headers["Retry-After"]) >= 1
    finally:
        srv.stop()
        router.stop(drain=False, timeout=5.0)


def test_serving_package_exports():
    from paddle_tpu import serving as jserving
    from paddle_tpu.serving import disagg as jdisagg
    from paddle_tpu_torch.serving import disagg

    later = {"DraftModel", "PrefixPool", "SessionTier", "prefix_digest"}
    assert set(serving.__all__) >= set(jserving.__all__) - later
    assert set(disagg.__all__) == set(jdisagg.__all__)
    for name in ("DisaggRouter", "DisaggReplica", "DisaggStream",
                 "PrefillEngine", "PrefillTicket", "KVHandoff",
                 "TenantSpec", "TenantTable", "disagg_fleet",
                 "ServingRouter", "local_fleet", "NoReplicasError"):
        assert hasattr(serving, name), name
    assert kv_wire.encode_kv_q is not None
