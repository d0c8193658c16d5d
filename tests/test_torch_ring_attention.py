"""Ring attention and the fused attention's sp branch in the port
(paddle_tpu_torch/parallel/ring_attention.py, ops/cuda_attention.py)
against the JAX package, on the CPU.

Ranks are gloo processes on a FileStore (tests/torch_ranks.py): one spawn
of 4 ranks and one of 2 for the whole file. The JAX side runs here, on
the 8 virtual devices tests/conftest.py sets up.

- ``ring_attention_sharded`` at T = 1024 over sp = 4 (256 tokens a
  rank), causal and not, against the JAX package's ``full_attention``
  and ``ring_attention_sharded`` over sp = 4 (rtol 2e-4, atol 2e-5, as
  test_distributed.py::test_ring_attention_long_context_exact), and its
  gradients against ``jax.grad`` of ``full_attention``.
- The fused attention under a dp2 x sp2 DistributedProgram rides the
  ring (a spy counts the calls) and matches the single run (test_
  distributed.py::test_fused_attention_rides_ring_under_sp_mesh); with
  dropout it does not ride the ring and still matches.
- BERT-tiny under fleet's ``sequence_parallel_degree=2`` (dropout 0), and
  at tp2 x sp2 with ``bert.tp_rules``, against the one-rank run.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from paddle_tpu.models import bert as jbert
from paddle_tpu.parallel.ring_attention import (full_attention,
                                                ring_attention_sharded)
import torch_ranks as tr

B, T, H, D = 1, 1024, 2, 16


def _qkv():
    rng = np.random.RandomState(7)
    return [rng.rand(B, T, H, D).astype("float32") for _ in range(3)] + [
        rng.standard_normal((B, T, H, D)).astype("float32")]


def _attn_feeds():
    rng = np.random.RandomState(0)
    return [{n: rng.rand(*tr.ATTN).astype("float32")
             for n in ("aq", "ak", "av")}]


def _bert_feeds():
    cfg = tr.bert_tiny_config(jbert)
    return [dict(zip(("input_ids", "mlm_labels"), jbert.synthetic_batch(
        cfg, 4, tr.BERT_SEQ, seed=s))) for s in range(3)]


SPEC = ("dp", None, "sp", None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from paddle_tpu_torch.models import bert

    q, k, v, dout = _qkv()
    feeds = _attn_feeds()
    specs = {n: SPEC for n in ("aq", "ak", "av")}
    jobs4 = [dict(model="attn", feeds=feeds),
             dict(model="attn", feeds=feeds, mesh={"dp": 2, "sp": 2},
                  feed_specs=specs),
             dict(model="bert_tiny", feeds=_bert_feeds(),
                  mesh={"tp": 2, "sp": 2},
                  rules=[(p, tuple(s)) for p, s in bert.tp_rules()])]
    got4 = tr.run_ranks(tr.ring_suite, 4, tmp_path_factory.mktemp("sp4"),
                        args=(q, k, v, dout, jobs4), timeout=240)
    jobs2 = [dict(model="bert_tiny", feeds=_bert_feeds()),
             dict(model="bert_tiny", feeds=_bert_feeds(),
                  strategy={"sequence_parallel_degree": 2}),
             dict(model="bert_tiny_drop", feeds=_bert_feeds()[:1]),
             dict(model="bert_tiny_drop", feeds=_bert_feeds()[:1],
                  mesh={"sp": 2})]
    got2 = tr.run_ranks(tr.layout_jobs, 2, tmp_path_factory.mktemp("sp2"),
                        args=(jobs2,), timeout=240)
    return (q, k, v, dout), got4, got2


def _jax(q, k, v, dout, causal):
    mesh = Mesh(np.array(jax.devices()[:4]), ("sp",))
    full = full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal)
    ring = ring_attention_sharded(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), mesh, causal=causal)
    grads = jax.grad(lambda a, b, c: jnp.sum(full_attention(
        a, b, c, causal=causal) * dout), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(full), np.asarray(ring), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_sharded_is_exact_at_t1024_over_sp4(runs, causal):
    (q, k, v, dout), got4, _ = runs
    full, ring, grads = _jax(q, k, v, dout, causal)
    for rank in got4:
        out, dq, dk, dv = rank["ring"][causal]
        np.testing.assert_allclose(out, full, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(out, ring, rtol=2e-4, atol=2e-5)
        for g, w in zip((dq, dk, dv), grads):
            np.testing.assert_allclose(g, w, rtol=2e-4, atol=2e-5)


def test_fused_attention_rides_the_ring_under_dp2_sp2(runs):
    _, got4, _ = runs
    for rank in got4:
        single, ringed = rank["jobs"][0], rank["jobs"][1]
        assert single["ring_calls"] == 0
        assert ringed["ring_calls"] == 1, "sp-split attention took no ring"
        assert ringed["reshards"] == {}
        np.testing.assert_allclose(ringed["fetches"][0][0],
                                   single["fetches"][0][0],
                                   rtol=2e-4, atol=2e-5)


def test_bert_tp2_sp2_matches_the_one_rank_run(runs):
    """tp and sp composed: the attention runs each rank's 2 heads of its
    T block on the ring, the rest under the tp rules."""
    _, got4, got2 = runs
    plain = got2[0][0]
    for rank in got4:
        run = rank["jobs"][2]
        assert run["ring_calls"] == 3 * 2        # 3 steps, 2 layers
        for step in range(3):
            np.testing.assert_allclose(run["fetches"][step][0],
                                       plain["fetches"][step][0], rtol=1e-5)
        for name, want in plain["states"][-1].items():
            np.testing.assert_allclose(
                run["states"][-1][name], want, rtol=0,
                atol=1e-4 * float(np.abs(want).max()))


def test_bert_under_fleets_sequence_parallel_degree(runs):
    _, _, got2 = runs
    plain = got2[0][0]
    for rank in (got2[0][1], got2[1][1]):
        for step in range(3):
            np.testing.assert_allclose(rank["fetches"][step][0],
                                       plain["fetches"][step][0], rtol=1e-5)
        for name, want in plain["states"][-1].items():
            np.testing.assert_allclose(
                rank["states"][-1][name], want, rtol=0,
                atol=1e-4 * float(np.abs(want).max()))


def test_attention_with_dropout_stays_off_the_ring(runs):
    """The reference's ring takes no dropout: under sp the attention with
    dropout 0.1 runs whole (the fallback is not taken: its inputs are
    whole) and draws the one-rank masks."""
    _, _, got2 = runs
    plain = got2[0][2]
    for rank in (got2[0][3], got2[1][3]):
        assert rank["reshards"] == {}
        np.testing.assert_allclose(rank["fetches"][0][0],
                                   plain["fetches"][0][0], rtol=1e-6)
