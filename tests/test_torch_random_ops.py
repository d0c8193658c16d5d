"""The last 8 op types of paddle_tpu/ops/random_ops.py
(uniform_random_batch_size_like, gaussian_random_batch_size_like,
truncated_gaussian_random, randint, randperm, multinomial,
shuffle_channel, random_crop), their layers, and
``fluid.layers.distributions``, in the port against the JAX package, on
the CPU.

- A draw cannot match the JAX package's bit for bit (each package has its
  own generator), so each draw op is held by its support (the values a
  draw may take; its shape and dtype, int64 where jax gives int32), its
  seeding (the same generator seed draws the same values, another seed
  others) and its moments: the mean and variance of N = 40,000 draws
  within 5 standard errors of the distribution's, and of the JAX
  lowering's own draws. ``shuffle_channel`` draws nothing and equals the
  JAX lowering.
- The draw ops are in ``lowering.DRAWS``: an unread draw still runs, so a
  later draw is the one the unpruned program makes.
- The layers (``uniform_random``, ``gaussian_random``, the batch-size-like
  pair, ``random_crop``, ``shuffle_channel``) and the four distributions
  build the same Program JSON in both packages; ``log_prob``,
  ``entropy`` and ``kl_divergence`` equal the JAX package's (1e-6
  relative), and ``sample``'s moments match.
"""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
from paddle_tpu.ops.registry import get_lowering as jax_lowering
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import lowering as pt_lowering_mod
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.ops.registry import LowerContext
from test_torch_activations import assert_close
from test_torch_detection import _rand, pt_lowering
from test_torch_nn_ops_tail import check

N = 40000
DRAW_OPS = ("uniform_random_batch_size_like",
            "gaussian_random_batch_size_like", "truncated_gaussian_random",
            "randint", "randperm", "multinomial", "random_crop")


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


def _port(op, ins, attrs, seed):
    ctx = LowerContext(torch.device("cpu"),
                       generator=torch.Generator().manual_seed(seed))
    out = pt_lowering(op)(ctx, {k: [torch.from_numpy(np.asarray(a))
                                    for a in v] for k, v in ins.items()},
                          dict(attrs))
    return out["Out"][0].numpy()


def _jax(op, ins, attrs, seed):
    ctx = JaxLowerContext(rng=jax.random.PRNGKey(seed), platform="cpu")
    out = jax_lowering(op)(ctx, {k: [jnp.asarray(a) for a in v]
                                 for k, v in ins.items()}, dict(attrs))
    return np.asarray(out["Out"][0])


_PROBS = np.array([[0.1, 0.0, 0.6, 0.3], [0.25, 0.25, 0.25, 0.25]],
                  np.float32)


def _draw_case(name):
    """(op, ins, attrs, (mean, var) of one draw, or None, support)."""
    ref = np.zeros((N // 100, 3), np.float32)
    phi = 0.05399096651318806       # the standard normal's pdf at 2
    mass = 0.9544997361036416       # its mass in [-2, 2]
    tvar = 1.0 - 2 * 2 * phi / mass
    return {
        "uniform_random_batch_size_like": (
            "uniform_random_batch_size_like", {"Input": [ref]},
            {"shape": [-1, 100], "min": -2.0, "max": 3.0, "dtype": "float32"},
            (0.5, 25.0 / 12), lambda v: (v >= -2.0).all() and (v < 3.0).all()),
        "gaussian_random_batch_size_like": (
            "gaussian_random_batch_size_like", {"Input": [ref]},
            {"shape": [3, -1], "input_dim_idx": 0, "output_dim_idx": 1,
             "mean": 1.5, "std": 2.0, "dtype": "float32"}, (1.5, 4.0),
            lambda v: np.isfinite(v).all()),
        "truncated_gaussian_random": (
            "truncated_gaussian_random", {}, {"shape": [N], "mean": -1.0,
                                              "std": 0.5},
            (-1.0, 0.25 * tvar),
            lambda v: (v >= -2.0).all() and (v <= 0.0).all()),
        "randint": ("randint", {}, {"shape": [N], "low": -3, "high": 5},
                    (0.5, (8 * 8 - 1) / 12.0),
                    lambda v: set(np.unique(v)) == set(range(-3, 5))),
        "randperm": ("randperm", {}, {"n": 50}, None,
                     lambda v: sorted(v.tolist()) == list(range(50))),
        "multinomial": ("multinomial", {"X": [_PROBS]},
                        {"num_samples": N // 2}, None,
                        lambda v: v.shape == (2, N // 2)
                        and (v[0] != 1).all() and v.min() >= 0
                        and v.max() <= 3),
        "random_crop": ("random_crop", {"X": [_rand(2, 3, 7, 9, seed=1)]},
                        {"shape": [4, 5]}, None, None),
    }[name]


@pytest.mark.parametrize("name", DRAW_OPS)
def test_draw_support_seeding_and_moments(name):
    op, ins, attrs, moments, support = _draw_case(name)
    a, b, c = (_port(op, ins, attrs, s) for s in (3, 3, 4))
    w = _jax(op, ins, attrs, 3)
    assert a.shape == w.shape
    assert a.dtype == w.dtype or (w.dtype == np.int32 and a.dtype == np.int64)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    if support is not None:
        assert support(a) and support(w)
    if moments is not None:
        mean, var = moments
        n = a.size
        for v in (a, w):
            v = v.astype(np.float64).reshape(-1)
            assert abs(v.mean() - mean) <= 5 * math.sqrt(var / n), v.mean()
            # the variance of a sample variance ~ (m4 - var^2) / n; 3 var^2
            # bounds m4 for these (normal-like or flatter) distributions
            assert abs(v.var() - var) <= 5 * math.sqrt(2 * var * var / n)


def test_multinomial_frequencies():
    """Each row's category frequencies within 5 standard errors of X."""
    op, ins, attrs, _, _ = _draw_case("multinomial")
    for v in (_port(op, ins, attrs, 7), _jax(op, ins, attrs, 7)):
        for row, p in zip(v, _PROBS):
            freq = np.bincount(row, minlength=4) / row.size
            se = np.sqrt(p * (1 - p) / row.size)
            assert (np.abs(freq - p) <= 5 * se + 1e-12).all(), (freq, p)


def test_random_crop_offsets():
    """Every crop is x at one offset for the whole batch, and the offsets
    of many draws cover every position (uniform over 4 x 5 starts)."""
    x = _rand(2, 3, 7, 9, seed=1)
    seen = set()
    for seed in range(200):
        v = _port("random_crop", {"X": [x]}, {"shape": [4, 5]}, seed)
        hits = [(i, j) for i in range(4) for j in range(5)
                if np.array_equal(v, x[:, :, i:i + 4, j:j + 5])]
        assert len(hits) == 1
        seen.add(hits[0])
    assert len(seen) == 20


def test_shuffle_channel_matches_jax():
    check("shuffle_channel", {"X": [_rand(2, 6, 3, 4, seed=2)]},
          {"group": 3}, ("X",))


def test_every_op_is_covered_and_drawn_ops_always_run():
    for op in DRAW_OPS + ("shuffle_channel",):
        pt_lowering(op)
    assert set(DRAW_OPS) <= pt_lowering_mod.DRAWS
    assert "shuffle_channel" not in pt_lowering_mod.DRAWS


def test_an_unread_draw_still_runs():
    """The pruned run draws what the full op list draws: the second draw's
    values are the same whether or not the first is fetched."""
    def build():
        pt_unique_name.switch()
        main, start = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, start):
            x = fluid.data(name="x", shape=[4, 3], dtype="float32")
            a = fluid.layers.gaussian_random_batch_size_like(x, [-1, 5])
            b = fluid.layers.uniform_random_batch_size_like(x, [-1, 5])
        main.random_seed = 9
        return main, a, b

    feed = {"x": np.zeros((4, 3), np.float32)}
    main, a, b = build()
    both = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=[a, b], scope=fluid.Scope())
    main, a, b = build()
    only = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=[b], scope=fluid.Scope())
    np.testing.assert_array_equal(only[0], both[1])


# ---------------------------------------------------------------------------
# layers and distributions
# ---------------------------------------------------------------------------
def _draw_layers(fl):
    L = fl.layers
    x = fl.data(name="x", shape=[None, 6, 5, 4], dtype="float32")
    return [
        L.uniform_random([3, 4], min=-0.5, max=0.5, seed=2),
        L.gaussian_random([2, 3], mean=1.0, std=0.1),
        L.uniform_random_batch_size_like(x, [-1, 7], min=0.0, max=1.0),
        L.gaussian_random_batch_size_like(x, [2, -1], input_dim_idx=1,
                                          output_dim_idx=1),
        L.random_crop(x, [4, 3]), L.shuffle_channel(x, 2),
    ]


def _dists(fl):
    D = fl.layers.distributions
    L = fl.layers
    u1, u2 = D.Uniform(-1.0, 3.0), D.Uniform([0.0, 1.0], [2.0, 5.0])
    n1, n2 = D.Normal(0.5, 2.0), D.Normal([0.0, 1.0], [1.5, 0.5])
    logits = L.assign(np.array([[1.0, 2.0, 0.5], [0.0, -1.0, 3.0]],
                               np.float32))
    c1 = D.Categorical(logits)
    c2 = D.Categorical(L.assign(np.array([[0.3, 0.2, 0.1], [1.0, 1.0, 1.0]],
                                         np.float32)))
    m1 = D.MultivariateNormalDiag(np.array([0.3, 0.5], np.float32),
                                  np.diag([0.4, 0.5]).astype(np.float32))
    m2 = D.MultivariateNormalDiag(np.array([-0.2, 1.0], np.float32),
                                  np.diag([1.2, 0.3]).astype(np.float32))
    value = L.assign(np.array([0.5, 2.5], np.float32))
    exact = {
        "u_log_prob": u2.log_prob(value), "u_entropy": u1.entropy(),
        "n_log_prob": n2.log_prob(value), "n_entropy": n2.entropy(),
        "n_kl": n1.kl_divergence(n2),
        "c_log_prob": c1.log_prob(L.assign(np.array([1, 2], np.int64))),
        "c_entropy": c1.entropy(), "c_kl": c1.kl_divergence(c2),
        "m_entropy": m1.entropy(), "m_kl": m1.kl_divergence(m2),
    }
    samples = {
        "u_sample": u1.sample([N]), "n_sample": n1.sample([N]),
        "c_sample": c2.sample([N // 2]), "m_sample": m2.sample([N]),
    }
    return exact, samples


def _both(fn):
    built = []
    for fl, un in ((jfluid, jax_unique_name), (fluid, pt_unique_name)):
        un.switch()
        main, start = fl.Program(), fl.Program()
        with fl.program_guard(main, start):
            outs = fn(fl)
        built.append((main, start, outs))
    (jm, js, _), (pm, ps, _) = built
    assert json.loads(pm.to_json()) == json.loads(jm.to_json())
    assert json.loads(ps.to_json()) == json.loads(js.to_json())
    return built


def test_draw_layers_build_the_reference_s_program():
    (_, _, jo), (_, _, po) = _both(_draw_layers)
    assert [(o.name, o.shape) for o in po] == [(o.name, o.shape) for o in jo]


def test_distributions_match_the_jax_package():
    (jm, _, (jex, jsa)), (pm, _, (pex, psa)) = _both(_dists)
    names = sorted(jex)
    jout = jfluid.Executor(jfluid.CPUPlace()).run(
        jm, fetch_list=[jex[k] for k in names] + [jsa[k] for k in sorted(jsa)],
        scope=jfluid.Scope())
    pout = fluid.Executor(fluid.CPUPlace()).run(
        pm, fetch_list=[pex[k] for k in names] + [psa[k] for k in sorted(psa)],
        scope=fluid.Scope())
    for k, a, w in zip(names, pout, jout):
        assert_close(np.asarray(a), np.asarray(w), 1e-6, k)
    for k, a, w in zip(sorted(jsa), pout[len(names):], jout[len(names):]):
        a, w = np.asarray(a), np.asarray(w)
        assert a.shape == w.shape, k
        cols = 1 if a.ndim == 1 else a.shape[-1]
        flat_a = a.reshape(-1, cols).astype(np.float64)
        flat_w = w.reshape(-1, cols).astype(np.float64)
        sd = flat_w.std(axis=0)
        se = np.maximum(sd, 1e-3) / math.sqrt(flat_w.shape[0])
        assert (np.abs(flat_a.mean(axis=0) - flat_w.mean(axis=0))
                <= 7 * se).all(), k
        assert (np.abs(flat_a.std(axis=0) - sd) <= 0.05 * sd + 1e-3).all(), k
