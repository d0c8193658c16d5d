"""The port's kernels, held against paddle_tpu's Pallas kernels.

On the CPU the wrappers run their plain torch versions (the CUDA kernels
are compared with those on the card by chip_smoke.py). Here the plain
versions go against the JAX package: the Pallas kernels in interpret
mode and its plain-jax references, on the same numpy inputs.
Tolerances: attention 2e-5 (the JAX tests' own bound, f32); LayerNorm
1e-5 for Y and Mean, 1e-4 for Variance (the port derives it from rstd).
"""
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import nn_ops as jax_nn_ops
from paddle_tpu.ops import pallas_attention as pa
from paddle_tpu.ops.pallas_layernorm import fused_layer_norm
from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.ops import cuda_attention as ca
from paddle_tpu_torch.ops import cuda_layernorm as cl
from paddle_tpu_torch.ops import nn_ops as pt_nn_ops
from paddle_tpu_torch.ops.registry import LowerContext

ATOL_ATTN = 2e-5


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


def _qkv(t, b=2, h=2, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, h, t, d)).astype(np.float32)
            for _ in range(3)]


def _kpm(b, t, seed=3):
    rng = np.random.default_rng(seed)
    return np.where(rng.random((b, t)) < 0.2, -1e30, 0.0).astype(np.float32)


def _maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


@pytest.mark.parametrize("t", [64, 48, 131, 192])
@pytest.mark.parametrize("use_kpm", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_plain_matches_pallas_and_reference(t, use_kpm, causal):
    q, k, v = _qkv(t, b=1)
    kpm = _kpm(1, t) if use_kpm else None
    out, lse = ca.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if kpm is None else torch.from_numpy(kpm), causal=causal)
    assert out.shape == (1, 2, t, 16) and lse.shape == (1, 2, t)
    jkpm = None if kpm is None else jnp.asarray(kpm)
    pallas = pa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jkpm, causal=causal,
                                interpret=True)
    ref = pa.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jkpm, causal=causal)
    assert _maxdiff(out.numpy(), pallas) <= ATOL_ATTN
    assert _maxdiff(out.numpy(), ref) <= ATOL_ATTN


def test_attention_fully_masked_rows_are_zero():
    q, k, v = _qkv(64, b=1)
    kpm = np.zeros((1, 64), np.float32)
    kpm[:, :8] = -1e30           # causal row r < 8 sees only masked keys
    out, lse = ca.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kpm), causal=True)
    assert torch.all(out[:, :, :8] == 0)
    assert torch.all(lse[:, :, :8] == -1e30)
    ref = pa.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), jnp.asarray(kpm),
                                 causal=True)
    assert _maxdiff(out.numpy(), ref) <= ATOL_ATTN


def _pallas_keep_mask(seed, b, h, t, p):
    """The keep mask rebuilt from pallas_attention's own hash, tile by tile
    in the blocks flash_attention picks for T (padded), cropped to T."""
    bq, bk = ca.reference_blocks(t, t)
    tp_q = -(-t // bq) * bq
    tp_k = -(-t // bk) * bk
    m = np.zeros((b * h, tp_q, tp_k), bool)
    for bh in range(b * h):
        s = pa.fold_bh_seed(jnp.int32(seed), jnp.int32(bh))
        for qi in range(tp_q // bq):
            for kj in range(tp_k // bk):
                m[bh, qi * bq:(qi + 1) * bq, kj * bk:(kj + 1) * bk] = \
                    np.asarray(pa._keep_mask(s, jnp.int32(qi),
                                             jnp.int32(kj), bq, bk, p))
    return m[:, :t, :t].reshape(b, h, t, t)


@pytest.mark.parametrize("t,seed,p", [(64, 7, 0.1), (131, 7, 0.3),
                                      (192, 123456789, 0.5),
                                      (48, -5, 0.2)])
def test_dropout_keep_mask_bit_identical(t, seed, p):
    b, h = 2, 2
    want = _pallas_keep_mask(seed, b, h, t, p)
    got = ca.dropout_keep_mask(seed, b, h, t, t, p).numpy()
    assert np.array_equal(got, want)
    assert 1 - p - 0.05 < got.mean() < 1 - p + 0.05


def test_dropout_seed_folding_wraps_like_int32():
    # bh * 1000003 overflows int32 for the largest seeds: both packages
    # must wrap the same way
    seed = 2 ** 31 - 10
    want = _pallas_keep_mask(seed, 1, 3, 64, 0.4)
    got = ca.dropout_keep_mask(seed, 1, 3, 64, 64, 0.4).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("t,causal,use_kpm", [(64, False, False),
                                              (131, True, True)])
def test_dropout_forward_matches_pallas(t, causal, use_kpm):
    q, k, v = _qkv(t, b=1, seed=1)
    kpm = _kpm(1, t) if use_kpm else None
    out, _ = ca.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if kpm is None else torch.from_numpy(kpm), seed=11,
        causal=causal, dropout_p=0.25)
    want = pa.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if kpm is None else jnp.asarray(kpm), seed=11, causal=causal,
        dropout_p=0.25, interpret=True)
    assert _maxdiff(out.numpy(), want) <= ATOL_ATTN


# bf16: the reference rounds P∘keep/(1−p) to the input dtype before P·V
# (pallas_attention._fwd_kernel's p_use.astype(v.dtype)); so does the plain
# version, which is the oracle of the card's bf16 forward. What is left is
# the running max at which the reference rounds, tile by tile.
BF16_FWD_CASES = {
    "plain": dict(t=128),
    "dropout p=0.1 seed=7": dict(t=128, dropout_p=0.1, seed=7),
    "T=131 causal kpm": dict(t=131, causal=True, use_kpm=True),
}


@pytest.mark.parametrize("case", sorted(BF16_FWD_CASES))
def test_bf16_forward_rounds_p_where_pallas_does(case):
    kw = dict(BF16_FWD_CASES[case])
    t, use_kpm = kw.pop("t"), kw.pop("use_kpm", False)
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(2, 4, t, 64)).astype(np.float32)
               for _ in range(3))
    kpm = _kpm(2, t) if use_kpm else None
    want = pa.flash_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        None if kpm is None else jnp.asarray(kpm), interpret=True, **kw)
    want = np.asarray(want.astype(jnp.float32))
    got, _ = ca.flash_attention_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        None if kpm is None else torch.from_numpy(kpm), **kw)
    assert got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - want)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    # without the rounding: 35-42% of the elements differ, by up to 3.9e-3
    assert (d > 0).mean() <= 1e-3, (d > 0).mean()
    assert d.max() <= ulp, (d.max(), ulp)


def test_attention_argument_checks():
    q = torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError, match="explicit integer"):
        ca.flash_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(ValueError, match="int32"):
        ca.dropout_keep_mask(2 ** 31, 1, 1, 8, 8, 0.5)
    meta = torch.zeros(1, 2, 8, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ca.flash_attention(meta, meta, meta)


# (shape, x dtype, gamma and beta: "x" = x's dtype, a dtype, or None): h = 770
# is the kernel's path without 16-byte loads on the card
LN_FWD_CASES = [
    pytest.param((64, 96), "float32", "x", id="shape0"),
    pytest.param((37, 64), "float32", "x", id="shape1"),
    pytest.param((64, 770), "float32", "x", id="h770"),
    pytest.param((64, 96), "float32", None, id="no_gamma_beta"),
    pytest.param((64, 96), "bfloat16", "float32", id="bf16_x_f32_gamma_beta"),
]


@pytest.mark.parametrize("shape,x_dtype,w_dtype", LN_FWD_CASES)
def test_layer_norm_plain_matches_pallas(shape, x_dtype, w_dtype):
    """The wrapper on the CPU against the Pallas forward (interpret mode) on
    the same inputs: within 1e-5 in f32; a bf16 y within the bf16 bound of
    chip_smoke.py (|d| <= 2e-2 + 1e-2|ref|), mean and rstd (f32 from the
    same bf16 x) within 1e-5."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    g = rng.normal(size=shape[1:]).astype(np.float32)
    b = rng.normal(size=shape[1:]).astype(np.float32)
    w_dtype = x_dtype if w_dtype == "x" else w_dtype
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    jx = jnp.asarray(x).astype(x_dtype)
    if w_dtype is None:
        tg = tb = jg = jb = None
    else:
        tg, tb = (torch.from_numpy(v).to(getattr(torch, w_dtype))
                  for v in (g, b))
        jg, jb = (jnp.asarray(v).astype(w_dtype) for v in (g, b))
    y, mean, rstd = cl.layer_norm_fwd(tx, tg, tb, 1e-5)
    jy, jmean, jrstd = fused_layer_norm(jx, jg, jb, 1e-5,
                                        interpret=True, return_stats=True)
    assert y.dtype == tx.dtype and jy.dtype == jx.dtype
    y, jy = y.float().numpy(), np.asarray(jy, np.float32)
    if x_dtype == "float32":
        assert _maxdiff(y, jy) <= 1e-5
    else:
        assert (np.abs(y - jy) <= 2e-2 + 1e-2 * np.abs(jy)).all()
    assert _maxdiff(mean.numpy(), jmean) <= 1e-5
    assert _maxdiff(rstd.numpy(), jrstd) <= 1e-5


@pytest.mark.parametrize("shape,begin", [((64, 96), 1), ((37, 64), 1),
                                         ((3, 5, 16), 1), ((3, 5, 16), 2)])
def test_layer_norm_lowering_matches_jax(shape, begin):
    rng = np.random.default_rng(6)
    x = rng.normal(size=shape).astype(np.float32)
    h = int(np.prod(shape[begin:]))
    g = rng.normal(size=(h,)).astype(np.float32)
    b = rng.normal(size=(h,)).astype(np.float32)
    attrs = {"epsilon": 1e-5, "begin_norm_axis": begin}
    got = pt_nn_ops._layer_norm(
        LowerContext(torch.device("cpu")),
        {"X": [torch.from_numpy(x)], "Scale": [torch.from_numpy(g)],
         "Bias": [torch.from_numpy(b)]}, attrs)
    want = jax_nn_ops._layer_norm(
        JaxLowerContext(platform="cpu"),
        {"X": [jnp.asarray(x)], "Scale": [jnp.asarray(g)],
         "Bias": [jnp.asarray(b)]}, attrs)
    for slot, tol in (("Y", 1e-5), ("Mean", 1e-5), ("Variance", 1e-4)):
        a, w = got[slot][0].numpy(), np.asarray(want[slot][0])
        assert a.shape == w.shape, slot
        assert _maxdiff(a, w) <= tol, slot


def test_cpu_path_counts_no_launch(monkeypatch):
    from paddle_tpu_torch.ops import cuda_build

    def no_build(name):
        raise AssertionError("the CPU path must not build a kernel")

    monkeypatch.setattr(cuda_build, "load", no_build)
    fa0 = ca.flash_attention.launches
    ln0 = cl.layer_norm_fwd.launches
    q = torch.randn(1, 2, 8, 4)
    ca.flash_attention(q, q, q)
    cl.layer_norm_fwd(torch.randn(4, 8))
    assert ca.flash_attention.launches == fa0
    assert cl.layer_norm_fwd.launches == ln0


def test_kernel_modules_import_without_toolchain(tmp_path):
    """Importing the kernel modules needs neither triton nor nvcc: nothing
    is built or imported until a CUDA tensor is launched on."""
    code = (
        "import sys\n"
        "import paddle_tpu_torch.ops.cuda_attention, "
        "paddle_tpu_torch.ops.cuda_layernorm\n"
        "from paddle_tpu_torch.ops import cuda_build\n"
        "assert 'triton' not in sys.modules\n"
        "assert not cuda_build._libs\n"
        "print('ok')\n")
    env = {"PATH": "/usr/bin:/bin", "CUDA_HOME": str(tmp_path),
           "PYTHONPATH": str(pytest.importorskip("pathlib").Path(
               __file__).resolve().parents[1])}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


# ---------------------------------------------------------------------------
# backward kernels: the plain versions against jax.grad of the Pallas
# kernels in interpret mode. The loss is sum(out * G) for a fixed random G,
# so the cotangent is G. Tolerance: 1e-5 * max|grad| (f32, the two sum in
# other orders; the dropout keep bits are the same).
# ---------------------------------------------------------------------------
ATTN_BWD_CASES = {
    "plain": dict(t=64),
    "causal": dict(t=64, causal=True),
    "kpm": dict(t=64, use_kpm=True),
    "T=131": dict(t=131, causal=True, use_kpm=True),
    "dropout": dict(t=64, causal=True, dropout_p=0.25, seed=11),
}


def _attn_bwd_inputs(t, use_kpm=False, **_):
    q, k, v = _qkv(t, b=2, seed=2)
    g = np.random.default_rng(8).normal(size=q.shape).astype(np.float32)
    return q, k, v, (_kpm(2, t, seed=4) if use_kpm else None), g


def _jax_attn_grads(q, k, v, kpm, g, causal=False, dropout_p=0.0, seed=None,
                    **_):
    def loss(q, k, v, kpm):
        out = pa.flash_attention(q, k, v, kpm, seed=seed, causal=causal,
                                 dropout_p=dropout_p, interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    args = [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if kpm is None else jnp.asarray(kpm)]
    argnums = (0, 1, 2, 3) if kpm is not None else (0, 1, 2)
    return [np.asarray(x) for x in jax.grad(loss, argnums=argnums)(*args)]


def _close_grad(got, want, name):
    bound = 1e-5 * float(np.abs(want).max())
    assert got.shape == want.shape, name
    assert _maxdiff(got, want) <= bound, (name, _maxdiff(got, want), bound)


@pytest.mark.parametrize("case", sorted(ATTN_BWD_CASES))
def test_attention_bwd_plain_matches_pallas_grad(case):
    kw = ATTN_BWD_CASES[case]
    q, k, v, kpm, g = _attn_bwd_inputs(**kw)
    opts = dict(causal=kw.get("causal", False),
                dropout_p=kw.get("dropout_p", 0.0))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    tkpm = None if kpm is None else torch.from_numpy(kpm)
    out, lse = ca.flash_attention_plain(tq, tk, tv, tkpm, kw.get("seed"),
                                        **opts)
    do = torch.from_numpy(g)
    delta = (do * out).sum(-1)
    dq, dk, dv, dkpm = ca.flash_attention_bwd_plain(
        tq, tk, tv, tkpm, kw.get("seed"), do, lse, delta, **opts)
    want = _jax_attn_grads(q, k, v, kpm, g, seed=kw.get("seed"), **opts)
    for name, a, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        _close_grad(a.numpy(), w, name)
    if kpm is not None:
        _close_grad(dkpm.sum(dim=1).numpy(), want[3], "dkpm")
    else:
        assert dkpm is None


@pytest.mark.parametrize("case", sorted(ATTN_BWD_CASES))
def test_attention_bwd_wrappers_on_cpu_give_each_kernels_plain(case):
    """The dQ and dK/dV wrappers on CPU tensors run each kernel's own plain
    version, which gives the same tensors as the whole plain backward."""
    kw = ATTN_BWD_CASES[case]
    q, k, v, kpm, g = (None if a is None else torch.from_numpy(a)
                       for a in _attn_bwd_inputs(**kw))
    opts = dict(causal=kw.get("causal", False),
                dropout_p=kw.get("dropout_p", 0.0))
    out, lse = ca.flash_attention_plain(q, k, v, kpm, kw.get("seed"), **opts)
    args = (q, k, v, kpm, kw.get("seed"), g, lse, (g * out).sum(-1))
    whole = ca.flash_attention_bwd_plain(*args, **opts)
    counts = (ca.flash_attention_dq.launches, ca.flash_attention_dkdv.launches)
    assert torch.equal(ca.flash_attention_dq(*args, **opts), whole[0])
    for got, want in zip(ca.flash_attention_dkdv(*args, **opts), whole[1:]):
        assert (got is None and want is None) or torch.equal(got, want)
    assert (ca.flash_attention_dq.launches,
            ca.flash_attention_dkdv.launches) == counts


@pytest.mark.parametrize("case", ["kpm", "dropout"])
def test_attention_function_on_cpu_gives_plain_grads(case, monkeypatch):
    """FlashAttention (the autograd.Function) on CPU tensors: the plain
    forward and the plain backward, and no kernel launch or build."""
    from paddle_tpu_torch.ops import cuda_build

    def no_build(name):
        raise AssertionError("the CPU path must not build a kernel")

    monkeypatch.setattr(cuda_build, "load", no_build)
    counts = (ca.flash_attention.launches, ca.flash_attention_dq.launches,
              ca.flash_attention_dkdv.launches)
    kw = ATTN_BWD_CASES[case]
    q, k, v, kpm, g = _attn_bwd_inputs(**kw)
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (q, k, v) + ((kpm,) if kpm is not None else ())]
    tkpm = leaves[3] if kpm is not None else None
    opts = dict(causal=kw.get("causal", False),
                dropout_p=kw.get("dropout_p", 0.0))
    out, lse = ca.FlashAttention.apply(leaves[0], leaves[1], leaves[2], tkpm,
                                       kw.get("seed"), 16 ** -0.5,
                                       opts["causal"], opts["dropout_p"])
    assert not lse.requires_grad
    (out * torch.from_numpy(g)).sum().backward()
    with torch.no_grad():
        ref_out, ref_lse = ca.flash_attention_plain(
            *(t.detach() for t in leaves[:3]), None if kpm is None
            else torch.from_numpy(kpm), kw.get("seed"), **opts)
        delta = (torch.from_numpy(g) * ref_out).sum(-1)
        want = ca.flash_attention_bwd_plain(
            *(t.detach() for t in leaves[:3]), None if kpm is None
            else torch.from_numpy(kpm), kw.get("seed"), torch.from_numpy(g),
            ref_lse, delta, **opts)
    assert torch.equal(out.detach(), ref_out)
    for leaf, w in zip(leaves[:3], want[:3]):
        assert torch.allclose(leaf.grad, w, rtol=0, atol=1e-6)
    if kpm is not None:
        assert torch.allclose(leaves[3].grad, want[3].sum(dim=1), atol=1e-6)
    assert (ca.flash_attention.launches, ca.flash_attention_dq.launches,
            ca.flash_attention_dkdv.launches) == counts


@pytest.mark.parametrize("shape,affine", [((64, 96), True), ((37, 64), True),
                                          ((24, 80), False)])
def test_layer_norm_bwd_plain_matches_pallas_grad(shape, affine):
    rng = np.random.default_rng(7)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    g = rng.normal(size=shape[1:]).astype(np.float32)
    b = rng.normal(size=shape[1:]).astype(np.float32)
    dy = rng.normal(size=shape).astype(np.float32)

    def loss(x, g, b):
        y = fused_layer_norm(x, g, b, 1e-5, interpret=True)
        return jnp.sum(y * jnp.asarray(dy))

    if affine:
        want = jax.grad(loss, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    else:
        want = (jax.grad(lambda x: loss(x, None, None))(jnp.asarray(x)),)
    tx = torch.from_numpy(x)
    tg = torch.from_numpy(g) if affine else None
    _, mean, rstd = cl.layer_norm_plain(tx, tg, None, 1e-5)
    got = cl.layer_norm_bwd_plain(tx, tg, mean, rstd, torch.from_numpy(dy))
    for name, a, w in zip(("dx", "dgamma", "dbeta"), got, want):
        bound = 1e-5 * max(1.0, float(np.abs(w).max()))
        assert _maxdiff(a.numpy(), w) <= bound, name
    if not affine:   # gamma None means ones; dγ/dβ still come back in f32
        assert got[1].dtype == got[2].dtype == torch.float32


def test_layer_norm_function_on_cpu_gives_plain_grads(monkeypatch):
    from paddle_tpu_torch.ops import cuda_build

    def no_build(name):
        raise AssertionError("the CPU path must not build a kernel")

    monkeypatch.setattr(cuda_build, "load", no_build)
    counts = (cl.layer_norm_fwd.launches, cl.layer_norm_bwd.launches)
    rng = np.random.default_rng(9)
    x, dy = (torch.from_numpy(rng.normal(size=(12, 40)).astype(np.float32))
             for _ in range(2))
    g, b = (torch.from_numpy(rng.normal(size=40).astype(np.float32))
            for _ in range(2))
    leaves = [t.clone().requires_grad_() for t in (x, g, b)]
    y, mean, rstd = cl.LayerNorm.apply(*leaves, 1e-5)
    assert not mean.requires_grad and not rstd.requires_grad
    (y * dy).sum().backward()
    _, m, r = cl.layer_norm_plain(x, g, b, 1e-5)
    want = cl.layer_norm_bwd_plain(x, g, m, r, dy)
    for leaf, w in zip(leaves, want):
        assert torch.allclose(leaf.grad, w, rtol=0, atol=1e-6)
    assert (cl.layer_norm_fwd.launches, cl.layer_norm_bwd.launches) == counts


# ---------------------------------------------------------------------------
# The f32 arithmetic plan of csrc/flash_attn_bwd.cu, emulated on the CPU
# before it runs on the card: its five products run on the tensor cores in
# TF32, three passes per product (x = big + small, each rounded to TF32 by
# cvt.rna; small·big + big·small + big·big summed in f32). The card's f32
# bound is 1e-4·max|grad| of the plain version (chip_smoke.RTOL_FA_BWD_F32);
# three passes must keep inside it, and one pass must not, or three would
# not be needed.
# ---------------------------------------------------------------------------
TF32_CASES = {
    "plain": dict(t=128),
    "causal": dict(t=128, causal=True),
    "kpm": dict(t=128, use_kpm=True),
    "T=131": dict(t=131, causal=True, use_kpm=True),
    "dropout p=0.1 seed=7": dict(t=128, dropout_p=0.1, seed=7),
}


def _tf32(x):
    """cvt.rna.tf32.f32 on f32 bits: the mantissa rounded to 10 bits, ties
    away from zero (half of the 13 dropped bits added to the magnitude,
    then the 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b with TF32 operands and f32 sums: big·big alone (passes=1) or
    3xTF32 (passes=3)."""
    a_big, b_big = _tf32(a), _tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


@pytest.mark.parametrize("case", sorted(TF32_CASES))
def test_bwd_3xtf32_plan_meets_the_f32_bound(case, monkeypatch):
    """flash_attention_bwd_plain with its five products (torch.matmul) in
    TF32 against the same function in f32."""
    kw = TF32_CASES[case]
    t = kw["t"]
    rng = np.random.default_rng(21)
    q, k, v, do = (torch.from_numpy(
        rng.normal(size=(2, 12, t, 64)).astype(np.float32)) for _ in range(4))
    kpm = torch.from_numpy(_kpm(2, t, seed=5)) if kw.get("use_kpm") else None
    seed = kw.get("seed")
    opts = dict(causal=kw.get("causal", False),
                dropout_p=kw.get("dropout_p", 0.0))
    out, lse = ca.flash_attention_plain(q, k, v, kpm, seed, **opts)
    delta = (do * out).sum(-1)
    want = ca.flash_attention_bwd_plain(q, k, v, kpm, seed, do, lse, delta,
                                        **opts)
    worst = {}
    for passes in (3, 1):
        monkeypatch.setattr(torch, "matmul",
                            lambda a, b, passes=passes: _mm_tf32(a, b, passes))
        got = ca.flash_attention_bwd_plain(q, k, v, kpm, seed, do, lse, delta,
                                           **opts)
        monkeypatch.undo()
        worst[passes] = max(
            _maxdiff(g.numpy(), w.numpy()) / float(w.abs().max())
            for g, w in zip(got, want) if w is not None)
    assert worst[3] <= 1e-4, worst      # three passes: inside the bound
    assert worst[1] > 1e-4, worst       # one pass: outside it


# The forward kernel's f32 plan: S = Q·Kᵀ and P·V in 3xTF32, held to the
# card's f32 forward bound (chip_smoke.ATOL_FA_F32 = 2e-5) for out and lse.
FWD_TF32_CASES = {
    "plain": dict(t=128),
    "causal": dict(t=128, causal=True),
    "T=131 causal kpm": dict(t=131, causal=True, use_kpm=True),
    "dropout p=0.1 seed=7": dict(t=128, dropout_p=0.1, seed=7),
}


@pytest.mark.parametrize("case", sorted(FWD_TF32_CASES))
def test_fwd_3xtf32_plan_meets_the_f32_bound(case, monkeypatch):
    """flash_attention_plain with its two products (torch.matmul) in TF32
    against the same function in f32."""
    kw = FWD_TF32_CASES[case]
    t = kw["t"]
    rng = np.random.default_rng(22)
    q, k, v = (torch.from_numpy(
        rng.normal(size=(2, 12, t, 64)).astype(np.float32)) for _ in range(3))
    kpm = torch.from_numpy(_kpm(2, t, seed=6)) if kw.get("use_kpm") else None
    opts = dict(seed=kw.get("seed"), causal=kw.get("causal", False),
                dropout_p=kw.get("dropout_p", 0.0))
    want_out, want_lse = ca.flash_attention_plain(q, k, v, kpm, **opts)
    worst = {}
    for passes in (3, 1):
        monkeypatch.setattr(torch, "matmul",
                            lambda a, b, passes=passes: _mm_tf32(a, b, passes))
        out, lse = ca.flash_attention_plain(q, k, v, kpm, **opts)
        monkeypatch.undo()
        live = want_lse > -1e29
        worst[passes] = (_maxdiff(out.numpy(), want_out.numpy()),
                         _maxdiff(lse[live].numpy(), want_lse[live].numpy()))
    assert max(worst[3]) <= 2e-5, worst     # three passes: inside the bound
    assert worst[1][0] > 2e-5, worst        # one pass: outside it


def test_attention_sources_share_the_mma_header():
    """The forward and backward kernels take their tile loads, fragments and
    products from csrc/flash_mma.cuh, and neither carries a copy."""
    from paddle_tpu_torch.ops import cuda_build

    def read(name):
        with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
            return f.read()

    header = read("flash_mma.cuh")
    for fn in ("mma_abt", "mma_pb", "load_tile", "keep_bits", "store_pair",
               "mma_3xtf32_x4", "cp_async16"):
        assert re.search(r"__forceinline__ \w+ %s\(" % fn, header), fn
    for src in ("flash_attn_fwd.cu", "flash_attn_bwd.cu"):
        text = read(src)
        assert '#include "flash_mma.cuh"' in text, src
        assert "__device__" not in text.split("__global__")[0], src
        for fn in ("mma_abt", "mma_pb"):
            assert "%s<" % fn in text, (src, fn)     # used ...
            assert "void %s(" % fn not in text, (src, fn)  # ... not defined


def test_layer_norm_sources_share_the_row_header():
    """The forward and backward LayerNorm kernels take their row parts (the
    16-byte chunk accessors, gamma where it is absent, the 16-byte test and
    the SM count) from csrc/ln_rows.cuh, and neither carries a copy."""
    from paddle_tpu_torch.ops import cuda_build

    def read(name):
        with open(os.path.join(cuda_build.CSRC_DIR, name)) as f:
            return f.read()

    def defines(text, fn):
        return re.search(r"\b(inline|__forceinline__)\s+\w+\s+%s\s*(<\w+>)?\s*\("
                         % fn, text)

    parts = ("lane_elem", "set_elem", "gamma_at", "rows_in_16_bytes",
             "card_sms")
    header = read("ln_rows.cuh")
    for fn in parts:
        assert defines(header, fn), fn
    for src in ("layer_norm_fwd.cu", "layer_norm_bwd.cu"):
        text = read(src)
        assert '#include "ln_rows.cuh"' in text, src
        for fn in parts:
            assert re.search(r"\b%s\s*[<(]" % fn, text), (src, fn)  # used
            assert not defines(text, fn), (src, fn)           # not defined


def test_library_digest_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edit to a header of csrc/ names a new library, so a stale one is
    never loaded."""
    from paddle_tpu_torch.ops import cuda_build

    for header in ("common.cuh", "flash_common.cuh", "flash_mma.cuh",
                   "ln_rows.cuh"):
        assert os.path.exists(os.path.join(cuda_build.CSRC_DIR, header))
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = cuda_build.library_path("k")
    assert first == cuda_build.library_path("k")
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert cuda_build.library_path("k") != first
    # the attention kernels' shared header names new libraries for both
    for name in ("flash_attn_fwd", "flash_attn_bwd"):
        (tmp_path / (name + ".cu")).write_text('#include "flash_mma.cuh"\n')
    (tmp_path / "flash_mma.cuh").write_text("// v1\n")
    before = [cuda_build.library_path(n)
              for n in ("flash_attn_fwd", "flash_attn_bwd")]
    (tmp_path / "flash_mma.cuh").write_text("// v2\n")
    after = [cuda_build.library_path(n)
             for n in ("flash_attn_fwd", "flash_attn_bwd")]
    assert before[0] != after[0] and before[1] != after[1]


def test_backward_wrappers_refuse_other_devices():
    meta = torch.zeros(1, 2, 8, 4, device="meta")
    lse = torch.zeros(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ca.flash_attention_dq(meta, meta, meta, None, None, meta, lse, lse)
    with pytest.raises(ValueError, match="unsupported device"):
        ca.flash_attention_dkdv(meta, meta, meta, None, None, meta, lse, lse)
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cl.layer_norm_bwd(x, None, x[:, 0], x[:, 0], x)
