"""The port's two kernels, held against paddle_tpu's Pallas kernels.

On the CPU the wrappers run their plain torch versions (the CUDA kernels
are compared with those on the card by chip_smoke.py). Here the plain
versions go against the JAX package: the Pallas kernels in interpret
mode and its plain-jax references, on the same numpy inputs.
Tolerances: attention 2e-5 (the JAX tests' own bound, f32); LayerNorm
1e-5 for Y and Mean, 1e-4 for Variance (the port derives it from rstd).
"""
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


def test_attention_argument_checks():
    q = torch.zeros(1, 2, 8, 4)
    with pytest.raises(ValueError, match="explicit integer"):
        ca.flash_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(ValueError, match="int32"):
        ca.dropout_keep_mask(2 ** 31, 1, 1, 8, 8, 0.5)
    meta = torch.zeros(1, 2, 8, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ca.flash_attention(meta, meta, meta)


@pytest.mark.parametrize("shape", [(64, 96), (37, 64)])
def test_layer_norm_plain_matches_pallas(shape):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    g = rng.normal(size=shape[1:]).astype(np.float32)
    b = rng.normal(size=shape[1:]).astype(np.float32)
    y, mean, rstd = cl.layer_norm_fwd(torch.from_numpy(x),
                                      torch.from_numpy(g),
                                      torch.from_numpy(b), 1e-5)
    jy, jmean, jrstd = fused_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                        jnp.asarray(b), 1e-5,
                                        interpret=True, return_stats=True)
    assert _maxdiff(y.numpy(), jy) <= 1e-5
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
