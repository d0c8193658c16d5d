"""Flash-attention forward: a hand-written CUDA kernel, its plain torch
version, and the ``fused_multihead_attention`` lowering.

Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_attention.py
``_fwd_kernel`` / ``_fwd_kernel_nokpm`` (called from ``_fwd_call``). The
kernel is ``csrc/flash_attn_fwd.cu``: FlashAttention-2 online softmax with
f32 statistics, one block per (64-row q tile, batch·head), K/V tiles of 64
rows in shared memory; its note says what bounds it on the H100.

Semantics kept from ``pallas_attention.flash_attention``: q/k/v are
(B, H, T, D); the default ``sm_scale`` is D^-½; ``key_padding_mask`` is an
additive f32 (B, Tk) mask shared by the heads; causal is ``row >= col`` in
absolute indices; rows with every key masked give 0; dropout > 0 needs an
explicit seed, and its keep mask is the reference's murmur3 counter hash,
taken in the reference's tile coordinates (``reference_blocks``), so the
two packages drop the same scores.

:func:`flash_attention` launches the kernel on CUDA tensors and takes
:func:`flash_attention_plain` only for tensors on the CPU. There is no
fallback on the card: a failed build or launch raises.
"""
import ctypes

import torch

from . import cuda_build
from .registry import register_op, single

__all__ = ["flash_attention", "flash_attention_plain", "dropout_keep_mask",
           "reference_blocks"]

NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 128


def _pick_block(t, want):
    b = min(want, t)
    while t % b:
        b -= 1
    return b


def reference_blocks(tq, tk, block_q=128, block_k=128):
    """The (block_q, block_k) tiles pallas_attention.flash_attention picks
    for these lengths (exact divisor, else pad up to the default block);
    the dropout hash is keyed by them."""
    bq = _pick_block(tq, block_q)
    bk = _pick_block(tk, block_k)
    if bq < min(block_q, tq) // 2:
        bq = min(block_q, tq)
    if bk < min(block_k, tk) // 2:
        bk = min(block_k, tk)
    return bq, bk


def _dropout_threshold(p):
    return min(int(p * 4294967296.0), 4294967295)


def _mul32(a, c):
    """(a * c) mod 2^32 for int64 tensors a in [0, 2^32) and constant c,
    without leaving int64: split a into 16-bit halves."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _int32(seed):
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError("dropout seed must fit in int32, got %d" % seed)
    return seed


def dropout_keep_mask(seed, batch, heads, tq, tk, dropout_p, device=None):
    """Bool (B, H, Tq, Tk) keep mask, bit for bit the one
    pallas_attention draws: murmur3 fmix32 over seed ⊕ qi·0x9E3779B9 ⊕
    kj·0x85EBCA6B + r·0x27D4EB2F + c·0x165667B1, the seed folded per
    batch·head (+bh·1000003, int32 wraparound), in the reference's tile
    coordinates. Computed in int64 masked to 32 bits after each step."""
    ref_bq, ref_bk = reference_blocks(tq, tk)
    i64 = dict(dtype=torch.int64, device=device)
    rows = torch.arange(tq, **i64)
    cols = torch.arange(tk, **i64)
    bh = torch.arange(batch * heads, **i64)
    seed_bh = ((_int32(seed) & _M32) + bh * 1000003) & _M32
    h = (seed_bh[:, None, None]
         ^ _mul32(rows // ref_bq, 0x9E3779B9)[None, :, None]
         ^ _mul32(cols // ref_bk, 0x85EBCA6B)[None, None, :])
    h = (h + _mul32(rows % ref_bq, 0x27D4EB2F)[None, :, None]
         + _mul32(cols % ref_bk, 0x165667B1)[None, None, :]) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    keep = h >= _dropout_threshold(dropout_p)
    return keep.reshape(batch, heads, tq, tk)


def _check_args(q, k, v, seed, dropout_p):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, H, T, D) q, k, v")
    if k.shape != v.shape or q.shape[:2] != k.shape[:2] \
            or q.shape[3] != k.shape[3]:
        raise ValueError("flash_attention: shapes q %s, k %s, v %s disagree"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError("dropout_p must be in [0, 1), got %r" % dropout_p)
    if dropout_p > 0.0 and seed is None:
        raise ValueError(
            "flash_attention(dropout_p>0) needs an explicit integer "
            "seed (vary it per step, or dropout masks repeat)")


def flash_attention_plain(q, k, v, key_padding_mask=None, seed=None,
                          sm_scale=None, causal=False, dropout_p=0.0):
    """The kernel's function in plain torch (f32 math): returns (out like
    q, lse (B, H, Tq) f32)."""
    _check_args(q, k, v, seed, dropout_p)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if key_padding_mask is not None:
        s = s + key_padding_mask.float()[:, None, None, :]
    if causal:
        rows = torch.arange(tq, device=q.device)[:, None]
        cols = torch.arange(tk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l_safe == 0.0, torch.ones_like(l_safe), l_safe)
    if dropout_p > 0.0:
        keep = dropout_keep_mask(seed, b, h, tq, tk, dropout_p, q.device)
        p = torch.where(keep, p, torch.zeros_like(p)) * (1.0 / (1.0 - dropout_p))
    out = torch.matmul(p, v.float()) / l_safe
    dead = m <= NEG_INF * 0.5
    out = torch.where(dead, torch.zeros_like(out), out)
    lse = torch.where(dead, torch.full_like(m, NEG_INF), m + torch.log(l_safe))
    return out.to(q.dtype), lse[..., 0]


def flash_attention(q, k, v, key_padding_mask=None, seed=None, sm_scale=None,
                    causal=False, dropout_p=0.0):
    """Flash multi-head attention forward: q (B, H, Tq, D), k/v
    (B, H, Tk, D) -> (out like q, lse (B, H, Tq) f32). Launches
    ``csrc/flash_attn_fwd.cu`` on CUDA tensors (counted in
    ``flash_attention.launches``); runs :func:`flash_attention_plain` on
    CPU tensors."""
    _check_args(q, k, v, seed, dropout_p)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, key_padding_mask, seed,
                                     sm_scale, causal, dropout_p)
    if q.device.type != "cuda":
        raise ValueError("flash_attention: unsupported device %s" % q.device)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError(
                "flash_attention: %s must be contiguous %s on %s" %
                (name, q.dtype, q.device))
    if q.dtype not in _DTYPE_CODE:
        raise ValueError("flash_attention takes float32/bfloat16, got %s"
                         % q.dtype)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if d > _MAX_D:
        raise ValueError("flash_attention: head dim %d > %d" % (d, _MAX_D))
    kpm = None
    if key_padding_mask is not None:
        kpm = key_padding_mask.to(torch.float32).contiguous()
        if tuple(kpm.shape) != (b, tk) or kpm.device != q.device:
            raise ValueError(
                "flash_attention: key_padding_mask must be (%d, %d) on %s"
                % (b, tk, q.device))
    ref_bq, ref_bk = reference_blocks(tq, tk)
    fn = cuda_build.load("flash_attn_fwd").flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty_like(q)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    use_dropout = dropout_p > 0.0
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            kpm.data_ptr() if kpm is not None else None,
            out.data_ptr(), lse.data_ptr(), b * h, h, tq, tk, d,
            float(sm_scale), int(bool(causal)), int(use_dropout),
            _dropout_threshold(dropout_p) if use_dropout else 0,
            1.0 / (1.0 - dropout_p),
            _int32(seed) if use_dropout else 0, ref_bq, ref_bk,
            _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    cuda_build.check(err, "flash_attn_fwd")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0


@register_op("fused_multihead_attention")
def _fused_mha_lowering(ctx, ins, attrs):
    """Q/K/V: (B, H, T, D). Always the flash-attention kernel on the card
    (the JAX package gates its Pallas kernel behind PADDLE_TPU_FLASH_MIN_SEQ
    because XLA fused the plain graph; here nothing else would)."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    kpm = ins["KeyPaddingMask"][0] if ins.get("KeyPaddingMask") else None
    causal = bool(attrs.get("causal", False))
    p = float(attrs.get("dropout_prob", 0.0))
    if attrs.get("is_test", False) or ctx.is_test:
        p = 0.0
    seed = None
    if p > 0.0:
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=ctx.next_rng(),
                                 device=ctx.device).item())
    out, _ = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                             kpm, seed=seed, causal=causal, dropout_p=p)
    return single(out)
