"""Flash attention: hand-written CUDA kernels for the forward and the
backward, their plain torch versions, the ``torch.autograd.Function``
that joins them, and the ``fused_multihead_attention`` lowering.

Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_attention.py:
``_fwd_kernel`` / ``_fwd_kernel_nokpm`` (called from ``_fwd_call``) by
``csrc/flash_attn_fwd.cu``, FlashAttention-2 online softmax with f32
statistics, one block per (64-row q tile, batch·head); ``_dq_kernel`` and
``_dkdv_kernel`` (called from ``_bwd_call``) by the two kernels of
``csrc/flash_attn_bwd.cu``, one block per q tile for dQ and one per key
tile for dK/dV, re-forming P from the saved lse. All three run their
products on the tensor cores (``mma.sync``: bf16, or 3xTF32 in f32) from
tiles copied by ``cp.async``, with the parts in ``csrc/flash_mma.cuh``.
Their notes say what bounds them on the H100. :class:`FlashAttention` is
``_flash``'s custom_vjp: its backward computes delta = rowsum(dO∘O) in
f32, launches both backward kernels and sums the per-(batch·head)
key-padding-mask partials over the heads, as ``_flash_bwd`` does.

Semantics kept from ``pallas_attention.flash_attention``: q/k/v are
(B, H, T, D); the default ``sm_scale`` is D^-½; ``key_padding_mask`` is an
additive f32 (B, Tk) mask shared by the heads; causal is ``row >= col`` in
absolute indices; rows with every key masked give 0; dropout > 0 needs an
explicit seed, and its keep mask is the reference's murmur3 counter hash,
taken in the reference's tile coordinates (``reference_blocks``), so the
two packages drop the same scores.

:func:`flash_attention`, :func:`flash_attention_dq` and
:func:`flash_attention_dkdv` launch their kernels on CUDA tensors and take
the plain versions (:func:`flash_attention_plain`,
:func:`flash_attention_dq_plain`, :func:`flash_attention_dkdv_plain`;
:func:`flash_attention_bwd_plain` is both at once) only for tensors on the
CPU. There is
no fallback on the card: a failed build or launch raises.
"""
import ctypes

import torch

from . import cuda_build
from .registry import register_op, single

__all__ = ["flash_attention", "flash_attention_plain", "flash_attention_dq",
           "flash_attention_dq_plain", "flash_attention_dkdv",
           "flash_attention_dkdv_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "FlashAttention", "dropout_keep_mask",
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


def _scores(q, k, key_padding_mask, sm_scale, causal):
    """S = q·kᵀ·scale + mask in f32, causal entries set to -1e30."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if key_padding_mask is not None:
        s = s + key_padding_mask.float()[:, None, None, :]
    if causal:
        rows = torch.arange(q.shape[2], device=q.device)[:, None]
        cols = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_plain(q, k, v, key_padding_mask=None, seed=None,
                          sm_scale=None, causal=False, dropout_p=0.0):
    """The kernel's function in plain torch (f32 math, P rounded to the
    input dtype before P·V where the reference rounds it): returns (out
    like q, lse (B, H, Tq) f32)."""
    _check_args(q, k, v, seed, dropout_p)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    s = _scores(q, k, key_padding_mask, sm_scale, causal)
    m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG_INF)
    p = torch.exp(s - m)
    l_safe = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l_safe == 0.0, torch.ones_like(l_safe), l_safe)
    if dropout_p > 0.0:
        keep = dropout_keep_mask(seed, b, h, tq, tk, dropout_p, q.device)
        p = torch.where(keep, p, torch.zeros_like(p)) * (1.0 / (1.0 - dropout_p))
    # P∘keep/(1−p) rounds to the input dtype before P·V, as the reference's
    # p_use.astype(v.dtype) does (a no-op in f32); l is the unrounded sum
    p = p.to(v.dtype).float()
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


def _bwd_plain_parts(q, k, v, key_padding_mask, seed, do, lse, delta,
                     sm_scale, causal, dropout_p):
    """(sm_scale, P∘keep/(1−p), dS) in f32, as both backward kernels
    re-form them from the saved lse."""
    _check_args(q, k, v, seed, dropout_p)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    s = _scores(q, k, key_padding_mask, sm_scale, causal)
    lse = lse[..., None]
    # dead rows carry lse = -1e30: their P is 0, not e^0
    p = torch.where(lse <= NEG_INF * 0.5, torch.zeros_like(s),
                    torch.exp(s - lse))
    dp = torch.matmul(do.to(v.dtype).float(), v.float().transpose(-1, -2))
    pd = p
    if dropout_p > 0.0:
        keep = dropout_keep_mask(seed, b, h, tq, tk, dropout_p, q.device)
        inv = 1.0 / (1.0 - dropout_p)
        pd = torch.where(keep, p, torch.zeros_like(p)) * inv
        dp = torch.where(keep, dp, torch.zeros_like(dp)) * inv
    return sm_scale, pd, p * (dp - delta[..., None])


def _dq_from(q, k, sm_scale, ds):
    return (torch.matmul(ds.to(k.dtype).float(), k.float())
            * sm_scale).to(q.dtype)


def _dkdv_from(q, k, v, key_padding_mask, do, sm_scale, pd, ds):
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * sm_scale
    dv = torch.matmul(pd.to(do.dtype).float().transpose(-1, -2), do.float())
    dkpm = ds.sum(dim=2) if key_padding_mask is not None else None
    return dk.to(k.dtype), dv.to(v.dtype), dkpm


def flash_attention_dq_plain(q, k, v, key_padding_mask, seed, do, lse, delta,
                             sm_scale=None, causal=False, dropout_p=0.0):
    """The dQ kernel's function in plain torch: dq like q."""
    sm_scale, _, ds = _bwd_plain_parts(q, k, v, key_padding_mask, seed, do,
                                       lse, delta, sm_scale, causal,
                                       dropout_p)
    return _dq_from(q, k, sm_scale, ds)


def flash_attention_dkdv_plain(q, k, v, key_padding_mask, seed, do, lse,
                               delta, sm_scale=None, causal=False,
                               dropout_p=0.0):
    """The dK/dV kernel's function in plain torch: (dk like k, dv like v,
    dkpm per (batch, head) (B, H, Tk) f32 or None)."""
    sm_scale, pd, ds = _bwd_plain_parts(q, k, v, key_padding_mask, seed, do,
                                        lse, delta, sm_scale, causal,
                                        dropout_p)
    return _dkdv_from(q, k, v, key_padding_mask, do, sm_scale, pd, ds)


def flash_attention_bwd_plain(q, k, v, key_padding_mask, seed, do, lse, delta,
                              sm_scale=None, causal=False, dropout_p=0.0):
    """The two backward kernels' function in plain torch (f32 math,
    rounding to the input dtype where the reference rounds), P and dS
    formed once: returns (dq like q, dk like k, dv like v, dkpm per
    (batch, head) (B, H, Tk) f32, or None without a key-padding mask).
    ``lse`` is the forward's, ``delta`` = rowsum(dO∘O) in f32, both
    (B, H, Tq)."""
    sm_scale, pd, ds = _bwd_plain_parts(q, k, v, key_padding_mask, seed, do,
                                        lse, delta, sm_scale, causal,
                                        dropout_p)
    return (_dq_from(q, k, sm_scale, ds),) + _dkdv_from(
        q, k, v, key_padding_mask, do, sm_scale, pd, ds)


def _bwd_args(q, k, v, key_padding_mask, seed, do, lse, delta, sm_scale,
              causal, dropout_p, name):
    """Check the backward kernels' inputs; returns the C arguments after
    the pointers, and the f32 key-padding mask or None."""
    _check_args(q, k, v, seed, dropout_p)
    if q.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (name, q.device))
    for tname, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.device != q.device or t.dtype != q.dtype \
                or not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous %s on %s"
                             % (name, tname, q.dtype, q.device))
    if q.dtype not in _DTYPE_CODE:
        raise ValueError("%s takes float32/bfloat16, got %s" % (name, q.dtype))
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if d > _MAX_D:
        raise ValueError("%s: head dim %d > %d" % (name, d, _MAX_D))
    if do.shape != q.shape:
        raise ValueError("%s: do must be shaped like q" % name)
    for tname, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, tq) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError("%s: %s must be contiguous float32 (%d, %d, %d)"
                             % (name, tname, b, h, tq))
    kpm = None
    if key_padding_mask is not None:
        kpm = key_padding_mask.to(torch.float32).contiguous()
        if tuple(kpm.shape) != (b, tk) or kpm.device != q.device:
            raise ValueError("%s: key_padding_mask must be (%d, %d) on %s"
                             % (name, b, tk, q.device))
    ref_bq, ref_bk = reference_blocks(tq, tk)
    use_dropout = dropout_p > 0.0
    tail = (b * h, h, tq, tk, d, float(sm_scale), int(bool(causal)),
            int(use_dropout),
            _dropout_threshold(dropout_p) if use_dropout else 0,
            1.0 / (1.0 - dropout_p), _int32(seed) if use_dropout else 0,
            ref_bq, ref_bk, _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    return tail, kpm


_BWD_TAIL_TYPES = [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_float,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def flash_attention_dq(q, k, v, key_padding_mask, seed, do, lse, delta,
                       sm_scale=None, causal=False, dropout_p=0.0):
    """dQ of flash attention (B, H, Tq, D) like q. Launches the dQ kernel
    of ``csrc/flash_attn_bwd.cu`` on CUDA tensors (counted in
    ``flash_attention_dq.launches``); runs
    :func:`flash_attention_dq_plain` on CPU tensors."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_dq_plain(q, k, v, key_padding_mask, seed, do,
                                        lse, delta, sm_scale, causal,
                                        dropout_p)
    tail, kpm = _bwd_args(q, k, v, key_padding_mask, seed, do, lse, delta,
                          sm_scale, causal, dropout_p, "flash_attention_dq")
    fn = cuda_build.load("flash_attn_bwd").flash_attn_bwd_dq
    fn.argtypes = [ctypes.c_void_p] * 8 + _BWD_TAIL_TYPES
    fn.restype = ctypes.c_int
    dq = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kpm.data_ptr() if kpm is not None else None, do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *tail)
    cuda_build.check(err, "flash_attn_bwd_dq")
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkdv(q, k, v, key_padding_mask, seed, do, lse, delta,
                         sm_scale=None, causal=False, dropout_p=0.0):
    """(dK like k, dV like v, dkpm per (batch, head) (B, H, Tk) f32 or
    None) of flash attention. Launches the dK/dV kernel of
    ``csrc/flash_attn_bwd.cu`` on CUDA tensors (counted in
    ``flash_attention_dkdv.launches``); runs
    :func:`flash_attention_dkdv_plain` on CPU tensors."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_attention_dkdv_plain(q, k, v, key_padding_mask, seed, do,
                                          lse, delta, sm_scale, causal,
                                          dropout_p)
    tail, kpm = _bwd_args(q, k, v, key_padding_mask, seed, do, lse, delta,
                          sm_scale, causal, dropout_p, "flash_attention_dkdv")
    fn = cuda_build.load("flash_attn_bwd").flash_attn_bwd_dkdv
    fn.argtypes = [ctypes.c_void_p] * 10 + _BWD_TAIL_TYPES
    fn.restype = ctypes.c_int
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dkpm = None
    if kpm is not None:
        dkpm = torch.empty(k.shape[:3], dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kpm.data_ptr() if kpm is not None else None, do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), dkpm.data_ptr() if dkpm is not None else None,
                 *tail)
    cuda_build.check(err, "flash_attn_bwd_dkdv")
    flash_attention_dkdv.launches += 1
    return dk, dv, dkpm


flash_attention_dkdv.launches = 0


def flash_attention_bwd(q, k, v, key_padding_mask, seed, out, lse, do,
                        sm_scale=None, causal=False, dropout_p=0.0):
    """Gradients of flash attention from the forward's out and lse and the
    output's gradient ``do``: (dq, dk, dv, dkpm per (batch, head) or
    None). delta = rowsum(dO∘O) is taken here in f32, as
    pallas_attention._flash_bwd does; then the dQ and the dK/dV kernels
    (or, on the CPU, the plain version once)."""
    delta = (do.float() * out.float()).sum(dim=-1)
    args = (q, k, v, key_padding_mask, seed, do, lse, delta, sm_scale,
            causal, dropout_p)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(*args)
    return (flash_attention_dq(*args),) + tuple(flash_attention_dkdv(*args))


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient (pallas_attention's custom_vjp
    ``_flash``): the forward launches the forward kernel and saves q, k,
    v, the mask, the seed, out and lse; the backward launches the two
    backward kernels. lse is an output without a gradient.

    ``FlashAttention.apply(q, k, v, key_padding_mask, seed, sm_scale,
    causal, dropout_p)`` -> (out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, key_padding_mask, seed, sm_scale, causal,
                dropout_p):
        out, lse = flash_attention(q, k, v, key_padding_mask, seed, sm_scale,
                                   causal, dropout_p)
        ctx.save_for_backward(q, k, v, key_padding_mask, out, lse)
        ctx.seed, ctx.sm_scale = seed, sm_scale
        ctx.causal, ctx.dropout_p = causal, dropout_p
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, kpm, out, lse = ctx.saved_tensors
        dq, dk, dv, dkpm_bh = flash_attention_bwd(
            q, k, v, kpm, ctx.seed, out, lse, dout.contiguous(),
            ctx.sm_scale, ctx.causal, ctx.dropout_p)
        dkpm = None
        if kpm is not None and ctx.needs_input_grad[3]:
            dkpm = dkpm_bh.sum(dim=1).to(kpm.dtype)
        return dq, dk, dv, dkpm, None, None, None, None


@register_op("fused_multihead_attention")
def _fused_mha_lowering(ctx, ins, attrs):
    """Q/K/V: (B, H, T, D). Always the flash-attention kernels on the card
    (the JAX package gates its Pallas kernel behind PADDLE_TPU_FLASH_MIN_SEQ
    because XLA fused the plain graph; here nothing else would), through
    :class:`FlashAttention`, so a backward runs the two backward kernels;
    with autograd off (serving) the Function records no graph and launches
    the same forward kernel. The dropout seed is drawn on the host
    (``ctx.next_seed``): no device round trip per layer."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    kpm = ins["KeyPaddingMask"][0] if ins.get("KeyPaddingMask") else None
    causal = bool(attrs.get("causal", False))
    p = float(attrs.get("dropout_prob", 0.0))
    if attrs.get("is_test", False) or ctx.is_test:
        p = 0.0
    seed = ctx.next_seed() if p > 0.0 else None
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out, _ = FlashAttention.apply(q, k, v, kpm, seed, q.shape[-1] ** -0.5,
                                  causal, p)
    return single(out)
