"""Row LayerNorm: hand-written CUDA kernels for the forward and the
backward, their plain torch versions, and the ``torch.autograd.Function``
that joins them.

Replaces the Pallas TPU kernels of paddle_tpu/ops/pallas_layernorm.py:
``_fwd_kernel`` (called from ``_ln_fwd``) by ``csrc/layer_norm_fwd.cu``,
one warp per row, f32 statistics, y in the input dtype, mean and rstd in
f32; ``_bwd_kernel`` (called from ``_ln_bwd``) by
``csrc/layer_norm_bwd.cu``, one launch: dx one warp per row from the
saved mean and rstd, the row read once into registers, and dγ, dβ summed
in f32 in a fixed order inside the same launch and written in gamma's
dtype. Both are bound by device memory (a few flops per byte); the
sources' notes say what their designs do about that. :class:`LayerNorm` is
``_ln``'s custom_vjp: mean and rstd carry no gradient.

:func:`layer_norm_fwd` and :func:`layer_norm_bwd` launch their kernels on
a CUDA tensor and take the plain versions (:func:`layer_norm_plain`,
:func:`layer_norm_bwd_plain`) only for a tensor on the CPU. There is no
fallback on the card: a failed build or launch raises.
"""
import ctypes

import torch

from . import cuda_build

__all__ = ["layer_norm_fwd", "layer_norm_plain", "layer_norm_bwd",
           "layer_norm_bwd_plain", "LayerNorm"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def layer_norm_plain(x, gamma=None, beta=None, eps=1e-5):
    """The kernel's function in plain torch: x (n, h) -> (y like x, mean
    (n,) f32, rstd (n,) f32), statistics as pallas_layernorm computes them
    (mean, then the mean of squared deviations)."""
    xf = x.float()
    mean = xf.mean(dim=1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=1, keepdim=True) + eps)
    y = xc * rstd
    if gamma is not None:
        y = y * gamma.float()
    if beta is not None:
        y = y + beta.float()
    return y.to(x.dtype), mean[:, 0], rstd[:, 0]


def _check_param(p, name, x, fn="layer_norm_fwd"):
    if p is None:
        return
    if p.device != x.device or p.dtype not in _DTYPE_CODE:
        raise ValueError(
            "%s: %s must be float32/bfloat16 on %s, got %s on %s"
            % (fn, name, x.device, p.dtype, p.device))
    if tuple(p.shape) != (x.shape[1],) or not p.is_contiguous():
        raise ValueError(
            "%s: %s must be a contiguous (%d,) vector, got %s"
            % (fn, name, x.shape[1], tuple(p.shape)))


def layer_norm_fwd(x, gamma=None, beta=None, eps=1e-5):
    """LayerNorm over the rows of x (n, h); gamma/beta (h,) or None.
    Returns (y, mean, rstd). Launches ``csrc/layer_norm_fwd.cu`` on a
    CUDA tensor (counted in ``layer_norm_fwd.launches``); runs
    :func:`layer_norm_plain` on a CPU tensor."""
    if x.dim() != 2:
        raise ValueError("layer_norm_fwd takes x of shape (n, h), got %s"
                         % (tuple(x.shape),))
    if x.device.type == "cpu":
        return layer_norm_plain(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise ValueError("layer_norm_fwd: unsupported device %s" % x.device)
    if x.dtype not in _DTYPE_CODE or not x.is_contiguous():
        raise ValueError(
            "layer_norm_fwd: x must be contiguous float32/bfloat16, got %s"
            % x.dtype)
    _check_param(gamma, "gamma", x)
    _check_param(beta, "beta", x)
    if (gamma is not None and beta is not None
            and gamma.dtype != beta.dtype):
        raise ValueError("layer_norm_fwd: gamma and beta dtypes differ")
    w_dtype = (gamma if gamma is not None else beta)
    w_code = _DTYPE_CODE[w_dtype.dtype] if w_dtype is not None else 0
    n, h = x.shape
    fn = cuda_build.load("layer_norm_fwd").layer_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    y = torch.empty_like(x)
    mean = torch.empty(n, dtype=torch.float32, device=x.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(),
            gamma.data_ptr() if gamma is not None else None,
            beta.data_ptr() if beta is not None else None,
            y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), n, h,
            float(eps), _DTYPE_CODE[x.dtype], w_code,
            torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "layer_norm_fwd")
    layer_norm_fwd.launches += 1
    return y, mean, rstd


layer_norm_fwd.launches = 0


def layer_norm_bwd_plain(x, gamma, mean, rstd, dy):
    """The backward kernel's function in plain torch: from x (n, h), gamma
    (h,) or None (ones), the forward's f32 mean and rstd (n,) and dy like
    x, returns (dx like x, dgamma, dbeta) with dgamma/dbeta in gamma's
    dtype (f32 without gamma), as pallas_layernorm._ln_bwd computes them."""
    xf, dyf = x.float(), dy.float()
    xhat = (xf - mean[:, None]) * rstd[:, None]
    wdy = dyf * gamma.float() if gamma is not None else dyf
    c1 = wdy.mean(dim=1, keepdim=True)
    c2 = (wdy * xhat).mean(dim=1, keepdim=True)
    dx = (wdy - c1 - xhat * c2) * rstd[:, None]
    w_dtype = gamma.dtype if gamma is not None else torch.float32
    return (dx.to(x.dtype), (dyf * xhat).sum(dim=0).to(w_dtype),
            dyf.sum(dim=0).to(w_dtype))


def layer_norm_bwd(x, gamma, mean, rstd, dy):
    """LayerNorm backward over the rows of x (n, h): (dx, dgamma, dbeta).
    Launches ``csrc/layer_norm_bwd.cu`` once on a CUDA tensor (counted in
    ``layer_norm_bwd.launches``): it writes dx, and dγ/dβ in gamma's dtype
    (f32 without gamma); runs :func:`layer_norm_bwd_plain` on a CPU
    tensor."""
    if x.dim() != 2 or dy.shape != x.shape:
        raise ValueError("layer_norm_bwd takes x and dy of one shape (n, h), "
                         "got %s and %s" % (tuple(x.shape), tuple(dy.shape)))
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, gamma, mean, rstd, dy)
    if x.device.type != "cuda":
        raise ValueError("layer_norm_bwd: unsupported device %s" % x.device)
    n, h = x.shape
    for name, t in (("x", x), ("dy", dy)):
        if t.dtype != x.dtype or t.dtype not in _DTYPE_CODE \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError("layer_norm_bwd: %s must be contiguous "
                             "float32/bfloat16 like x" % name)
    for name, t in (("mean", mean), ("rstd", rstd)):
        if tuple(t.shape) != (n,) or t.dtype != torch.float32 \
                or t.device != x.device or not t.is_contiguous():
            raise ValueError("layer_norm_bwd: %s must be contiguous float32 "
                             "(%d,)" % (name, n))
    _check_param(gamma, "gamma", x, "layer_norm_bwd")
    lib = cuda_build.load("layer_norm_bwd")
    fn = lib.layer_norm_bwd
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ws = lib.layer_norm_bwd_workspace
    ws.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    ws.restype = ctypes.c_int
    w_dtype = gamma.dtype if gamma is not None else torch.float32
    dx = torch.empty_like(x)
    dg = torch.empty(h, dtype=w_dtype, device=x.device)
    db = torch.empty(h, dtype=w_dtype, device=x.device)
    with torch.cuda.device(x.device):
        n_scratch = ctypes.c_longlong(0)
        cuda_build.check(ws(n, h, ctypes.byref(n_scratch)), "layer_norm_bwd")
        # the blocks' partial rows of dγ and dβ, summed inside the launch
        scratch = torch.empty(n_scratch.value, dtype=torch.float32,
                              device=x.device)
        err = fn(x.data_ptr(),
                 gamma.data_ptr() if gamma is not None else None,
                 mean.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), scratch.data_ptr(), dg.data_ptr(),
                 db.data_ptr(), n, h, _DTYPE_CODE[x.dtype],
                 _DTYPE_CODE[w_dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    cuda_build.check(err, "layer_norm_bwd")
    layer_norm_bwd.launches += 1
    return dx, dg, db


layer_norm_bwd.launches = 0


class LayerNorm(torch.autograd.Function):
    """Row LayerNorm with its gradient (pallas_layernorm's custom_vjp
    ``_ln``): the forward launches the forward kernel and saves x, gamma,
    mean and rstd; the backward launches the backward kernel. mean and
    rstd are outputs without a gradient.

    ``LayerNorm.apply(x, gamma, beta, eps)`` -> (y, mean, rstd)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        y, mean, rstd = layer_norm_fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, rstd)
        ctx.mark_non_differentiable(mean, rstd)
        return y, mean, rstd

    @staticmethod
    def backward(ctx, dy, _dmean, _drstd):
        x, gamma, mean, rstd = ctx.saved_tensors
        dx, dg, db = layer_norm_bwd(x, gamma, mean, rstd, dy.contiguous())
        return (dx, dg if ctx.needs_input_grad[1] else None,
                db if ctx.needs_input_grad[2] else None, None)
