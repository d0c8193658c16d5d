"""Row LayerNorm forward: a hand-written CUDA kernel and its plain torch
version.

Replaces the Pallas TPU kernel paddle_tpu/ops/pallas_layernorm.py
``_fwd_kernel`` (called from ``_ln_fwd``). The kernel is
``csrc/layer_norm_fwd.cu``: one warp per row, f32 statistics, y in the
input dtype, mean and rstd in f32. It is bound by device memory (a few
flops per byte); the source's note says what its design does about that.

:func:`layer_norm_fwd` launches the kernel on a CUDA tensor and takes the
plain version :func:`layer_norm_plain` only for a tensor on the CPU. There
is no fallback on the card: a failed build or launch raises.
"""
import ctypes

import torch

from . import cuda_build

__all__ = ["layer_norm_fwd", "layer_norm_plain"]

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


def _check_param(p, name, x):
    if p is None:
        return
    if p.device != x.device or p.dtype not in _DTYPE_CODE:
        raise ValueError(
            "layer_norm_fwd: %s must be float32/bfloat16 on %s, got %s on %s"
            % (name, x.device, p.dtype, p.device))
    if tuple(p.shape) != (x.shape[1],) or not p.is_contiguous():
        raise ValueError(
            "layer_norm_fwd: %s must be a contiguous (%d,) vector, got %s"
            % (name, x.shape[1], tuple(p.shape)))


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
