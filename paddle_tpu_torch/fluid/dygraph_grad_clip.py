"""Gradient clipping strategies for the eager (dygraph) path.

Reference surface: python/paddle/fluid/dygraph_grad_clip.py:1
(GradClipByValue / GradClipByNorm / GradClipByGlobalNorm), consumed by
``optimizer.minimize(loss, grad_clip=...)``.

Port of paddle_tpu/fluid/dygraph_grad_clip.py. A clip strategy is a pure
function over (param, grad) pairs. On symbolic gradients (the static path
of ``minimize(grad_clip=...)``) it appends graph ops through
``layers.clip`` / ``layers.clip_by_norm`` and the global-norm group of
fluid/clip.py, the same ops as the JAX package; on tensors it computes
with torch (the reference honors grad_clip only in dygraph; both packages
accept it on the static path as well).
"""
import torch

from . import framework

__all__ = [
    "GradClipByValue",
    "GradClipByNorm",
    "GradClipByGlobalNorm",
]


def _is_symbolic(g):
    return isinstance(g, framework.Variable)


def _raw(g):
    # eager grads are tensors; accept a wrapper with .value too
    value = getattr(g, "value", None)
    return g if value is None else value


class GradClipBase:
    """Callable over a list of (param, grad) pairs; None grads pass through."""

    def __str__(self):
        raise NotImplementedError()

    def _clip(self, para_and_grad):
        raise NotImplementedError()

    def __call__(self, para_and_grad):
        return self._clip(para_and_grad)


class GradClipByValue(GradClipBase):
    """Elementwise clamp of every gradient to [min_value, max_value].

    ref dygraph_grad_clip.py:45. If ``min_value`` is None it defaults to
    ``-max_value`` (which must then be positive).
    """

    def __init__(self, min_value, max_value=None):
        if min_value is None and max_value is None:
            raise ValueError(
                "GradClipByValue: at least one bound must be given"
            )
        if min_value is None:
            if max_value <= 0.0:
                raise ValueError(
                    "GradClipByValue: max_value must be positive when "
                    "min_value is None"
                )
            min_value = -max_value
        if max_value is None:
            max_value = abs(float(min_value))
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def __str__(self):
        return "ClipByValue, min = %f, max=%f" % (
            self.min_value, self.max_value)

    def _clip(self, para_and_grad):
        out = []
        for p, g in para_and_grad:
            if g is None:
                out.append((p, g))
            elif _is_symbolic(g):
                from .layers import nn as _nn
                out.append((p, _nn.clip(g, self.min_value, self.max_value)))
            else:
                out.append(
                    (p, torch.clamp(_raw(g), self.min_value, self.max_value)))
        return out


class GradClipByNorm(GradClipBase):
    """Per-tensor L2 norm clip: g * clip_norm / max(clip_norm, ||g||).

    ref dygraph_grad_clip.py:120.
    """

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __str__(self):
        return "ClipByNorm, clip_norm=%f" % self.clip_norm

    def _clip(self, para_and_grad):
        out = []
        for p, g in para_and_grad:
            if g is None:
                out.append((p, g))
            elif _is_symbolic(g):
                from .layers import nn as _nn
                out.append((p, _nn.clip_by_norm(g, self.clip_norm)))
            else:
                gv = _raw(g)
                norm = torch.sqrt(torch.sum(torch.square(gv.float())))
                scale = self.clip_norm / torch.clamp(norm, min=self.clip_norm)
                out.append((p, (gv * scale.to(gv.dtype))))
        return out


class GradClipByGlobalNorm(GradClipBase):
    """Joint clip: every grad scaled by max_norm / max(global_norm, max_norm)
    where global_norm = sqrt(sum ||g_i||^2) over ALL grads.

    ref dygraph_grad_clip.py:191.
    """

    def __init__(self, max_global_norm, dtype="float32"):
        self.max_global_norm = float(max_global_norm)
        self.dtype = dtype

    def __str__(self):
        return "ClipByGlobalNorm, max_global_norm=%f" % self.max_global_norm

    def _clip(self, para_and_grad):
        live = [(p, g) for p, g in para_and_grad if g is not None]
        if not live:
            return list(para_and_grad)
        if any(_is_symbolic(g) for _, g in live):
            # static mode: reuse the graph-side global-norm group clip
            from .clip import _global_norm_clip_group
            clipped = iter(
                _global_norm_clip_group(live, self.max_global_norm))
            return [
                (p, next(clipped)[1]) if g is not None else (p, g)
                for p, g in para_and_grad
            ]
        sq = sum(
            torch.sum(torch.square(_raw(g).float()))
            for _, g in live
        )
        global_norm = torch.sqrt(sq)
        scale = self.max_global_norm / torch.clamp(
            global_norm, min=self.max_global_norm)
        out = []
        for p, g in para_and_grad:
            if g is None:
                out.append((p, g))
            else:
                gv = _raw(g)
                out.append((p, gv * scale.to(gv.dtype)))
        return out
