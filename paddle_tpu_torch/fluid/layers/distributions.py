"""Probability distributions (ref: python/paddle/fluid/layers/
distributions.py): Uniform, Normal, Categorical, MultivariateNormalDiag —
same class surface, math composed from layer primitives. A copy of
paddle_tpu/fluid/layers/distributions.py bound to the port's layers; its
draws come from the run's torch.Generator."""
import math

import numpy as np

from ..framework import Variable
from . import nn, ops, tensor

__all__ = ["Uniform", "Normal", "Categorical", "MultivariateNormalDiag"]


def _to_var(v, like=None):
    if isinstance(v, Variable):
        return v
    arr = np.asarray(v, dtype="float32")
    return tensor.assign(arr)


class Distribution:
    def sample(self, shape, seed=0):
        raise NotImplementedError

    def entropy(self):
        raise NotImplementedError

    def log_prob(self, value):
        raise NotImplementedError

    def kl_divergence(self, other):
        raise NotImplementedError


class Uniform(Distribution):
    """U(low, high) (ref distributions.py Uniform)."""

    def __init__(self, low, high):
        self.low = _to_var(low)
        self.high = _to_var(high)

    def sample(self, shape, seed=0):
        u = ops.uniform_random(shape, min=0.0, max=1.0, seed=seed)
        rng = nn.elementwise_sub(self.high, self.low)
        return nn.elementwise_add(
            nn.elementwise_mul(u, rng), self.low
        )

    def log_prob(self, value):
        rng = nn.elementwise_sub(self.high, self.low)
        lb = tensor.cast(nn._layer("less_than", {"X": self.low, "Y": value},
                                   out_dtype="bool"), "float32")
        ub = tensor.cast(nn._layer("less_than", {"X": value, "Y": self.high},
                                   out_dtype="bool"), "float32")
        inside = nn.elementwise_mul(lb, ub)
        return nn.elementwise_sub(
            nn.log(inside), nn.log(rng)
        )

    def entropy(self):
        return nn.log(nn.elementwise_sub(self.high, self.low))


class Normal(Distribution):
    """N(loc, scale) (ref distributions.py Normal)."""

    def __init__(self, loc, scale):
        self.loc = _to_var(loc)
        self.scale = _to_var(scale)

    def sample(self, shape, seed=0):
        z = nn.gaussian_random(shape, mean=0.0, std=1.0, seed=seed)
        return nn.elementwise_add(
            nn.elementwise_mul(z, self.scale), self.loc
        )

    def log_prob(self, value):
        var = nn.elementwise_mul(self.scale, self.scale)
        diff = nn.elementwise_sub(value, self.loc)
        return nn.elementwise_sub(
            nn.scale(
                nn.elementwise_div(nn.elementwise_mul(diff, diff), var),
                scale=-0.5,
            ),
            nn.scale(
                nn.log(self.scale), scale=1.0,
                bias=0.5 * math.log(2.0 * math.pi),
            ),
        )

    def entropy(self):
        return nn.scale(
            nn.log(self.scale),
            scale=1.0,
            bias=0.5 + 0.5 * math.log(2.0 * math.pi),
        )

    def kl_divergence(self, other):
        var_ratio = nn.elementwise_div(self.scale, other.scale)
        var_ratio = nn.elementwise_mul(var_ratio, var_ratio)
        t1 = nn.elementwise_div(
            nn.elementwise_sub(self.loc, other.loc), other.scale
        )
        t1 = nn.elementwise_mul(t1, t1)
        return nn.scale(
            nn.elementwise_sub(
                nn.elementwise_add(var_ratio, t1), nn.log(var_ratio)
            ),
            scale=0.5,
            bias=-0.5,
        )


class Categorical(Distribution):
    """Categorical over logits (ref distributions.py Categorical)."""

    def __init__(self, logits):
        self.logits = logits

    def _probs(self):
        return nn.softmax(self.logits)

    def sample(self, shape=None, seed=0):
        # (the reference raises NotImplementedError here; we sample via
        # sampling_id, tiling the batch for a leading sample shape)
        if not shape:
            return nn.sampling_id(self._probs(), seed=seed)
        import numpy as _np

        probs = self._probs()
        if len(probs.shape) != 2:
            raise ValueError(
                "Categorical.sample with a sample shape needs 2-D logits "
                "(batch, n_categories)"
            )
        n = int(_np.prod(shape))
        tiled = nn.expand(nn.unsqueeze(probs, [0]), [n, 1, 1])
        flat = nn.reshape(tiled, [-1, probs.shape[-1]])
        draws = nn.sampling_id(flat, seed=seed)
        return nn.reshape(draws, list(shape) + [probs.shape[0]])

    def entropy(self):
        p = self._probs()
        logp = nn._layer("log_softmax", {"X": self.logits})
        return nn.scale(
            nn.reduce_sum(nn.elementwise_mul(p, logp), dim=[-1]),
            scale=-1.0,
        )

    def log_prob(self, value):
        logp = nn._layer("log_softmax", {"X": self.logits})
        oh = nn.one_hot(tensor.cast(value, "int64"), self.logits.shape[-1])
        return nn.reduce_sum(nn.elementwise_mul(logp, oh), dim=[-1])

    def kl_divergence(self, other):
        p = self._probs()
        lp = nn._layer("log_softmax", {"X": self.logits})
        lq = nn._layer("log_softmax", {"X": other.logits})
        return nn.reduce_sum(
            nn.elementwise_mul(p, nn.elementwise_sub(lp, lq)), dim=[-1]
        )


class MultivariateNormalDiag(Distribution):
    """N(loc, Sigma) with diagonal covariance `scale` given as the (D, D)
    diagonal COVARIANCE matrix, matching the reference semantics
    (ref distributions.py MultivariateNormalDiag: entropy/kl use
    det/inv of the covariance itself)."""

    def __init__(self, loc, scale):
        self.loc = _to_var(loc)      # (D,)
        self.scale = _to_var(scale)  # (D, D) diagonal covariance matrix

    def _cov_diag(self):
        # diagonal of the covariance: sum over rows of eye*scale
        d = self.scale.shape[0]
        eye = tensor.eye(d, d)
        return nn.reduce_sum(nn.elementwise_mul(self.scale, eye), dim=[1])

    def sample(self, shape=None, seed=0):
        d = self.loc.shape[-1]
        z = nn.gaussian_random(list(shape or []) + [d], seed=seed)
        std = ops.sqrt(self._cov_diag())
        return nn.elementwise_add(nn.elementwise_mul(z, std), self.loc)

    def entropy(self):
        # 0.5 * (d*(1+log 2pi) + log det(Sigma))
        var = self._cov_diag()
        d = self.loc.shape[-1]
        return nn.scale(
            nn.reduce_sum(nn.log(var)),
            scale=0.5,
            bias=0.5 * d * (1.0 + math.log(2.0 * math.pi)),
        )

    def kl_divergence(self, other):
        var1 = self._cov_diag()
        var2 = other._cov_diag()
        ratio = nn.elementwise_div(var1, var2)
        diff = nn.elementwise_sub(other.loc, self.loc)
        t2 = nn.elementwise_div(nn.elementwise_mul(diff, diff), var2)
        n = float(self.loc.shape[-1])
        return nn.scale(
            nn.elementwise_sub(
                nn.elementwise_add(
                    nn.reduce_sum(ratio), nn.reduce_sum(t2)
                ),
                nn.reduce_sum(nn.log(ratio)),
            ),
            scale=0.5,
            bias=-0.5 * n,
        )
