"""Parameter initializers (ref: python/paddle/fluid/initializer.py).

Each initializer appends an op to the *startup program* block that produces
the parameter value; running the startup program draws it on the executor's
device from the run's seeded ``torch.Generator``. Copied from
paddle_tpu/fluid/initializer.py.
"""
import math

import numpy as np

from . import framework
from .framework import default_startup_program

__all__ = [
    "Constant",
    "Uniform",
    "Normal",
    "TruncatedNormal",
    "Xavier",
    "Bilinear",
    "MSRA",
    "NumpyArrayInitializer",
    "ConstantInitializer",
    "UniformInitializer",
    "NormalInitializer",
    "TruncatedNormalInitializer",
    "XavierInitializer",
    "BilinearInitializer",
    "MSRAInitializer",
    "force_init_on_cpu",
    "init_on_cpu",
]


def force_init_on_cpu():
    return False


class init_on_cpu:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError

    @staticmethod
    def _compute_fans(var):
        shape = var.shape
        if len(shape) < 2:
            fan_in = fan_out = int(shape[0]) if shape else 1
        else:
            receptive = 1
            for s in shape[2:]:
                receptive *= int(s)
            fan_in = int(shape[1]) * receptive
            fan_out = int(shape[0]) * receptive
        return fan_in, fan_out


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self._value = value

    def __call__(self, var, block):
        return block.append_op(
            type="fill_constant",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "value": float(self._value),
            },
        )


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self._low = low
        self._high = high
        self._seed = seed

    def __call__(self, var, block):
        return block.append_op(
            type="uniform_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "min": self._low,
                "max": self._high,
                "seed": self._seed,
            },
        )


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean = loc
        self._std_dev = scale
        self._seed = seed

    def __call__(self, var, block):
        return block.append_op(
            type="gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": self._mean,
                "std": self._std_dev,
                "seed": self._seed,
            },
        )


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self._mean = loc
        self._std_dev = scale
        self._seed = seed

    def __call__(self, var, block):
        return block.append_op(
            type="truncated_gaussian_random",
            outputs={"Out": [var.name]},
            attrs={
                "shape": list(var.shape),
                "dtype": var.dtype,
                "mean": self._mean,
                "std": self._std_dev,
                "seed": self._seed,
            },
        )


class XavierInitializer(Initializer):
    """Glorot init (ref initializer.py XavierInitializer)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self._uniform = uniform
        self._fan_in = fan_in
        self._fan_out = fan_out
        self._seed = seed

    def __call__(self, var, block):
        f_in, f_out = self._compute_fans(var)
        fan_in = f_in if self._fan_in is None else self._fan_in
        fan_out = f_out if self._fan_out is None else self._fan_out
        if self._uniform:
            limit = math.sqrt(6.0 / (fan_in + fan_out))
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = math.sqrt(2.0 / (fan_in + fan_out))
        return NormalInitializer(0.0, std, self._seed)(var, block)


class MSRAInitializer(Initializer):
    """Kaiming init (ref initializer.py MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self._uniform = uniform
        self._fan_in = fan_in
        self._seed = seed

    def __call__(self, var, block):
        f_in, _ = self._compute_fans(var)
        fan_in = f_in if self._fan_in is None else self._fan_in
        if self._uniform:
            limit = math.sqrt(6.0 / fan_in)
            return UniformInitializer(-limit, limit, self._seed)(var, block)
        std = math.sqrt(2.0 / fan_in)
        return NormalInitializer(0.0, std, self._seed)(var, block)


class BilinearInitializer(Initializer):
    """For upsampling deconv weights (ref initializer.py BilinearInitializer)."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("BilinearInitializer needs 4-D weight")
        weight = np.zeros(shape, dtype="float32")
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        size = shape[2] * shape[3]
        for i in range(np.prod(shape)):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            idx = np.unravel_index(i, shape)
            weight[idx] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        return NumpyArrayInitializer(weight)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self._value = np.asarray(value)

    def __call__(self, var, block):
        return block.append_op(
            type="assign_value",
            outputs={"Out": [var.name]},
            attrs={
                "dtype": var.dtype,
                "shape": list(self._value.shape),
                "values": self._value.reshape(-1).tolist(),
            },
        )


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer


def _global_weight_initializer():
    return XavierInitializer()


def _global_bias_initializer():
    return ConstantInitializer(0.0)
