"""paddle.libs (ref: python/paddle/libs — bundled native shared
objects: mklml, warpctc, ...). Port of paddle_tpu/libs. This package's
native code is built from its sources at first use: the card's kernels
from ``paddle_tpu_torch/csrc`` by nvcc (``ops/cuda_build.py``), the host
data library from ``paddle_tpu_torch/native`` by g++. No .so bundle
ships here."""

__all__ = []
