"""ref import path python/paddle/fluid/lod_tensor.py; a copy of
paddle_tpu/fluid/lod_tensor.py. The implementations live in fluid/lod.py
(dense-padded + lengths design)."""
from .lod import (  # noqa: F401
    LoDTensor,
    create_lod_tensor,
    create_random_int_lodtensor,
)

__all__ = ["create_lod_tensor", "create_random_int_lodtensor"]
