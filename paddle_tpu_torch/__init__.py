"""paddle_tpu_torch — the port of paddle_tpu to PyTorch and CUDA for one
NVIDIA H100.

The Fluid API and its Programs are the same as paddle_tpu's; ops lower to
torch, and every Pallas TPU kernel on a ported path becomes a CUDA kernel
written by hand for Hopper (``csrc/``). It imports torch and never jax or
paddle_tpu. Entry points run on the card unless the caller passes a CPU
place::

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import serving
"""
from . import fluid  # noqa: F401
from . import reader  # noqa: F401
from . import serving  # noqa: F401

__version__ = "0.1.0"
