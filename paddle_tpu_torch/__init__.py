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
from . import reader  # noqa: F401
# like the reference: import the module, then rebind the name to the
# function, so paddle.batch(...) calls it and import ...batch works
from . import batch  # noqa: F401
batch = batch.batch
from . import fluid  # noqa: F401
from . import observability  # noqa: F401
from . import serving  # noqa: F401
from . import dataset  # noqa: F401
from . import compat  # noqa: F401
from . import sysconfig  # noqa: F401
from . import utils  # noqa: F401
# ref paddle/__init__.py runs the Windows scipy-DLL diagnosis at import
from .check_import_scipy import check_import_scipy
import os as _os

check_import_scipy(_os.name)

__version__ = "0.1.0"


def version():
    return __version__
