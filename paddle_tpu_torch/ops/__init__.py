"""Op lowerings (importing this package registers them). Port of
paddle_tpu/ops for the ops of the BERT, ResNet, MNIST, GPT and
Transformer NMT slices."""
from . import registry
from . import math_ops  # noqa: F401
from . import tensor_ops  # noqa: F401
from . import random_ops  # noqa: F401
from . import nn_ops  # noqa: F401
from . import cuda_attention  # noqa: F401
from . import loss_ops  # noqa: F401
from . import metric_ops  # noqa: F401
from . import optimizer_ops  # noqa: F401
from . import control_ops  # noqa: F401
from .registry import LOWERINGS, get_lowering, register_op  # noqa: F401
