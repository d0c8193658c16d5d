"""Op lowerings (importing this package registers them). Port of
paddle_tpu/ops for the ops of the slices ported so far (ROADMAP.md
Queue 1)."""
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
from . import sequence_ops  # noqa: F401
from . import rnn_ops  # noqa: F401
from . import detection_ops  # noqa: F401
from . import rcnn_ops  # noqa: F401
from . import crf_ops  # noqa: F401
from . import misc_ops  # noqa: F401
from . import collective_ops  # noqa: F401
from .registry import (  # noqa: F401
    LOWERINGS, get_lowering, has_lowering, register_op,
)
