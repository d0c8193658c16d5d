"""fluid.layers namespace (ref: python/paddle/fluid/layers/__init__.py)."""
from . import nn
from .nn import *  # noqa: F401,F403
from . import io
from .io import *  # noqa: F401,F403
from . import tensor
from .tensor import *  # noqa: F401,F403
from . import loss
from .loss import *  # noqa: F401,F403
from . import metric_op
from .metric_op import *  # noqa: F401,F403
from . import learning_rate_scheduler
from .learning_rate_scheduler import *  # noqa: F401,F403
from . import control_flow
from .control_flow import *  # noqa: F401,F403
from . import ops
from .ops import *  # noqa: F401,F403
from . import sequence_lod
from .sequence_lod import *  # noqa: F401,F403
from . import rnn
from . import rnn_cells  # noqa: F401
_rnn_module = rnn
# rebinds `rnn` to the rnn() layer, like the reference
from .rnn import *  # noqa: F401,F403
from . import detection
from .detection import *  # noqa: F401,F403
from . import distributions
from .distributions import *  # noqa: F401,F403
from . import device  # noqa: F401
from . import collective  # noqa: F401
from . import layer_function_generator  # noqa: F401
from . import math_op_patch

math_op_patch.monkey_patch_variable()

__all__ = []
__all__ += nn.__all__
__all__ += io.__all__
__all__ += tensor.__all__
__all__ += loss.__all__
__all__ += metric_op.__all__
__all__ += learning_rate_scheduler.__all__
__all__ += control_flow.__all__
__all__ += ops.__all__
__all__ += sequence_lod.__all__
__all__ += _rnn_module.__all__
__all__ += detection.__all__
__all__ += distributions.__all__
