"""fluid.layers namespace (ref: python/paddle/fluid/layers/__init__.py):
the layers the port covers so far."""
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
from . import control_flow
from .control_flow import *  # noqa: F401,F403
from . import ops
from .ops import *  # noqa: F401,F403
from .rnn import gather_tree  # noqa: F401
from . import rnn_cells
from .rnn_cells import *  # noqa: F401,F403  (binds `rnn` to the rnn() layer, like the reference)

__all__ = []
__all__ += nn.__all__
__all__ += io.__all__
__all__ += tensor.__all__
__all__ += loss.__all__
__all__ += metric_op.__all__
__all__ += control_flow.__all__
__all__ += ops.__all__
__all__ += ["gather_tree"]
__all__ += rnn_cells.__all__
