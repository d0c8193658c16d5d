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

__all__ = []
__all__ += nn.__all__
__all__ += io.__all__
__all__ += tensor.__all__
__all__ += loss.__all__
__all__ += metric_op.__all__
__all__ += control_flow.__all__
__all__ += ops.__all__
