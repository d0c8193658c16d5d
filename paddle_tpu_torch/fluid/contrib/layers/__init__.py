"""fluid.contrib.layers namespace (ref: contrib/layers/__init__.py);
port of paddle_tpu/fluid/contrib/layers: rnn_impl basic units + the
text-matching/CTR op family (nn) + metric bundle (metric_op)."""
from . import rnn_impl
from .rnn_impl import *  # noqa: F401,F403
from . import nn
from .nn import *  # noqa: F401,F403
from . import metric_op
from .metric_op import *  # noqa: F401,F403

__all__ = list(rnn_impl.__all__) + list(nn.__all__) \
    + list(metric_op.__all__)
