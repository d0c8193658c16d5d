"""fluid.contrib.layers namespace (ref: contrib/layers/__init__.py); port
of paddle_tpu/fluid/contrib/layers: the rnn_impl basic units. The
text-matching/CTR op family (nn) and the metric bundle (metric_op) wait
for a later slice (ROADMAP.md Queue 1, item 6.8)."""
from . import rnn_impl
from .rnn_impl import *  # noqa: F401,F403

__all__ = list(rnn_impl.__all__)
