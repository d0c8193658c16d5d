"""fluid.contrib (ref: python/paddle/fluid/contrib); port of
paddle_tpu/fluid/contrib: ``layers`` (its rnn_impl units), ``decoder`` and
``mixed_precision``. The rest of the reference's contrib (the layers' nn
and metric_op families, reader, quant, slim, trainer, inferencer, the
stat and memory tools, extend_optimizer) waits for later slices
(ROADMAP.md, Queue 1)."""
from . import layers  # noqa: F401
from . import decoder  # noqa: F401
from . import mixed_precision
from .mixed_precision import decorate as mixed_precision_decorate  # noqa: F401

__all__ = ["layers", "mixed_precision"]
