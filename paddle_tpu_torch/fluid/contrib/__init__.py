"""fluid.contrib (ref: python/paddle/fluid/contrib); port of
paddle_tpu/fluid/contrib: ``layers`` (its rnn_impl units), ``decoder``,
``mixed_precision``, and the int8 quantization chain: ``quant``,
``quantize`` and ``slim`` (its ``core.strategy`` and ``quantization``).
The rest of the reference's contrib (the layers' nn and metric_op
families, reader, the rest of slim, trainer, inferencer, the stat and
memory tools, extend_optimizer) waits for a later slice (ROADMAP.md,
Queue 1, item 6.8)."""
from . import layers  # noqa: F401
from . import decoder  # noqa: F401
from . import mixed_precision
from .mixed_precision import decorate as mixed_precision_decorate  # noqa: F401
from . import quant  # noqa: F401
from . import quantize  # noqa: F401
from . import slim  # noqa: F401

__all__ = ["layers", "mixed_precision", "quant", "slim"]
