"""fluid.contrib (ref: python/paddle/fluid/contrib); port of
paddle_tpu/fluid/contrib. Only ``mixed_precision`` is ported; the rest of
the reference's contrib (layers, decoder, reader, quant, slim, trainer,
inferencer, the stat and memory tools, extend_optimizer) waits for later
slices (ROADMAP.md, Queue 1)."""
from . import mixed_precision
from .mixed_precision import decorate as mixed_precision_decorate  # noqa: F401

__all__ = ["mixed_precision"]
