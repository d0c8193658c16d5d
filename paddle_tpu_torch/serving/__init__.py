"""paddle_tpu_torch.serving — online inference on the card (port of
paddle_tpu/serving, the ServingEngine layer)::

    ServingEngine   bounded queue + dispatch thread, dynamic
                    micro-batching, deadlines, load shedding
      └─ Predictor  eager forward, parameters resident on the card

The HTTP frontend, registry, router and the decode, disaggregated and
speculative engines wait for later slices (ROADMAP.md).
"""
from .batcher import BucketSpec, assemble, round_up_pow2, tail_signature  # noqa: F401
from .engine import (  # noqa: F401
    DeadlineExceededError, EngineClosedError, ServingEngine, ShedError,
)

__all__ = [
    "BucketSpec", "DeadlineExceededError", "EngineClosedError",
    "ServingEngine", "ShedError", "assemble", "round_up_pow2",
    "tail_signature",
]
