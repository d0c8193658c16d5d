"""paddle_tpu_torch.serving — online inference on the card (port of
paddle_tpu/serving, the ServingEngine and DecodeEngine layers)::

    ServingEngine   bounded queue + dispatch thread, dynamic
                    micro-batching, deadlines, load shedding
      └─ Predictor  eager forward, parameters resident on the card
    DecodeEngine    slotted KV cache, continuous batching, streaming
      └─ Predictor  one per prefill bucket + one step program, sharing
                    one device copy of the parameters

The HTTP frontend, registry, router and the disaggregated, prefix-pool
and speculative engines wait for later slices (ROADMAP.md Queue 1, item
7).
"""
from .batcher import BucketSpec, assemble, round_up_pow2, tail_signature  # noqa: F401
from .decode import (  # noqa: F401
    DecodeEngine, DecodeStream, default_prompt_buckets, kv_slot_bytes,
)
from .engine import (  # noqa: F401
    DeadlineExceededError, EngineClosedError, ServingEngine, ShedError,
)

__all__ = [
    "BucketSpec", "DeadlineExceededError", "DecodeEngine", "DecodeStream",
    "EngineClosedError", "ServingEngine", "ShedError", "assemble",
    "default_prompt_buckets", "kv_slot_bytes", "round_up_pow2",
    "tail_signature",
]
