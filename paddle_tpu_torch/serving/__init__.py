"""paddle_tpu_torch.serving — online inference on the card (port of
paddle_tpu/serving)::

    ModelRegistry       named models, isolated scopes, atomic hot reload
      └─ ServingEngine  bounded queue + dispatch thread, dynamic
                        micro-batching, deadlines, load shedding
           └─ Predictor eager forward, parameters resident on the card
    DecodeEngine        slotted KV cache, continuous batching, streaming
      └─ Predictor      one per prefill bucket + one step program, sharing
                        one device copy of the parameters
    ServingServer       stdlib HTTP/JSON frontend (/v1/models/<name>:predict,
                        chunked :generate, /healthz, /metrics)

Every layer reports to :mod:`paddle_tpu_torch.observability` under the
JAX package's metric names. The router (``router.py``) and the
disaggregated engines (``disagg/`` beyond ``tenancy``) wait for ROADMAP.md
Queue 1 item 7.3; the prefix-pool and speculative engines
(``prefix_pool.py``, ``spec.py``) for item 7.4.
"""
from .batcher import BucketSpec, assemble, round_up_pow2, tail_signature  # noqa: F401
from .decode import (  # noqa: F401
    DecodeEngine, DecodeStream, default_prompt_buckets, kv_slot_bytes,
)
from .engine import (  # noqa: F401
    DeadlineExceededError, EngineClosedError, ServingEngine, ShedError,
)
from .http import ServingHandler, ServingServer  # noqa: F401
from .registry import ModelRegistry  # noqa: F401

__all__ = [
    "BucketSpec", "DeadlineExceededError", "DecodeEngine", "DecodeStream",
    "EngineClosedError", "ModelRegistry", "ServingEngine", "ServingHandler",
    "ServingServer", "ShedError", "assemble", "default_prompt_buckets",
    "kv_slot_bytes", "round_up_pow2", "tail_signature",
]
