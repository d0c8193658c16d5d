"""paddle_tpu_torch.parallel.comms — the gradient-communication
subsystem (port of paddle_tpu/parallel/comms). Four layers:

- :mod:`.quantize` — block-scaled int8/fp8 encode/decode with per-block
  scales + error-feedback helpers (EQuARX / DGC lineage); the
  disaggregated serving fleet's KV handoff rides it too;
- :mod:`.allreduce` — the quantized two-shot allreduce over a rank
  group (quantize -> all_to_all -> dequant-accumulate -> all_gather),
  ``CommConfig``, and the tensor-wide ``pmean_int8``;
- :mod:`.bucketing` — deterministic size-targeted gradient buckets in
  reverse-backward order + ``sync_bucketed``;
- :mod:`.grad_sync` — ``GradSyncProgram``, the dp program that owns
  its gradient collectives via the ``grad_comm`` lowering hook, with
  ``comm.*`` telemetry and deadline-covered dispatch.

Selected per ``Fleet`` config: ``DistributedStrategy.grad_sync_mode =
"comms"`` (+ ``grad_quantize`` / ``grad_bucket_bytes`` /
``grad_overlap`` / ``grad_error_feedback`` knobs) — see
parallel/fleet.py.
"""
from .allreduce import (  # noqa: F401
    CommConfig, allreduce_wire_bytes, exact_allreduce_flat, pmean_int8,
    quantized_allreduce_flat,
)
from .bucketing import (  # noqa: F401
    Bucket, BucketPlan, bucket_padded_len, pack_bucket, plan_buckets,
    residual_name, sync_bucketed, unpack_bucket,
)
from .grad_sync import GradSyncProgram  # noqa: F401
from .quantize import (  # noqa: F401
    DEFAULT_BLOCK, WIRE_DTYPES, compression_ratio, dequantize_blocks,
    error_feedback_apply, error_feedback_update, pad_flat,
    quantize_blocks, round_up, wire_bytes, wire_info,
)

__all__ = [
    "CommConfig", "GradSyncProgram",
    "quantize_blocks", "dequantize_blocks", "pad_flat", "wire_info",
    "error_feedback_apply", "error_feedback_update",
    "wire_bytes", "compression_ratio", "DEFAULT_BLOCK", "WIRE_DTYPES",
    "quantized_allreduce_flat", "exact_allreduce_flat", "pmean_int8",
    "allreduce_wire_bytes",
    "Bucket", "BucketPlan", "plan_buckets", "bucket_padded_len",
    "pack_bucket", "unpack_bucket", "sync_bucketed", "residual_name",
]
