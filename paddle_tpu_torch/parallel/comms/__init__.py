"""paddle_tpu_torch.parallel.comms — only the block codec
(:mod:`.quantize`) is ported: the disaggregated serving fleet's KV
handoff rides it. The quantized allreduce, bucketing, gradient sync and
error feedback wait for ROADMAP.md Queue 1 item 8.2.
"""
from .quantize import (  # noqa: F401
    DEFAULT_BLOCK, WIRE_DTYPES, compression_ratio, dequantize_blocks,
    pad_flat, quantize_blocks, round_up, wire_bytes, wire_info,
)
