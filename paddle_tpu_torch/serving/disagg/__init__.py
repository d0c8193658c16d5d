"""Disaggregated prefill/decode serving (port of
paddle_tpu/serving/disagg).

The :class:`~paddle_tpu_torch.serving.decode.DecodeEngine` runs prefill
and step on the same device, so one long prompt stalls every live
stream. This package splits the two phases across the fleet machinery:

- :mod:`.kv_wire` — the serialized KV handoff (EQuARX int8 block-scaled
  per (layer, row) with fp32 scales; ``fp32`` lossless mode) between the
  phases, byte for byte the JAX package's format.
- :mod:`.prefill` — :class:`PrefillEngine`: bucketed-prefill-only
  replicas with a priority queue and a TTFT SLO.
- :mod:`.tenancy` — per-tenant priority classes, quotas, and SLO targets
  gating admission.
- :mod:`.router` — :class:`DisaggRouter`: session-affine routing over
  prefill + decode replicas, dead-replica migration via re-prefill (zero
  failed streams), and the :func:`disagg_fleet` builder.

The int8-**resident** slot cache lives in
``DecodeEngine(kv_dtype="int8")`` (``serving/decode.py``) — same codec,
applied to residency instead of transport.
"""
from .kv_wire import (
    KVHandoff, decode_kv, dequantize_rows, encode_kv,
    handoff_compression, handoff_wire_bytes, quantize_rows,
)
from .prefill import PrefillEngine, PrefillTicket
from .router import DisaggReplica, DisaggRouter, DisaggStream, disagg_fleet
from .tenancy import (
    PRIORITY_CLASSES, TenantSpec, TenantTable, resolve_priority,
)

__all__ = [
    "KVHandoff", "encode_kv", "decode_kv", "quantize_rows",
    "dequantize_rows", "handoff_wire_bytes", "handoff_compression",
    "PrefillEngine", "PrefillTicket",
    "DisaggReplica", "DisaggRouter", "DisaggStream", "disagg_fleet",
    "PRIORITY_CLASSES", "TenantSpec", "TenantTable", "resolve_priority",
]
