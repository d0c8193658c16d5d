"""Quantized allreduce over a rank group (port of
paddle_tpu/parallel/comms/allreduce.py).

The two-shot EQuARX schedule (PAPERS.md: "EQuARX: Efficient Quantized
AllReduce in XLA"), on the group's ``torch.distributed`` collectives
where the JAX package uses jax collectives inside shard_map:

1. **quantize** the local flat vector block-wise (int8 payload +
   per-block fp32 scales);
2. **reduce-scatter**: ``all_to_all`` routes each rank its own 1/n chunk
   of every peer's quantized payload — the only phase where the full
   vector crosses the wire, and it crosses quantized;
3. **dequant-accumulate**: each rank decodes the n received chunks with
   their senders' scales and sums them in fp32 in rank order;
4. **all-gather**: the reduced chunk is re-quantized and gathered, so
   the return leg is quantized too. Every rank decodes the SAME payload
   — the result is bit-identical across ranks, which keeps replicated
   parameters replicated.

Total wire bytes: ``2 * (n-1)/n * (N + 4N/block)`` vs the fp32 ring's
``2 * (n-1)/n * 4N`` — a 3.94x payload cut at block 256.

``group`` is a :class:`paddle_tpu_torch.parallel.mesh.RankGroup`; every
rank calls each function with a flat vector of the same length.
``pmean_int8`` is the legacy tensor-wide-scale single-shot variant
LocalSGD's delta sync rides (parallel/local_sgd.py,
``quantized_sync=True``).
"""
import torch

from . import quantize as qz

__all__ = ["CommConfig", "quantized_allreduce_flat", "exact_allreduce_flat",
           "pmean_int8", "allreduce_wire_bytes"]


class CommConfig:
    """Gradient-communication knobs, carried per Fleet/program.

    - ``quantized``: block-scaled quantized allreduce instead of fp32
    - ``block_size``: elements per quantization scale block
    - ``wire_dtype``: ``"int8"`` (default) or ``"fp8_e4m3"``
    - ``error_feedback``: carry per-rank compression residuals across
      steps (quantized path only)
    - ``bucket_bytes``: target size of gradient buckets
      (:mod:`.bucketing`); one allreduce per bucket
    - ``overlap``: in the JAX package, leave XLA free to overlap bucket
      collectives with the remaining backward; ``False`` fences every
      collective behind the complete backward pass. The port runs
      eagerly and syncs after the backward in both cases, so the two
      give the same values and the same schedule; the knob sets the
      reported ``overlap_ratio``.
    """

    __slots__ = ("quantized", "block_size", "wire_dtype",
                 "error_feedback", "bucket_bytes", "overlap")

    def __init__(self, quantized=False, block_size=qz.DEFAULT_BLOCK,
                 wire_dtype="int8", error_feedback=True,
                 bucket_bytes=4 << 20, overlap=True):
        self.quantized = bool(quantized)
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1, got %d"
                             % self.block_size)
        if wire_dtype not in qz.WIRE_DTYPES:
            raise ValueError(
                "unknown wire dtype %r (known: %s)"
                % (wire_dtype, sorted(qz.WIRE_DTYPES)))
        self.wire_dtype = wire_dtype
        self.error_feedback = bool(error_feedback)
        self.bucket_bytes = int(bucket_bytes)
        if self.bucket_bytes < 1:
            raise ValueError("bucket_bytes must be >= 1, got %d"
                             % self.bucket_bytes)
        self.overlap = bool(overlap)

    def to_dict(self):
        return {k: getattr(self, k) for k in self.__slots__}

    def __repr__(self):
        return "CommConfig(%s)" % ", ".join(
            "%s=%r" % (k, getattr(self, k)) for k in self.__slots__)


def quantized_allreduce_flat(flat, group, block_size=qz.DEFAULT_BLOCK,
                             wire_dtype="int8", mean=True):
    """Block-scaled quantized allreduce of a flat fp32 vector over
    `group`. ``flat`` must be the same length on every rank and a
    multiple of ``group.size * block_size`` (see
    :func:`.bucketing.bucket_padded_len`). Returns ``(reduced,
    local_decoded)``: the (mean- or sum-) reduced vector, identical on
    every rank, and this rank's locally-decoded phase-1 payload — what
    the wire carried for THIS rank, the reference value error feedback
    needs."""
    n = group.size
    length = flat.shape[0]
    chunk = length // n
    if chunk * n != length or chunk % block_size:
        raise ValueError(
            "quantized allreduce needs len %% (axis_size * block) == 0; "
            "got len=%d, axis=%d, block=%d" % (length, n, block_size))
    payload, scales = qz.quantize_blocks(flat, block_size, wire_dtype)
    local_decoded = qz.dequantize_blocks(payload, scales, block_size)
    # phase 1 — reduce-scatter: chunk j of every rank's payload lands on
    # rank j (the narrow dtype on the wire)
    recv = group.all_to_all(payload)
    recv_scales = group.all_to_all(scales)
    decoded = (recv.float().reshape(n, -1, block_size)
               * recv_scales.reshape(n, -1)[:, :, None])
    reduced = decoded.reshape(n, chunk).sum(dim=0)
    if mean:
        reduced = reduced / n
    # phase 2 — re-quantize the reduced chunk and gather: the return leg
    # is quantized too, and every rank decodes identical bytes
    payload2, scales2 = qz.quantize_blocks(reduced, block_size, wire_dtype)
    full = group.all_gather(payload2)
    full_scales = group.all_gather(scales2)
    return qz.dequantize_blocks(full, full_scales, block_size), local_decoded


def exact_allreduce_flat(flat, group, mean=True):
    """fp32 reference path with the same call shape as the quantized
    one (``local_decoded`` is the input itself: no compression, no
    residual)."""
    total = group.all_reduce(flat)
    if mean:
        total = total / group.size
    return total, flat


def allreduce_wire_bytes(n_elements, n_shards, quantized=False,
                         block_size=qz.DEFAULT_BLOCK, wire_dtype="int8",
                         full_itemsize=4):
    """Deterministic bytes-on-the-wire accounting for one allreduce of
    ``n_elements`` over ``n_shards`` (per shard): the fp32 ring moves
    ``2 (n-1)/n * 4N``; the quantized two-shot moves the same chunk
    pattern with int8 payloads + fp32 block scales."""
    n = max(1, int(n_shards))
    frac = 2.0 * (n - 1) / n
    if not quantized:
        return frac * float(n_elements) * full_itemsize
    return frac * qz.wire_bytes(n_elements, block_size, wire_dtype)


def pmean_int8(x, group):
    """Mean of ``x`` over `group` with an int8-quantized payload.

    Tensor-wide shared symmetric scale ``s = max over ranks of max|x| /
    127`` (one scalar all-reduce — every rank must use the SAME scale or
    the sum is meaningless), int32 sum of the int8 payload, dequantize,
    divide. Error bound: |pmean_int8(x) - mean(x)| <= s/2 per element.

    Non-float inputs and scalars take the exact mean — quantizing a
    handful of elements saves nothing."""
    n = group.size
    if not torch.is_floating_point(x) or x.dim() == 0:
        return group.all_reduce(x) / n
    amax = group.all_reduce(x.detach().abs().max().float(), "max")
    # all-zero tensors: keep the scale finite; the result is exactly 0
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    total = group.all_reduce(q.to(torch.int32))
    return (total.float() * (scale / n)).to(x.dtype)
