"""Block-scaled quantization (port of the codec in
paddle_tpu/parallel/comms/quantize.py).

EQuARX-style encoding (PAPERS.md: "EQuARX: Efficient Quantized
AllReduce in XLA", arxiv 2506.17615): a flat fp32 vector is split into
fixed-size blocks, each block carries its OWN symmetric scale
``s_b = max|block| / levels``, and payloads ship as int8 (or fp8
``float8_e4m3fn``). Per-block scales bound the rounding error by
``max|block| / (2 * levels)`` per element.

The encode runs in torch, op for op as the JAX package's jnp encode:
the scale is ``max(amax, 1e-30) / levels`` and the int8 payload is
``clip(round(block / scale), -levels, levels)`` with round-half-even,
so payloads and scales are bit for bit the JAX package's on the same
input. Inputs may be numpy arrays or tensors on any device; outputs are
tensors on the input's device (the CPU for numpy input).

:mod:`paddle_tpu_torch.serving.disagg.kv_wire` rides this encoding for
the prefill->decode KV handoff (one block per (layer, row) of the
cache), and the quantized gradient allreduce (:mod:`.allreduce`) with
its error feedback for the data-parallel gradient sync.
"""
import numpy as np
import torch

__all__ = [
    "DEFAULT_BLOCK", "WIRE_DTYPES", "wire_info", "round_up", "pad_flat",
    "quantize_blocks", "dequantize_blocks", "wire_bytes",
    "compression_ratio", "error_feedback_apply", "error_feedback_update",
]

DEFAULT_BLOCK = 256

# wire format name -> (itemsize bytes, max representable magnitude)
WIRE_DTYPES = {
    "int8": (1, 127.0),
    "fp8_e4m3": (1, 448.0),
}


def wire_info(wire_dtype):
    """(torch dtype, itemsize, levels) for a wire format name."""
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(
            "unknown wire dtype %r (known: %s)"
            % (wire_dtype, sorted(WIRE_DTYPES)))
    itemsize, levels = WIRE_DTYPES[wire_dtype]
    if wire_dtype == "int8":
        return torch.int8, itemsize, levels
    dt = getattr(torch, "float8_e4m3fn", None)
    if dt is None:
        raise ValueError(
            "wire dtype 'fp8_e4m3' needs a torch build with "
            "torch.float8_e4m3fn; use 'int8'")
    return dt, itemsize, levels


def _tensor(x):
    # np.require copies only a read-only or strided array
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.require(x, requirements=("C", "W")))


def round_up(n, m):
    return ((int(n) + m - 1) // m) * m


def pad_flat(flat, multiple):
    """Zero-pad a flat vector to a length multiple; returns (padded,
    original_length). Zero pad rows quantize exactly (their block scale
    floors at tiny), so padding never perturbs real elements."""
    flat = _tensor(flat)
    n = flat.shape[0]
    target = round_up(n, multiple)
    if target == n:
        return flat, n
    return torch.cat(
        [flat, flat.new_zeros((target - n,))]), n


def quantize_blocks(flat, block_size=DEFAULT_BLOCK, wire_dtype="int8"):
    """Encode a flat fp32 vector (length % block_size == 0) into
    ``(payload, scales)``: payload has the wire dtype and the input's
    length, scales is fp32 with one entry per block."""
    dt, _, levels = wire_info(wire_dtype)
    flat = _tensor(flat)
    blocks = flat.to(torch.float32).reshape(-1, block_size)
    amax = blocks.abs().amax(dim=1)
    # all-zero blocks: keep the scale finite; they decode to exact 0
    scales = torch.clamp_min(amax, 1e-30) / levels
    scaled = blocks / scales[:, None]
    if dt == torch.int8:
        payload = torch.clamp(torch.round(scaled), -levels, levels).to(dt)
    else:
        payload = torch.clamp(scaled, -levels, levels).to(dt)
    return payload.reshape(flat.shape), scales


def dequantize_blocks(payload, scales, block_size=DEFAULT_BLOCK):
    """Decode ``(payload, scales)`` back to flat fp32."""
    payload = _tensor(payload)
    blocks = payload.to(torch.float32).reshape(-1, block_size)
    return (blocks * _tensor(scales)[:, None]).reshape(payload.shape)


def error_feedback_apply(flat, residual):
    """Compensated send value: this step's gradient plus the carried
    compression error of previous steps."""
    return flat + residual


def error_feedback_update(compensated, decoded):
    """Next step's residual: what the wire format could not represent
    of the compensated value this step."""
    return compensated - decoded


# -- deterministic wire-byte accounting (host side) -------------------------

def wire_bytes(n_elements, block_size=DEFAULT_BLOCK, wire_dtype="int8"):
    """Bytes one transmission of a quantized length-n vector puts on
    the wire: payload + per-block fp32 scales. ``n_elements`` must
    already be block-padded (see :func:`round_up`)."""
    itemsize = WIRE_DTYPES[wire_dtype][0]
    n_blocks = (int(n_elements) + block_size - 1) // block_size
    return int(n_elements) * itemsize + n_blocks * 4


def compression_ratio(n_elements, block_size=DEFAULT_BLOCK,
                      wire_dtype="int8", full_itemsize=4):
    """fp32-payload bytes over quantized-payload bytes for one
    transmission — ``4 / (1 + 4/block)`` for int8: 3.94x at block 256,
    crossing the 3.5x bar at any block >= 32."""
    return (float(n_elements) * full_itemsize
            / wire_bytes(n_elements, block_size, wire_dtype))
