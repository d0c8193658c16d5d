"""Shared incremental-decode machinery for KV-cache decoder cells (port of
paddle_tpu/models/decode_utils.py).

One decode step at position ``pos`` needs three masks derived from the
static cache length ``tmax``: a one-hot cache-write selector, its
complement, and the <=pos additive visibility mask. Keeping them (and the
head-split attention) here means a fix to the cache-write or masking logic
lands in every decoder at once.
"""
from ..fluid import layers
from ..fluid.layer_helper import LayerHelper

__all__ = ["attend", "split_heads", "step_masks", "update_cache"]


def split_heads(t, heads, dh):
    """(B, T, heads*dh) -> (B, heads, T, dh)."""
    t = layers.reshape(t, [0, 0, heads, dh])
    return layers.transpose(t, [0, 2, 1, 3])


def attend(q, k, v, mask, heads, hidden):
    """q (B,Tq,H), k/v (B,Tk,H), additive mask broadcastable to
    (B,nh,Tq,Tk) -> context (B,Tq,H)."""
    dh = hidden // heads

    def split(t):
        return split_heads(t, heads, dh)

    scores = layers.matmul(split(q), split(k), transpose_y=True,
                           alpha=dh ** -0.5)
    if mask is not None:
        scores = layers.elementwise_add(scores, mask)
    ctx = layers.matmul(layers.softmax(scores), split(v))
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    return layers.reshape(ctx, [0, 0, hidden])


def step_masks(pos, tmax):
    """For a (B, 1) int64 position: returns (write3, keep3, self_mask)
    — the (B, T, 1) one-hot cache-write selector, its complement, and
    the (B, 1, 1, T) additive mask hiding positions > pos."""
    steps = layers.unsqueeze(
        layers.range(0, tmax, 1, "int64"), [0])          # (1, T)
    write = layers.cast(layers.equal(steps, pos), "float32")
    write3 = layers.unsqueeze(write, [2])                # (B, T, 1)
    keep3 = layers.scale(write3, scale=-1.0, bias=1.0)
    seen = layers.cast(
        layers.less_equal(steps, pos), "float32")        # (B, T)
    self_mask = layers.scale(seen, scale=1e9, bias=-1e9)
    self_mask = layers.unsqueeze(self_mask, [1, 2])      # (B, 1, 1, T)
    return write3, keep3, self_mask


def update_cache(cache, new_t, write3=None, keep3=None, pos=None,
                 per_row=False):
    """Write the (B, 1, H) step value into the (B, T, H) cache.

    With ``pos`` (the (B, 1) decode position) this is the
    ``decode_cache_write`` op, an O(B·H) write: uniform across the batch
    by default, or an independent position per row with ``per_row=True``
    (slotted continuous-batching decode). Without ``pos``, the one-hot
    masked rewrite (``write3``/``keep3`` from :func:`step_masks`) re-reads
    and re-writes the whole cache."""
    if pos is not None:
        helper = LayerHelper("decode_cache_write")
        out = helper.create_variable_for_type_inference(dtype=cache.dtype)
        out.shape = cache.shape
        helper.append_op(
            type="decode_cache_write",
            inputs={"Cache": [cache], "Value": [new_t], "Pos": [pos]},
            outputs={"Out": [out]},
            attrs={"per_row": bool(per_row)},
        )
        return out
    if write3 is None or keep3 is None:
        raise ValueError(
            "update_cache needs either pos (uniform-position fast "
            "path) or the write3/keep3 masks from step_masks")
    return layers.elementwise_add(
        layers.elementwise_mul(cache, keep3),
        layers.elementwise_mul(new_t, write3))
