"""Head-split helper shared by the attention models (port of
paddle_tpu/models/decode_utils.py ``split_heads``; the KV-cache decode
helpers wait for the decode slice)."""
from ..fluid import layers

__all__ = ["split_heads"]


def split_heads(t, heads, dh):
    """(B, T, heads*dh) -> (B, heads, T, dh)."""
    t = layers.reshape(t, [0, 0, heads, dh])
    return layers.transpose(t, [0, 2, 1, 3])
