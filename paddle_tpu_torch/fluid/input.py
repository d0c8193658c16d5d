"""fluid.input: one_hot / embedding, the "v2" variants
(ref: python/paddle/fluid/input.py).

Unlike ``fluid.layers.one_hot`` / ``fluid.layers.embedding`` (which
collapse a trailing ids dimension of 1, the LoD-era convention), these
append the new dimension to the id shape AS-IS: ids of shape (B, 1)
produce (B, 1, depth) / (B, 1, emb_size), exactly like the reference —
shapes in ported v2-style scripts line up.
"""
from .layer_helper import LayerHelper

__all__ = ["one_hot", "embedding"]


def one_hot(input, depth, allow_out_of_range=False):
    helper = LayerHelper("one_hot_v2", **locals())
    out = helper.create_variable_for_type_inference("float32")
    out.shape = tuple(input.shape or (-1,)) + (depth,)
    helper.append_op(
        type="one_hot",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"depth": depth, "allow_out_of_range": allow_out_of_range,
               "_squeeze": False},
    )
    return out


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(
        attr=helper.param_attr, shape=size, dtype=dtype, is_bias=False)
    out = helper.create_variable_for_type_inference(dtype)
    out.shape = tuple(input.shape or (-1,)) + (size[1],)
    padding_idx = (
        -1 if padding_idx is None
        else padding_idx if padding_idx >= 0
        else size[0] + padding_idx
    )
    helper.append_op(
        type="lookup_table_v2",
        inputs={"Ids": [input], "W": [w]},
        outputs={"Out": [out]},
        attrs={"padding_idx": padding_idx, "is_sparse": is_sparse,
               "is_distributed": is_distributed, "_squeeze": False},
    )
    return out
