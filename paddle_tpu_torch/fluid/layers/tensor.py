"""Tensor creation layers (ref: python/paddle/fluid/layers/tensor.py);
port of paddle_tpu/fluid/layers/tensor.py, the part BERT calls."""
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr

__all__ = ["create_parameter"]


def create_parameter(
    shape,
    dtype,
    name=None,
    attr=None,
    is_bias=False,
    default_initializer=None,
):
    helper = LayerHelper("create_parameter", **locals())
    if attr is None:
        attr = ParamAttr(name=name)
    return helper.create_parameter(
        attr, shape, dtype, is_bias, default_initializer
    )
