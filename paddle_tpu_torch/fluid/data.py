"""fluid.data (ref: python/paddle/fluid/data.py); port of
paddle_tpu/fluid/data.py.

Unlike ``fluid.layers.data`` (which PREPENDS a -1 batch dimension),
``fluid.data`` takes the FULL shape — write the batch dimension
yourself, using None (or -1) for "any size"::

    x = fluid.data(name="x", shape=[None, 784], dtype="float32")
"""
from .layers import io as _io

__all__ = ["data"]


def data(name, shape, dtype="float32", lod_level=0):
    full = [-1 if s is None else int(s) for s in shape]
    return _io.data(
        name, full, append_batch_size=False, dtype=dtype,
        lod_level=lod_level,
    )
