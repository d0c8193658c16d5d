"""Feed declaration (ref: python/paddle/fluid/layers/io.py); port of
paddle_tpu/fluid/layers/io.py ``data``. LoD feeds and py_readers wait for
the host-data-path slice."""
from .. import core
from ..framework import default_main_program

__all__ = ["data"]


def data(
    name,
    shape,
    append_batch_size=True,
    dtype="float32",
    lod_level=0,
    type=core.VarType.LOD_TENSOR,
    stop_gradient=True,
):
    """Declare a feed variable (ref layers/io.py:data). With
    append_batch_size=True a leading -1 batch dim is added."""
    if lod_level:
        raise NotImplementedError(
            "lod_level > 0 feeds are not ported yet (host data path slice)")
    helper_shape = list(shape)
    if append_batch_size:
        helper_shape = [-1] + helper_shape
    block = default_main_program().current_block()
    return block.create_var(
        name=name,
        shape=helper_shape,
        dtype=dtype,
        type=type,
        stop_gradient=stop_gradient,
        lod_level=lod_level,
        is_data=True,
        need_check_feed=True,
    )
