"""Feed declaration (ref: python/paddle/fluid/layers/io.py); port of
paddle_tpu/fluid/layers/io.py ``data``. A ``lod_level`` > 0 feed is a
dense padded array with a ``name@SEQ_LEN`` int32 companion of per-row
lengths, as in the JAX package; the Executor fills full lengths for a
plain array. Ragged LoDTensor feeds wait for the sequence slice,
py_readers for the host-data-path slice."""
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
    helper_shape = list(shape)
    if append_batch_size:
        helper_shape = [-1] + helper_shape
    block = default_main_program().current_block()
    main = block.create_var(
        name=name,
        shape=helper_shape,
        dtype=dtype,
        type=type,
        stop_gradient=stop_gradient,
        lod_level=lod_level,
        is_data=True,
        need_check_feed=True,
    )
    if lod_level and lod_level > 0:
        # sequences are fed dense-padded with a per-row length vector
        block.create_var(
            name=name + "@SEQ_LEN",
            shape=[-1],
            dtype="int32",
            stop_gradient=True,
            is_data=True,
        )
    return main
