"""Collective layers (ref: python/paddle/fluid/layers/collective.py).
A copy of paddle_tpu/fluid/layers/collective.py; the ops' lowerings are
in ops/collective_ops.py."""
from ..layer_helper import LayerHelper

__all__ = ["_c_allreduce", "_c_allgather", "_c_broadcast",
           "_c_reducescatter", "_c_sync_calc_stream", "_c_sync_comm_stream"]


def _op(op_type, x, attrs=None, out_shape=None):
    helper = LayerHelper(op_type, x=x)
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = out_shape if out_shape is not None else x.shape
    helper.append_op(
        type=op_type,
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs=attrs or {},
    )
    return out


def _c_allreduce(x, out=None, reduce_type="sum", ring_id=0,
                 use_calc_stream=False):
    return _op("c_allreduce_" + reduce_type, x, {"ring_id": ring_id})


def _c_allgather(x, nranks, ring_id=0, use_calc_stream=False):
    shape = None
    if x.shape is not None:
        shape = (x.shape[0] * nranks if x.shape[0] not in (None, -1) else -1,)\
            + tuple(x.shape[1:])
    return _op("c_allgather", x, {"ring_id": ring_id, "nranks": nranks},
               out_shape=shape)


def _c_broadcast(x, root=0, ring_id=0, use_calc_stream=False):
    return _op("c_broadcast", x, {"root": root, "ring_id": ring_id})


def _c_reducescatter(x, nranks, ring_id=0, use_calc_stream=False):
    shape = None
    if x.shape is not None:
        shape = (x.shape[0] // nranks if x.shape[0] not in (None, -1) else -1,)\
            + tuple(x.shape[1:])
    return _op("c_reducescatter", x, {"ring_id": ring_id, "nranks": nranks},
               out_shape=shape)


def _c_sync_calc_stream(x):
    return _op("c_sync_calc_stream", x)


def _c_sync_comm_stream(x, ring_id=0):
    return _op("c_sync_comm_stream", x, {"ring_id": ring_id})
