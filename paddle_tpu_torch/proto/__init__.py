"""paddle.proto (ref: python/paddle/proto — framework protobuf
definitions: framework_pb2, data_feed_pb2, ...). Port of
paddle_tpu/proto.

Programs here serialize to json (Program.to_json / from_json) instead
of protobufs; accessing a *_pb2 symbol raises with that pointer.
"""

__all__ = []


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise NotImplementedError(
        "paddle.proto.%s: ProgramDesc protobufs have no counterpart here — "
        "Programs serialize via to_json()/from_json() "
        "(fluid/framework.py)" % name
    )
