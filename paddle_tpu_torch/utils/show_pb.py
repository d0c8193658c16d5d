"""Print a model config protobuf (ref: python/paddle/utils/show_pb.py).

The reference deserializes a paddle-v1 ``ModelConfig`` protobuf. This
framework's programs are plain python objects with a json serde — dump
those with ``program.to_string()`` or
``print(program)`` instead; reading v1 protobufs would need the retired
proto definitions, so that path raises with this guidance.
"""
import sys

__all__ = ["show_pb"]


def show_pb(path):
    raise NotImplementedError(
        "show_pb reads retired paddle-v1 ModelConfig protobufs (%r). "
        "paddle_tpu_torch Programs serialize to json — use "
        "program.to_string() for a readable dump." % (path,)
    )


if __name__ == "__main__":
    show_pb(sys.argv[1] if len(sys.argv) > 1 else None)
