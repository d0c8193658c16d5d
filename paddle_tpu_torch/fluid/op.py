"""Legacy low-level op wrappers (ref: python/paddle/fluid/op.py:24-292);
port of paddle_tpu/fluid/op.py over the port's lowering registry.

The reference builds raw C++ OperatorBase instances from op protos,
outside any Program — the pre-layers API kept alive for ancient unit
tests. This framework has no standalone C++ operators: every op is a
symbolic record in a Program, run op by op by the Executor. The
introspection half (op registry listing) is real; direct operator
construction raises with the modern path.
"""
from .. import ops as _ops  # noqa: F401  (registers the lowerings)
from ..ops.registry import KNOWN_UNSUPPORTED, LOWERINGS

__all__ = ["get_all_op_protos", "Operator", "OperatorFactory",
           "OpDescCreationMethod"]


class _OpProto(object):
    """Minimal proto-like descriptor over the lowering registry."""

    def __init__(self, type):
        self.type = type
        self.comment = "torch lowering registered in paddle_tpu_torch.ops"


def get_all_op_protos():
    """Descriptors for every registered op type (ref op.py:24 reads the
    C++ OpInfoMap; here the torch lowering registry is the op library)."""
    return [_OpProto(t) for t in sorted(LOWERINGS)]


_GUIDANCE = (
    "paddle_tpu_torch has no standalone operator objects: ops are "
    "symbolic Program records the Executor runs. Build programs with "
    "fluid.layers.* (or block.append_op for custom graphs) and run them "
    "with fluid.Executor."
)


class OpDescCreationMethod(object):
    """ref op.py:41 — protobuf OpDesc assembly; unmappable (no protobuf
    op descs exist), raises with the modern path."""

    def __init__(self, op_proto):
        self._proto = op_proto

    def __call__(self, *args, **kwargs):
        raise NotImplementedError(
            "OpDescCreationMethod(%s): " % getattr(
                self._proto, "type", "?") + _GUIDANCE)


class OperatorFactory(object):
    """ref op.py:178 — C++ OperatorBase construction."""

    def types(self):
        return sorted(set(LOWERINGS) | set(KNOWN_UNSUPPORTED))

    def get_op_info(self, t):
        if t not in LOWERINGS and t not in KNOWN_UNSUPPORTED:
            raise ValueError("Operator %r has not been registered" % t)
        return _OpProto(t)

    def __call__(self, *args, **kwargs):
        raise NotImplementedError("OperatorFactory: " + _GUIDANCE)


Operator = OperatorFactory()
