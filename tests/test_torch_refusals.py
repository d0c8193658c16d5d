"""The op library's refusals against the JAX package's.

Both registries sort an op type they cannot run into two kinds:

- the reference types unsupported BY DESIGN (``KNOWN_UNSUPPORTED``, 18
  keys: pserver RPC, NCCL setup, TensorRT/Anakin subgraphs, mkldnn
  quantization, the reader ops), each refused with its reason and the
  alternative to reach for — 17 of them, as ``cudnn_lstm`` is listed
  and registered in both packages. The port keeps the JAX package's
  keys and rewords the reasons for torch.distributed and the card;
- any other unknown type, refused with the nearest registered names
  (``difflib``), never with the whole list of 324.

``fluid.op.Operator`` lists and describes both kinds, as the JAX
package's does.
"""
import re

import pytest

import paddle_tpu.fluid  # noqa: F401  (registers the JAX lowerings)
import paddle_tpu.fluid.contrib.slim.quantization  # noqa: F401
from paddle_tpu.fluid import op as jop
from paddle_tpu.ops import registry as jreg

import paddle_tpu_torch.fluid  # noqa: F401  (registers the lowerings)
from paddle_tpu_torch.fluid import op as pop
from paddle_tpu_torch.ops import registry as preg

UNSUPPORTED = sorted(jreg.KNOWN_UNSUPPORTED)
MISSPELT = ["softmaxx", "conv2dd", "layer_nrom", "matmull",
            "elementwise_ad", "lookup_tabel", "batchnorm", "sendd",
            "zzz_no_such_op"]


def _refusal(registry, op_type):
    with pytest.raises(NotImplementedError) as e:
        registry.get_lowering(op_type)
    return str(e.value)


def test_the_seventeen_types_are_the_reference_s():
    assert len(UNSUPPORTED) == 18
    assert sorted(preg.KNOWN_UNSUPPORTED) == UNSUPPORTED
    assert set(preg.LOWERINGS) == set(jreg.LOWERINGS)
    # both packages run cudnn_lstm (its last state), manifest or not
    assert set(UNSUPPORTED) & set(preg.LOWERINGS) == {"cudnn_lstm"}


@pytest.mark.parametrize("op_type", UNSUPPORTED)
def test_a_known_unsupported_type_is_refused_with_its_reason(op_type):
    if op_type in jreg.LOWERINGS:
        assert preg.get_lowering(op_type) is preg.LOWERINGS[op_type]
        return
    want = _refusal(jreg, op_type)
    got = _refusal(preg, op_type)
    assert "intentionally unsupported" in want
    assert got == "op '%s' is intentionally unsupported on the card: %s" % (
        op_type, preg.KNOWN_UNSUPPORTED[op_type])
    assert preg.KNOWN_UNSUPPORTED[op_type]
    # the reworded reasons name no TPU machinery
    assert not re.search(r"\b(TPU|XLA|ICI|DCN|lax)\b",
                         preg.KNOWN_UNSUPPORTED[op_type])


def test_send_gives_the_reference_s_reason_reworded():
    assert "pserver RPC" in _refusal(jreg, "send")
    got = _refusal(preg, "send")
    assert "pserver RPC" in got and "torch.distributed" in got


@pytest.mark.parametrize("op_type", MISSPELT)
def test_an_unknown_type_names_the_nearest_registered_ones(op_type):
    def nearest(msg):
        m = re.search(r"nearest supported: ([^)]*)\)", msg)
        return m.group(1).split(", ") if m else []

    want, got = _refusal(jreg, op_type), _refusal(preg, op_type)
    assert nearest(got) == nearest(want)
    assert set(nearest(got)) <= set(preg.LOWERINGS)
    assert "no torch lowering registered for op '%s'" % op_type in got
    assert "registered: 324 ops" in got
    # the hint replaced the whole list of names
    assert len(got) < 400


def test_operator_lists_and_describes_both_kinds():
    assert pop.Operator.types() == jop.Operator.types()
    assert len(pop.Operator.types()) == 324 + 17
    for mod in (jop, pop):
        assert mod.Operator.get_op_info("send").type == "send"
        assert mod.Operator.get_op_info("mul").type == "mul"
        with pytest.raises(ValueError, match="has not been registered"):
            mod.Operator.get_op_info("no_such_op")
