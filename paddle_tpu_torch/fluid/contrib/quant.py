"""Quantization-aware training (QAT): the fake quant-dequant ops and the
transform that inserts them (ref: python/paddle/fluid/contrib/slim/
quantization/quantization_pass.py QuantizationTransformPass and the
fake_quantize ops of paddle/fluid/operators/fake_quantize_op.cc).

Port of paddle_tpu/fluid/contrib/quant.py. The three op types quantize to
the symmetric ``bit_length`` grid and back, in the input's dtype, and
their gradient is straight-through: ``x + (q - x).detach()``, the
JAX package's ``x + stop_gradient(q - x)``, so the gradient to X is the
identity and the scales get none. The transform is program surgery on
the symbolic Program, the same in both packages, so both give the same
Program JSON.
"""
import torch

from ...ops.detection_ops import scalar
from ...ops.registry import register_op
from .. import core
from ..framework import default_startup_program

__all__ = [
    "QuantizationTransformPass", "quantize_program",
    "fake_quant_dequant_abs_max",
]

_QUANTIZABLE = ("mul", "matmul", "conv2d", "depthwise_conv2d")


def _qdq(x, scale, bits):
    """Quantize-dequantize x with a symmetric per-tensor (or broadcast)
    scale; straight-through gradient. Every divisor is a tensor: CUDA
    divides by a Python number as a multiply by its reciprocal, which
    rounds some quotients apart from IEEE division (the JAX lowering's
    and the CPU's)."""
    qmax = float(2 ** (bits - 1) - 1)
    s = torch.clamp(scale, min=1e-9)
    q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax) * s \
        / scalar(qmax, s)
    return x + (q - x).detach()


@register_op("fake_quantize_dequantize_abs_max")
def _fake_qdq_abs_max(ctx, ins, attrs):
    x = ins["X"][0]
    bits = attrs.get("bit_length", 8)
    scale = x.detach().abs().amax()
    return {"Out": [_qdq(x, scale, bits)], "OutScale": [scale.reshape(1)]}


@register_op("fake_channel_wise_quantize_dequantize_abs_max")
def _fake_qdq_channel(ctx, ins, attrs):
    x = ins["X"][0]
    bits = attrs.get("bit_length", 8)
    axis = attrs.get("quant_axis", 0)
    red = tuple(i for i in range(x.dim()) if i != axis)
    scale = x.detach().abs().amax(dim=red, keepdim=True)
    return {"Out": [_qdq(x, scale, bits)], "OutScale": [scale.reshape(-1)]}


@register_op("fake_quantize_dequantize_moving_average_abs_max")
def _fake_qdq_moving_avg(ctx, ins, attrs):
    """Activation fake-quant with a moving-average abs-max scale kept as
    persistable state (InScale in, OutScale out: the same var), updated
    by every training run like batch_norm's running statistics."""
    x = ins["X"][0]
    in_scale = ins["InScale"][0]
    bits = attrs.get("bit_length", 8)
    momentum = attrs.get("moving_rate", 0.9)
    is_test = attrs.get("is_test", False) or ctx.is_test
    cur = x.detach().abs().amax().reshape(1)
    if is_test:
        scale = in_scale
    else:
        scale = momentum * in_scale + (1.0 - momentum) * cur
    scale = scale.detach()
    return {"Out": [_qdq(x, scale, bits)], "OutScale": [scale]}


def fake_quant_dequant_abs_max(x, bit_length=8, name=None):
    """Layer-level fake quant-dequant (abs-max, per-tensor)."""
    from ..layer_helper import LayerHelper

    helper = LayerHelper(name or "fake_qdq")
    out = helper.create_variable_for_type_inference(x.dtype)
    out.shape = x.shape
    scale = helper.create_variable_for_type_inference("float32")
    scale.shape = (1,)
    helper.append_op(
        type="fake_quantize_dequantize_abs_max",
        inputs={"X": [x]},
        outputs={"Out": [out], "OutScale": [scale]},
        attrs={"bit_length": bit_length},
    )
    return out


class QuantizationTransformPass:
    """Insert fake quant-dequant ops ahead of quantizable compute ops.

    Weights get channel-wise abs-max quant; activations get moving-average
    abs-max with persistable scale state initialised by the startup program.
    ref: slim/quantization/quantization_pass.py:QuantizationTransformPass.
    """

    def __init__(self, weight_bits=8, activation_bits=8, moving_rate=0.9,
                 quantizable_op_type=_QUANTIZABLE, skip_pattern="skip_quant"):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.moving_rate = moving_rate
        self.op_types = tuple(quantizable_op_type)
        self.skip_pattern = skip_pattern

    def apply(self, program, startup_program=None):
        startup = startup_program or default_startup_program()
        # walk EVERY block (the reference pass iterates program.blocks):
        # quantizable compute inside while/cond bodies gets fake-quant too
        for block in program.blocks:
            self._apply_block(program, block, startup)
        return program

    def _apply_block(self, program, block, startup):
        quantized = {}  # var name -> dequantized var name (this block)
        i = 0
        while i < len(block.ops):
            op = block.ops[i]
            if op.type not in self.op_types or op.attrs.get(self.skip_pattern):
                i += 1
                continue
            inserted = 0
            for slot, names in list(op.inputs.items()):
                new_names = []
                for name in names:
                    # sub-block ops reference globals (params) by name
                    var = block.vars.get(name) or (
                        program.global_block().vars.get(name)
                    )
                    if var is None or var.dtype not in ("float32", "float16",
                                                        "bfloat16"):
                        new_names.append(name)
                        continue
                    if name not in quantized:
                        qname, n_ins = self._insert_qdq(
                            block, startup, i + inserted, var,
                            is_weight=getattr(var, "persistable", False),
                            op_type=op.type, slot=slot,
                        )
                        quantized[name] = qname
                        inserted += n_ins
                    new_names.append(quantized[name])
                op.inputs[slot] = new_names
            i += 1 + inserted

    def _insert_qdq(self, block, startup, idx, var, is_weight, op_type, slot):
        qvar = block.create_var(
            name=var.name + ".quantized", dtype=var.dtype, shape=var.shape
        )
        if is_weight:
            # conv weights quant per output-channel (axis 0); mul/matmul
            # weights per column (axis 1) — ref quantization_pass.py
            axis = 0 if "conv" in op_type else max(0, len(var.shape) - 1)
            scale_var = block.create_var(
                name=var.name + ".quant_scale", dtype="float32",
                shape=(int(var.shape[axis]),) if var.shape else (1,),
            )
            block._insert_op(
                idx,
                type="fake_channel_wise_quantize_dequantize_abs_max",
                inputs={"X": [var]},
                outputs={"Out": [qvar], "OutScale": [scale_var]},
                attrs={"bit_length": self.weight_bits, "quant_axis": axis},
            )
            return qvar.name, 1
        # activation: persistable moving-average scale state. Persistables
        # live in the GLOBAL block (sub-block qdq ops reference it by name,
        # like any parameter read from a while/cond body)
        state = block.program.global_block().create_var(
            name=var.name + ".quant_scale_state", dtype="float32", shape=(1,)
        )
        state.persistable = True
        sv = startup.global_block().create_var(
            name=state.name, dtype="float32", shape=(1,)
        )
        sv.persistable = True
        startup.global_block().append_op(
            type="fill_constant",
            inputs={},
            outputs={"Out": [sv]},
            attrs={"shape": [1], "value": 1e-3,
                   "dtype": core.convert_dtype("float32")},
        )
        block._insert_op(
            idx,
            type="fake_quantize_dequantize_moving_average_abs_max",
            inputs={"X": [var], "InScale": [state]},
            outputs={"Out": [qvar], "OutScale": [state]},
            attrs={"bit_length": self.activation_bits,
                   "moving_rate": self.moving_rate},
        )
        return qvar.name, 1


def quantize_program(program, startup_program=None, weight_bits=8,
                     activation_bits=8):
    """One-call QAT transform (build graph -> quantize -> minimize)."""
    return QuantizationTransformPass(
        weight_bits=weight_bits, activation_bits=activation_bits
    ).apply(program, startup_program)
