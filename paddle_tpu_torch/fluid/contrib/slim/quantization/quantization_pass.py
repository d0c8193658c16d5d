"""Freeze / int8-convert passes for quantization
(ref: python/paddle/fluid/contrib/slim/quantization/quantization_pass.py:
QuantizationFreezePass, ConvertToInt8Pass, AddQuantDequantPass).

Port of paddle_tpu/fluid/contrib/slim/quantization/quantization_pass.py.
The frozen inference program runs real int8 compute: ``quantized_mul``
and ``quantized_conv2d`` quantize the activation inline, sum the int8 x
int8 products in int32, and rescale by act_scale * weight_scale. The
JAX package sums with ``lax.dot_general`` / ``lax.conv_general_dilated``
at ``preferred_element_type=int32``; the port gives the same int32 sums,
exactly, by one of two routes (:func:`int_matmul`):

- on the card, an 8-bit product is ``torch._int_mm``: int8 x int8 summed
  in int32 by cuBLASLt. Its shape rules (more than 16 rows, K and N
  multiples of 8) are met by padding with zero rows and columns, which
  add nothing to any sum;
- on the CPU, and for ``quant_bits=16`` (an int32 activation) on the card,
  the operands go to float64 and are multiplied there. Every product of
  two such integers, and every partial sum, is an integer below 2^53 in
  magnitude (|sum| <= 32767 * 128 * K, so K up to 2.1e9), which float64
  holds exactly, whatever order the library sums in. float32 would not
  do: it is exact only below 2^24, and 127^2 * 4608 (ResNet-50's largest
  reduction) is 7.4e7. The exact sum is then wrapped to int32 as an
  int32 accumulation wraps.

A convolution is the same product over its im2col columns
(:func:`int_conv2d`). Weights not yet int8 are rounded and converted as
XLA converts float to int8: NaN to 0, out-of-range values to the nearest
bound (:func:`saturate_int8`).
"""
import numpy as np
import torch
import torch.nn.functional as F

from .....ops.detection_ops import scalar, table
from .....ops.registry import register_op

__all__ = [
    "QuantizationFreezePass", "ConvertToInt8Pass", "AddQuantDequantPass",
    "OutScaleForTrainingPass", "OutScaleForInferencePass",
    "TransformForMobilePass",
]

_QMAX = {8: 127.0, 16: 32767.0}


def saturate_int8(x):
    """Float values to int8 as XLA converts them: NaN to 0, values past
    the range to -128 or 127, the rest truncated (callers round first)."""
    x = torch.nan_to_num(x.float(), nan=0.0, posinf=127.0, neginf=-128.0)
    return x.clamp(-128.0, 127.0).to(torch.int8)


def _quant_act(x, scale, bits):
    """The activation on the `bits` grid: int8 for 8 bits, int32 for 16.
    The divisors here and in the rescales are tensors: CUDA divides by a
    Python number as a multiply by its reciprocal, which rounds some
    quotients apart from IEEE division (the JAX lowering's and the
    CPU's), and a quotient on a rounding boundary then lands on another
    grid value."""
    qmax = _QMAX[bits]
    x = x.float()
    s = scalar(float(max(np.float32(scale), np.float32(1e-9))), x)
    q = torch.clamp(torch.round(x / s * qmax), -qmax, qmax)
    q = torch.nan_to_num(q, nan=0.0)        # XLA converts NaN to 0
    return q.to(torch.int8 if bits == 8 else torch.int32)


def _ceil8(n):
    return -(-n // 8) * 8


def _wrap_int32(exact):
    """float64 integer values (exact) as int32, wrapped modulo 2^32."""
    v = exact.to(torch.int64)
    return (torch.remainder(v + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)


def int_matmul(a, b):
    """(M, K) x (K, N) integer product summed in int32, exactly: int8 or
    int32 `a`, int8 `b` (the module docstring gives the two routes)."""
    if a.is_cuda and a.dtype == torch.int8:
        int_matmul.launches += 1
        m, k = a.shape
        n = b.shape[1]
        mp, kp, np_ = max(m, 17), _ceil8(k), _ceil8(n)
        if (mp, kp) != (m, k):
            a = F.pad(a, (0, kp - k, 0, mp - m))
        # (N, K) row-major seen as its transpose: the layout nn.Linear's
        # weight has, which cuBLASLt's int8 product takes
        bt = b.t()
        if (kp, np_) != (k, n):
            bt = F.pad(bt, (0, kp - k, 0, np_ - n))
        return torch._int_mm(a.contiguous(), bt.contiguous().t())[:m, :n]
    return _wrap_int32(a.double() @ b.double())


int_matmul.launches = 0


def int_conv2d(xq, wq, strides, pads, dilations, groups):
    """NCHW convolution of int8 `xq` with int8 `wq`
    (Cout, Cin/groups, kh, kw), summed in int32 exactly: im2col columns
    through :func:`int_matmul`, one product a group. `pads` is (ph, pw)
    or (top, left, bottom, right) read as the JAX lowering reads it:
    H gets (pads[0], pads[2]), W gets (pads[1], pads[3])."""
    if len(pads) == 2:
        ph0 = ph1 = int(pads[0])
        pw0 = pw1 = int(pads[1])
    else:
        ph0, pw0, ph1, pw1 = (int(p) for p in pads)
    b, c = xq.shape[:2]
    cout, cg, kh, kw = wq.shape
    ng = cout // groups
    # unfold works on floats: float16 holds int8 values exactly, and the
    # CPU's float64 columns feed int_matmul's float64 route directly
    col_dtype = torch.float16 if xq.is_cuda else torch.float64
    x = F.pad(xq.to(col_dtype), (pw0, pw1, ph0, ph1))
    ho = (x.shape[2] - dilations[0] * (kh - 1) - 1) // strides[0] + 1
    wo = (x.shape[3] - dilations[1] * (kw - 1) - 1) // strides[1] + 1
    cols = F.unfold(x, (kh, kw), dilation=tuple(dilations),
                    stride=tuple(strides))              # (B, C·kh·kw, L)
    cols = cols.view(b, groups, cg * kh * kw, ho * wo)
    outs = []
    for g in range(groups):
        a = cols[:, g].transpose(1, 2).reshape(b * ho * wo, cg * kh * kw)
        if col_dtype == torch.float16:
            a = a.to(torch.int8)
        w = wq[g * ng:(g + 1) * ng].reshape(ng, cg * kh * kw).t()
        outs.append(int_matmul(a, w))                    # (B·L, ng)
    acc = outs[0] if groups == 1 else torch.cat(outs, 1)
    return acc.view(b, ho, wo, cout).permute(0, 3, 1, 2)


def _weight_int8(w):
    return w if w.dtype == torch.int8 else saturate_int8(torch.round(w))


def _weight_scale(ctx, attrs, device):
    ws = attrs["weight_scale"]
    return ctx.constant(ws, lambda: table(ws, device))


@register_op("quantized_mul")
def _quantized_mul(ctx, ins, attrs):
    """x (f32) @ w (int8-valued): inline activation quant, int32 sums,
    per-column rescale."""
    x, w = ins["X"][0], ins["Y"][0]
    bits = attrs.get("quant_bits", 8)
    qmax = _QMAX[bits]
    xq = _quant_act(x, attrs["act_scale"], bits)
    wq = _weight_int8(w)
    x2 = xq.reshape(-1, xq.shape[-1]) if xq.dim() > 2 else xq
    acc = int_matmul(x2, wq)
    w_scale = _weight_scale(ctx, attrs, x.device)
    out = acc.float() * (float(attrs["act_scale"]) * w_scale
                         / scalar(qmax * qmax, w_scale))
    if xq.dim() > 2:
        out = out.reshape(tuple(xq.shape[:-1]) + (w.shape[-1],))
    return {"Out": [out]}


@register_op("quantized_conv2d")
def _quantized_conv2d(ctx, ins, attrs):
    """NCHW conv with int8 inputs and int32 sums; the weight scale is per
    output channel. ``quant_bits=16`` raises, as the JAX lowering does:
    its int32 activation and int8 filter are operands of different
    dtypes, which ``lax.conv_general_dilated`` refuses (ROADMAP.md Queue
    3)."""
    x, w = ins["Input"][0], ins["Filter"][0]
    bits = attrs.get("quant_bits", 8)
    if bits != 8:
        raise TypeError(
            "quantized_conv2d with quant_bits=%d: the activation is int32 "
            "and the filter int8, operands the JAX package's convolution "
            "refuses; the port refuses them too" % bits)
    qmax = _QMAX[bits]
    strides = list(attrs.get("strides", [1, 1]))
    pads = attrs.get("paddings", [0, 0])
    dil = list(attrs.get("dilations", [1, 1]))
    groups = int(attrs.get("groups", 1) or 1)
    xq = _quant_act(x, attrs["act_scale"], bits)
    acc = int_conv2d(xq, _weight_int8(w), strides, pads, dil, groups)
    w_scale = _weight_scale(ctx, attrs, x.device)
    out = acc.float() * (
        float(attrs["act_scale"]) * w_scale.reshape(1, -1, 1, 1)
        / scalar(qmax * qmax, w_scale))
    return {"Output": [out]}


def _weight_quant_axis(op_type, shape):
    # conv filters per output channel (axis 0); matmul weights per column
    return 0 if "conv" in op_type else max(0, len(shape) - 1)


def _channel_scales(w, axis):
    red = tuple(i for i in range(w.ndim) if i != axis)
    return np.maximum(np.max(np.abs(w), axis=red), 1e-9)


def _scope_array(scope, name):
    """The scope's value of `name` as a host array (None when absent)."""
    view = scope.find_var(name)
    return None if view is None else np.asarray(view)


class QuantizationFreezePass:
    """Rewrite a QAT (or calibrated) program for int8 inference
    (ref quantization_pass.py:634).

    - weight fake-qdq ops are removed; the scope weight becomes its
      rounded int8 grid value (storage dtype unchanged until
      ConvertToInt8Pass)
    - activation fake-qdq ops are removed; the trained moving-average
      scale (read from the scope) becomes the consumer's ``act_scale``
    - consumer mul/conv2d ops become quantized_mul / quantized_conv2d
    """

    def __init__(self, scope, place, weight_bits=8, activation_bits=8,
                 weight_quantize_type="abs_max"):
        self._scope = scope
        self._place = place
        self._weight_bits = int(weight_bits)
        self._activation_bits = int(activation_bits)
        self._weight_quantize_type = weight_quantize_type

    def apply(self, program):
        qmax = _QMAX[self._weight_bits]
        for block in program.blocks:
            act_scale = {}     # dequantized-name -> (orig_name, scale)
            weight_scale = {}  # dequantized-name -> (orig_name, scales)
            new_ops = []
            for op in block.ops:
                if op.type == "fake_quantize_dequantize_moving_average_abs_max":
                    src = op.input("X")[0]
                    state = op.input("InScale")[0]
                    sval = _scope_array(self._scope, state)
                    if sval is None:
                        raise RuntimeError(
                            "freeze: activation scale state %r not in "
                            "scope — run startup + some training/"
                            "calibration steps first" % state
                        )
                    scale = float(sval.reshape(-1)[0])
                    act_scale[op.output("Out")[0]] = (src, scale)
                    continue
                if op.type == "fake_channel_wise_quantize_dequantize_abs_max":
                    src = op.input("X")[0]
                    w = _scope_array(self._scope, src)
                    if w is None:
                        raise RuntimeError(
                            "freeze: weight %r not in scope" % src)
                    axis = int(op.attrs.get("quant_axis", 0))
                    scales = _channel_scales(w, axis)
                    shape = [1] * w.ndim
                    shape[axis] = -1
                    wq = np.clip(
                        np.round(w / scales.reshape(shape) * qmax),
                        -qmax, qmax)
                    self._scope.set(src, wq.astype(w.dtype))
                    weight_scale[op.output("Out")[0]] = (src, scales)
                    continue
                if op.type in ("mul", "matmul") and (
                        op.input("Y") and op.input("Y")[0] in weight_scale):
                    xname = op.input("X")[0]
                    if xname not in act_scale:
                        raise RuntimeError(
                            "freeze: %s consumes unquantized activation %r"
                            % (op.type, xname)
                        )
                    xsrc, ascale = act_scale[xname]
                    wsrc, wscales = weight_scale[op.input("Y")[0]]
                    op.type = "quantized_mul"
                    op.inputs = {"X": [xsrc], "Y": [wsrc]}
                    op.attrs = {
                        "act_scale": ascale,
                        "weight_scale": [float(s) for s in wscales],
                        "quant_bits": self._weight_bits,
                    }
                elif op.type in ("conv2d", "depthwise_conv2d") and (
                        op.input("Filter")
                        and op.input("Filter")[0] in weight_scale):
                    xname = op.input("Input")[0]
                    if xname not in act_scale:
                        raise RuntimeError(
                            "freeze: conv consumes unquantized "
                            "activation %r" % xname
                        )
                    xsrc, ascale = act_scale[xname]
                    wsrc, wscales = weight_scale[op.input("Filter")[0]]
                    op.attrs = dict(
                        op.attrs,
                        act_scale=ascale,
                        weight_scale=[float(s) for s in wscales],
                        quant_bits=self._weight_bits,
                    )
                    op.inputs = {"Input": [xsrc], "Filter": [wsrc]}
                    op.type = "quantized_conv2d"
                else:
                    # rewire any other reader of a dequantized name
                    for slot, names in op.inputs.items():
                        op.inputs[slot] = [
                            act_scale.get(n, weight_scale.get(n, (n,)))[0]
                            for n in names
                        ]
                new_ops.append(op)
            block.ops = new_ops
        program._bump_version()
        return program


class ConvertToInt8Pass:
    """Cast frozen int8-grid weights to real int8 storage
    (ref quantization_pass.py:944)."""

    def __init__(self, scope, place):
        self._scope = scope
        self._place = place

    def apply(self, program):
        for block in program.blocks:
            for op in block.ops:
                if op.type == "quantized_mul":
                    names = op.input("Y")
                elif op.type == "quantized_conv2d":
                    names = op.input("Filter")
                else:
                    continue
                for n in names:
                    w = _scope_array(self._scope, n)
                    if w is None:
                        continue
                    if w.dtype != np.int8:
                        self._scope.set(n, w.astype(np.int8))
                    var = block.vars.get(n) or \
                        program.global_block().vars.get(n)
                    if var is not None:
                        var.dtype = "int8"
        program._bump_version()
        return program


class AddQuantDequantPass:
    """Insert per-tensor fake quant-dequant on inputs of extra op types
    (elementwise_add, pool2d, ...) so their int8 error is modeled during
    QAT (ref quantization_pass.py:1237)."""

    _DEFAULT_TYPES = ("elementwise_add", "pool2d", "concat", "softmax",
                      "relu")

    def __init__(self, scope=None, place=None, moving_rate=0.9,
                 quant_bits=8, skip_pattern="skip_quant",
                 quantizable_op_type=_DEFAULT_TYPES):
        self._moving_rate = moving_rate
        self._quant_bits = quant_bits
        self._skip_pattern = skip_pattern
        self._op_types = tuple(quantizable_op_type)

    def apply(self, program, startup_program=None):
        from ...quant import QuantizationTransformPass

        pass_ = QuantizationTransformPass(
            weight_bits=self._quant_bits,
            activation_bits=self._quant_bits,
            moving_rate=self._moving_rate,
            quantizable_op_type=self._op_types,
            skip_pattern=self._skip_pattern,
        )
        return pass_.apply(program, startup_program)


class OutScaleForTrainingPass:
    """The reference collects per-output scales for TensorRT export; the
    int8 program here computes with the op-attr scales directly, so this
    is a documented no-op kept for pipeline compatibility."""

    def __init__(self, scope=None, place=None, moving_rate=0.9):
        self._moving_rate = moving_rate

    def apply(self, program):
        return program


OutScaleForInferencePass = OutScaleForTrainingPass


class TransformForMobilePass:
    """Paddle-Lite's mobile op renaming has no counterpart here."""

    def __init__(self, *a, **k):
        raise NotImplementedError(
            "TransformForMobilePass targets Paddle-Lite mobile kernels; "
            "the int8 program needs no mobile transform"
        )
