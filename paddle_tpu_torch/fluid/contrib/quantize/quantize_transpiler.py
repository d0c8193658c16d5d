"""QuantizeTranspiler — the pre-slim quantization API
(ref: python/paddle/fluid/contrib/quantize/quantize_transpiler.py).

Thin façade over the slim passes: training_transpile applies the QAT
fake-quant transform; freeze_program rewrites onto the real-int8 ops;
convert_to_int8 casts weight storage. Kept so reference scripts using
the older entry point run unchanged.
"""

__all__ = ["QuantizeTranspiler", "quant"]


def quant(x, scale, num_bits):
    """Round x onto the num_bits int grid given scale
    (ref quantize_transpiler.py:75)."""
    import numpy as np

    return np.round(x / scale * ((1 << (num_bits - 1)) - 1))


class QuantizeTranspiler:
    def __init__(self, weight_bits=8, activation_bits=8,
                 activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", window_size=10000,
                 moving_rate=0.9):
        if activation_quantize_type == "range_abs_max":
            # window-based range tracking: the moving-average state
            # covers the same role in the scan-friendly form
            activation_quantize_type = "moving_average_abs_max"
        self.weight_bits = int(weight_bits)
        self.activation_bits = int(activation_bits)
        self.activation_quantize_type = activation_quantize_type
        self.weight_quantize_type = weight_quantize_type
        self.window_size = int(window_size)
        self.moving_rate = float(moving_rate)

    def training_transpile(self, program=None, startup_program=None):
        from ...framework import (
            default_main_program, default_startup_program,
        )
        from ..quant import QuantizationTransformPass

        program = program or default_main_program()
        startup_program = startup_program or default_startup_program()
        QuantizationTransformPass(
            weight_bits=self.weight_bits,
            activation_bits=self.activation_bits,
            moving_rate=self.moving_rate,
        ).apply(program, startup_program)
        return program

    def freeze_program(self, program, place, scope=None):
        from ...executor import global_scope
        from ..slim.quantization import QuantizationFreezePass

        return QuantizationFreezePass(
            scope or global_scope(), place,
            weight_bits=self.weight_bits,
            activation_bits=self.activation_bits,
        ).apply(program)

    def convert_to_int8(self, program, place, scope=None):
        from ...executor import global_scope
        from ..slim.quantization import ConvertToInt8Pass

        return ConvertToInt8Pass(
            scope or global_scope(), place).apply(program)
