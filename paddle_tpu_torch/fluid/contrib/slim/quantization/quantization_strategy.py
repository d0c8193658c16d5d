"""QuantizationStrategy: schedule QAT inside a Compressor run
(ref: contrib/slim/quantization/quantization_strategy.py).

Port of paddle_tpu/fluid/contrib/slim/quantization/
quantization_strategy.py. At start_epoch the fake-quant transform is
applied to the optimize and eval graphs (the next run executes the
changed program). At end_epoch the trained scales freeze the eval graph
into the real-int8 inference program, optionally saved both as float
(QAT simulation) and int8 models. The Compressor that calls these hooks
comes with the rest of slim (ROADMAP.md Queue 1, item 6.8).
"""
import numpy as np

from ..core.strategy import Strategy

__all__ = ["QuantizationStrategy"]


class QuantizationStrategy(Strategy):
    def __init__(self, start_epoch=0, end_epoch=0,
                 float_model_save_path=None, mobile_model_save_path=None,
                 int8_model_save_path=None, activation_bits=8,
                 weight_bits=8, activation_quantize_type="abs_max",
                 weight_quantize_type="abs_max", save_in_nodes=None,
                 save_out_nodes=None):
        super().__init__(start_epoch, end_epoch)
        self.float_model_save_path = float_model_save_path
        if mobile_model_save_path is not None:
            raise NotImplementedError(
                "mobile_model_save_path targets Paddle-Lite; the int8 "
                "program is saved via int8_model_save_path"
            )
        self.int8_model_save_path = int8_model_save_path
        self.activation_bits = int(activation_bits)
        self.weight_bits = int(weight_bits)
        self.activation_quantize_type = activation_quantize_type
        self.weight_quantize_type = weight_quantize_type
        self.save_in_nodes = save_in_nodes
        self.save_out_nodes = save_out_nodes
        self._applied = False

    def on_epoch_begin(self, context):
        from ...quant import QuantizationTransformPass

        if self._applied or context.epoch_id != self.start_epoch:
            return
        pass_ = QuantizationTransformPass(
            weight_bits=self.weight_bits,
            activation_bits=self.activation_bits)
        from ....executor import Executor
        from ....framework import Program

        startup = Program()
        pass_.apply(context.optimize_graph.program, startup)
        if context.eval_graph is not None and (
                context.eval_graph.program
                is not context.optimize_graph.program):
            pass_.apply(context.eval_graph.program, startup)
        # initialize the new scale-state vars only (params keep values)
        Executor(context.place).run(startup, scope=context.scope)
        self._applied = True

    def on_epoch_end(self, context):
        if context.epoch_id != self.end_epoch:
            return
        from ....executor import Executor
        from .... import io as _io
        from .quantization_pass import (
            ConvertToInt8Pass, QuantizationFreezePass,
        )

        graph = context.eval_graph or context.train_graph
        exe = Executor(context.place)
        if self.float_model_save_path:
            self._save(graph, exe, self.float_model_save_path)
        frozen = graph.clone(for_test=True)
        QuantizationFreezePass(
            context.scope, context.place,
            weight_bits=self.weight_bits,
            activation_bits=self.activation_bits,
        ).apply(frozen.program)
        ConvertToInt8Pass(context.scope, context.place).apply(
            frozen.program)
        context.put("int8_program", frozen.program)
        if self.int8_model_save_path:
            self._save(frozen, exe, self.int8_model_save_path)

    def _save(self, graph, exe, path):
        from .... import io as _io

        in_nodes = self.save_in_nodes or list(graph.in_nodes.values())
        out_nodes = self.save_out_nodes or list(graph.out_nodes.values())
        _io.save_inference_model(
            path, list(in_nodes),
            [graph.var(n)._var for n in out_nodes], exe,
            main_program=graph.program)
