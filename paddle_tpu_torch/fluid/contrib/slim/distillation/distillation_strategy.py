"""DistillationStrategy (ref: contrib/slim/distillation/
distillation_strategy.py).

Inside [start_epoch, end_epoch) training runs a DISTILL graph: the
distillers' losses are appended to a clone of the train program (teacher
vars stop-gradient — teacher and student live in one program here, see
distiller.py) and the distiller optimizer minimizes the combined loss.
After end_epoch the original optimize graph (fine-tune stage) returns.

Port of paddle_tpu/fluid/contrib/slim/distillation/
distillation_strategy.py.
"""
from ..core.strategy import Strategy

__all__ = ["DistillationStrategy"]


class DistillationStrategy(Strategy):
    def __init__(self, distillers=None, start_epoch=0, end_epoch=0):
        super().__init__(start_epoch, end_epoch)
        self.distillers = list(distillers or [])
        self._distill_graph = None
        self._orig_graph = None

    def _build_distill_graph(self, context):
        from ....executor import Executor
        from ....framework import Program, program_guard
        from .... import layers

        graph = context.train_graph.clone()
        program = graph.program
        startup = Program()
        losses = [d.distiller_loss(program) for d in self.distillers]
        with program_guard(program, startup):
            total = losses[0]
            for extra in losses[1:]:
                total = layers.elementwise_add(total, extra)
            # student task loss (the train graph's first out node) joins
            out_names = list(context.train_graph.out_nodes.values())
            if out_names:
                task_loss = graph.var(out_names[0])._var
                total = layers.elementwise_add(total, task_loss)
            opt = (context.distiller_optimizer
                   or context.train_optimizer)
            if opt is None:
                raise ValueError(
                    "DistillationStrategy needs distiller_optimizer (or "
                    "train_optimizer) on the Compressor")
            opt.minimize(total, startup_program=startup)
        Executor(context.place).run(startup, scope=context.scope)
        graph.out_nodes = dict(context.train_graph.out_nodes)
        graph.out_nodes["distill_loss"] = total.name
        return graph

    def on_epoch_begin(self, context):
        if context.epoch_id == self.start_epoch:
            if self._distill_graph is None:
                self._distill_graph = self._build_distill_graph(context)
            self._orig_graph = context.optimize_graph
            context.optimize_graph = self._distill_graph

    def on_epoch_end(self, context):
        if context.epoch_id == self.end_epoch:
            context.optimize_graph = self._orig_graph
