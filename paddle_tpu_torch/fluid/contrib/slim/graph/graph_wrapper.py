"""GraphWrapper: a strategy-friendly view over the symbolic Program
(ref: python/paddle/fluid/contrib/slim/graph/graph_wrapper.py).

The reference wraps the C++ IrGraph; here the Program's Block/Operator
records are already python, so the wrappers are thin views adding the
graph queries strategies need: producer/consumer walks, parameter
lookups, FLOPs and parameter counts.

Port of paddle_tpu/fluid/contrib/slim/graph/graph_wrapper.py over the
port's Program. ``infer_shape`` and ``compile(for_parallel=True)`` reach
modules the port brings later and raise, naming their items.
"""
import numpy as np

from ....framework import Parameter, Variable

__all__ = ["VarWrapper", "OpWrapper", "GraphWrapper"]

_OPTIMIZE_OPS = {
    "sgd", "momentum", "lars_momentum", "adam", "adamax", "adagrad",
    "decayed_adagrad", "adadelta", "rmsprop", "ftrl", "lamb", "dpsgd",
}


class VarWrapper:
    def __init__(self, var, graph):
        self._var = var
        self._graph = graph

    def __eq__(self, v):
        return isinstance(v, VarWrapper) and self._var.name == v._var.name

    def __hash__(self):
        return hash(self._var.name)

    def name(self):
        return self._var.name

    def shape(self):
        return self._var.shape

    def set_shape(self, shape):
        self._var.shape = tuple(shape)

    def inputs(self):
        """Ops producing this var."""
        return [
            op for op in self._graph.ops()
            if self.name() in op.all_output_names()
        ]

    def outputs(self):
        """Ops consuming this var."""
        return [
            op for op in self._graph.ops()
            if self.name() in op.all_input_names()
        ]


class OpWrapper:
    def __init__(self, op, graph):
        self._op = op
        self._graph = graph

    def __eq__(self, other):
        return isinstance(other, OpWrapper) and self.idx() == other.idx()

    def __hash__(self):
        return hash(("op", self.idx()))

    def idx(self):
        return self._graph._op_index(self._op)

    def type(self):
        return self._op.type

    def is_bwd_op(self):
        return self._op.type == "backward" or "@GRAD" in "".join(
            self.all_output_names())

    def is_opt_op(self):
        return self._op.type in _OPTIMIZE_OPS

    def all_input_names(self):
        return [n for ns in self._op.inputs.values() for n in ns]

    def all_output_names(self):
        return [n for ns in self._op.outputs.values() for n in ns]

    def all_inputs(self):
        return [self._graph.var(n) for n in self.all_input_names()
                if self._graph.has_var(n)]

    def all_outputs(self):
        return [self._graph.var(n) for n in self.all_output_names()
                if self._graph.has_var(n)]

    def inputs(self, name):
        return [self._graph.var(n) for n in self._op.input(name)]

    def outputs(self, name):
        return [self._graph.var(n) for n in self._op.output(name)]

    def set_attr(self, key, value):
        self._op.attrs[key] = value
        self._graph.program._bump_version()

    def attr(self, name):
        return self._op.attrs.get(name)


class GraphWrapper:
    """ref graph_wrapper.py:189. in_nodes/out_nodes: lists of
    (display_name, var_name) tuples or dicts."""

    def __init__(self, program=None, in_nodes=None, out_nodes=None):
        from ....framework import default_main_program

        self.program = program if program is not None \
            else default_main_program()
        self.persistables = {
            v.name: v for v in self.program.list_vars()
            if getattr(v, "persistable", False)
        }
        self.in_nodes = dict(in_nodes or [])
        self.out_nodes = dict(out_nodes or [])
        self._attrs = {}

    # -- vars -----------------------------------------------------------
    def all_parameters(self):
        return [
            VarWrapper(v, self) for v in self.program.list_vars()
            if isinstance(v, Parameter)
        ]

    def is_parameter(self, var):
        v = var._var if isinstance(var, VarWrapper) else var
        return isinstance(v, Parameter)

    def is_persistable(self, var):
        v = var._var if isinstance(var, VarWrapper) else var
        return bool(getattr(v, "persistable", False))

    def ops(self):
        return [
            OpWrapper(op, self)
            for block in self.program.blocks
            for op in block.ops
        ]

    def _op_index(self, op):
        i = 0
        for block in self.program.blocks:
            for o in block.ops:
                if o is op:
                    return i
                i += 1
        return -1

    def vars(self):
        return [VarWrapper(v, self) for v in self.program.list_vars()]

    def has_var(self, name):
        return any(b.has_var(name) for b in self.program.blocks)

    def var(self, name):
        for block in self.program.blocks:
            if block.has_var(name):
                return VarWrapper(block.var(name), self)
        raise ValueError("var %r not in graph" % name)

    # -- topology -------------------------------------------------------
    def pre_ops(self, op):
        ins = set(op.all_input_names())
        return [
            o for o in self.ops()
            if ins.intersection(o.all_output_names())
        ]

    def next_ops(self, op):
        outs = set(op.all_output_names())
        return [
            o for o in self.ops()
            if outs.intersection(o.all_input_names())
        ]

    def get_param_by_op(self, op):
        return [v for v in op.all_inputs() if self.is_parameter(v)]

    # -- stats ----------------------------------------------------------
    def numel_params(self):
        total = 0
        for p in self.all_parameters():
            total += int(np.prod([s for s in p.shape() if s and s > 0]))
        return total

    def flops(self, only_conv=False):
        """Per-sample multiply FLOPs of conv2d/mul ops (batch dim
        excluded, matching the reference's accounting)."""
        total = 0
        for op in self.ops():
            if op.type() in ("conv2d", "depthwise_conv2d"):
                out = op.outputs("Output")[0].shape()
                filt = op.inputs("Filter")[0].shape()
                if None in out[2:] or -1 in out[2:]:
                    continue
                groups = int(op.attr("groups") or 1)
                total += (int(np.prod(out[1:])) *
                          int(np.prod(filt[1:])) // max(groups, 1))
            elif not only_conv and op.type() == "mul":
                x = op.inputs("X")[0].shape()
                y = op.inputs("Y")[0].shape()
                total += int(np.prod([s for s in x[1:] if s and s > 0])) * \
                    int(y[-1])
        return total

    # -- program management --------------------------------------------
    def clone(self, for_test=False):
        return GraphWrapper(
            self.program.clone(for_test), list(self.in_nodes.items()),
            list(self.out_nodes.items()))

    def program_guard(self):
        from ....framework import program_guard

        return program_guard(self.program)

    def get_optimize_graph(self, optimizer, place, scope=None,
                           no_grad_var_names=None):
        """Append loss backward + optimizer to a clone (the training
        graph for fine-tune stages); optimizer state (lr var,
        accumulators) is initialized immediately via its own startup."""
        from ....executor import Executor
        from ....framework import Program, program_guard

        graph = self.clone()
        startup = Program()
        with program_guard(graph.program, startup):
            loss_name = list(graph.out_nodes.values())[0]
            loss = graph.var(loss_name)._var
            optimizer.minimize(
                loss, startup_program=startup,
                no_grad_set=set(no_grad_var_names or ()))
        Executor(place).run(startup, scope=scope)
        return graph

    def infer_shape(self):
        """Recompute static shapes by abstract propagation through the op
        lowerings (the reference reads ``analysis.shapes``). Raises: the
        port brings that module with ROADMAP.md Queue 1 item 11."""
        raise NotImplementedError(
            "GraphWrapper.infer_shape reads analysis/shapes.py, which the "
            "port brings with ROADMAP.md Queue 1 item 11")

    def update_param_shape(self, scope=None):
        pass

    def update_groups_of_conv(self):
        pass

    def compile(self, for_parallel=True, for_test=False, mem_opt=False):
        """Return the executable form: the program itself (cloned for test
        when asked). ``for_parallel=True`` (the default) wraps it in a
        ``CompiledProgram``, which the port brings with ROADMAP.md Queue 1
        item 8.1: until then it raises."""
        if for_parallel:
            raise NotImplementedError(
                "GraphWrapper.compile(for_parallel=True) builds a "
                "CompiledProgram (fluid/compiler.py), which the port brings "
                "with ROADMAP.md Queue 1 item 8.1; pass for_parallel=False")
        return self.program.clone(for_test) if for_test else self.program

    def merge(self, graph):
        """Append another graph's ops/vars into this one (ref merge —
        used to fold teacher graphs in): vars are shared by name, ops
        appended in order."""
        dst = self.program.global_block()
        for block in graph.program.blocks:
            for name, var in block.vars.items():
                if not dst.has_var(name):
                    dst.vars[name] = var
            for op in block.ops:
                dst.ops.append(op)
        self.program._bump_version()

    def save_persistables(self, path, exe):
        from .... import io as _io

        _io.save_persistables(exe, path, self.program)

    def load_persistables(self, path, exe):
        from .... import io as _io

        _io.load_persistables(exe, path, self.program)

    def save_infer_model(self, path, exe, in_out, program_only=False):
        """ref save_infer_model(path, exe, (in_names, out_names))."""
        from .... import io as _io

        in_names, out_names = in_out
        _io.save_inference_model(
            path, list(in_names),
            [self.var(n)._var for n in out_names], exe,
            main_program=self.program, program_only=program_only)

    def save_model(self, path, exe):
        from .... import io as _io

        _io.save_inference_model(
            path, list(self.in_nodes.values()),
            [self.var(n)._var for n in self.out_nodes.values()],
            exe, main_program=self.program)
