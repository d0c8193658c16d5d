"""Control-flow layers (ref: python/paddle/fluid/layers/control_flow.py);
port of paddle_tpu/fluid/layers/control_flow.py.

While, cond (and IfElse, case, switch_case), StaticRNN and DynamicRNN
append ops that run a sub-block (ops/control_ops.py): the JAX package
traces them into lax.while_loop, lax.cond and lax.scan; the port runs
them eagerly. LoDTensorArray works with build-time (python) indices only,
as in the reference. reorder_lod_tensor_by_rank raises, as the JAX
package's does (dense-padded batches have no rank table). ``Print``'s op
prints from the host when its tensor is ready.
"""
import contextlib

import numpy as np

from .. import core
from ..framework import Variable
from ..layer_helper import LayerHelper
from . import tensor as tensor_layers

__all__ = [
    "While", "Switch", "increment", "array_write", "create_array",
    "less_than", "less_equal", "greater_than", "greater_equal", "equal",
    "not_equal", "array_read", "array_length", "cond", "IfElse",
    "StaticRNN", "DynamicRNN", "reorder_lod_tensor_by_rank", "Print",
    "is_empty", "case", "switch_case", "while_loop",
]


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------
def _cmp(op_type, x, y, cond=None):
    helper = LayerHelper(op_type, x=x, y=y)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
        cond.stop_gradient = True
    cond.shape = x.shape
    helper.append_op(
        type=op_type,
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [cond]},
    )
    return cond


def less_than(x, y, force_cpu=None, cond=None):
    return _cmp("less_than", x, y, cond)


def less_equal(x, y, cond=None):
    return _cmp("less_equal", x, y, cond)


def greater_than(x, y, cond=None):
    return _cmp("greater_than", x, y, cond)


def greater_equal(x, y, cond=None):
    return _cmp("greater_equal", x, y, cond)


def equal(x, y, cond=None):
    return _cmp("equal", x, y, cond)


def not_equal(x, y, cond=None):
    return _cmp("not_equal", x, y, cond)


def is_empty(x, cond=None):
    helper = LayerHelper("is_empty", x=x)
    if cond is None:
        cond = helper.create_variable_for_type_inference("bool")
    cond.shape = ()
    helper.append_op(
        type="is_empty", inputs={"X": [x]}, outputs={"Out": [cond]}
    )
    return cond


def increment(x, value=1.0, in_place=True):
    helper = LayerHelper("increment", x=x, value=value)
    if in_place:
        out = x
    else:
        out = helper.create_variable_for_type_inference(x.dtype)
        out.shape = x.shape
    helper.append_op(
        type="increment",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"step": float(value)},
    )
    return out


# ---------------------------------------------------------------------------
# LoDTensorArray (build-time indices)
# ---------------------------------------------------------------------------
class _BuildTimeArray:
    """Python-list LoDTensorArray: works for static (trace-time) indices."""

    def __init__(self, name):
        self.name = name
        self.vars = []


def create_array(dtype):
    helper = LayerHelper("array")
    arr = _BuildTimeArray(helper.name)
    arr.dtype = core.convert_dtype(dtype)
    return arr


def _static_index(i):
    if isinstance(i, Variable):
        # the reference's rule, kept so both packages accept the same
        # programs
        raise NotImplementedError(
            "LoDTensorArray with a run-time (Variable) index is not "
            "supported (the reference cannot compile data-dependent "
            "indexing); use StaticRNN / layers.while_loop carries instead"
        )
    return int(np.asarray(i).reshape(-1)[0])


def array_write(x, i, array=None):
    if array is None:
        array = create_array(x.dtype)
    idx = _static_index(i) if not _is_buildtime_counter(i) else len(array.vars)
    while len(array.vars) <= idx:
        array.vars.append(None)
    array.vars[idx] = x
    return array


def _is_buildtime_counter(i):
    return i is None


def array_read(array, i):
    idx = _static_index(i)
    v = array.vars[idx]
    if v is None:
        raise ValueError("array slot %d was never written" % idx)
    return v


def array_length(array):
    return tensor_layers.fill_constant([1], "int64", len(array.vars))


# ---------------------------------------------------------------------------
# While
# ---------------------------------------------------------------------------
class While:
    """ref control_flow.py While (lax.while_loop in the JAX package). Usage:

        cond = layers.less_than(i, n)
        w = layers.While(cond)
        with w.block():
            ... ops updating loop vars ...
            layers.increment(i)
            layers.less_than(i, n, cond=cond)   # refresh condition
    """

    def __init__(self, cond, is_test=False, name=None):
        self.helper = LayerHelper("while", name=name)
        self.cond_var = cond
        self.is_test = is_test

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        parent_block = program.current_block()
        with program._block_guard() as blk:
            yield
        # carried vars: everything the sub-block writes that exists outside
        written = []
        for op in blk.ops:
            for n in op.output_arg_names:
                if n not in written:
                    written.append(n)
        carried = [
            n for n in written
            if parent_block.has_var_recursive(n) and n != self.cond_var.name
        ]
        carried_vars = [parent_block._var_recursive(n) for n in carried]
        parent_block.append_op(
            type="while",
            inputs={
                "Condition": [self.cond_var],
                "X": carried_vars,
            },
            outputs={"Out": carried_vars},
            attrs={
                "sub_block": blk.idx,
                "carried_names": carried,
                "cond_name": self.cond_var.name,
                "is_test": self.is_test,
            },
        )


def while_loop(cond, body, loop_vars, is_test=False, name=None):
    """Functional while (1.6 API): cond/body are python fns over Variables."""
    helper = LayerHelper("while_loop", name=name)
    pred = cond(*loop_vars)
    w = While(pred)
    out_vars = list(loop_vars)
    with w.block():
        new_vars = body(*out_vars)
        if not isinstance(new_vars, (list, tuple)):
            new_vars = [new_vars]
        for old, new in zip(out_vars, new_vars):
            helper.append_op(
                type="assign", inputs={"X": [new]}, outputs={"Out": [old]}
            )
        new_pred = cond(*out_vars)
        helper.append_op(
            type="assign", inputs={"X": [new_pred]}, outputs={"Out": [pred]}
        )
    return out_vars


# ---------------------------------------------------------------------------
# cond / case / switch_case (1.6-style functional control flow)
# ---------------------------------------------------------------------------
def cond(pred, true_fn=None, false_fn=None, name=None):
    helper = LayerHelper("cond", name=name)
    program = helper.main_program
    parent_block = program.current_block()

    with program._block_guard() as tb:
        t_out = true_fn() if true_fn is not None else None
    with program._block_guard() as fb:
        f_out = false_fn() if false_fn is not None else None

    def _norm(o):
        if o is None:
            return []
        return list(o) if isinstance(o, (list, tuple)) else [o]

    t_list, f_list = _norm(t_out), _norm(f_out)
    if len(t_list) != len(f_list):
        raise ValueError(
            "true_fn and false_fn must return the same number of outputs"
        )
    outs = []
    for tv in t_list:
        o = parent_block.create_var(
            name=tv.name + "@COND_OUT", dtype=tv.dtype, shape=tv.shape
        )
        outs.append(o)
    parent_block.append_op(
        type="cond",
        inputs={"Cond": [pred]},
        outputs={"Out": outs},
        attrs={
            "true_block": tb.idx,
            "false_block": fb.idx,
            "true_out_names": [v.name for v in t_list],
            "false_out_names": [v.name for v in f_list],
        },
    )
    if not outs:
        return None
    return outs[0] if len(outs) == 1 else outs


def case(pred_fn_pairs, default=None, name=None):
    """Cascaded cond (ref control_flow.py case)."""
    if not pred_fn_pairs:
        raise ValueError("pred_fn_pairs must be non-empty")

    def build(i):
        if i == len(pred_fn_pairs):
            if default is None:
                return pred_fn_pairs[-1][1]()
            return default()
        pred, fn = pred_fn_pairs[i]
        if i == len(pred_fn_pairs) - 1 and default is None:
            return cond(pred, fn, pred_fn_pairs[-1][1])
        return cond(pred, fn, lambda: build(i + 1))

    return build(0)


def switch_case(branch_index, branch_fns, default=None, name=None):
    pairs = []
    for idx, fn in (
        branch_fns.items() if isinstance(branch_fns, dict) else enumerate(branch_fns)
    ):
        pred = equal(
            branch_index,
            tensor_layers.fill_constant([1], branch_index.dtype, idx),
        )
        pairs.append((pred, fn))
    return case(pairs, default)


class Switch:
    """ref control_flow.py Switch — conditional_block cases. Vars assigned
    inside a case must be created (e.g. fill_constant) beforehand."""

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self.inside_scope = False
        self.pre_not_conditions = []

    @contextlib.contextmanager
    def case(self, condition):
        program = self.helper.main_program
        parent_block = program.current_block()
        # combine with negation of previous cases
        from .nn import logical_and, logical_not

        for prev in self.pre_not_conditions:
            condition = logical_and(condition, prev)
        self.pre_not_conditions.append(logical_not(condition))
        with program._block_guard() as blk:
            yield
        written = []
        for op in blk.ops:
            for n in op.output_arg_names:
                if n not in written and parent_block.has_var_recursive(n):
                    written.append(n)
        wvars = [parent_block._var_recursive(n) for n in written]
        parent_block.append_op(
            type="conditional_block",
            inputs={"Cond": [condition], "X": wvars},
            outputs={"Out": wvars},
            attrs={"sub_block": blk.idx, "written_names": written},
        )

    @contextlib.contextmanager
    def default(self):
        from .nn import logical_and

        cond_all = self.pre_not_conditions[0]
        for c in self.pre_not_conditions[1:]:
            cond_all = logical_and(cond_all, c)
        with self.case(cond_all):
            yield


class IfElse:
    """ref control_flow.py IfElse — kept for parity; implemented over cond
    with explicit true/false input splits."""

    OUT_IF_ELSE_BLOCKS = 2

    def __init__(self, cond_var, name=None):
        self.cond = cond_var
        self.helper = LayerHelper("ifelse", name=name)
        self._true_ops = None
        self._outputs_true = []
        self._outputs_false = []
        self._phase = None
        self._program = self.helper.main_program
        self._blocks = {}

    @contextlib.contextmanager
    def true_block(self):
        with self._program._block_guard() as blk:
            self._phase = True
            self._blocks[True] = blk
            yield
        self._phase = None

    @contextlib.contextmanager
    def false_block(self):
        with self._program._block_guard() as blk:
            self._phase = False
            self._blocks[False] = blk
            yield
        self._phase = None

    def input(self, x):
        return x

    def output(self, *outs):
        if self._phase is True:
            self._outputs_true.extend(outs)
        elif self._phase is False:
            self._outputs_false.extend(outs)
        else:
            raise ValueError("IfElse.output() outside a block")

    def __call__(self):
        if len(self._outputs_true) != len(self._outputs_false):
            raise ValueError("true/false blocks must output the same arity")
        parent = self._program.current_block()
        outs = []
        for tv in self._outputs_true:
            o = parent.create_var(
                name=tv.name + "@IFELSE_OUT", dtype=tv.dtype, shape=tv.shape
            )
            outs.append(o)
        parent.append_op(
            type="cond",
            inputs={"Cond": [self.cond]},
            outputs={"Out": outs},
            attrs={
                "true_block": self._blocks[True].idx,
                "false_block": self._blocks[False].idx,
                "true_out_names": [v.name for v in self._outputs_true],
                "false_out_names": [v.name for v in self._outputs_false],
            },
        )
        return outs


# ---------------------------------------------------------------------------
# StaticRNN
# ---------------------------------------------------------------------------
class StaticRNN:
    """ref control_flow.py StaticRNN: the step block runs once per time
    step (lax.scan in the JAX package).

    Usage (same as reference; step inputs are time-major (T, B, D)):

        rnn = layers.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            h_prev = rnn.memory(init=h0)
            h = layers.fc(input=[xt, h_prev], size=D, ...)
            rnn.update_memory(h_prev, h)
            rnn.step_output(h)
        out = rnn()   # (T, B, D)
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._block = None
        self._mem_init = []       # outer init Variables
        self._mem_in = []         # in-block memory placeholders
        self._mem_updated = []    # in-block updated values
        self._x_outer = []
        self._x_in = []
        self._step_outputs = []
        self._outs = None

    @contextlib.contextmanager
    def step(self):
        program = self.helper.main_program
        self._parent_block = program.current_block()
        with program._block_guard() as blk:
            self._block = blk
            yield
        self._finalize()

    def step_input(self, x):
        xt = self._block.create_var(
            name=x.name + "@STEP",
            dtype=x.dtype,
            shape=tuple(x.shape[1:]) if x.shape else None,
        )
        self._x_outer.append(x)
        self._x_in.append(xt)
        return xt

    def memory(self, init=None, shape=None, batch_ref=None,
               init_value=0.0, init_batch_dim_idx=0, ref_batch_dim_idx=1):
        if init is None:
            if shape is None:
                raise ValueError("memory needs init or shape")
            init = tensor_layers.fill_constant(
                shape, "float32", init_value
            )
        m = self._block.create_var(
            name="%s@MEM_%d" % (init.name, len(self._mem_in)),
            dtype=init.dtype,
            shape=init.shape,
        )
        self._mem_init.append(init)
        self._mem_in.append(m)
        self._mem_updated.append(None)
        return m

    def update_memory(self, mem, var):
        idx = self._mem_in.index(mem)
        self._mem_updated[idx] = var

    def step_output(self, o):
        self._step_outputs.append(o)

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def _finalize(self):
        if any(u is None for u in self._mem_updated):
            raise ValueError("every memory needs update_memory()")
        parent = self._parent_block
        outs = []
        for idx, o in enumerate(self._step_outputs):
            ov = parent.create_var(
                name="%s@SCAN_OUT_%d" % (o.name, idx),
                dtype=o.dtype,
                shape=((self._x_outer[0].shape[0],) + tuple(o.shape or ()))
                if self._x_outer and self._x_outer[0].shape
                else None,
            )
            outs.append(ov)
        parent.append_op(
            type="static_rnn",
            inputs={
                "Mem": self._mem_init,
                "X": self._x_outer,
            },
            outputs={"Out": outs},
            attrs={
                "sub_block": self._block.idx,
                "mem_names": [m.name for m in self._mem_in],
                "mem_updated": [u.name for u in self._mem_updated],
                "x_names": [x.name for x in self._x_in],
                "out_names": [o.name for o in self._step_outputs],
            },
        )
        self._outs = outs

    def __call__(self):
        if not self._outs:
            raise ValueError("StaticRNN has no outputs")
        return self._outs[0] if len(self._outs) == 1 else self._outs


class DynamicRNN:
    """Variable-length RNN (ref control_flow.py:2435 DynamicRNN), dense
    form, as in the JAX package. The reference sorts sequences by length
    and shrinks the batch each step; here sequences travel padded (B, T,
    ...) with a `@SEQ_LEN` companion (see fluid/lod.py) and every step
    runs the FULL batch under a mask — finished sequences freeze their
    memory and emit zeros, which is mathematically identical and keeps
    every step's shapes the same. Same user surface:

        drnn = layers.DynamicRNN()
        with drnn.block():
            w = drnn.step_input(sentence)        # (B, D) at step t
            enc = drnn.static_input(encoder)     # closure, unchanged
            h = drnn.memory(init=boot)           # or shape=[D], value=0.
            h2 = some_layers(w, h, enc)
            drnn.update_memory(h, h2)
            drnn.output(h2)
        out = drnn()                             # (B, T, D) padded
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self._block = None
        self._parent_block = None
        self._mem_init = []
        self._mem_in = []
        self._mem_updated = []
        self._x_outer = []
        self._x_in = []
        self._static = []
        self._step_outputs = []
        self._outs = None

    @contextlib.contextmanager
    def block(self):
        program = self.helper.main_program
        self._parent_block = program.current_block()
        with program._block_guard() as blk:
            self._block = blk
            yield
        self._finalize()

    def step_input(self, x, level=0):
        if x.shape is None or len(x.shape) < 2:
            raise ValueError(
                "DynamicRNN.step_input needs a (batch, time, ...) padded "
                "sequence var (declare with lod_level=1)"
            )
        xt = self._block.create_var(
            name=x.name + "@STEP",
            dtype=x.dtype,
            shape=(x.shape[0],) + tuple(x.shape[2:]),
        )
        self._x_outer.append(x)
        self._x_in.append(xt)
        return xt

    def static_input(self, x):
        # non-sequence input: the step block closes over it unchanged (the
        # reference reorders it by sequence rank; we never reorder)
        self._static.append(x)
        return x

    def memory(self, init=None, shape=None, value=0.0, need_reorder=False,
               dtype="float32"):
        if init is None:
            if shape is None:
                raise ValueError("DynamicRNN.memory needs init or shape")
            if not self._x_outer:
                raise ValueError(
                    "call step_input before a shape-only memory so the "
                    "batch size is known"
                )
            ref = self._x_outer[0]
            # the init must live in the PARENT block (it is an outer input
            # of the scan), while memory() is called inside block();
            # batch dim is taken from the step input AT LOWERING TIME so
            # dynamic-batch (-1) data vars work
            parent = self._parent_block
            from .. import unique_name as _un

            full_shape = [ref.shape[0] if ref.shape else -1] + list(shape)
            init = parent.create_var(
                name=_un.generate("drnn_mem_init"),
                dtype=dtype,
                shape=tuple(full_shape),
            )
            parent.append_op(
                type="fill_constant_batch_size_like",
                inputs={"Input": [ref]},
                outputs={"Out": [init]},
                attrs={
                    "shape": [-1] + list(shape),
                    "dtype": core.convert_dtype(dtype),
                    "value": float(value),
                    "input_dim_idx": 0,
                    "output_dim_idx": 0,
                },
            )
        # need_reorder is a no-op: sequences are never rank-sorted here
        m = self._block.create_var(
            name="%s@MEM_%d" % (init.name, len(self._mem_in)),
            dtype=init.dtype,
            shape=init.shape,
        )
        self._mem_init.append(init)
        self._mem_in.append(m)
        self._mem_updated.append(None)
        return m

    def update_memory(self, ex_mem, new_mem):
        idx = self._mem_in.index(ex_mem)
        self._mem_updated[idx] = new_mem

    def output(self, *outputs):
        self._step_outputs.extend(outputs)

    def _seq_len_var(self):
        from .sequence_lod import _seq_len_var

        for x in self._x_outer:
            sl = _seq_len_var(x)
            if sl is not None:
                return sl
        return None

    def _finalize(self):
        if not self._x_outer:
            raise ValueError("DynamicRNN needs at least one step_input")
        if any(u is None for u in self._mem_updated):
            raise ValueError("every DynamicRNN memory needs update_memory()")
        parent = self._parent_block
        b, t = self._x_outer[0].shape[0], self._x_outer[0].shape[1]
        outs = []
        for o in self._step_outputs:
            ov = parent.create_var(
                name=o.name + "@DRNN_OUT",
                dtype=o.dtype,
                shape=(b, t) + tuple(o.shape[1:] if o.shape else ()),
            )
            outs.append(ov)
        ins = {"Mem": self._mem_init, "X": self._x_outer}
        sl = self._seq_len_var()
        if sl is not None:
            ins["SeqLen"] = [sl]
        parent.append_op(
            type="dynamic_rnn",
            inputs=ins,
            outputs={"Out": outs},
            attrs={
                "sub_block": self._block.idx,
                "mem_names": [m.name for m in self._mem_in],
                "mem_updated": [u.name for u in self._mem_updated],
                "x_names": [x.name for x in self._x_in],
                "out_names": [o.name for o in self._step_outputs],
            },
        )
        # outputs keep the input's sequence structure
        if sl is not None:
            from .sequence_lod import _alias_seq_len

            for ov in outs:
                _alias_seq_len(self.helper, self._x_outer[0], ov)
        self._outs = outs

    def __call__(self):
        if not self._outs:
            raise ValueError("DynamicRNN has no outputs")
        return self._outs[0] if len(self._outs) == 1 else self._outs


def reorder_lod_tensor_by_rank(x, rank_table):
    raise NotImplementedError(
        "rank-table reordering is a LoD-runtime detail; dense-padded "
        "batches don't need it (sort host-side if required)"
    )


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    helper = LayerHelper("print", input=input)
    out = helper.create_variable_for_type_inference(input.dtype)
    out.shape = input.shape
    helper.append_op(
        type="print",
        inputs={"In": [input]},
        outputs={"Out": [out]},
        attrs={"message": message or ""},
    )
    return out
