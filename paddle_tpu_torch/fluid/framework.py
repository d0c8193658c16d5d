"""Symbolic Program IR.

Port of paddle_tpu/fluid/framework.py (ref: python/paddle/fluid/
framework.py:799,1684,2136,3554). The IR is a pure symbolic record —
Program/Block/Variable/Operator — that the Executor walks op by op,
lowering each op to torch. The IR, ``clone``/``_prune`` and the
``to_json``/``from_json`` serde are copied unchanged, so both packages
build the same Program for the same layer calls and read and write the
same ``__model__`` JSON.
"""
import collections
import contextlib
import copy
import itertools
import json
import traceback

import numpy as np
import torch

from . import core
from . import unique_name

__all__ = [
    "Program",
    "Block",
    "Variable",
    "Operator",
    "Parameter",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "name_scope",
    "grad_var_name",
    "cpu_places",
    "cuda_places",
    "convert_np_dtype_to_dtype_",
]

GRAD_VAR_SUFFIX = "@GRAD"


def grad_var_name(var_name):
    return var_name + GRAD_VAR_SUFFIX


def convert_np_dtype_to_dtype_(np_dtype):
    return core.convert_dtype(np_dtype)


def cpu_places(device_count=None):
    return [core.CPUPlace(i) for i in range(device_count or 1)]


def cuda_places(device_ids=None):
    """One CUDAPlace per visible card (or per id in `device_ids`)."""
    if device_ids is None:
        device_ids = range(torch.cuda.device_count())
    return [core.CUDAPlace(i) for i in device_ids]


# ---------------------------------------------------------------------------
# name_scope
# ---------------------------------------------------------------------------
class NameScope:
    def __init__(self, name="", parent=None):
        self._children = {}
        self._name = name
        self._parent = parent

    def child(self, prefix):
        if prefix not in self._children:
            self._children[prefix] = [NameScope(prefix, self)]
        else:
            new_child = NameScope(
                prefix + "_%d" % len(self._children[prefix]), self
            )
            self._children[prefix].append(new_child)
        return self._children[prefix][-1]

    def parent(self):
        return self._parent

    def name(self):
        return self._name


_name_scope = NameScope()


@contextlib.contextmanager
def name_scope(prefix=None):
    global _name_scope
    _name_scope = _name_scope.child(prefix or "")
    try:
        yield
    finally:
        _name_scope = _name_scope.parent()


# ---------------------------------------------------------------------------
# Variable
# ---------------------------------------------------------------------------
class Variable:
    """A named symbolic tensor in a Block.

    Mirrors ref framework.py:799 Variable. Holds static metadata only —
    values live in the executor Scope (torch tensors on the place's
    device). Shape may contain -1 (batch dims resolved at feed time).
    """

    def __init__(
        self,
        block,
        type=core.VarType.LOD_TENSOR,
        name=None,
        shape=None,
        dtype=None,
        lod_level=None,
        capacity=None,
        persistable=None,
        error_clip=None,
        stop_gradient=False,
        is_data=False,
        need_check_feed=False,
        belong_to_optimizer=False,
        **kwargs
    ):
        self.block = block
        if name is None:
            name = unique_name.generate("_generated_var")
        self.name = name
        self.type = type
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = core.convert_dtype(dtype) if dtype is not None else None
        self.lod_level = lod_level or 0
        self.persistable = bool(persistable)
        self.error_clip = error_clip
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.need_check_feed = need_check_feed
        self.belong_to_optimizer = belong_to_optimizer
        self.op = None  # producer op, set by Block.append_op

    def to_string(self, throw_on_error=True, with_details=False):
        return "var %s : shape%s dtype %s%s" % (
            self.name,
            self.shape,
            self.dtype,
            " persistable" if self.persistable else "",
        )

    __str__ = to_string

    def __repr__(self):
        return self.to_string()

    @property
    def grad_name(self):
        return grad_var_name(self.name)

    def numel(self):
        n = 1
        for s in self.shape or ():
            n *= s
        return n


class Parameter(Variable):
    """Trainable persistable variable (ref framework.py:4507)."""

    def __init__(self, block, shape, dtype, **kwargs):
        if shape is None or dtype is None:
            raise ValueError("Parameter needs shape and dtype")
        for s in shape:
            if s <= 0:
                raise ValueError(
                    "Parameter shape must be positive, got %s" % (shape,)
                )
        kwargs.setdefault("persistable", True)
        self.trainable = kwargs.pop("trainable", True)
        self.optimize_attr = kwargs.pop("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.pop("regularizer", None)
        self.gradient_clip_attr = kwargs.pop("gradient_clip_attr", None)
        self.do_model_average = kwargs.pop("do_model_average", None)
        self.is_distributed = kwargs.pop("is_distributed", False)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)


# ---------------------------------------------------------------------------
# Operator
# ---------------------------------------------------------------------------
class Operator:
    """Symbolic op record: (type, inputs, outputs, attrs).

    Mirrors ref framework.py:1684. Inputs/outputs map slot name -> list of
    var *names*. Semantics live in paddle_tpu_torch.ops lowerings.
    """

    def __init__(self, block, type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = type
        self.attrs = dict(attrs or {})
        self.inputs = self._canonicalize(inputs)
        self.outputs = self._canonicalize(outputs)
        # op provenance for failure diagnosis: trim trailing
        # framework-internal frames by file
        stack = traceback.extract_stack(limit=10)
        while stack and stack[-1].filename.endswith(
                ("framework.py", "layer_helper.py")):
            stack.pop()
        self.callstack = stack
        self._is_backward = type.endswith("_grad") or type == "backward"

    @staticmethod
    def _canonicalize(io):
        out = {}
        for slot, vs in (io or {}).items():
            if vs is None:
                out[slot] = []
                continue
            if not isinstance(vs, (list, tuple)):
                vs = [vs]
            out[slot] = [v.name if isinstance(v, Variable) else v for v in vs]
        return out

    def input(self, slot):
        return self.inputs.get(slot, [])

    def output(self, slot):
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    @property
    def output_arg_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name):
        return self.attrs[name]

    def has_attr(self, name):
        return name in self.attrs

    def _set_attr(self, name, val):
        self.attrs[name] = val

    def all_attrs(self):
        return dict(self.attrs)

    def to_string(self, throw_on_error=True):
        return "{%s} = %s(%s) attrs:%s" % (
            ", ".join(self.output_arg_names),
            self.type,
            ", ".join(self.input_arg_names),
            {k: v for k, v in self.attrs.items() if not k.startswith("_")},
        )

    __str__ = to_string

    def __repr__(self):
        return self.to_string()


# ---------------------------------------------------------------------------
# Block
# ---------------------------------------------------------------------------
class Block:
    """Sequence of ops + symbol table of vars (ref framework.py:2136)."""

    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = collections.OrderedDict()  # name -> Variable
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, **kwargs):
        name = kwargs.get("name")
        if name is not None and name in self.vars:
            return self.vars[name]
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, **kwargs):
        param = Parameter(self, **kwargs)
        self.vars[param.name] = param
        self.program._bump_version()
        return param

    def var(self, name):
        v = self.vars.get(name)
        if v is None:
            raise ValueError(
                "var %s not in block %d of program" % (name, self.idx)
            )
        return v

    def has_var(self, name):
        return name in self.vars

    def _var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        raise ValueError("var %s not found in block %d or its parents"
                         % (name, self.idx))

    def has_var_recursive(self, name):
        try:
            self._var_recursive(name)
            return True
        except ValueError:
            return False

    def all_parameters(self):
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type=None, inputs=None, outputs=None, attrs=None):
        op = Operator(self, type, inputs, outputs, attrs)
        self.ops.append(op)
        for slot, names in op.outputs.items():
            for n in names:
                if n in self.vars:
                    self.vars[n].op = op
        self.program._bump_version()
        return op

    def to_string(self, throw_on_error=True, with_details=False):
        lines = ["  block %d (parent %d):" % (self.idx, self.parent_idx)]
        for v in self.vars.values():
            lines.append("    " + v.to_string())
        for op in self.ops:
            lines.append("    " + op.to_string())
        return "\n".join(lines)

    __str__ = to_string


# ---------------------------------------------------------------------------
# Program
# ---------------------------------------------------------------------------
class Program:
    """A whole model description: list of Blocks (ref framework.py:3554)."""

    _uid_counter = itertools.count()

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._uid = next(Program._uid_counter)
        self._version = 0
        self._is_start_up_program = False
        # marks set by append_backward
        self._loss_name = None
        self._appending_grad_times = 0

    def _bump_version(self):
        self._version += 1

    def global_block(self):
        return self.blocks[0]

    def block(self, idx):
        return self.blocks[idx]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def _create_block(self, parent_idx=None):
        """Append a sub-block (the body of a while, cond or StaticRNN op)
        under the current block, or `parent_idx`, and make it current."""
        new_idx = len(self.blocks)
        parent = (
            self.current_block_idx if parent_idx is None else parent_idx
        )
        self.blocks.append(Block(self, new_idx, parent))
        self.current_block_idx = new_idx
        self._bump_version()
        return self.current_block()

    def _rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    @contextlib.contextmanager
    def _block_guard(self, parent_idx=None):
        blk = self._create_block(parent_idx)
        try:
            yield blk
        finally:
            self._rollback()

    def list_vars(self):
        for blk in self.blocks:
            for v in blk.vars.values():
                yield v

    def all_parameters(self):
        params = []
        for blk in self.blocks:
            params.extend(blk.all_parameters())
        return params

    def to_string(self, throw_on_error=True, with_details=False):
        return "program:\n" + "\n".join(b.to_string() for b in self.blocks)

    __str__ = to_string

    def __repr__(self):
        return self.to_string()

    # -- clone / prune -----------------------------------------------------
    def clone(self, for_test=False):
        """Deep-copy the program. ``for_test=True`` marks inference mode:
        ops like dropout/batch_norm lower in eval mode, and backward and
        optimizer ops are dropped."""
        p = Program()
        p.random_seed = self.random_seed
        p.blocks = []
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            for name, v in blk.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nb.vars[name] = nv
            for op in blk.ops:
                nop = Operator(
                    nb,
                    op.type,
                    {k: list(v) for k, v in op.inputs.items()},
                    {k: list(v) for k, v in op.outputs.items()},
                    dict(op.attrs),
                )
                if for_test and "is_test" in _TEST_MODE_ATTR_OPS.get(
                    op.type, ()
                ):
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
            p.blocks.append(nb)
        p.current_block_idx = 0
        p._loss_name = None if for_test else self._loss_name
        if for_test:
            # drop backward + optimizer ops, then iteratively drop any op
            # whose inputs can no longer be produced
            gb = p.global_block()
            kept = [
                op
                for op in gb.ops
                if not op._is_backward and op.type not in _OPTIMIZER_OP_TYPES
            ]
            available = {
                v.name
                for v in gb.vars.values()
                if v.persistable or v.is_data
            }
            final = []
            for op in kept:
                if all(n in available for n in op.input_arg_names):
                    final.append(op)
                    available.update(op.output_arg_names)
            gb.ops = final
        p._bump_version()
        return p

    def _prune(self, targets):
        """Backward-slice the global block to the ops needed for `targets`
        (ref framework.py Program._prune / prune_backward)."""
        p = self.clone(for_test=True)
        target_names = set()
        for t in targets:
            target_names.add(t.name if isinstance(t, Variable) else t)
        gb = p.global_block()

        # every attr that references a body block
        _BLOCK_ATTRS = ("sub_block", "true_block", "false_block")

        def _sub_blocks(op):
            return [
                p.block(op.attr(a)) for a in _BLOCK_ATTRS if op.has_attr(a)
            ]

        def _op_reads(op):
            """All names an op reads, including reads made by ops inside its
            sub-blocks."""
            reads = set(op.input_arg_names)
            for sub in _sub_blocks(op):
                sub_reads = set()
                produced = set()
                for sop in sub.ops:
                    sub_reads.update(_op_reads(sop) - produced)
                    produced.update(sop.output_arg_names)
                reads |= sub_reads - set(sub.vars)  # minus sub-block locals
            return reads

        needed = set(target_names)
        kept = []
        for op in reversed(gb.ops):
            if any(n in needed for n in op.output_arg_names):
                kept.append(op)
                needed.update(_op_reads(op))
        gb.ops = list(reversed(kept))
        # drop vars no op references (keep targets + data feeds)
        referenced = set(target_names)

        def _mark(ops):
            for op in ops:
                referenced.update(op.input_arg_names)
                referenced.update(op.output_arg_names)
                for sub in _sub_blocks(op):
                    _mark(sub.ops)

        _mark(gb.ops)
        for name in list(gb.vars):
            v = gb.vars[name]
            if name not in referenced and not getattr(v, "is_data", False):
                del gb.vars[name]
        p._bump_version()
        return p

    # -- serialization (same JSON as paddle_tpu's Program.to_json) ---------
    def to_json(self):
        def _attr(v):
            if isinstance(v, np.ndarray):
                return {"__ndarray__": v.tolist(), "dtype": str(v.dtype)}
            if isinstance(v, Variable):
                return {"__var__": v.name}
            return v

        return json.dumps(
            {
                "random_seed": self.random_seed,
                "blocks": [
                    {
                        "idx": b.idx,
                        "parent_idx": b.parent_idx,
                        "vars": [
                            {
                                "name": v.name,
                                "shape": v.shape,
                                "dtype": v.dtype,
                                "persistable": v.persistable,
                                "stop_gradient": v.stop_gradient,
                                "lod_level": v.lod_level,
                                "is_data": v.is_data,
                                "is_parameter": isinstance(v, Parameter),
                                "trainable": getattr(v, "trainable", False),
                                "type": v.type,
                            }
                            for v in b.vars.values()
                        ],
                        "ops": [
                            {
                                "type": op.type,
                                "inputs": op.inputs,
                                "outputs": op.outputs,
                                "attrs": {
                                    k: _attr(v)
                                    for k, v in op.attrs.items()
                                    if not k.startswith("_")
                                },
                            }
                            for op in b.ops
                        ],
                    }
                    for b in self.blocks
                ],
            }
        )

    @staticmethod
    def from_json(text):
        def _unattr(v):
            if isinstance(v, dict) and "__ndarray__" in v:
                return np.array(v["__ndarray__"], dtype=v["dtype"])
            return v

        data = json.loads(text)
        p = Program()
        p.random_seed = data["random_seed"]
        p.blocks = []
        for bd in data["blocks"]:
            b = Block(p, bd["idx"], bd["parent_idx"])
            for vd in bd["vars"]:
                kw = dict(
                    name=vd["name"],
                    shape=vd["shape"],
                    dtype=vd["dtype"],
                    persistable=vd["persistable"],
                    stop_gradient=vd["stop_gradient"],
                    lod_level=vd["lod_level"],
                    is_data=vd["is_data"],
                    type=vd["type"],
                )
                if vd.get("is_parameter"):
                    b.create_parameter(trainable=vd.get("trainable", True), **kw)
                else:
                    b.vars[vd["name"]] = Variable(b, **kw)
            for od in bd["ops"]:
                b.ops.append(
                    Operator(
                        b,
                        od["type"],
                        od["inputs"],
                        od["outputs"],
                        {k: _unattr(v) for k, v in od["attrs"].items()},
                    )
                )
            p.blocks.append(b)
        p.current_block_idx = 0
        p._bump_version()
        return p


# ops whose clone(for_test=True) should set is_test
_TEST_MODE_ATTR_OPS = {
    "dropout": ("is_test",),
    "batch_norm": ("is_test",),
    "instance_norm": ("is_test",),
    "data_norm": ("is_test",),
    "lrn": ("is_test",),
}

_OPTIMIZER_OP_TYPES = frozenset(
    [
        "sgd",
        "momentum",
        "lars_momentum",
        "adagrad",
        "decayed_adagrad",
        "adadelta",
        "adam",
        "adamax",
        "rmsprop",
        "ftrl",
        "lamb",
        "dpsgd",
        "increment_step",
        "global_norm_clip",
    ]
)


# ---------------------------------------------------------------------------
# default programs
# ---------------------------------------------------------------------------
_main_program_ = Program()
_startup_program_ = Program()
_startup_program_._is_start_up_program = True


def default_main_program():
    return _main_program_


def default_startup_program():
    return _startup_program_


def switch_main_program(program):
    global _main_program_
    prev = _main_program_
    _main_program_ = program
    return prev


def switch_startup_program(program):
    global _startup_program_
    prev = _startup_program_
    _startup_program_ = program
    return prev


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)
