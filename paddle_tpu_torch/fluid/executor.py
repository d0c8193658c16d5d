"""Executor + Scope.

Port of paddle_tpu/fluid/executor.py (ref python/paddle/fluid/
executor.py and paddle/fluid/framework/scope.cc). The Scope holds torch
tensors (or host arrays not yet moved, which the first run moves to its
device and writes back); ``Executor.run`` runs the program's ops eagerly
on the place's device. No jit, compile cache or executable ledger: torch
runs eagerly. A run of a ``minimize``d program trains: autograd is on only
for the region its ``backward`` op differentiates, and the values written
back to the scope are detached, so no graph outlives the run
(fluid/lowering.py).
"""
import numpy as np
import torch

from . import core
from .framework import Variable, default_main_program
from .lowering import build_step_fn

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "to_numpy"]


class Scope:
    """name -> tensor mapping (device-resident between runs)."""

    def __init__(self, parent=None):
        self._vars = {}
        self._parent = parent

    def set(self, name, value):
        self._vars[name] = value

    def __getitem__(self, name):
        return self._vars[name]

    def __contains__(self, name):
        return name in self._vars

    def get(self, name, default=None):
        return self._vars.get(name, default)

    def keys(self):
        return self._vars.keys()

    def items(self):
        return self._vars.items()

    def find_value(self, name, default=None):
        """Parent-chain value lookup (FindVar semantics, raw value)."""
        scope = self
        while scope is not None:
            if name in scope._vars:
                return scope._vars[name]
            scope = scope._parent
        return default

    def update(self, name, value):
        """Write to the scope in the chain that owns `name`; a new name is
        set here."""
        scope = self
        while scope is not None:
            if name in scope._vars:
                scope._vars[name] = value
                return
            scope = scope._parent
        self._vars[name] = value

    def new_scope(self):
        return Scope(parent=self)


_scope_stack = [Scope()]


def global_scope():
    return _scope_stack[-1]


class scope_guard:
    def __init__(self, scope):
        self._scope = scope

    def __enter__(self):
        _scope_stack.append(self._scope)
        return self._scope

    def __exit__(self, *exc):
        _scope_stack.pop()


def _as_name(v):
    if isinstance(v, Variable):
        return v.name
    if isinstance(v, str):
        return v
    raise TypeError("fetch/feed entry must be Variable or str, got %r" % (v,))


def to_tensor(value, device, dtype=None):
    """A tensor of `value` (tensor, numpy array or nested list) on
    `device`, cast to `dtype` when given."""
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))
    return t.to(device=device, dtype=dtype)


def to_numpy(t):
    """Host numpy copy of a tensor; bfloat16, which numpy lacks, is widened
    to float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def feed_dtypes(program, feed_names):
    """name -> torch dtype the program declares for each feed (None when
    the program does not say)."""
    block = program.global_block()
    out = {}
    for n in feed_names:
        var = block.vars.get(n)
        out[n] = core.torch_dtype(var.dtype) if (
            var is not None and var.dtype is not None) else None
    return out


class Executor:
    """Runs Programs on the device of `place` (default: the card)."""

    def __init__(self, place=None):
        self.place = place if place is not None else core.default_place()
        self.device = self.place.torch_device()
        self._run_counter = 0

    def run(self, program=None, feed=None, fetch_list=None, scope=None,
            return_numpy=True):
        program = program if program is not None else default_main_program()
        scope = scope if scope is not None else global_scope()
        feed = feed or {}
        fetch_names = [_as_name(f) for f in (fetch_list or [])]
        feeds = self._prepare_feeds(program, feed)
        state = self._gather_state(program, scope)
        step = build_step_fn(program, list(feeds), fetch_names, self.device)
        fetches, new_state = step(state, feeds, self._next_generator(program))
        for k, v in new_state.items():
            scope.update(k, v)
        if return_numpy:
            return [to_numpy(v) for v in fetches]
        return list(fetches)

    def _prepare_feeds(self, program, feed):
        """Feed values as tensors on the device, coerced to the dtype the
        program declares for each feed. A feed of a ``lod_level`` > 0 var
        given as a plain (B, T, ...) array gets full lengths, (B,) int32
        of T, for its ``@SEQ_LEN`` companion unless that is fed too."""
        block = program.global_block()
        feed = dict(feed)
        for name in list(feed):
            seq_name = name + "@SEQ_LEN"
            if block.has_var(seq_name) and seq_name not in feed:
                shape = np.shape(feed[name])
                feed[seq_name] = np.full((shape[0],), shape[1], "int32")
        want = feed_dtypes(program, list(feed))
        return {name: to_tensor(v, self.device, want[name])
                for name, v in feed.items()}

    def _gather_state(self, program, scope):
        """The program's persistable values on the device; host values are
        moved once and written back to the scope that holds them."""
        state = {}
        for v in program.global_block().vars.values():
            if not v.persistable:
                continue
            val = scope.find_value(v.name)
            if val is None:
                continue
            if not (isinstance(val, torch.Tensor)
                    and val.device == self.device):
                val = to_tensor(val, self.device)
                scope.update(v.name, val)
            state[v.name] = val
        return state

    def _next_generator(self, program):
        """A fresh generator per run: seeded from ``program.random_seed``
        (0 means one seed per program) and the run count."""
        self._run_counter += 1
        seed = program.random_seed or (hash(("paddle_tpu_torch",
                                             program._uid)) % (2 ** 31))
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed + 1000003 * self._run_counter)
        return gen
