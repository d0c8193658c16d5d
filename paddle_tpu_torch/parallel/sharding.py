"""Parallel execution of Programs over a rank group: data, tensor and
sequence parallel, and ZeRO-1 (port of paddle_tpu/parallel/sharding.py).

The JAX package jits ONE global step with sharded feeds and state over a
device Mesh, and XLA's partitioner inserts every collective. The port
runs one process per rank, each running the same script, and gives the
results the JAX package gives:

- **feeds**: every rank is given the same global feed and takes its
  rank's slice of the batch axis over ``dp`` (batch-sharded when the
  leading dim divides by the dp size, replicated otherwise), and of any
  dim a ``feed_specs`` entry splits over ``tp`` or ``sp``
  (``feed_sharding``);
- **state**: rank 0's persistables are broadcast on the first run, so
  every rank starts alike, and each rank keeps its block of a parameter
  that ``param_rules`` (or the program's ``_sharding_spec``) split over
  ``tp``/``sp``, and of an optimizer accumulator that ``opt_state_rules``
  split over ``dp`` (ZeRO-1); ``param_sharding`` follows the JAX
  package's precedence. A scope value of the whole shape is cut to the
  rank's block when a run starts (after the broadcast, or after a
  caller sets whole values);
- **layouts**: the run carries each value's layout over the tp and sp
  axes, and the ops' layout rules insert the collectives
  (parallel/tensor_parallel.py), so one autograd tape gives each rank
  the gradient of its block;
- **gradients**: averaged over the dp axis in the gradient hook
  (fluid/lowering.py ``_run_training``), between the backward op and
  the optimizer ops; a parameter whose moments are dp-split takes its
  block of the averaged gradient by one reduce-scatter instead, its
  update op runs on the blocks and an all-gather over dp makes the
  parameter whole again (ops/optimizer_ops.py). The AMP ``SkipGate``
  reads a finiteness flag reduced over every split axis, so every rank
  decides alike;
- **batch norm** takes the global batch's moments (ops/nn_ops.py);
- **random draws**: a draw over a value that is whole across tp and sp
  comes from the generator the rank's tp/sp group shares, keyed by its
  dp coordinate (at dp = 1 the plain run's); a draw over a split value
  draws the whole value and keeps the block; draws of a static shape
  are alike on every rank (ops/registry.py);
- **fetches** come back as the JAX package returns them, global: a
  split fetch is gathered and a partial one reduced, then batch-major
  fetches are gathered over dp in rank order, a float fetch is averaged
  over dp (a mean over equal shards is the global mean), a persistable
  is this rank's (they are alike), and anything else is this rank's
  (ROADMAP.md Queue 3 says which fetches this gives exactly). Saves of
  split state write the global values (:meth:`consolidated_scope`,
  fluid/io.py).

Each rank runs its shard eagerly, so the hand-written CUDA kernels stay
on the path on every rank: attention on the rank's own heads under tp
and on each block of the ring under sp (the JAX package turns its
Pallas kernels off under a mesh; ROADMAP.md Queue 3).

:class:`StackedDpProgram` is the per-rank counterpart of the JAX
package's stacked program: each rank keeps its own copy of the state
the ops write (the stack's row), takes its batch statistics and random
draws from its own slice, and a subclass owns the gradient
collectives (:class:`..comms.grad_sync.GradSyncProgram`).
"""
import re

import numpy as np
import torch

from .. import observability as obs
from ..fluid.executor import (Scope, expand_lod_feeds, global_scope,
                              program_seed, to_numpy)
from ..fluid.framework import Variable
from ..fluid.lowering import build_step_fn
from . import tensor_parallel as tpl
from .mesh import P, RankGroup

__all__ = ["ShardingRule", "DistributedProgram", "StackedDpProgram",
           "replicated", "batch_sharded"]

# the seed of dp coordinate c's generator is the run's seed plus c times this
_RANK_SEED_STRIDE = 7919


class ShardingRule:
    """Map parameter names (regex) to a partition spec over mesh axes."""

    def __init__(self, pattern, spec):
        self.pattern = re.compile(pattern)
        self.spec = spec if isinstance(spec, P) else P(*spec)

    def match(self, name):
        return self.pattern.search(name) is not None


def replicated(mesh):
    return P()


def batch_sharded(mesh, axis="dp"):
    return P(axis)


def _merge_axis_into(base_spec, extra_spec, shape, mesh):
    """Place extra_spec's (single) mesh axis onto the first free,
    evenly-divisible dim of base_spec. Returns the merged PartitionSpec or
    None when it can't be merged (base is None, axis taken, nothing
    divides)."""
    if base_spec is None:
        return None
    extra_axes = [a for a in extra_spec if a is not None]
    if len(extra_axes) != 1:
        return None
    axis = extra_axes[0]
    entries = list(base_spec) + [None] * (len(shape) - len(base_spec))
    if any(a == axis or (isinstance(a, tuple) and axis in a)
           for a in entries if a is not None):
        return None
    size = mesh.shape[axis]
    for dim in range(len(shape)):
        if entries[dim] is None and shape[dim] % size == 0:
            entries[dim] = axis
            merged = P(*entries)
            if _spec_fits(merged, shape, mesh):
                return merged
            entries[dim] = None
    return None


def _spec_fits(spec, shape, mesh):
    """A PartitionSpec only applies if every sharded dim divides evenly."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        if dim >= len(shape):
            return False
        size = mesh.shape[axis] if not isinstance(axis, tuple) else int(
            np.prod([mesh.shape[a] for a in axis])
        )
        if shape[dim] % size != 0:
            return False
    return True


def _as_bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _line(mesh, axis):
    """This rank's line of `mesh` along `axis`; a group of one rank when
    the mesh has no such axis."""
    if axis in mesh.shape:
        return mesh.axis_group(axis)
    me = None if mesh.rank is None else mesh.ranks[mesh.rank]
    return RankGroup([me], 0, None, mesh.backend, mesh.device)


def _move_dim(t, dim, fn):
    """fn applied to `t` with `dim` moved to the front, moved back."""
    if dim == 0:
        return fn(t.contiguous())
    return fn(t.movedim(dim, 0).contiguous()).movedim(0, dim).contiguous()


class DistributedProgram:
    """Wraps a Program with a rank group; runnable through the ordinary
    Executor (same hook as CompiledProgram). Every rank of the group
    runs it with the same feed."""

    # the state the ops write is alike on every dp rank (replicated)
    _replicated_state = True

    def __init__(self, program, mesh, param_rules=None, feed_axis="dp",
                 feed_specs=None, opt_state_rules=None):
        self._program = program
        self._mesh = mesh
        self._param_rules = list(param_rules or [])
        # ZeRO-style rules applied ONLY to optimizer state (moments etc.):
        # params/grads stay wherever param_rules put them while the
        # optimizer state + its update shard over 'dp'
        self._opt_state_rules = list(opt_state_rules or [])
        block = program.global_block()
        self._opt_state_names = {
            v.name for v in block.vars.values()
            if getattr(v, "belong_to_optimizer", False)}
        # longest-first so "emb_2"'s accumulators never match "emb"
        self._param_names = sorted(
            (p.name for p in block.all_parameters()), key=len, reverse=True)
        # honor sharding annotations left by DistributeTranspiler.transpile
        for name, spec in (getattr(program, "_sharding_spec", None) or []):
            # exact-name anchor: a bare suffix pattern would also capture
            # params like "src_emb" when the annotation targets "emb"
            self._param_rules.append(
                ShardingRule("^" + re.escape(name) + "$", spec))
        self._feed_axis = feed_axis
        self._feed_specs = dict(feed_specs or {})
        self._dp = None
        self._groups = None
        self._synced = None         # state names broadcast from rank 0
        self._base_seed = None
        self._grad_names = (None, ())
        self._plan = (None, None)
        program._distributed = self

    # -- sharding resolution --------------------------------------------
    def _param_rule_spec(self, name, shape):
        for rule in self._param_rules:
            if rule.match(name) and _spec_fits(rule.spec, shape, self._mesh):
                return rule.spec
        return None

    def param_sharding(self, name, shape):
        """The partition spec of state var `name` of global `shape`: the
        JAX package's precedence (its ``param_sharding``)."""
        if name in self._opt_state_names and self._opt_state_rules:
            base = self._param_rule_spec(name, shape)
            for rule in self._opt_state_rules:
                if not rule.match(name):
                    continue
                # moments of tp-sharded params keep the tp layout AND gain
                # the ZeRO axis on a free dim; fall back to the plain ZeRO
                # spec, then to the param layout
                merged = _merge_axis_into(base, rule.spec, shape, self._mesh)
                if merged is not None:
                    return merged
                if _spec_fits(rule.spec, shape, self._mesh):
                    return rule.spec
            if base is not None:
                return base
        spec = self._param_rule_spec(name, shape)
        if spec is None and name in self._opt_state_names:
            # accumulators inherit their param's layout (they share its
            # shape). Accumulator names are "<param>_<acc>_<n>".
            for pname in self._param_names:
                if name.startswith(pname + "_"):
                    spec = self._param_rule_spec(pname, shape)
                    break
        return spec if spec is not None else P()

    def feed_sharding(self, name, shape):
        """The partition spec of feed `name` of global `shape`: its
        ``feed_specs`` entry when that fits, else P('dp') (this rank's
        slice of the batch axis) when the leading dim divides, else P()
        (the whole feed on every rank)."""
        spec = self._feed_specs.get(name)
        if spec is not None and _spec_fits(spec, shape, self._mesh):
            return spec if isinstance(spec, P) else P(*spec)
        if (self._feed_axis and self._feed_axis in self._mesh.shape
                and shape and shape[0] % self._mesh.shape[
                    self._feed_axis] == 0):
            return P(self._feed_axis)
        return P()

    def _layout(self, spec, what):
        """The :class:`~.tensor_parallel.Layout` of `spec` over the axes
        of more than one rank."""
        if any(isinstance(a, tuple) for a in spec):
            raise NotImplementedError(
                "%s: a dim split over several mesh axes at once (%s) is "
                "not run by the port's layouts" % (what, spec))
        return tpl.Layout({a: d for d, a in enumerate(spec)
                           if a is not None and self._mesh.shape[a] > 1})

    def _state_plan(self):
        """(name -> global shape, name -> Layout) of the program's split
        persistables, made once per program version."""
        program = self._program
        if self._plan[0] == program._version:
            return self._plan[1]
        shapes, lays = {}, {}
        for v in program.global_block().vars.values():
            if not v.persistable or v.shape is None:
                continue
            shape = tuple(int(d) for d in v.shape)
            if any(d < 0 for d in shape):
                continue
            lay = self._layout(self.param_sharding(v.name, shape), v.name)
            if lay.whole:
                continue
            if "dp" in lay.split and v.name not in self._opt_state_names:
                raise NotImplementedError(
                    "%s: a parameter split over the dp axis (every dp rank "
                    "computes on its own batch with the whole parameter); "
                    "the port splits optimizer state over dp "
                    "(opt_state_rules, ZeRO-1) and parameters over tp/sp"
                    % v.name)
            shapes[v.name], lays[v.name] = shape, lay
        self._plan = (program._version, (shapes, lays))
        return shapes, lays

    def _zero_plan(self):
        """{grad name: (the dim its moments split over dp, the gradient's
        layout after the reduce-scatter)} of the parameters whose
        accumulators ZeRO-1 splits, made once per program version.
        Accumulator names are "<param>_<acc>_<n>": each belongs to the
        longest parameter name it starts with."""
        program = self._program
        if getattr(self, "_zero", (None,))[0] == program._version:
            return self._zero[1]
        _, lays = self._state_plan()
        owner = {}
        for n in self._opt_state_names:
            for p in self._param_names:      # longest first
                if n.startswith(p + "_"):
                    owner.setdefault(p, []).append(n)
                    break
        zero = {}
        for g, p in self._param_grads().items():
            for acc in sorted(owner.get(p, ())):
                d = lays.get(acc, tpl.WHOLE).split.get("dp")
                if d is not None:
                    zero[g] = (d, lays.get(p, tpl.WHOLE).with_split("dp", d))
                    break
        self._zero = (program._version, zero)
        return zero

    # -- hooks a subclass changes ------------------------------------------
    def _param_grads(self):
        """{grad name: parameter name} of the global block's backward
        ops whose target is a persistable (a parameter): the gradients
        the hook averages."""
        program = self._program
        if self._grad_names[0] != program._version:
            block = program.global_block()
            names = {}
            for op in block.ops:
                if op.type != "backward":
                    continue
                for t, g in zip(op.attrs.get("targets", ()),
                                op.output("Grads")):
                    var = block.vars.get(t)
                    if var is not None and var.persistable:
                        names[g] = t
            self._grad_names = (program._version, names)
        return self._grad_names[1]

    def _grad_comm(self):
        """The gradient hook of this program's step: each parameter's
        gradient summed over the dp axis and divided by its size, one
        all-reduce per gradient (the JAX package's partitioner inserts
        one per gradient too); a parameter whose moments are split over
        dp (ZeRO-1) takes its block of that average by one
        reduce-scatter."""
        group = self._dp_line
        names = self._param_grads()
        if not names or group.size == 1:
            return None
        zero = self._zero_plan()

        def hook(grads):
            n = group.size
            out = {}
            for k, g in grads.items():
                if k not in names:
                    continue
                if k in zero:
                    out[k] = _move_dim(g, zero[k][0],
                                       group.reduce_scatter) / n
                else:
                    out[k] = group.all_reduce(g) / n
            return out

        hook.grad_layouts = {k: lay for k, (_, lay) in zero.items()}
        return hook

    def _batch_stats_group(self):
        return self._dp_line if self._dp_line.size > 1 else None

    def _seed_extra_state(self, state, scope, device):
        """Add mode-private scope state (residuals, ...) to `state`."""

    def _on_dispatch(self):
        """Called right before each step runs."""

    def _generators(self, executor, program):
        """(this rank's generator, the generator every rank shares): two
        objects, so that the draws from the first do not move the
        second. The rank's is keyed by its dp coordinate, so the ranks
        of one tp/sp group draw alike; dp coordinate 0 draws the plain
        run's."""
        seed = executor._next_seed(program, base=self._base_seed)
        rank = self._dp_line.rank
        return (executor._seeded(seed + _RANK_SEED_STRIDE * rank),
                executor._seeded(seed))

    # -- state and feeds ----------------------------------------------------
    def _sync(self, program, state, scope, device):
        """On the first run (and whenever the set of state names
        changes): every rank takes rank 0's state and, with
        ``random_seed`` 0, rank 0's per-program seed. Then every split
        persistable that holds its whole value is cut to this rank's
        block."""
        group = self._mesh
        names = tuple(sorted(state))
        if self._synced != names:
            base = program_seed(program)
            if group.group is not None:
                for name in names:
                    v = state[name]
                    got = group.broadcast(_as_bytes(v)).view(
                        v.dtype).reshape(v.shape)
                    state[name] = got
                    scope.update(name, got)
                if not program.random_seed:
                    base = int(group.broadcast(torch.tensor(
                        [base], dtype=torch.int64, device=device))[0])
            self._base_seed = base
            self._synced = names
        shapes, lays = self._state_plan()
        for name in sorted(lays):
            v = state.get(name)
            if v is not None and tuple(v.shape) == shapes[name]:
                got = tpl.conform(self, v, tpl.WHOLE, lays[name])
                state[name] = got
                scope.update(name, got)

    @property
    def groups(self):
        """{axis: this rank's line along it} for every mesh axis of more
        than one rank: the lines the layouts use."""
        if self._groups is None:
            self._groups = {a: self._mesh.axis_group(a)
                            for a, n in self._mesh.shape.items() if n > 1}
        return self._groups

    @property
    def _dp_line(self):
        if self._dp is None:
            self._dp = _line(self._mesh, "dp")
        return self._dp

    def _local_feeds(self, executor, program, feed):
        """(this rank's feed tensors on the executor's device, whether
        any feed was split over the dp batch axis, name -> Layout of the
        feeds split over tp/sp)."""
        dp = self._dp_line
        feed = expand_lod_feeds(program.global_block(), feed or {})
        split, lays = False, {}
        for name, value in feed.items():
            shape = tuple(np.shape(value))  # an array, a tensor or a list
            spec = tuple(self.feed_sharding(name, shape))
            if "dp" in spec[1:]:
                raise NotImplementedError(
                    "feeds shard over 'dp' on the LEADING (batch) dim "
                    "only; feed %r asked for %s" % (name, P(*spec)))
            if spec[:1] == ("dp",):
                per = shape[0] // dp.size
                feed[name] = value[dp.rank * per:(dp.rank + 1) * per]
                split = split or dp.size > 1
            lay = self._layout(P(*[None if a == "dp" else a for a in spec]),
                               name)
            if not lay.whole:
                lays[name] = lay
        feeds = executor._prepare_feeds(program, feed)
        for name, lay in lays.items():
            feeds[name] = tpl.conform(self, feeds[name], tpl.WHOLE, lay)
        return feeds, split, lays

    def _fetch(self, block, name, value, split, lay):
        """The global value of one fetch (module docstring)."""
        value = tpl.whole(self, value, lay)
        group = self._dp_line
        if group.group is None:
            return value
        var = block.vars.get(name)
        decl = getattr(var, "shape", None)
        if split and value.dim() >= 1 and decl and (
                decl[0] in (None, -1)
                or decl[0] == group.size * value.shape[0]):
            return group.all_gather(value)
        if self._replicated_state and var is not None and var.persistable:
            return value
        if torch.is_floating_point(value):
            return group.all_reduce(value) / group.size
        return group.broadcast(value)

    def consolidated_scope(self, scope):
        """A COPY of ``scope`` with every split persistable made whole
        (its global value), for serialization; the live scope is
        untouched. A collective: every rank calls it."""
        shapes, lays = self._state_plan()
        snap = Scope()
        for name in sorted(scope.keys()):
            v = scope[name]
            if isinstance(v, torch.Tensor):
                if name in lays and tuple(v.shape) != shapes[name]:
                    v = tpl.whole(self, v, lays[name])
                else:
                    v = v.clone()
            snap.set(name, v)
        return snap

    # -- executor hook ---------------------------------------------------
    def _executor_run(self, executor, feed, fetch_list, scope,
                      return_numpy):
        group = self._mesh
        if group.rank is None:
            raise RuntimeError(
                "this process (a rank outside the group %s) cannot run "
                "its program" % (group,))
        device = executor.device
        if group.backend == "nccl" and group.group is not None \
                and device != group.device:
            raise RuntimeError(
                "the nccl group runs on %s but the executor's place is %s"
                % (group.device, device))
        program = self._program
        scope = scope if scope is not None else global_scope()
        fetch_names = [f.name if isinstance(f, Variable) else f
                       for f in (fetch_list or [])]
        block = program.global_block()
        with obs.span("executor.run"):
            with obs.span("executor.feed_convert"):
                feeds, split, feed_lays = self._local_feeds(
                    executor, program, feed)
                state = executor._gather_state(program, scope)
                self._sync(program, state, scope, device)
                self._seed_extra_state(state, scope, device)
            shapes, lays = self._state_plan()
            laid = bool(lays or feed_lays or set(self.groups) - {"dp"})
            start = None
            if laid:
                start = {n: lay for n, lay in lays.items() if n in state}
                start.update(feed_lays)
            step = build_step_fn(
                program, list(feeds), fetch_names, device,
                grad_comm=self._grad_comm(),
                mesh_axes={a: a for a in group.axis_names}, mesh=group,
                batch_stats_group=self._batch_stats_group(),
                layouts=start, groups=self.groups)
            gen, shared = self._generators(executor, program)
            self._on_dispatch()
            fetches, new_state = step(state, feeds, gen, shared)
            end = getattr(step, "layouts", None) or {}
            for k in sorted(new_state):
                v = new_state[k]
                if laid:
                    v = tpl.conform(self, v, end.get(k, tpl.WHOLE),
                                    lays.get(k, tpl.WHOLE))
                scope.update(k, v)
            out = [self._fetch(block, n, v, split, end.get(n, tpl.WHOLE))
                   for n, v in zip(fetch_names, fetches)]
        if return_numpy:
            return [to_numpy(v) for v in out]
        return out


class StackedDpProgram(DistributedProgram):
    """The per-rank counterpart of the JAX package's stacked dp program:
    each rank keeps its own copy of the parameters, the optimizer state
    and every persistable some op writes (BN moving statistics, AMP
    loss-scale counters, lr counters), where the JAX package stacks
    them on a leading dp dim. Batch statistics and random draws come
    from the rank's own slice, as inside the JAX package's shard_map.
    A subclass owns the gradient collectives (:meth:`_grad_comm`).

    Use :meth:`consolidated_scope` (a copy) or :meth:`consolidate_scope`
    (in place) before saving: floats are averaged over the ranks and
    integers taken from rank 0, as the JAX package collapses its stack.
    Both are collectives: every rank calls them."""

    _mode_name = "StackedDp"
    _replicated_state = False

    def __init__(self, program, mesh, **kw):
        wide = sorted(a for a, n in mesh.shape.items() if a != "dp" and n > 1)
        if wide or any(any(a is not None for a in r.spec)
                       for r in kw.get("param_rules") or []):
            raise NotImplementedError(
                "%s with tensor/sequence parallelism (mesh %s): it stacks "
                "whole per-dp-shard param copies, which would silently "
                "override the tp/sp sharding rules — run it pure-dp"
                % (self._mode_name, mesh.shape))
        if kw.get("opt_state_rules"):
            raise NotImplementedError(
                "%s with opt_state_rules: ZeRO shards optimizer state over "
                "dp, %s keeps stacked per-dp-shard state — pick one"
                % (self._mode_name, self._mode_name))
        super().__init__(program, mesh, **kw)
        if mesh.shape.get("dp", 1) <= 1:
            raise ValueError(
                "%s requires a dp mesh axis of size > 1 "
                "(got mesh %s); with one worker there is nothing to "
                "synchronize — use the plain collective mode"
                % (self._mode_name, mesh.shape,)
            )
        block = program.global_block()
        written = {n for op in block.ops for n in op.output_arg_names}
        self._local_names = {
            v.name for v in block.vars.values()
            if getattr(v, "persistable", False) and (
                v.name in written or getattr(v, "belong_to_optimizer",
                                             False))
        } | {p.name for p in block.all_parameters()}

    def feed_sharding(self, name, shape):
        spec = self._feed_specs.get(name)
        if spec is not None and any(tuple(spec)[1:]):
            raise NotImplementedError(
                "%s feeds shard over 'dp' on the LEADING (batch) dim "
                "only; feed %r asked for %s" % (self._mode_name, name, spec))
        return super().feed_sharding(name, shape)

    def _batch_stats_group(self):
        return None

    def _generators(self, executor, program):
        gen, _ = super()._generators(executor, program)
        return gen, None

    def _collapse(self, v):
        group = self._mesh
        if torch.is_floating_point(v):
            return group.all_reduce(v) / group.size
        return group.broadcast(v)

    def consolidated_scope(self, scope):
        """A COPY of ``scope`` with the per-rank state collapsed (floats
        averaged over the ranks, integers rank 0's), for serialization;
        the live scope is untouched."""
        snap = Scope()
        # sorted: every rank issues the collectives in the same order
        for name in sorted(scope.keys()):
            v = scope[name]
            if name in self._local_names and isinstance(v, torch.Tensor):
                snap.set(name, self._collapse(v))
            elif isinstance(v, torch.Tensor):
                snap.set(name, v.clone())
            else:
                snap.set(name, v)
        return snap

    def consolidate_scope(self, scope):
        """IN-PLACE collapse (end of training)."""
        for name in sorted(self._local_names):
            v = scope.find_value(name)
            if isinstance(v, torch.Tensor):
                scope.update(name, self._collapse(v))

    def shrink_dp(self, scope, surviving_shards, new_mesh=None):
        raise NotImplementedError(
            "%s.shrink_dp: shrinking the rank group to the survivors of "
            "a lost rank comes with the elastic FleetGuard, ROADMAP.md "
            "Queue 1 item 8.6" % self._mode_name)
