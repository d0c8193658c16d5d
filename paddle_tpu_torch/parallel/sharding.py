"""Data-parallel execution of Programs over a rank group (port of the
pure-dp part of paddle_tpu/parallel/sharding.py).

The JAX package jits ONE global step with batch-sharded feeds and
replicated state over a device Mesh, and XLA's partitioner inserts the
gradient all-reduces. The port runs one process per rank, each running
the same script, and gives the results the JAX package gives:

- **feeds**: every rank is given the same global feed and takes its
  rank's slice of the batch axis — batch-sharded when the leading dim
  divides by the dp size, replicated otherwise (``feed_sharding``);
- **state**: rank 0's persistables are broadcast on the first run, so
  every rank starts alike; each step then applies the same update on
  every rank, so parameters and optimizer accumulators stay bit for bit
  equal;
- **gradients**: averaged over the ranks in the gradient hook
  (fluid/lowering.py ``_run_training``), between the backward op and
  the optimizer ops; the AMP ``SkipGate`` reads the averaged gradients,
  so every rank decides alike;
- **batch norm** takes the global batch's moments (ops/nn_ops.py);
- **random draws** over a rank's slice of the batch (dropout) differ
  between ranks, those of a static shape are alike (ops/registry.py);
- **fetches** come back as the JAX package returns them, the global
  batch's value: batch-major fetches are gathered in rank order, a
  float fetch is averaged over the ranks (a mean over equal shards is
  the global mean), a persistable is this rank's (they are alike), and
  anything else is this rank's (ROADMAP.md Queue 3 says which fetches
  this gives exactly).

Each rank runs its shard eagerly, so the hand-written CUDA kernels stay
on the path on every rank (the JAX package turns its Pallas kernels off
under a mesh; ROADMAP.md Queue 3).

:class:`StackedDpProgram` is the per-rank counterpart of the JAX
package's stacked program: each rank keeps its own copy of the state
the ops write (the stack's row), takes its batch statistics and random
draws from its own slice, and a subclass owns the gradient
collectives (:class:`..comms.grad_sync.GradSyncProgram`).

Tensor-parallel rules and ZeRO optimizer-state rules raise: they come
with ROADMAP.md Queue 1 item 8.3.
"""
import re

import numpy as np
import torch

from .. import observability as obs
from ..fluid.executor import (Scope, expand_lod_feeds, global_scope,
                              program_seed, to_numpy)
from ..fluid.framework import Variable
from ..fluid.lowering import build_step_fn
from .mesh import P

__all__ = ["ShardingRule", "DistributedProgram", "StackedDpProgram",
           "replicated", "batch_sharded"]

# the seed of rank r's own generator is the run's seed plus r times this
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


def _later_83(what):
    return NotImplementedError(
        "%s: the port's data-parallel program keeps every parameter and "
        "optimizer state whole on each rank; tensor-parallel rules and "
        "ZeRO optimizer-state sharding come with ROADMAP.md Queue 1 item "
        "8.3" % what)


def _as_bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


class DistributedProgram:
    """Wraps a Program with a rank group; runnable through the ordinary
    Executor (same hook as CompiledProgram). Every rank of the group
    runs it with the same feed."""

    # the state the ops write is alike on every rank (replicated)
    _replicated_state = True

    def __init__(self, program, mesh, param_rules=None, feed_axis="dp",
                 feed_specs=None, opt_state_rules=None):
        if any(any(a is not None for a in r.spec)
               for r in param_rules or []):
            raise _later_83("param_rules with a tensor-parallel spec")
        if opt_state_rules:
            raise _later_83("opt_state_rules (ZeRO-1)")
        if getattr(program, "_sharding_spec", None):
            raise _later_83("the program's sharding annotations")
        self._program = program
        self._mesh = mesh
        self._feed_axis = feed_axis
        self._feed_specs = dict(feed_specs or {})
        self._synced = None         # state names broadcast from rank 0
        self._base_seed = None
        self._grad_names = (None, ())

    # -- sharding resolution --------------------------------------------
    def feed_sharding(self, name, shape):
        """P('dp') (this rank's slice of the batch axis) or P()
        (the whole feed on every rank)."""
        n = self._mesh.size
        spec = self._feed_specs.get(name)
        if spec is not None:
            entries = tuple(spec)
            if entries and entries[0] == "dp" and not any(entries[1:]):
                if shape and shape[0] % n == 0:
                    return P("dp")
            elif not any(entries):
                return P()
            else:
                raise NotImplementedError(
                    "feeds shard over 'dp' on the LEADING (batch) dim "
                    "only; feed %r asked for %s" % (name, spec))
        if (self._feed_axis == "dp" and shape
                and shape[0] % n == 0):
            return P("dp")
        return P()

    # -- hooks a subclass changes ------------------------------------------
    def _param_grads(self):
        """The Grads names of the global block's backward ops whose
        target is a persistable (a parameter): the gradients the hook
        averages."""
        program = self._program
        if self._grad_names[0] != program._version:
            block = program.global_block()
            names = []
            for op in block.ops:
                if op.type != "backward":
                    continue
                for t, g in zip(op.attrs.get("targets", ()),
                                op.output("Grads")):
                    var = block.vars.get(t)
                    if var is not None and var.persistable:
                        names.append(g)
            self._grad_names = (program._version, tuple(names))
        return self._grad_names[1]

    def _grad_comm(self):
        """The gradient hook of this program's step: each parameter's
        gradient summed over the group and divided by its size, one
        all-reduce per gradient (the JAX package's partitioner inserts
        one per gradient too)."""
        group = self._mesh
        names = set(self._param_grads())
        if not names:
            return None

        def hook(grads):
            n = group.size
            return {k: group.all_reduce(g) / n for k, g in grads.items()
                    if k in names}

        return hook

    def _batch_stats_group(self):
        return self._mesh if self._mesh.size > 1 else None

    def _seed_extra_state(self, state, scope, device):
        """Add mode-private scope state (residuals, ...) to `state`."""

    def _on_dispatch(self):
        """Called right before each step runs."""

    def _generators(self, executor, program):
        """(this rank's generator, the generator every rank shares): two
        objects, so that the draws from the first do not move the
        second. Rank 0's draws are the plain run's."""
        seed = executor._next_seed(program, base=self._base_seed)
        return (executor._seeded(seed + _RANK_SEED_STRIDE * self._mesh.rank),
                executor._seeded(seed))

    # -- state and feeds ----------------------------------------------------
    def _sync(self, program, state, scope, device):
        """On the first run (and whenever the set of state names
        changes): every rank takes rank 0's state and, with
        ``random_seed`` 0, rank 0's per-program seed."""
        group = self._mesh
        names = tuple(sorted(state))
        if self._synced == names:
            return
        base = program_seed(program)
        if group.group is not None:
            for name in names:
                v = state[name]
                got = group.broadcast(_as_bytes(v)).view(v.dtype).reshape(
                    v.shape)
                state[name] = got
                scope.update(name, got)
            if not program.random_seed:
                base = int(group.broadcast(torch.tensor(
                    [base], dtype=torch.int64, device=device))[0])
        self._base_seed = base
        self._synced = names

    def _local_feeds(self, executor, program, feed):
        """(this rank's feed tensors on the executor's device, whether
        any feed was split over the batch axis)."""
        group = self._mesh
        feed = expand_lod_feeds(program.global_block(), feed or {})
        split = False
        for name, value in feed.items():
            shape = np.shape(value)       # an array, a tensor or a list
            if self.feed_sharding(name, shape) == P("dp"):
                per = shape[0] // group.size
                feed[name] = value[group.rank * per:(group.rank + 1) * per]
                split = split or group.size > 1
        return executor._prepare_feeds(program, feed), split

    def _fetch(self, block, name, value, split):
        """The global value of one fetch (module docstring)."""
        group = self._mesh
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
                feeds, split = self._local_feeds(executor, program, feed)
                state = executor._gather_state(program, scope)
                self._sync(program, state, scope, device)
                self._seed_extra_state(state, scope, device)
            step = build_step_fn(
                program, list(feeds), fetch_names, device,
                grad_comm=self._grad_comm(),
                mesh_axes={a: a for a in group.axis_names}, mesh=group,
                batch_stats_group=self._batch_stats_group())
            gen, shared = self._generators(executor, program)
            self._on_dispatch()
            fetches, new_state = step(state, feeds, gen, shared)
            for k, v in new_state.items():
                scope.update(k, v)
            out = [self._fetch(block, n, v, split)
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
