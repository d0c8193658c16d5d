"""LocalSGD collective mode: k-step local updates and periodic parameter
averaging over the dp axis (port of paddle_tpu/parallel/local_sgd.py).

Reference semantics: transpiler/collective.py class LocalSGD (ref
collective.py:270) wired by fleet collective mode "local_sgd" (ref
incubate/fleet/collective/__init__.py:225-253). Each worker advances its
OWN parameters from its OWN batch shard; every ``k_steps`` the workers'
parameters are averaged. At k=1 with SGD this is plain synchronous dp in
exact arithmetic (the average of per-shard updates is the update from
the averaged gradients); at k>1 workers diverge between averaging
points, trading communication for staleness.

The JAX package runs the step under ``shard_map`` over 'dp' with the
per-shard state stacked on a leading dim, and averages with a
``lax.cond``-gated ``lax.pmean``. The port runs one process per rank on
:class:`..sharding.StackedDpProgram`: each rank keeps its own
parameters, optimizer state and written persistables in its scope,
takes no gradient collective, and draws from its own generator (rank 0
draws the plain run's masks). After every k-th step it averages the
trainable parameters over dp, one all-reduce of all of them flattened
per dtype; a step that does not average issues no parameter collective
(:attr:`LocalSGDProgram.param_collectives` counts them).

``quantized_sync=True`` averages the DELTA since the last sync through
:func:`.comms.allreduce.pmean_int8`, per parameter; each parameter's
anchor (its last synced value) lives in the scope as
``<name>@LSGD_ANCHOR``, not a program var, so ``fluid.io`` never saves
it. The error is bounded by pmax|delta| / 254 per element.
"""
import torch

from .sharding import StackedDpProgram

__all__ = ["LocalSGDProgram"]


class LocalSGDProgram(StackedDpProgram):
    """Runnable through the ordinary Executor like DistributedProgram.
    Each rank keeps its own copy of the trainable parameters and the
    optimizer state; use :meth:`consolidated_scope` (a copy) or
    :meth:`consolidate_scope` before saving persistables."""

    _mode_name = "LocalSGD"

    def __init__(self, program, mesh, k_steps=1, quantized_sync=False,
                 **kw):
        super().__init__(program, mesh, **kw)
        self._k = max(1, int(k_steps))
        self._quantized_sync = bool(quantized_sync)
        self._avg_names = sorted(
            v.name for v in program.global_block().all_parameters()
            if getattr(v, "trainable", True))
        self._anchor_names = (
            {n: n + "@LSGD_ANCHOR" for n in self._avg_names}
            if self._quantized_sync else {})
        self._step_i = 0
        # the parameter collectives of the last step
        self.param_collectives = 0

    def _grad_comm(self):
        """No gradient collective: each rank steps on its own gradient."""
        return None

    def _seed_extra_state(self, state, scope, device):
        # the first run anchors each parameter at its (broadcast) start
        for pn, an in self._anchor_names.items():
            if scope.find_value(an) is None and pn in state:
                scope.set(an, state[pn].clone())

    def _executor_run(self, executor, feed, fetch_list, scope,
                      return_numpy):
        from ..fluid.executor import global_scope

        out = super()._executor_run(executor, feed, fetch_list, scope,
                                    return_numpy)
        self._step_i += 1
        self.param_collectives = 0
        if self._step_i % self._k == 0:
            self._average(scope if scope is not None else global_scope())
        return out

    def _average(self, scope):
        group = self._dp_line
        names = [n for n in self._avg_names
                 if isinstance(scope.find_value(n), torch.Tensor)]
        if self._quantized_sync:
            from .comms.allreduce import pmean_int8

            for n in names:
                v, a = scope.find_value(n), scope.find_value(
                    self._anchor_names[n])
                new = a + pmean_int8(v - a, group)
                scope.update(n, new)
                scope.update(self._anchor_names[n], new.clone())
                self.param_collectives += 1
            return
        by_dtype = {}
        for n in names:
            by_dtype.setdefault(scope.find_value(n).dtype, []).append(n)
        for ns in by_dtype.values():
            vals = [scope.find_value(n) for n in ns]
            flat = group.all_reduce(torch.cat([v.reshape(-1)
                                               for v in vals]))
            flat = flat / group.size
            self.param_collectives += 1
            at = 0
            for n, v in zip(ns, vals):
                scope.update(n, flat[at:at + v.numel()].view_as(v).clone())
                at += v.numel()
