"""Pruning strategies (ref: contrib/slim/prune/prune_strategy.py).

Port of paddle_tpu/fluid/contrib/slim/prune/prune_strategy.py.
UniformPruneStrategy masks the configured ratio of groups in every
matching parameter at start_epoch (lazy masked pruning: zeros, static
shapes — see pruner.py); the mask is re-asserted after each training
batch so optimizer updates cannot resurrect pruned groups.
SensitivePruneStrategy's per-layer sensitivity search keeps the same
re-assert machinery but searches ratios by eval-loss sensitivity.

The mask is derived as the reference derives it: a group counts as
pruned when its |.| sum is 0 after pruning (groups that were zero
already count too). Each prune event reads the mask back once; after
every batch the groups are zeroed again where the value lives: on the
card, in place, in the tensor the scope holds (no copy to the host and
back), a host value on the host.
"""
import fnmatch

import numpy as np
import torch

from ..core.strategy import Strategy
from .pruner import StructurePruner, as_host, prune_program, zero_groups

__all__ = ["PruneStrategy", "UniformPruneStrategy",
           "SensitivePruneStrategy"]


def _zero_sum_groups(value, axis):
    """The reference's mask of `value`: True where a group's |.| sum along
    every other axis is 0. A tensor is reduced on its device and only the
    (groups,) mask is read back."""
    reduce_dims = tuple(i for i in range(value.ndim) if i != axis)
    if isinstance(value, torch.Tensor):
        with torch.no_grad():
            s = value.abs().sum(dim=reduce_dims) if reduce_dims \
                else value.abs()
        return as_host(s == 0)
    arr = np.asarray(value)
    return np.sum(np.abs(arr), axis=reduce_dims) == 0


class PruneStrategy(Strategy):
    """Base: prune once at start_epoch, hold masks through end_epoch."""

    def __init__(self, pruner=None, start_epoch=0, end_epoch=0,
                 target_ratio=0.5, pruned_params="conv.*_weights",
                 metric_name=None):
        super().__init__(start_epoch, end_epoch)
        self.pruner = pruner or StructurePruner()
        self.target_ratio = float(target_ratio)
        self.pruned_params = pruned_params
        self.metric_name = metric_name
        self._masks = {}  # param name -> bool mask (True = pruned group)
        self._mask_idx = {}  # (param name, device) -> pruned group indices

    def _patterns(self):
        return [self.pruned_params] if isinstance(
            self.pruned_params, str) else list(self.pruned_params)

    def _record_mask(self, context, name):
        val = context.scope.get(name)
        axis = self.pruner.axis_for(name, val)
        self._masks[name] = (_zero_sum_groups(val, axis), axis)

    def _prune_now(self, context, ratio):
        program = context.optimize_graph.program
        report = prune_program(
            program, ratio, patterns=self._patterns(),
            pruner=self.pruner, scope=context.scope)
        # record masks for re-assertion
        for name in report:
            self._record_mask(context, name)
        return report

    def _group_index(self, name, mask, device):
        """The pruned groups of `name` as an int64 tensor on `device`,
        made once."""
        key = (name, device)
        idx = self._mask_idx.get(key)
        if idx is None:
            idx = self._mask_idx[key] = torch.as_tensor(
                np.flatnonzero(mask).astype(np.int64), device=device)
        return idx

    def _reassert_masks(self, context):
        for name, (mask, axis) in self._masks.items():
            val = context.scope.get(name)
            if isinstance(val, torch.Tensor):
                zero_groups(val, self._group_index(name, mask, val.device),
                            axis)
            else:
                arr = np.array(val)
                sl = [slice(None)] * arr.ndim
                sl[axis] = mask
                arr[tuple(sl)] = 0
                context.scope.set(name, arr)

    def on_epoch_begin(self, context):
        if context.epoch_id == self.start_epoch and not self._masks:
            report = self._prune_now(context, self.target_ratio)
            print("[prune] masked %s" % (report,))

    def on_batch_end(self, context):
        if self._masks:
            self._reassert_masks(context)

    def sparsity(self, context):
        z = t = 0
        for name in self._masks:
            arr = as_host(context.scope.get(name))
            z += int((arr == 0).sum())
            t += arr.size
        return z / max(t, 1)


class UniformPruneStrategy(PruneStrategy):
    """ref prune_strategy.py UniformPruneStrategy: one ratio everywhere."""


class SensitivePruneStrategy(PruneStrategy):
    """Per-parameter ratios chosen by loss sensitivity: each candidate is
    test-pruned alone, the eval metric drop measured, and ratios assigned
    inversely to sensitivity so the total target is met where it hurts
    least (ref prune_strategy.py SensitivePruneStrategy, simplified to a
    single calibration round). A probe's parameter is kept and put back
    as a clone on its own device."""

    def __init__(self, pruner=None, start_epoch=0, end_epoch=0,
                 target_ratio=0.5, pruned_params="conv.*_weights",
                 metric_name="loss", sensitivities_file=None,
                 num_steps=1, eval_rate=None):
        super().__init__(pruner, start_epoch, end_epoch, target_ratio,
                         pruned_params, metric_name)
        self.sensitivities_file = sensitivities_file
        self.num_steps = num_steps
        self.eval_rate = eval_rate

    def on_epoch_begin(self, context):
        if context.epoch_id != self.start_epoch or self._masks:
            return
        if context.eval_graph is None or context.eval_reader is None:
            # no eval signal: degrade to uniform with a notice
            print("[prune] no eval graph; sensitive -> uniform ratios")
            super().on_epoch_begin(context)
            return
        program = context.optimize_graph.program
        names = [
            p.name for p in program.global_block().all_parameters()
            if any(fnmatch.fnmatch(p.name, pat)
                   for pat in self._patterns())
        ]
        base, _ = context.run_eval_graph()
        base_m = float(base[self.metric_name])
        sens = {}
        probe = min(max(self.target_ratio, 0.1), 0.9)
        for name in names:
            val = context.scope.get(name)
            keep = val.detach().clone() if isinstance(
                val, torch.Tensor) else np.asarray(val).copy()
            prune_program(program, probe, patterns=[name],
                          pruner=self.pruner, scope=context.scope)
            res, _ = context.run_eval_graph()
            sens[name] = abs(float(res[self.metric_name]) - base_m)
            context.scope.set(name, keep)
        if self.sensitivities_file:
            import json

            with open(self.sensitivities_file, "w") as f:
                json.dump(sens, f, indent=1)
        # inverse-sensitivity ratio allocation, mean == target_ratio
        inv = {n: 1.0 / (s + 1e-9) for n, s in sens.items()}
        scale = self.target_ratio * len(inv) / sum(inv.values())
        report = {}
        for name in names:
            ratio = float(np.clip(inv[name] * scale, 0.0, 0.9))
            report.update(prune_program(
                program, ratio, patterns=[name], pruner=self.pruner,
                scope=context.scope))
            self._record_mask(context, name)
        print("[prune] sensitive masks: %s" % (report,))
