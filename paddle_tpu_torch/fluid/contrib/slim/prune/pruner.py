"""Parameter pruning (ref: contrib/slim/prune/pruner.py:22-107).

Port of paddle_tpu/fluid/contrib/slim/prune/pruner.py.
`StructurePruner.cal_pruned_idx`/`prune_tensor` follow the reference's
group-pruning semantics (l1_norm criterion over the non-pruned axes);
`prune_program` masks the chosen groups to zero in place and keeps the
shapes, as the JAX package does, so the pruned program is the same
program with the same shapes in both packages (the sparsity is real).

Where the value lives on the card, the groups are chosen on the host from
one copy of the parameter, with the reference's numpy code (the same
values pick the same indices in both packages, ties included: numpy's
default sort), and zeroed on the card, in place, in the tensor the scope
holds (`zero_groups`). A host value is masked on the host, as the
reference masks it.
"""
import fnmatch

import numpy as np
import torch

__all__ = ["Pruner", "StructurePruner", "prune_program"]


def as_host(value):
    """A host numpy copy of a scope value (a tensor is read back once)."""
    if isinstance(value, torch.Tensor):
        from ....executor import to_numpy

        return to_numpy(value)
    return np.asarray(value)


def zero_groups(tensor, idx, axis):
    """Zero the groups `idx` (a 1-D int64 tensor on the tensor's device)
    of `tensor` along `axis`, in place: the same tensor object, its
    storage unchanged."""
    with torch.no_grad():
        tensor.index_fill_(axis, idx, 0)
    return tensor


class Pruner:
    """Base pruner (ref pruner.py:22). Subclasses used with
    prune_program must provide axis_for/cal_pruned_idx/prune_tensor
    (StructurePruner is the stock implementation)."""

    def prune(self, param, ratio=0.5):
        raise NotImplementedError


class StructurePruner(Pruner):
    """Group pruning by axis + criterion (ref pruner.py:34).

    pruning_axis/criterions are dicts keyed by param name ('*' default),
    criterion 'l1_norm' supported.
    """

    def __init__(self, pruning_axis=None, criterions=None):
        self.pruning_axis = pruning_axis or {"*": 0}
        self.criterions = criterions or {"*": "l1_norm"}

    def axis_for(self, name, param):
        """The pruning axis this pruner would use for `param`."""
        return self.pruning_axis.get(name, self.pruning_axis.get("*"))

    def cal_pruned_idx(self, name, param, ratio, axis=None):
        """The groups to prune, from host values (a tensor is read back
        once): the reference's numpy code, so that equal values give
        equal indices in both packages."""
        param = as_host(param)
        criterion = self.criterions.get(name, self.criterions.get("*"))
        if axis is None:
            axis = self.axis_for(name, param)
        prune_num = int(round(param.shape[axis] * ratio))
        reduce_dims = tuple(i for i in range(param.ndim) if i != axis)
        if criterion != "l1_norm":
            raise ValueError("criterion %r not supported (l1_norm only)"
                             % criterion)
        scores = np.sum(np.abs(param), axis=reduce_dims)
        return scores.argsort()[:prune_num]

    def prune_tensor(self, tensor, pruned_idx, pruned_axis, lazy=False):
        mask = np.zeros(tensor.shape[pruned_axis], dtype=bool)
        mask[np.asarray(pruned_idx, dtype=int)] = True
        if lazy:
            out = np.array(tensor)
            sl = [slice(None)] * out.ndim
            sl[pruned_axis] = mask
            out[tuple(sl)] = 0
            return out
        sl = [slice(None)] * tensor.ndim
        sl[pruned_axis] = ~mask
        return np.asarray(tensor)[tuple(sl)]


def prune_program(program, ratio, patterns=("*",), pruner=None,
                  scope=None):
    """Mask-prune matching parameters of `program` in place in the scope
    (lazy pruning: zeroed groups, static shapes). Returns
    {param_name: n_pruned_groups}. A tensor's groups are zeroed on its
    device, in the tensor the scope holds."""
    from ....executor import global_scope

    pruner = pruner or StructurePruner()
    scope = scope if scope is not None else global_scope()
    report = {}
    for p in program.global_block().all_parameters():
        if not any(fnmatch.fnmatch(p.name, pat) for pat in patterns):
            continue
        val = scope.get(p.name)
        if val is None:
            continue
        arr = as_host(val)
        # the axis is resolved ONCE and passed to both calls so a custom
        # per-param axis policy can't desynchronize index vs mask axis
        axis = pruner.axis_for(p.name, arr)
        if axis is None or arr.ndim <= axis:
            continue  # e.g. 1-D biases under pruning_axis=1
        idx = pruner.cal_pruned_idx(p.name, arr, ratio, axis=axis)
        if len(idx) == 0:
            continue
        if isinstance(val, torch.Tensor):
            zero_groups(val, torch.as_tensor(
                np.asarray(idx, dtype=np.int64), device=val.device), axis)
        else:
            scope.set(p.name, pruner.prune_tensor(arr, idx, axis,
                                                  lazy=True))
        report[p.name] = int(len(idx))
    return report
