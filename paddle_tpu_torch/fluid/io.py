"""Model save/load (ref: python/paddle/fluid/io.py).

Port of paddle_tpu/fluid/io.py, same on-disk format: parameters and
persistables as ``.npz`` archives, the inference program as the
``__model__`` Program JSON, ``fluid.save`` as ``<path>.pdparams.npz`` and
``<path>.pdmodel.json``. A file written by either package loads in the
other.

A value is stored as the JAX package's ``np.asarray`` gives it: a tensor
is copied to the host once, a 0-d counter stays 0-d, and a bfloat16
value, which numpy lacks, keeps its 2-byte bits under numpy's void dtype
``V2`` (what ``np.savez`` writes for the JAX package's bfloat16 arrays).
Loading turns ``V2`` back into a bfloat16 tensor.
"""
import json
import os

import numpy as np
import torch

from .executor import global_scope
from .framework import Parameter, Program, Variable, default_main_program

__all__ = [
    "save_vars", "save_params", "save_persistables", "load_vars",
    "load_params", "load_persistables", "load_latest_persistables",
    "save_inference_model", "load_inference_model", "batch", "save",
    "load", "load_program_state", "set_program_state",
    "params_from_numpy",
]


def is_parameter(var):
    return isinstance(var, Parameter)


def is_persistable(var):
    return var.persistable


def _collect(program, predicate, vars=None):
    if vars is not None:
        return [
            program.global_block().var(v) if isinstance(v, str) else v
            for v in vars
        ]
    return [v for v in program.list_vars() if predicate(v)]


def _host(value):
    """`value` as the array the file stores (see the module docstring)."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).cpu().numpy().view("V2")
        return t.cpu().numpy()
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":   # an ml_dtypes array from a caller
        return arr.view("V2")
    return arr


def _restored(arr):
    """A stored array as the scope holds it: ``V2`` bits as bfloat16."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(
            np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return arr


def _scope_payload(var_list, scope):
    payload = {}
    for v in var_list:
        val = scope.find_value(v.name)
        if val is not None:
            payload[v.name] = _host(val)
    return payload


def _distributed_of(program):
    """(the Program, the ``DistributedProgram`` that runs it or None) of
    a Program, a CompiledProgram or a DistributedProgram."""
    if hasattr(program, "_state_plan"):
        return program._program, program
    program = getattr(program, "_program", program)
    return program, getattr(program, "_distributed", None)


def _global_values(program, scope):
    """(the Program, a scope with the global values): a program run by a
    ``DistributedProgram`` (parallel/sharding.py) that keeps tp-, sp- or
    ZeRO-split state has its blocks gathered into a copy of `scope` (a
    collective: every rank saves)."""
    program, dist = _distributed_of(program)
    if dist is not None and dist._state_plan()[1]:
        scope = dist.consolidated_scope(scope)
    return program, scope


def _persistable_state(program, scope):
    """(the Program, {name: value} of its persistables with their global
    values): what the step-managed store saves, for
    ``save_persistables(use_orbax=True)``, ``resilience.TrainGuard`` and
    ``parallel.elastic.FleetGuard``. A collective where the program
    keeps split state (:func:`_global_values`)."""
    program, scope = _global_values(program, scope)
    state = {}
    for v in _collect(program, is_persistable):
        val = scope.find_value(v.name)
        if val is not None:
            state[v.name] = val
    return program, state


def _store_group(program):
    """The rank group whose ranks share one directory of the step-managed
    store, or None for a program that one process runs. Every rank of a
    ``DistributedProgram`` holds the same global values, so rank 0 of
    its group writes them (:func:`_store_save`) and every rank reads
    them back (:func:`_agreed_step`); the next run cuts each rank's
    blocks again. A program whose ranks each keep state of their own
    (``StackedDpProgram``: LocalSGD, the gradient-sync modes) is
    refused: one directory holds one copy."""
    _, dist = _distributed_of(program)
    mesh = getattr(dist, "_mesh", None)
    if mesh is None or mesh.group is None:
        return None
    if not dist._replicated_state:
        raise NotImplementedError(
            "the step-managed checkpoint store over a %s: each of its %d "
            "ranks keeps state of its own, and a step directory holds one "
            "copy. Save each rank's with save_persistables(use_orbax="
            "False) into a directory of its own, or train under "
            "parallel.elastic.FleetGuard, whose workers each keep their "
            "own checkpoints" % (type(dist).__name__, mesh.size))
    return mesh


def _store_save(program, scope, dirname, step, **kw):
    """Save the program's persistables (:func:`_persistable_state`) as
    step `step` of the store under `dirname`, once for the rank group
    (:func:`_store_group`: rank 0 writes). Every rank takes part, and
    every rank meets the ``save`` fault site once. Returns the number of
    values saved."""
    from ..parallel.checkpoint import save_checkpoint
    from .resilience import fault_check

    group = _store_group(program)
    _, state = _persistable_state(program, scope)
    if group is None or group.rank == 0:
        save_checkpoint(dirname, state, step=step, **kw)
    else:
        fault_check("save")     # the writer's save_checkpoint checks it
    return len(state)


def _agreed_step(program, step, dirname):
    """`step` (None: no checkpoint), the step this rank chose in the
    store under `dirname`, after checking that rank 0 of the program's
    group (:func:`_store_group`) chose the same one; ranks that see
    different checkpoints raise before any of them restores."""
    group = _store_group(program)
    if group is None:
        return step
    mine = -1 if step is None else int(step)
    first = int(group.broadcast(torch.tensor(
        [mine], dtype=torch.int64, device=group.device))[0])
    if first != mine:
        raise RuntimeError(
            "rank %d of %s chose checkpoint step %s under %r and rank 0 "
            "chose %s: the ranks of one program must share one checkpoint "
            "directory" % (group.rank, group, step, dirname,
                           None if first < 0 else first))
    return step


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    """Write the vars to ``dirname/filename`` (npz). A tensor-parallel or
    ZeRO-split persistable is written as its global value
    (:func:`_global_values`)."""
    main_program = main_program or default_main_program()
    scope = scope if scope is not None else global_scope()
    main_program, scope = _global_values(main_program, scope)
    var_list = _collect(main_program, predicate or is_persistable, vars)
    os.makedirs(dirname, exist_ok=True)
    np.savez(os.path.join(dirname, filename or "__vars__.npz"),
             **_scope_payload(var_list, scope))


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    save_vars(
        executor, dirname, main_program, predicate=is_parameter,
        filename=filename or "__params__.npz", scope=scope,
    )


def save_persistables(executor, dirname, main_program=None, filename=None,
                      use_orbax=False, step=0, scope=None):
    """Write every persistable var (parameters, optimizer moments,
    batch-norm statistics, learning-rate and loss-scaling counters) to
    ``dirname/__persistables__.npz``. With use_orbax=True the write goes
    to the step-managed store (parallel/checkpoint.py) as step `step`:
    retention, atomic steps and digest manifests, split state as its
    global values, written once for a program's rank group into the
    directory its ranks share (:func:`_store_save`). The name is the JAX
    package's, whose store is orbax; the port's store is its own."""
    if use_orbax:
        _store_save(main_program or default_main_program(),
                    scope if scope is not None else global_scope(),
                    dirname, step)
        return
    save_vars(
        executor, dirname, main_program, predicate=is_persistable,
        filename=filename or "__persistables__.npz", scope=scope,
    )


def _load_npz(dirname, filename):
    path = os.path.join(dirname, filename)
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return np.load(path, allow_pickle=False)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    main_program = main_program or default_main_program()
    var_list = _collect(main_program, predicate or is_persistable, vars)
    data = _load_npz(dirname, filename or "__vars__.npz")
    scope = scope if scope is not None else global_scope()
    for v in var_list:
        if v.name in data:
            scope.set(v.name, _restored(data[v.name]))


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    load_vars(
        executor, dirname, main_program, predicate=is_parameter,
        filename=filename or "__params__.npz", scope=scope,
    )


def load_persistables(executor, dirname, main_program=None, filename=None,
                      use_orbax=False, step=None, scope=None):
    """Read ``__persistables__.npz`` into the scope (host arrays; the next
    run moves them to its device). With use_orbax=True read step `step`
    (the newest verified one when None) of the step-managed store,
    shape-checked against the program's vars."""
    if use_orbax:
        from ..parallel.checkpoint import load_checkpoint

        main = main_program or default_main_program()
        _apply_state(main, load_checkpoint(dirname, step=step),
                     scope if scope is not None else global_scope())
        return
    load_vars(
        executor, dirname, main_program, predicate=is_persistable,
        filename=filename or "__persistables__.npz", scope=scope,
    )


def load_latest_persistables(executor, dirname, main_program=None):
    """Crash-resume entry point over the step-managed store: load the
    newest complete checkpoint under `dirname` into the scope and
    return its step number, or return None (loading nothing) when no
    checkpoint exists yet — so a cold start and a restart are the same
    call site. ``resilience.TrainGuard`` wires this automatically."""
    from ..parallel.checkpoint import restore_latest

    program = main_program or default_main_program()
    found = restore_latest(dirname)
    if _agreed_step(program, found and found[0], dirname) is None:
        return None
    step, state = found
    _apply_state(program, state, global_scope())
    return step


def save_inference_model(
    dirname,
    feeded_var_names,
    target_vars,
    executor,
    main_program=None,
    model_filename=None,
    params_filename=None,
    export_for_deployment=True,
    program_only=False,
    scope=None,
):
    """ref io.py:save_inference_model: the program pruned to
    `target_vars`, plus the parameters. `export_for_deployment` is
    accepted and not read, as in the JAX package."""
    main_program = main_program or default_main_program()
    inference_program = main_program._prune(target_vars)
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "program": json.loads(inference_program.to_json()),
        "feed_names": list(feeded_var_names),
        "fetch_names": [
            t.name if isinstance(t, Variable) else t for t in target_vars
        ],
    }
    with open(os.path.join(dirname, model_filename or "__model__"), "w") as f:
        json.dump(meta, f)
    if not program_only:
        save_params(
            executor, dirname, main_program,
            filename=params_filename or "__params__.npz", scope=scope,
        )
    return [meta["fetch_names"]]


def load_inference_model(
    dirname,
    executor,
    model_filename=None,
    params_filename=None,
    pserver_endpoints=None,
    scope=None,
):
    """ref io.py:load_inference_model → (program, feed_names, fetch_vars).
    The parameters land in `scope` (default ``global_scope()``) as host
    arrays; the first run moves them to its device. `pserver_endpoints`
    is accepted and not read, as in the JAX package."""
    with open(os.path.join(dirname, model_filename or "__model__")) as f:
        meta = json.load(f)
    program = Program.from_json(json.dumps(meta["program"]))
    data = _load_npz(dirname, params_filename or "__params__.npz")
    scope = scope if scope is not None else global_scope()
    for name in data.files:
        scope.set(name, _restored(data[name]))
    fetch_vars = [
        program.global_block().var(n) for n in meta["fetch_names"]
    ]
    return [program, meta["feed_names"], fetch_vars]


def _names(var_list):
    return [v.name if isinstance(v, Variable) else v for v in var_list]


def save(program, model_path):
    """paddle 1.6-style ``fluid.save``: the program's persistables to
    ``model_path + ".pdparams.npz"``, its JSON to ``".pdmodel.json"``."""
    dirname = os.path.dirname(model_path) or "."
    os.makedirs(dirname, exist_ok=True)
    program, scope = _global_values(program, global_scope())
    persistables = [v for v in program.list_vars() if v.persistable]
    np.savez(model_path + ".pdparams.npz",
             **_scope_payload(persistables, scope))
    with open(model_path + ".pdmodel.json", "w") as f:
        f.write(program.to_json())


def load(program, model_path, executor=None, var_list=None):
    """``fluid.load``: the saved values of `var_list`, else of the
    program's persistables, else every saved value, into the scope."""
    data = np.load(model_path + ".pdparams.npz")
    scope = global_scope()
    if var_list:
        names = _names(var_list)
    elif program is not None:
        names = [v.name for v in program.list_vars()
                 if getattr(v, "persistable", False)]
    else:
        names = list(data.files)
    for name in names:
        if name in data:
            scope.set(name, _restored(data[name]))


def load_program_state(model_path, var_list=None):
    """ref io.py load_program_state: the saved persistables as a plain
    {name: ndarray} dict, without touching any scope (bfloat16 values as
    the file holds them, ``V2``)."""
    data = np.load(model_path + ".pdparams.npz")
    names = _names(var_list) if var_list else list(data.files)
    return {n: np.asarray(data[n]) for n in names if n in data}


def set_program_state(program, state_dict):
    """ref io.py set_program_state: write a {name: ndarray} dict into the
    global scope for the program's persistable vars (shape-checked)."""
    _apply_state(program, state_dict, global_scope())


def _apply_state(program, state_dict, scope):
    """Write the values of `state_dict` of the program's persistables
    into the scope that holds each (shape-checked; host values, which
    the next run moves to its device). Returns how many it wrote."""
    program, _ = _distributed_of(program)
    n = 0
    for v in program.list_vars():
        if not v.persistable or v.name not in state_dict:
            continue
        arr = _host(state_dict[v.name])
        if v.shape is not None and all(
            s not in (None, -1) for s in v.shape
        ) and tuple(arr.shape) != tuple(v.shape):
            raise ValueError(
                "set_program_state: shape mismatch for %r: program says "
                "%s, state has %s" % (v.name, v.shape, arr.shape)
            )
        scope.update(v.name, _restored(arr))
        n += 1
    return n


def batch(reader, batch_size, drop_last=False):
    from ..reader_utils import batch as _batch

    return _batch(reader, batch_size, drop_last)


def get_program_persistable_vars(program):
    return [v for v in program.list_vars() if v.persistable]


def get_program_parameter(program):
    return program.all_parameters()


def params_from_numpy(named, device):
    """{name: ndarray} -> {name: tensor on `device`}, layouts unchanged
    (fc weights (in, out), embeddings (vocab, hidden)): how a scope of the
    JAX package is copied into a scope of the port."""
    return {n: torch.tensor(np.asarray(a), device=device)
            for n, a in named.items()}
