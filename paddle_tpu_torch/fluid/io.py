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


def _global_values(program, scope):
    """(the Program, a scope with the global values): a program run by a
    ``DistributedProgram`` (parallel/sharding.py) that keeps tp-, sp- or
    ZeRO-split state has its blocks gathered into a copy of `scope` (a
    collective: every rank saves)."""
    if hasattr(program, "_state_plan"):
        dist, program = program, program._program
    else:
        dist = getattr(program, "_distributed", None)
    if dist is not None and dist._state_plan()[1]:
        scope = dist.consolidated_scope(scope)
    return program, scope


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


def _no_orbax(what):
    raise NotImplementedError(
        "%s reads parallel/checkpoint.py (the sharded checkpoint store), "
        "which the port brings with ROADMAP.md Queue 1 item 8.6; use the "
        "__persistables__.npz path (use_orbax=False) until then" % what)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      use_orbax=False, step=0, scope=None):
    """Write every persistable var (parameters, optimizer moments,
    batch-norm statistics, learning-rate and loss-scaling counters) to
    ``dirname/__persistables__.npz``."""
    if use_orbax:
        _no_orbax("save_persistables(use_orbax=True)")
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
    run moves them to its device)."""
    if use_orbax:
        _no_orbax("load_persistables(use_orbax=True)")
    load_vars(
        executor, dirname, main_program, predicate=is_persistable,
        filename=filename or "__persistables__.npz", scope=scope,
    )


def load_latest_persistables(executor, dirname, main_program=None):
    """The crash-resume entry point over the step-managed checkpoint
    store; raises until that store is ported."""
    _no_orbax("load_latest_persistables")


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
    scope = global_scope()
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
        scope.set(v.name, _restored(arr))


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
