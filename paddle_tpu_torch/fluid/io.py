"""Model save/load (ref: python/paddle/fluid/io.py).

Port of paddle_tpu/fluid/io.py, same on-disk format: parameters as a
``.npz`` archive, the inference program as the ``__model__`` Program JSON.
A directory written by either package loads in the other.
"""
import json
import os

import numpy as np
import torch

from .executor import global_scope, to_numpy
from .framework import Parameter, Program, Variable, default_main_program

__all__ = [
    "save_vars", "save_params", "load_vars", "load_params",
    "save_inference_model", "load_inference_model", "params_from_numpy",
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
    return to_numpy(value) if isinstance(value, torch.Tensor) \
        else np.asarray(value)


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    main_program = main_program or default_main_program()
    var_list = _collect(main_program, predicate or is_persistable, vars)
    scope = scope if scope is not None else global_scope()
    os.makedirs(dirname, exist_ok=True)
    payload = {}
    for v in var_list:
        val = scope.find_value(v.name)
        if val is not None:
            payload[v.name] = _host(val)
    np.savez(os.path.join(dirname, filename or "__vars__.npz"), **payload)


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    save_vars(
        executor, dirname, main_program, predicate=is_parameter,
        filename=filename or "__params__.npz", scope=scope,
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
            scope.set(v.name, np.asarray(data[v.name]))


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    load_vars(
        executor, dirname, main_program, predicate=is_parameter,
        filename=filename or "__params__.npz", scope=scope,
    )


def save_inference_model(
    dirname,
    feeded_var_names,
    target_vars,
    executor,
    main_program=None,
    model_filename=None,
    params_filename=None,
    program_only=False,
    scope=None,
):
    """ref io.py:save_inference_model: the program pruned to
    `target_vars`, plus the parameters."""
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
    scope=None,
):
    """ref io.py:load_inference_model → (program, feed_names, fetch_vars).
    The parameters land in `scope` (default ``global_scope()``) as host
    arrays; the first run moves them to its device."""
    with open(os.path.join(dirname, model_filename or "__model__")) as f:
        meta = json.load(f)
    program = Program.from_json(json.dumps(meta["program"]))
    data = _load_npz(dirname, params_filename or "__params__.npz")
    scope = scope if scope is not None else global_scope()
    for name in data.files:
        scope.set(name, np.asarray(data[name]))
    fetch_vars = [
        program.global_block().var(n) for n in meta["fetch_names"]
    ]
    return [program, meta["feed_names"], fetch_vars]


def params_from_numpy(named, device):
    """{name: ndarray} -> {name: tensor on `device`}, layouts unchanged
    (fc weights (in, out), embeddings (vocab, hidden)): how a scope of the
    JAX package is copied into a scope of the port."""
    return {n: torch.tensor(np.asarray(a), device=device)
            for n, a in named.items()}
