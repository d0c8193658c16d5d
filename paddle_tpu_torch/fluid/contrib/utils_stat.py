"""Program introspection utilities (ref: fluid/contrib/
memory_usage_calc.py, op_frequence.py, model_stat.py).

Port of paddle_tpu/fluid/contrib/utils_stat.py. A bfloat16 var counts 2
bytes an element, as in the JAX package: the port's ``core.np_dtype``
widens bfloat16 to float32 (host copies), which would count it twice."""
import collections

import numpy as np

from .. import core

__all__ = ["memory_usage", "op_freq_statistic", "summary"]


def _var_bytes(var, batch_size):
    if var.shape is None:
        return 0
    n = 1
    for i, s in enumerate(var.shape):
        if s in (None, -1):
            s = batch_size if i == 0 else 1
        n *= s
    try:
        dtype = core.convert_dtype(var.dtype)
        itemsize = 2 if dtype == core.VarType.BF16 else np.dtype(
            core.np_dtype(dtype)).itemsize
    except TypeError:
        itemsize = 4
    return n * itemsize


def memory_usage(program, batch_size):
    """Estimated activation+parameter bytes of one step (ref
    memory_usage_calc.py:46). It sums every var of the program, as if
    none shared memory: an upper bound of the device memory a step
    holds."""
    total = 0
    for block in program.blocks:
        for var in block.vars.values():
            total += _var_bytes(var, batch_size)
    return total


def op_freq_statistic(program):
    """Op-type histogram of the program (ref op_frequence.py)."""
    freq = collections.Counter()
    for block in program.blocks:
        for op in block.ops:
            freq[op.type] += 1
    return collections.OrderedDict(freq.most_common())


def summary(program):
    """Parameter summary table (ref model_stat.py summary): returns and
    prints total/trainable parameter counts with per-var shapes."""
    from ..framework import Parameter

    rows = []
    total = 0
    for var in program.global_block().vars.values():
        if isinstance(var, Parameter) and var.shape is not None:
            n = int(np.prod([max(s, 1) for s in var.shape]))
            rows.append((var.name, tuple(var.shape), n))
            total += n
    lines = ["%-40s %-20s %12s" % ("param", "shape", "count")]
    for name, shape, n in rows:
        lines.append("%-40s %-20s %12d" % (name, shape, n))
    lines.append("total params: %d" % total)
    out = "\n".join(lines)
    print(out)
    return {"total_params": total, "params": rows}
