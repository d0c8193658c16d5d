"""Distributed lookup-table maintenance (ref: contrib/utils/
lookup_table_utils.py).

The reference converts pserver-era distributed lookup tables between
dist/sparse program forms and splices per-pserver shard checkpoints
back together. Here, as in the JAX package, the table is ONE parameter
saved and loaded whole by io.save/load_persistables, so the conversion
helpers reduce to identity/compose operations on the unified checkpoint.
Port of paddle_tpu/fluid/contrib/utils/lookup_table_utils.py, over the
port's io.
"""
from ... import io as _io

__all__ = [
    "create_kvs_content", "convert_dist_to_sparse_program",
    "load_persistables_for_increment", "load_persistables_for_inference",
    "get_inference_model",
]


def create_kvs_content(kv_dict):
    """Serialize a {feasign: embedding-row} dict the reference's kv text
    way: one 'key\\tv1,v2,...' line per entry."""
    return "\n".join(
        "%s\t%s" % (k, ",".join(str(float(x)) for x in v))
        for k, v in kv_dict.items()
    )


def convert_dist_to_sparse_program(program):
    """The pserver 'dist' lookup form does not exist here — the table is
    already one parameter; the program IS the
    sparse form. Returned unchanged (documented identity)."""
    return program


def load_persistables_for_increment(dirname, executor, program,
                                    lookup_table_var=None,
                                    lookup_table_var_path=None):
    """Resume training: the unified checkpoint already contains the full
    table, so this is load_persistables (per-shard splicing unneeded)."""
    _io.load_persistables(executor, dirname, program)


def load_persistables_for_inference(dirname, executor, program,
                                    lookup_table_var_name=None):
    _io.load_persistables(executor, dirname, program)


def get_inference_model(main_program, feeded_var_names, target_vars):
    """Prune to an inference program (ref builds one for the sparse
    table); the generic pruner covers it."""
    from ...framework import default_main_program

    program = main_program or default_main_program()
    return program._prune(target_vars)
