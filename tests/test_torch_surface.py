"""The port's public names and signatures against the JAX package's.

For every module the two packages share (the same path under
``paddle_tpu/`` and ``paddle_tpu_torch/``), each public name of the
JAX package's module (its ``__all__``, or the functions and classes it
defines) must exist in the port's, each function must take the
reference's parameters first and in its order, and each public method
of a class too. What is left out on purpose is listed in
:data:`LEFT_OUT`, each with its reason; the list must be exact, so an
entry that is no longer needed fails as well as a new gap.
"""
import importlib
import inspect
import os
import warnings

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TPU = "a TPU name: the port runs on the card (CUDAPlace) or the CPU"
JAX = ("a jax-only helper: the port's mesh is a torch.distributed rank "
       "group, not a jax Mesh over devices")
ITEM9 = "dygraph waits for ROADMAP.md Queue 1 item 9"
ITEM11 = ("analysis, run health, the ledger, the sanitizer and capacity "
          "planning wait for ROADMAP.md Queue 1 item 11")
PLUMBING = ("internal lowering plumbing: the port runs ops eagerly on "
            "torch tensors, with a device and generators, not traced "
            "jax values and PRNG keys")
GROUP = ("a collective takes a rank group (torch.distributed) where the "
         "JAX package names a mesh axis or a device list")
PLACE = "the port's extra place= (the card unless asked), placed last"

LEFT_OUT = {
    ('fluid', 'TPUPlace'): TPU,
    ('fluid', 'dygraph'): ITEM9,
    ('fluid', 'VarBase'): ITEM9,
    ('fluid', 'is_compiled_with_tpu'): TPU,
    ('fluid.core', 'Place.jax_device'): TPU,
    ('fluid.core', 'TPUPlace'): TPU,
    ('fluid.core', 'is_compiled_with_tpu'): TPU,
    ('fluid.core', 'np_dtype'): PLUMBING,
    ('fluid.framework', 'tpu_places'): TPU,
    ('fluid.lowering', 'bind_outputs'): PLUMBING,
    ('fluid.lowering', 'apply_op'): PLUMBING,
    ('fluid.lowering', 'op_read_names'): PLUMBING,
    ('fluid.lowering', 'build_step_fn'): PLUMBING,
    ('native.build', 'build_tsan'): ITEM11,
    ('observability', 'ExecutableLedger'): ITEM11,
    ('observability', 'get_ledger'): ITEM11,
    ('observability', 'drift_rows'): ITEM11,
    ('observability', 'drift_summary'): ITEM11,
    ('observability', 'load_snapshot'): ITEM11,
    ('observability', 'render_drift_table'): ITEM11,
    ('observability', 'StepSeries'): ITEM11,
    ('observability', 'GoodputAccount'): ITEM11,
    ('observability', 'RunHealth'): ITEM11,
    ('observability', 'load_run'): ITEM11,
    ('observability', 'render_health_report'): ITEM11,
    ('observability', 'render_comparison'): ITEM11,
    ('ops.collective_ops', 'axis_size'): JAX,
    ('ops.registry', 'LowerContext.__init__'): PLUMBING,
    ('ops.registry', 'LowerContext.set_op_tag'): PLUMBING,
    ('parallel.comms', 'GradSyncProgram.predicted_comm_seconds'): ITEM11,
    ('parallel.comms', 'quantized_allreduce_flat'): GROUP,
    ('parallel.comms', 'exact_allreduce_flat'): GROUP,
    ('parallel.comms', 'pmean_int8'): GROUP,
    ('parallel.comms', 'sync_bucketed'): GROUP,
    ('parallel.comms.allreduce', 'quantized_allreduce_flat'): GROUP,
    ('parallel.comms.allreduce', 'exact_allreduce_flat'): GROUP,
    ('parallel.comms.allreduce', 'pmean_int8'): GROUP,
    ('parallel.comms.allreduce', 'axis_size'): JAX,
    ('parallel.comms.bucketing', 'sync_bucketed'): GROUP,
    ('parallel.comms.grad_sync', 'GradSyncProgram.predicted_comm_seconds'): ITEM11,
    ('parallel.mesh', 'build_mesh'): GROUP,
    ('parallel.mesh', 'P.update'): JAX,
    ('parallel.mesh', 'NamedSharding'): JAX,
    ('parallel.mesh', 'Mesh'): JAX,
    ('parallel.quantized_collectives', 'pmean_int8'): GROUP,
    ('parallel.ring_attention', 'ring_attention'): GROUP,
    ('parallel.sharding', 'DistributedProgram.shard_state'): JAX,
    ('serving', 'BucketSpec.feed_specs'): ITEM11,
    ('serving', 'DecodeEngine.sentinel_replay'): ITEM11,
    ('serving', 'ServingEngine.check_hbm_budget'): ITEM11,
    ('serving', 'ServingEngine.warmup'): ITEM11,
    ('serving', 'disagg_fleet'): PLACE,
    ('serving.batcher', 'BucketSpec.feed_specs'): ITEM11,
    ('serving.decode', 'DecodeEngine.sentinel_replay'): ITEM11,
    ('serving.disagg', 'disagg_fleet'): PLACE,
    ('serving.disagg.router', 'disagg_fleet'): PLACE,
    ('serving.engine', 'ServingEngine.check_hbm_budget'): ITEM11,
    ('serving.engine', 'ServingEngine.warmup'): ITEM11,
}


def _modules(pkg):
    out = set()
    for d, _, files in os.walk(os.path.join(ROOT, pkg)):
        if "__pycache__" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f),
                                      os.path.join(ROOT, pkg))[:-3]
                rel = rel.replace(os.sep, ".")
                if rel == "__init__" or rel.endswith(".__init__"):
                    rel = rel[:-len("__init__")].rstrip(".")
                out.add(rel)
    return out


SHARED = sorted(_modules("paddle_tpu") & _modules("paddle_tpu_torch"))


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_")
                 and getattr(v, "__module__", None) == mod.__name__
                 and (inspect.isfunction(v) or inspect.isclass(v))]
    return [n for n in names if hasattr(mod, n)]


def _params(f):
    try:
        return [p.name for p in inspect.signature(f).parameters.values()]
    except (TypeError, ValueError):
        return None


def _differences(rel):
    """{(module, name): what differs} for one shared module."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jm = importlib.import_module("paddle_tpu" + ("." + rel if rel
                                                     else ""))
        pm = importlib.import_module("paddle_tpu_torch" + ("." + rel if rel
                                                           else ""))
    out = {}

    def sig(key, a, b):
        pa, pb = _params(a), _params(b)
        if pa is not None and pb is not None and pb[:len(pa)] != pa:
            out[key] = "parameters %s, the reference's %s" % (pb, pa)

    for n in _public(jm):
        jv = getattr(jm, n)
        if not hasattr(pm, n):
            out[(rel, n)] = "missing"
            continue
        pv = getattr(pm, n)
        if inspect.isfunction(jv) and callable(pv):
            sig((rel, n), jv, pv)
        if inspect.isclass(jv) and inspect.isclass(pv):
            for m, mv in vars(jv).items():
                if (m.startswith("_") and m != "__init__") \
                        or not inspect.isfunction(mv):
                    continue
                if not hasattr(pv, m):
                    out[(rel, n + "." + m)] = "missing"
                else:
                    sig((rel, n + "." + m), mv, getattr(pv, m))
    return out


def test_the_shared_modules_are_found():
    assert len(SHARED) > 200
    for rel in ("fluid", "fluid.core", "fluid.framework",
                "fluid.layer_helper", "fluid.optimizer", "fluid.io",
                "fluid.resilience", "parallel.checkpoint",
                "parallel.elastic"):
        assert rel in SHARED
    assert {rel for rel, _ in LEFT_OUT} <= set(SHARED)


@pytest.mark.parametrize("rel", SHARED)
def test_public_names_and_signatures(rel):
    got = _differences(rel)
    want = {k: v for k, v in LEFT_OUT.items() if k[0] == rel}
    assert sorted(got) == sorted(want), {
        "new differences": {k: got[k] for k in set(got) - set(want)},
        "listed but gone": sorted(set(want) - set(got))}


def test_the_names_of_fault_12():
    from paddle_tpu.fluid import core as jcore
    from paddle_tpu.fluid import framework as jframework
    from paddle_tpu_torch.fluid import core, framework, layer_helper
    from paddle_tpu_torch.fluid import optimizer
    from paddle_tpu_torch.fluid import unique_name

    assert core.VarDesc.VarType.FP32 == jcore.VarDesc.VarType.FP32 \
        == "float32"
    for dt in ("float16", "bfloat16", "float32", "float64", "int32",
               "int64", "bool", "uint8"):
        assert framework.dtype_is_floating(dt) \
            == jframework.dtype_is_floating(dt)
    with unique_name.guard():
        helper = layer_helper.LayerHelper("fc", input=3)
    helper.is_instance("input", int)
    with pytest.raises(TypeError, match="input of fc must be"):
        helper.is_instance("input", str)
    assert optimizer.SGD(0.1).load({"x": 1}) is None
