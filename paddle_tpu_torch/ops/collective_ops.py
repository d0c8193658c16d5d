"""Collective op lowerings (port of paddle_tpu/ops/collective_ops.py; ref
paddle/fluid/operators/collective/c_allreduce_op.h, c_allgather_op.cc,
c_broadcast_op.cc, c_reducescatter_op.cc, c_comm_init_op.cc).

The JAX package lowers these to ``jax.lax`` collectives over the mesh
axis its lowering context binds to the op's ``ring_id`` (or to
``"collective"``), inside ``shard_map``; with no axis bound they are the
identity, NCCL's world-size-1 semantics. The port binds the axis the same
way (``ctx.mesh_axes``) and runs the collective on the rank group
(``ctx.mesh``, parallel/mesh.py) over ``torch.distributed``: each rank
gives its own ``X`` and gets what the JAX package's shard of that rank
gets. ``c_allreduce_sum`` is differentiable (its gradient is the group
sum of the gradients, as ``lax.psum``'s transpose); the other
collectives give constants to autograd (ROADMAP.md Queue 3).

The data-parallel step does not use these ops: ``DistributedProgram``
averages the gradients in the gradient hook (parallel/sharding.py).
They exist for API parity and for programs that script their own
collectives.
"""
import torch

from .registry import register_op, single


def _axis(ctx, attrs):
    """The mesh axis bound to the op's ring id; None = no axis bound
    (single-rank execution)."""
    ring = attrs.get("ring_id", 0)
    return ctx.mesh_axes.get(ring) or ctx.mesh_axes.get("collective")


def _group(ctx, attrs):
    """The rank group of the op's axis, or None when none is bound."""
    ax = _axis(ctx, attrs)
    if ax is None:
        return None
    if ctx.mesh is None:
        raise RuntimeError(
            "collective bound to mesh axis %r but the run has no rank "
            "group (LowerContext.mesh)" % (ax,))
    return ctx.mesh.axis_group(ax)


def collective_guard(what, site="collective"):
    """Host-side health gate, hit before each collective is issued:
    counts a fault-spec check at `site` and enforces the thread's armed
    collective deadline (fluid/resilience.py), so a fleet that already
    lost a peer raises CollectiveTimeoutError here instead of waiting on
    it. World-size-1 paths are guarded too: the entry point is the unit
    of accounting, as the telemetry dispatch counters below count it.
    Imported lazily — ops must stay importable before the fluid package
    finishes initialising.

    Public: parallel/comms routes every gradient sync through here too,
    so deadlines and fault drills cover it like the c_* ops."""
    from .. import observability as obs
    from ..fluid.resilience import collective_check

    obs.inc("collective.dispatch")
    obs.inc("collective.dispatch.%s" % what)
    collective_check(what, site=site)


_guard = collective_guard


def _allreduce(name, op):
    def lower(ctx, ins, attrs):
        x = ins["X"][0]
        _guard(name)
        group = _group(ctx, attrs)
        if group is None:
            return single(x)
        return single(group.all_reduce(x, op))

    return lower


@register_op("c_allreduce_sum")
def _c_allreduce_sum(ctx, ins, attrs):
    from ..parallel.mesh import all_reduce_sum

    x = ins["X"][0]
    _guard("c_allreduce_sum")
    group = _group(ctx, attrs)
    if group is None:
        return single(x)
    return single(all_reduce_sum(x, group))


register_op("c_allreduce_max")(_allreduce("c_allreduce_max", "max"))
register_op("c_allreduce_min")(_allreduce("c_allreduce_min", "min"))
# the JAX package gathers the axis and multiplies (XLA has no product
# all-reduce): exact, zeros and signs included; RankGroup.all_reduce
# does the same in rank order
register_op("c_allreduce_prod")(_allreduce("c_allreduce_prod", "prod"))


@register_op("c_allgather")
def _c_allgather(ctx, ins, attrs):
    x = ins["X"][0]
    _guard("c_allgather")
    group = _group(ctx, attrs)
    if group is None:
        return single(x)
    # paddle concatenates along dim 0
    return single(group.all_gather(x))


@register_op("c_broadcast")
def _c_broadcast(ctx, ins, attrs):
    x = ins["X"][0]
    _guard("c_broadcast")
    group = _group(ctx, attrs)
    if group is None:
        return single(x)
    return single(group.broadcast(x, attrs.get("root", 0)))


@register_op("c_reducescatter")
def _c_reducescatter(ctx, ins, attrs):
    x = ins["X"][0]
    _guard("c_reducescatter")
    group = _group(ctx, attrs)
    if group is None:
        return single(x)
    return single(group.reduce_scatter(x))


@register_op("c_concat")
def _c_concat(ctx, ins, attrs):
    return _c_allgather(ctx, ins, attrs)


@register_op("c_identity")
def _c_identity(ctx, ins, attrs):
    return single(ins["X"][0])


@register_op("c_split")
def _c_split(ctx, ins, attrs):
    """This rank's 1/size slice of X along dim 0 (no communication)."""
    x = ins["X"][0]
    group = _group(ctx, attrs)
    if group is None:
        return single(x)
    per = x.shape[0] // group.size
    return single(x.narrow(0, group.rank * per, per))


@register_op("c_sync_calc_stream")
def _c_sync_calc_stream(ctx, ins, attrs):
    # the ops of a rank run in stream order: nothing to synchronise
    return single(ins["X"][0])


@register_op("c_sync_comm_stream")
def _c_sync_comm_stream(ctx, ins, attrs):
    return single(ins["X"][0])


@register_op("c_comm_init")
def _c_comm_init(ctx, ins, attrs):
    # the communicator is the rank group, made before the run: no-op
    return {}


@register_op("c_comm_init_all")
def _c_comm_init_all(ctx, ins, attrs):
    return {}


@register_op("c_gen_nccl_id")
def _c_gen_nccl_id(ctx, ins, attrs):
    return {}


@register_op("barrier")
def _barrier(ctx, ins, attrs):
    """A rendezvous of the group when an axis is bound; X, if given,
    passes through."""
    _guard("barrier", site="barrier")
    group = _group(ctx, attrs)
    if group is not None:
        group.barrier()
    if ins.get("X"):
        return single(ins["X"][0])
    return {}


@register_op("ppermute")
def _ppermute(ctx, ins, attrs):
    """Ring permute — building block for ring attention / pipeline."""
    x = ins["X"][0]
    _guard("ppermute")
    group = _group(ctx, attrs)
    if group is None:
        return single(x)
    return single(group.ppermute(x, attrs.get("shift", 1)))


@register_op("all_to_all")
def _all_to_all(ctx, ins, attrs):
    x = ins["X"][0]
    _guard("all_to_all")
    group = _group(ctx, attrs)
    if group is None:
        return single(x)
    return single(group.all_to_all(x, attrs.get("split_axis", 0),
                                   attrs.get("concat_axis", 0)))


@register_op("c_allreduce_quant")
def _c_allreduce_quant(ctx, ins, attrs):
    """Block-scaled quantized mean-allreduce (parallel/comms): quantize
    -> reduce-scatter -> dequant-accumulate -> all-gather. Explicit-op
    twin of the grad-sync path for programs that script their own
    collectives. attrs: ``block_size`` (default 256), ``wire_dtype``
    ('int8' | 'fp8_e4m3'), ``op`` ('mean' default | 'sum'). Inputs that
    can't block-quantize (non-float, scalar) take the exact reduce, like
    pmean_int8."""
    x = ins["X"][0]
    _guard("c_allreduce_quant")
    group = _group(ctx, attrs)
    if group is None:
        return single(x)
    from ..parallel.comms import allreduce as _ar
    from ..parallel.comms import quantize as _qz

    mean = attrs.get("op", "mean") != "sum"
    block = int(attrs.get("block_size", _qz.DEFAULT_BLOCK))
    wire = attrs.get("wire_dtype", "int8")
    n = group.size
    if not torch.is_floating_point(x) or x.dim() == 0:
        red = group.all_reduce(x)
        return single(red / n if mean else red)
    flat, orig = _qz.pad_flat(x.detach().float().reshape(-1), n * block)
    reduced, _ = _ar.quantized_allreduce_flat(flat, group, block, wire,
                                              mean=mean)
    return single(reduced[:orig].reshape(x.shape).to(x.dtype))
