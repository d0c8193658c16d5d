"""Control-flow op lowerings: while, conditional_block, cond, static_rnn,
gather_tree, is_empty, select_input, select_output (port of
paddle_tpu/ops/control_ops.py).

The JAX package traces a sub-block into lax.while_loop, lax.cond or
lax.scan. The port runs it eagerly: each lowering copies the env at the
op (``ctx.current_env``), binds its carried values and runs the block's
ops through ``ctx.run_ops``, the runner of the top-level block. Tensors
stay on the device they arrive on. A loop or a branch reads its condition
on the host, one synchronisation per iteration or branch: the eager cost
of data-dependent control flow. A scan's step count is a shape, so
``static_rnn`` never synchronises.

``static_rnn`` stacks every step output into a (T, ...) tensor, as
lax.scan does; ``dynamic_decode`` emits every decoder state as a step
output, so the stack holds each KV cache T times (the values must be the
reference's). The stack is allocated once, at the first step, and each
step is copied into it.

``dynamic_rnn`` needs LoD lengths end to end and waits for the sequence
slice.
"""
import torch

from .promotion import promote
from .registry import register_op, single
from .tensor_ops import _jax_index


def _run_block(ctx, idx, env):
    block = ctx.program.block(idx)
    return ctx.run_ops(block, block.ops, env, ctx)


def _truth(t):
    """The host's bool of a one-element condition tensor (a sync)."""
    return bool(t.reshape(()))


@register_op("while")
def _while(ctx, ins, attrs):
    """Run the sub-block while its condition var holds.
    inputs: Condition (the cond var's value), X (carried values, in the
    order of ``carried_names``). Each iteration starts from the env at the
    op with the carried values and the condition bound; only the carried
    values and the condition go on to the next one."""
    carried = attrs["carried_names"]
    cond_name = attrs["cond_name"]
    outer = dict(ctx.current_env)
    state = dict(zip(carried, ins["X"]))
    state[cond_name] = ins["Condition"][0]
    while _truth(state[cond_name]):
        env = dict(outer)
        env.update(state)
        env = _run_block(ctx, attrs["sub_block"], env)
        state = {n: env[n] for n in carried + [cond_name]}
    return {"Out": [state[n] for n in carried]}


@register_op("conditional_block")
def _conditional_block(ctx, ins, attrs):
    """Run the sub-block iff Cond holds; the vars it writes (which exist
    before it, so the untaken branch has values) come out."""
    written = attrs["written_names"]
    if not _truth(ins["Cond"][0]):
        return {"Out": list(ins["X"])}
    env = dict(ctx.current_env)
    env.update(zip(written, ins["X"]))
    env = _run_block(ctx, attrs["sub_block"], env)
    return {"Out": [env[n] for n in written]}


@register_op("cond")
def _cond(ctx, ins, attrs):
    """layers.cond(pred, true_fn, false_fn): run one of the two branch
    blocks on the env at the op; the outputs are its return vars."""
    if _truth(ins["Cond"][0]):
        block, names = attrs["true_block"], attrs["true_out_names"]
    else:
        block, names = attrs["false_block"], attrs["false_out_names"]
    env = _run_block(ctx, block, dict(ctx.current_env))
    return {"Out": [env[n] for n in names]}


@register_op("static_rnn")
def _static_rnn(ctx, ins, attrs):
    """StaticRNN: the step sub-block once per slice of the (T, ...) step
    inputs along axis 0 (once with none), memories carried; the step
    outputs stacked to (T, ...)."""
    mem_names = attrs["mem_names"]
    mem_updated = attrs["mem_updated"]
    x_names = attrs["x_names"]
    out_names = attrs["out_names"]
    outer = dict(ctx.current_env)
    mems = list(ins["Mem"])
    xs = ins["X"]
    steps = xs[0].shape[0] if xs else 1
    stacked = None
    for t in range(steps):
        env = dict(outer)
        env.update(zip(mem_names, mems))
        env.update((n, x[t]) for n, x in zip(x_names, xs))
        env = _run_block(ctx, attrs["sub_block"], env)
        mems = [env[n] for n in mem_updated]
        outs = [env[n] for n in out_names]
        if stacked is None:
            stacked = [o.new_empty((steps,) + tuple(o.shape)) for o in outs]
        for s, o in zip(stacked, outs):
            s[t] = o
    return {"Out": stacked or []}


@register_op("dynamic_rnn")
def _dynamic_rnn(ctx, ins, attrs):
    raise NotImplementedError(
        "op 'dynamic_rnn' (DynamicRNN) is not ported yet: it needs LoD "
        "lengths end to end and comes with the sequence slice of "
        "paddle_tpu_torch (ROADMAP.md Queue 1, item 6.5)")


@register_op("gather_tree")
def _gather_tree(ctx, ins, attrs):
    """Beam-search backtrace (ref operators/gather_tree_op): Ids and
    Parents are (T, B, W); from the last step back, each step's ids are
    read through the parent pointers followed so far. Parents index as
    jax reads an int32 index (a negative one wraps once, then clamped)."""
    ids = ins["Ids"][0]
    parents = ins["Parents"][0].long()
    steps, batch, beam = ids.shape
    rows = torch.arange(batch, device=ids.device)[:, None]
    par = torch.arange(beam, device=ids.device).expand(batch, beam)
    out = torch.empty_like(ids)
    for t in range(steps - 1, -1, -1):
        par = _jax_index(par, beam)
        out[t] = ids[t][rows, par]
        par = parents[t][rows, par]
    return single(out)


@register_op("is_empty")
def _is_empty(ctx, ins, attrs):
    x = ins["X"][0]
    return single(torch.tensor(x.numel() == 0, device=x.device))


@register_op("select_input")
def _select_input(ctx, ins, attrs):
    """X[Mask] of the inputs stacked (promoted by jax's rules), the index
    read as jax reads it."""
    xs = promote(*ins["X"])
    mask = _jax_index(ins["Mask"][0].reshape(1).long(), len(xs))
    return single(torch.stack(xs).index_select(0, mask)[0])


@register_op("select_output")
def _select_output(ctx, ins, attrs):
    return {"Out": [ins["X"][0]]}
