"""Control-flow op lowerings: while, conditional_block, cond, static_rnn,
dynamic_rnn, gather_tree, is_empty, select_input, select_output (port of
paddle_tpu/ops/control_ops.py).

The JAX package traces a sub-block into lax.while_loop, lax.cond or
lax.scan. The port runs it eagerly: each lowering copies the env at the
op (``ctx.current_env``), binds its carried values and runs the block's
ops through ``ctx.run_ops``, the runner of the top-level block. Tensors
stay on the device they arrive on. A loop or a branch reads its condition
on the host, one synchronisation per iteration or branch: the eager cost
of data-dependent control flow. A scan's step count is a shape, so
``static_rnn`` never synchronises.

``static_rnn`` stacks its step outputs into (T, ...) tensors, as lax.scan
does, but only those the run reads (``ctx.rnn_live``, from the run's
liveness plan; XLA drops the rest of the reference's scan): under
``dynamic_decode``, which emits every decoder state as a step output, the
KV caches are carried and never stacked. Each live stack is allocated
once, at the first step, and each step is copied into it. A block runs
its live ops only (``ctx.live_ops``).

In a training run the sub-blocks run under the forward region's
autograd tape, so a ``backward`` op differentiates through ``cond``,
``conditional_block``, ``static_rnn`` and ``dynamic_rnn``; a ``while``
whose carried values hold a gradient raises, as the JAX package's jax.vjp
refuses ``lax.while_loop`` in reverse mode.

``dynamic_rnn`` (DynamicRNN) walks the time axis of batch-major (B, T, ...)
step inputs, every step over the whole batch: past a row's ``SeqLen`` its
memories hold and its step outputs are zero, as the JAX package's masked
lax.scan gives them (the reference shrinks the batch instead). Its step
outputs are collected in a list and stacked once, so autograd reaches
through every step.
"""
import torch

from .promotion import promote
from .registry import register_op, single
from .sequence_ops import _lens
from .tensor_ops import _jax_index


def _run_block(ctx, idx, env):
    block = ctx.program.block(idx)
    return ctx.run_ops(block, ctx.live_ops(block), env, ctx)


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
    if any(state[n].requires_grad for n in carried):
        raise NotImplementedError(
            "autograd through a 'while' op: a backward op's region carries "
            "a gradient through the loop, and the reference cannot "
            "differentiate 'while' either (jax.vjp refuses lax.while_loop "
            "in reverse mode)")
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
    inputs along axis 0 (once with none), the live memories carried; the
    live step outputs stacked to (T, ...), None in a dead output's place."""
    mem_names = attrs["mem_names"]
    mem_updated = attrs["mem_updated"]
    x_names = attrs["x_names"]
    out_names = attrs["out_names"]
    live_out, live_mem = ctx.rnn_live(len(out_names), len(mem_names))
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
        mems = [env[n] if j in live_mem else m
                for j, (n, m) in enumerate(zip(mem_updated, mems))]
        if stacked is None:
            stacked = [None] * len(out_names)
            for i in live_out:
                o = env[out_names[i]]
                stacked[i] = o.new_empty((steps,) + tuple(o.shape))
        for i in live_out:
            stacked[i][t] = env[out_names[i]]
    return {"Out": stacked or []}


@register_op("dynamic_rnn")
def _dynamic_rnn(ctx, ins, attrs):
    """DynamicRNN: the step sub-block once per step of the (B, T, ...)
    step inputs, the live memories carried. A row whose step t is at or
    past its length keeps its memories (a select) and gives zeros (a
    product with the 0/1 mask, so a non-finite value there stays
    non-finite, as in the JAX package). The live step outputs come out
    stacked to (B, T, ...), None in a dead output's place."""
    mem_names = attrs["mem_names"]
    mem_updated = attrs["mem_updated"]
    x_names = attrs["x_names"]
    out_names = attrs["out_names"]
    live_out, live_mem = ctx.rnn_live(len(out_names), len(mem_names))
    outer = dict(ctx.current_env)
    mems = list(ins["Mem"])
    xs = ins["X"]
    batch, steps = xs[0].shape[0], xs[0].shape[1]
    lens = _lens(ins, xs[0])
    seqs = [[] for _ in out_names]
    for t in range(steps):
        env = dict(outer)
        env.update(zip(mem_names, mems))
        env.update((n, x[:, t]) for n, x in zip(x_names, xs))
        env = _run_block(ctx, attrs["sub_block"], env)
        alive = t < lens

        def mask(v):
            return alive.to(v.dtype).reshape((batch,) + (1,) * (v.dim() - 1))

        mems = [torch.where(mask(env[n]) > 0, env[n], m) if j in live_mem
                else m for j, (n, m) in enumerate(zip(mem_updated, mems))]
        for i in live_out:
            o = env[out_names[i]]
            seqs[i].append(o * mask(o))
    return {"Out": [torch.stack(seqs[i], dim=1) if i in live_out else None
                    for i in range(len(out_names))]}


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
