"""Program → torch execution.

Port of paddle_tpu/fluid/lowering.py. The JAX package traces a block into
one jax function for XLA; here ``run_ops`` walks the block and calls each
op's torch lowering eagerly, on the tensors of the run's device.

Autodiff: the JAX package lowers each symbolic ``backward`` op by
replaying the preceding region under jax.vjp. The port runs eagerly, so it
records that region once with torch.autograd (``_run_training``), for
every backward op of the block, and calls ``torch.autograd.grad`` at each
op; recompute segments run under torch.utils.checkpoint. Control-flow
sub-blocks run eagerly under the same tape, so autograd reaches through
``cond``, ``conditional_block``, ``static_rnn`` and ``dynamic_rnn``; a
``while`` on the tape raises, as jax.vjp refuses ``lax.while_loop``.

Control flow: a while, cond, static_rnn or dynamic_rnn op runs its
sub-block through ``run_ops`` on a copy of the env at the op
(ops/control_ops.py), as the JAX package traces it into lax.while_loop /
cond / scan.

Liveness: XLA drops what the reference's compiled step computes and never
reads. The port runs eagerly, so :class:`LivePlan` marks, once per
(program, version, fetch names), the ops the fetches need, going backward
from the fetch list through the sub-blocks; every other op is skipped,
and ``static_rnn`` and ``dynamic_rnn`` stack only their live step
outputs. An op that writes a persistable, draws from the run's generator
(:data:`DRAWS`), acts on the host (:data:`HOST_EFFECTS`), has no
outputs, or is a ``backward`` op always runs,
with what it reads.

Data parallel: a program run over a rank group (parallel/sharding.py)
hands ``build_step_fn`` a ``grad_comm`` hook, which ``_run_training``
calls with the global block's raw gradients right after its backward op
and before the optimizer ops read them, as the JAX package's hook sits
between jax.vjp and the update.

Tensor and sequence parallel: a run over a mesh with tp or sp axes, or
with ZeRO-split optimizer state, carries each env value's layout
(``LowerContext.layouts``, parallel/tensor_parallel.py); ``apply_op``
runs the op's layout rule or the fallback, and a gradient takes its
target's layout. The collectives the rules insert are differentiable, so
the one tape needs no gradient rule of its own for tp or sp.
"""
import contextlib
import threading

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from .. import ops as _ops  # noqa: F401  (registers the lowerings)
from ..ops.registry import LowerContext, get_lowering


class OpLoweringError(RuntimeError):
    pass


def _format_callstack(op):
    frames = [
        "    %s:%d in %s" % (f.filename, f.lineno, f.name)
        for f in op.callstack[-3:]
    ]
    return "\n".join(frames) or "    <no callstack>"


def resolve_inputs(op, env):
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n not in env:
                raise OpLoweringError(
                    "op '%s' input %s='%s' has no value. Was the var fed, "
                    "initialized by the startup program, or produced by an "
                    "earlier op?\n  op: %s\n  defined at:\n%s"
                    % (op.type, slot, n, op, _format_callstack(op))
                )
            vals.append(env[n])
        ins[slot] = vals
    return ins


def bind_outputs(op, outs, env):
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        for n, v in zip(names, vals):
            if v is None:           # an output no live op reads
                continue
            if v.requires_grad:     # never with autograd off (serving)
                var = op.block.vars.get(n)
                if var is not None and var.stop_gradient:
                    v = v.detach()
            env[n] = v


def apply_op(op, env, ctx):
    fn = get_lowering(op.type)
    ins = resolve_inputs(op, env)
    # The generic skip gate (the reference's SkipGate, attached to the
    # update ops by dynamic loss scaling): where it reads 0, every output
    # bound to the name of one of the op's inputs (param, moments, beta
    # powers) keeps its old tensor, so the op is a true no-op.
    gate = ins.pop("SkipGate", None)
    ctx.current_env = env  # control-flow ops run their blocks on a copy
    ctx.current_op = op
    layouts = ctx.layouts
    try:
        if layouts is None:
            outs = fn(ctx, ins, op.attrs)
        else:
            outs = _apply_laid_out(op, fn, ins, gate, ctx, layouts)
    except (OpLoweringError, NotImplementedError):
        raise
    except Exception as e:
        raise OpLoweringError(
            "lowering op '%s' failed: %s: %s\n  op: %s\n  defined at:\n%s"
            % (op.type, type(e).__name__, e, op, _format_callstack(op))
        ) from e
    if gate:
        _skip_gate(op, ins, outs, gate[0])
    bind_outputs(op, outs, env)
    return env


def _apply_laid_out(op, fn, ins, gate, ctx, layouts):
    """The op under the run's layouts (parallel/tensor_parallel.py): its
    rule or the fallback; records its outputs' layouts."""
    from ..parallel import tensor_parallel as tpl

    if gate:
        name = op.input("SkipGate")[0]
        gate[0] = tpl.whole(ctx, gate[0], layouts.get(name, tpl.WHOLE),
                            op.type)
    lays = {slot: [layouts.get(n, tpl.WHOLE) for n in op.inputs[slot]]
            for slot in ins}
    outs, out_lays = tpl.run(op.type, fn, ctx, ins, op.attrs, lays)
    for slot, names in op.outputs.items():
        got = out_lays.get(slot, ())
        for i, n in enumerate(names):
            lay = got[i] if i < len(got) else None
            if lay is None or lay.whole:
                layouts.pop(n, None)
            else:
                layouts[n] = lay
    return outs


def _skip_gate(op, ins, outs, gate):
    keep = gate.reshape(()) != 0
    old = {n: v for slot, names in op.inputs.items() if slot != "SkipGate"
           for n, v in zip(names, ins.get(slot, []))}
    for slot, names in op.outputs.items():
        vals = outs.get(slot)
        if vals is None:
            continue
        outs[slot] = [torch.where(keep, v, old[n]) if n in old else v
                      for n, v in zip(names, vals)]


def run_ops(block, op_list, env, ctx):
    """Run a list of ops in order on `env` (name -> tensor). A list with a
    ``backward`` op trains (:func:`_run_training`)."""
    if any(op.type == "backward" for op in op_list):
        return _run_training(op_list, env, ctx)
    for op in op_list:
        env = apply_op(op, env, ctx)
    return env


def _run_training(op_list, env, ctx):
    """The ``backward`` ops of a block on one torch.autograd tape.

    Every target of any backward op that is bound at program start becomes
    one fresh leaf (the tensors the caller holds are never marked), as the
    JAX package's jax.vjp primals; the ops up to the last backward op run
    under enable_grad, once. At each backward op, torch.autograd.grad with
    the seed ``InitGrad`` (ones by default) gives the gradient of each
    target, zeros where the loss does not reach it, and the tape is kept
    until the last backward op. A target produced inside the region is
    differentiated at the value its last writer left (a fresh leaf there
    if nothing before it is differentiable). An earlier backward op's
    ``Grads`` are constants to a later one, unless the later one targets
    them: then they are fresh leaves. A var in a backward op's
    ``no_grad`` set is a constant to that backward op from where it is
    produced (:func:`_stop_gradient`).

    Recompute: the checkpoint vars of the backward ops cut the ops before
    the first backward op into segments (:func:`segment_cuts`), and each
    segment but the last runs under ``torch.utils.checkpoint``, so autograd
    keeps its inputs only and replays it in the backward pass. Across a
    cut the env keeps only what a later op reads, a fetch or a persistable
    (:func:`_needed_after`); a replay draws what the first pass drew
    (:func:`_segment`).

    The ops after the last backward op (the optimizer's) run under
    no_grad, and the env comes back detached, so no graph outlives the
    run. The three phases are profiler ranges
    (``paddle_tpu_torch::forward``, ``::backward``, ``::optimizer``)."""
    at = [i for i, op in enumerate(op_list) if op.type == "backward"]
    env = dict(env)
    start = set(env)
    leaves, later_targets = {}, set()
    stop_at = _stop_gradient(op_list, at, start)
    for i in at:
        before = producer_map(op_list[:i])
        for n in op_list[i].attrs["targets"]:
            if n in start:
                if n not in leaves:
                    leaves[n] = env[n] = env[n].detach().requires_grad_()
            elif n not in before:
                raise OpLoweringError(
                    "backward target '%s' is neither a parameter/feed/state "
                    "var nor produced before the backward op" % n)
            elif op_list[before[n]].type == "backward":
                later_targets.add(n)
            else:   # differentiable where it is produced, even from consts
                stop_at.setdefault(before[n], []).append((n, _TARGET))
    state = [None]      # the backward op running, for _ConstFor
    first = at[0]
    cuts = segment_cuts(op_list[:first], [
        c for i in at for c in (op_list[i].attrs.get("checkpoints") or ())
        if c])
    lo = 0
    with torch.enable_grad():
        with record_function("paddle_tpu_torch::forward"):
            if cuts:
                needed = _needed_after(op_list, cuts, ctx)
                for cut in cuts:
                    # a replay runs its segment whole (an early stop would
                    # surface inside an op's lowering as an error)
                    with set_checkpoint_early_stop(False):
                        env = checkpoint(
                            _segment(op_list, lo, cut + 1, needed[cut], ctx,
                                     stop_at, state, env),
                            use_reentrant=False, preserve_rng_state=False)
                    lo = cut + 1
            env = _run_span(op_list, lo, first, env, ctx, stop_at, state)
        for k, idx in enumerate(at):
            bw_op = op_list[idx]
            if k:
                with record_function("paddle_tpu_torch::forward"):
                    env = _run_span(op_list, at[k - 1] + 1, idx, env, ctx,
                                    stop_at, state)
            with record_function("paddle_tpu_torch::backward"):
                loss = env[bw_op.input("Loss")[0]]
                init = bw_op.input("InitGrad")
                seed = (env[init[0]].detach().to(loss.dtype).expand_as(loss)
                        if init else torch.ones_like(loss))
                state[0] = idx
                grads = _grads(loss, [leaves.get(n, env[n]) for n in
                                      bw_op.attrs["targets"]],
                               seed, retain=idx != at[-1])
            grad_names = bw_op.output("Grads")
            if ctx.layouts is not None:     # a gradient lies as its target
                for t, n in zip(bw_op.attrs["targets"], grad_names):
                    lay = ctx.layouts.get(t)
                    if lay is None:
                        ctx.layouts.pop(n, None)
                    else:
                        ctx.layouts[n] = lay
            # the data-parallel gradient hook (module docstring)
            gc = getattr(ctx, "grad_comm", None)
            if gc is not None and bw_op.block.idx == 0:
                synced = gc(dict(zip(grad_names, grads)))
                grads = [synced.get(n, g) for n, g in zip(grad_names, grads)]
                for n, lay in getattr(gc, "grad_layouts", {}).items():
                    if n in synced:
                        ctx.layouts[n] = lay
            for n, g in zip(grad_names, grads):
                env[n] = g.requires_grad_() if n in later_targets else g
    with torch.no_grad(), record_function("paddle_tpu_torch::optimizer"):
        for op in op_list[at[-1] + 1:]:
            env = apply_op(op, env, ctx)
    return {n: v.detach() for n, v in env.items()}


# a backward op's target produced in the region: made differentiable where
# its last writer before that op produces it (a leaf if nothing before it
# is), as the JAX package's zero probe
_TARGET = object()


def _run_span(op_list, lo, hi, env, ctx, stop_at, state):
    """Ops lo..hi-1 of `op_list` on `env`, each no_grad var made a
    constant and each produced target differentiable where it is
    produced."""
    for j in range(lo, hi):
        env = apply_op(op_list[j], env, ctx)
        for n, which in stop_at.get(j, ()):
            if which is _TARGET:
                if not env[n].requires_grad:
                    env[n] = env[n].detach().requires_grad_()
            elif which is None:
                env[n] = env[n].detach()
            else:
                env[n] = _ConstFor.apply(env[n], which, state)
    return env


def _segment(op_list, lo, hi, live, ctx, stop_at, state, env):
    """The function torch.utils.checkpoint runs for ops lo..hi-1: on a copy
    of `env`, returning the names in `live`. The env is held here, not
    passed through checkpoint, which would walk its every tensor on each
    call and replay. The replay in the backward pass sets the run's
    generators (:meth:`LowerContext.rng_states`) to the states they had
    when the first pass began, so every dropout mask and kernel seed is
    drawn again as it was, and puts back their states afterwards; what
    the replay computes is discarded except what autograd saved, so a
    persistable (the step counter) is written once."""
    drawn = []

    def run():
        replay = bool(drawn)
        if replay:
            now = ctx.rng_states()
            ctx.set_rng_states(drawn[0])
        else:
            drawn.append(ctx.rng_states())
        try:
            out = _run_span(op_list, lo, hi, dict(env), ctx, stop_at, state)
        finally:
            if replay:
                ctx.set_rng_states(now)
        return {n: v for n, v in out.items() if n in live}

    return run


class _ConstFor(torch.autograd.Function):
    """Identity whose gradient is zero while one of the backward ops at
    `which` runs (``state[0]``): a no_grad var of some, not all, of the
    backward ops that reach it."""

    @staticmethod
    def forward(ctx, x, which, state):
        ctx.which, ctx.state = which, state
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (None if ctx.state[0] in ctx.which else g), None, None


def _stop_gradient(op_list, at, start):
    """op index -> [(name, None or backward op indices)]: each var a
    backward op lists in ``no_grad`` at the op before it that last writes
    it (a var bound at program start is a constant unless it is a target).
    None: every backward op after that op lists it, and it is detached;
    else a :class:`_ConstFor` stops it for the listed ones only."""
    lists = {}
    for i in at:
        before = producer_map(op_list[:i])
        for n in op_list[i].attrs.get("no_grad") or ():
            if n in before and n not in start:
                lists.setdefault((before[n], n), set()).add(i)
    stop = {}
    for (j, n), which in lists.items():
        every = len(which) == sum(i > j for i in at)
        stop.setdefault(j, []).append((n, None if every else
                                       frozenset(which)))
    return stop


def _needed_after(op_list, cuts, ctx):
    """cut index -> the names read after that op: by a later op (its
    sub-blocks' reads and a backward op's targets included), a fetch, or
    a persistable (``ctx.keep_names``)."""
    need, at = set(ctx.keep_names), set(cuts)
    needed = {}
    for j in range(len(op_list) - 1, cuts[0] - 1, -1):
        if j in at:
            needed[j] = set(need)
        need |= op_read_names(op_list[j])
    return needed


def op_read_names(op):
    """Every name an op may read: its inputs, a backward op's targets, and
    the outer names its sub-blocks' ops read before writing them."""
    names = set(op.input_arg_names)
    if op.type == "backward":
        names.update(op.attrs.get("targets", ()))
    for blk in _sub_blocks(op):
        produced = set()
        for sop in blk.ops:
            names |= op_read_names(sop) - produced
            produced.update(sop.output_arg_names)
    return names


def segment_cuts(region, cut_var_names):
    """Indices of the ops ending a segment: each cut var's producing op
    closes its segment; a cut at the region's last op is dropped."""
    produce = producer_map(region)
    cuts = sorted({produce[c] for c in cut_var_names if c in produce})
    if cuts and cuts[-1] == len(region) - 1:
        cuts = cuts[:-1]
    return cuts


# the attrs by which an op names the blocks it runs (while, static_rnn,
# conditional_block: sub_block; cond: true_block and false_block)
_BLOCK_ATTRS = ("sub_block", "true_block", "false_block")


def _grads(loss, inputs, seed, retain=False):
    """d loss / d input for each of `inputs`, zeros where loss does not
    depend on it; `retain` keeps the tape for a later backward op."""
    live = [i for i, t in enumerate(inputs) if t.requires_grad]
    got = [None] * len(inputs)
    if live and loss.requires_grad:
        for i, g in zip(live, torch.autograd.grad(
                loss, [inputs[i] for i in live], grad_outputs=seed,
                allow_unused=True, retain_graph=retain)):
            got[i] = g
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(inputs, got)]


def producer_map(region):
    """name -> index of the op producing it (last writer wins)."""
    produce = {}
    for j, rop in enumerate(region):
        for names in rop.outputs.values():
            for n in names:
                produce[n] = j
    return produce


def persistable_names(program):
    return [v.name for v in program.global_block().vars.values()
            if v.persistable]


_precision_lock = threading.Lock()
_precision_depth = [0, None]      # runs inside, the caller's settings


def precision_switches():
    """The process-wide switches a run on the card sets, as (namespace,
    attribute, value) triples: cuBLAS's reduced-precision bf16 and fp16
    split-K sums off, and TF32 off for f32 matrix products and for cuDNN's
    f32 convolutions (torch's default, ``cudnn.allow_tf32 = True``, rounds
    a convolution's f32 inputs to 10-bit mantissas). TF32 goes off through
    ``fp32_precision = "ieee"``: reading the legacy ``allow_tf32`` raises
    once a caller has set the two apart."""
    matmul = torch.backends.cuda.matmul
    return [(matmul, "allow_bf16_reduced_precision_reduction", False),
            (matmul, "allow_fp16_reduced_precision_reduction", False),
            (matmul, "fp32_precision", "ieee"),
            (torch.backends.cudnn.conv, "fp32_precision", "ieee")]


@contextlib.contextmanager
def f32_precision():
    """While a program runs on the card, its products compute as the
    reference's do on the TPU and as the port's do on the CPU: bfloat16
    and float16 products sum in f32 (XLA's bf16 dot accumulates in f32),
    and f32 products and convolutions take their f32 inputs whole, not
    rounded to TF32 (:func:`precision_switches`). The switches are
    process-wide: they are set when the first run enters and restored to
    the caller's values when the last concurrent run leaves, so a
    caller's own work between runs sees its own settings, and that on
    other threads during a run sees the run's."""
    with _precision_lock:
        if _precision_depth[0] == 0:
            switches = precision_switches()
            _precision_depth[1] = [(ns, attr, getattr(ns, attr))
                                   for ns, attr, _ in switches]
            for ns, attr, value in switches:
                setattr(ns, attr, value)
        _precision_depth[0] += 1
    try:
        yield
    finally:
        with _precision_lock:
            _precision_depth[0] -= 1
            if _precision_depth[0] == 0:
                for ns, attr, value in _precision_depth[1]:
                    setattr(ns, attr, value)


# op types whose lowering draws from the run's generator (``next_rng`` or
# ``next_seed``): they run whether or not anything reads them, so that a
# later draw is the one the unpruned run makes
DRAWS = frozenset({"dropout", "uniform_random", "gaussian_random",
                   "sampling_id", "fused_multihead_attention", "dpsgd",
                   "nce", "sampled_softmax_with_cross_entropy",
                   "uniform_random_batch_size_like",
                   "gaussian_random_batch_size_like",
                   "truncated_gaussian_random", "randint", "randperm",
                   "multinomial", "random_crop"})
# op types that act on the host (print a tensor, call a Python function):
# they run whether or not anything reads them, as their effect is the point
HOST_EFFECTS = frozenset({"print", "py_func"})


def _sub_blocks(op):
    return [op.block.program.block(op.attrs[a]) for a in _BLOCK_ATTRS
            if a in op.attrs]


class LivePlan:
    """The ops a run that fetches `fetch_names` executes, block by block.

    ``ops[idx]`` lists block idx's live ops in program order; ``rnn[id(op)]``
    holds a live ``static_rnn``'s or ``dynamic_rnn``'s live output positions
    and carried memory positions. An op is live when a later live op, a
    fetch or its block's outputs read what it writes, or when it has an
    effect (:meth:`has_effect`). A control-flow op reads its inputs and
    what its sub-blocks' live ops read from the outer env."""

    def __init__(self, program, fetch_names):
        self._persist = set(v.name for v in program.list_vars()
                            if v.persistable)
        self._effect = {}
        self.ops = {}
        self.rnn = {}
        self.ops[0], _ = self._block(program.global_block(),
                                     set(fetch_names))

    def has_effect(self, op):
        """Writes a persistable, draws, has no outputs, is a ``backward``
        op, or holds such an op in a sub-block."""
        hit = self._effect.get(id(op))
        if hit is None:
            outs = op.output_arg_names
            hit = self._effect[id(op)] = bool(
                op.type == "backward" or op.type in DRAWS
                or op.type in HOST_EFFECTS or not outs
                or any(n in self._persist for n in outs)
                or any(self.has_effect(s) for b in _sub_blocks(op)
                       for s in b.ops))
        return hit

    def _block(self, block, seeds):
        """(the live ops of `block` when `seeds` must hold their values at
        its end, the names those ops read before the block writes them)."""
        needed = set(seeds)
        live = []
        for op in reversed(block.ops):
            if not (self.has_effect(op)
                    or any(n in needed for n in op.output_arg_names)):
                continue
            reads = self._reads(op, needed)
            needed.difference_update(op.output_arg_names)
            needed.update(reads)
            live.append(op)
        live.reverse()
        return live, needed

    def _reads(self, op, needed):
        reads = set(op.input_arg_names)
        if op.type == "backward":
            reads.update(op.attrs.get("targets", ()))
        a = op.attrs
        if op.type in ("static_rnn", "dynamic_rnn"):
            sub = op.block.program.block(a["sub_block"])
            outs = {i for i, n in enumerate(op.output("Out")) if n in needed}
            mems = set()
            while True:     # a memory is live when a live op reads it
                live, free = self._block(
                    sub, {a["out_names"][i] for i in outs}
                    | {a["mem_updated"][j] for j in mems})
                more = {j for j, n in enumerate(a["mem_names"])
                        if n in free} - mems
                if not more:
                    break
                mems |= more
            self.ops[sub.idx] = live
            self.rnn[id(op)] = (outs, mems)
            return reads | free
        if op.type == "while":
            seeds = {a["sub_block"]: set(a["carried_names"])
                     | {a["cond_name"]}}
        elif op.type == "conditional_block":
            seeds = {a["sub_block"]: set(a["written_names"])}
        elif op.type == "cond":
            seeds = {a["true_block"]: set(a["true_out_names"]),
                     a["false_block"]: set(a["false_out_names"])}
        else:       # any other block runs whole
            seeds = {b.idx: {n for o in b.ops for n in o.output_arg_names}
                     for b in _sub_blocks(op)}
        for idx, names in seeds.items():
            self.ops[idx], free = self._block(op.block.program.block(idx),
                                              names)
            reads |= free
        return reads


def live_plan(program, fetch_names):
    """The program's :class:`LivePlan` for `fetch_names`, made once per
    program version and kept on the program."""
    cache = getattr(program, "_live_plans", None)
    if cache is None or cache[0] != program._version:
        cache = program._live_plans = (program._version, {})
    key = tuple(fetch_names)
    plan = cache[1].get(key)
    if plan is None:
        plan = cache[1][key] = LivePlan(program, fetch_names)
    return plan


def build_step_fn(program, feed_names, fetch_names, device, is_test=False,
                  grad_comm=None, mesh_axes=None, mesh=None,
                  batch_stats_group=None, layouts=None, groups=None):
    """Return step(state, feeds, generator, shared_generator) ->
    (fetches, new_state).

    ``state`` / ``feeds`` are dicts name -> tensor on `device` (the
    device random and constant ops create their tensors on);
    ``new_state`` holds every persistable var with a value after the run.
    The ops run eagerly under ``torch.inference_mode()`` when `is_test`
    and under ``torch.no_grad()`` otherwise; a ``backward`` op turns
    autograd on for the region it differentiates (:func:`run_ops`). On
    the card they run under :func:`f32_precision`.
    Only the ops of :func:`live_plan` run.

    Data parallel (paddle_tpu_torch/parallel): ``grad_comm`` is a callable
    ``{grad_name: tensor} -> {grad_name: tensor}`` that the global block's
    backward op hands its raw gradients to before the optimizer ops read
    them (:func:`_run_training`); ``mesh_axes`` and ``mesh`` bind the
    collective ops' rings to the rank group; ``batch_stats_group`` is the
    group ``batch_norm`` takes its training statistics over; and
    ``shared_generator`` draws what every rank draws alike
    (:class:`~paddle_tpu_torch.ops.registry.LowerContext`).

    Tensor and sequence parallel: ``layouts`` (name -> Layout, the
    state's and the feeds' that are split) turns the run's layouts on,
    and ``groups`` maps each mesh axis of more than one rank to this
    rank's line along it. The step then keeps the layouts of its env's
    values after the run in ``step.layouts``, for the caller to make its
    fetches and state global."""
    block = program.global_block()
    plan = live_plan(program, fetch_names)      # None: every op runs
    op_list = list(block.ops) if plan is None else plan.ops[0]
    persist = set(persistable_names(program))
    keep = persist | set(fetch_names)
    device = torch.device(device)

    def step(state, feeds, generator=None, shared_generator=None):
        ctx = LowerContext(device, generator=generator, is_test=is_test,
                           program=program, run_ops=run_ops, plan=plan,
                           mesh_axes=mesh_axes, mesh=mesh,
                           shared_generator=shared_generator)
        ctx.keep_names = keep
        ctx.grad_comm = grad_comm
        ctx.batch_stats_group = batch_stats_group
        if layouts is not None:
            ctx.layouts = dict(layouts)
            ctx.groups = dict(groups or {})
            ctx.split_axes = tuple(a for a in ctx.groups if a != "dp")
        env = dict(state)
        env.update(feeds)
        guard = torch.inference_mode() if is_test else torch.no_grad()
        sums = (f32_precision() if device.type == "cuda"
                else contextlib.nullcontext())
        with guard, sums:
            env = run_ops(block, op_list, env, ctx)
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise OpLoweringError(
                "fetch vars %s were never computed by the program" % missing
            )
        fetches = [env[n] for n in fetch_names]
        new_state = {n: env[n] for n in persist if n in env}
        step.layouts = ctx.layouts
        return fetches, new_state

    return step
