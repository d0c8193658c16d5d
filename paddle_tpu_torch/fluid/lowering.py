"""Program → torch execution.

Port of paddle_tpu/fluid/lowering.py. The JAX package traces a block into
one jax function for XLA; here ``run_ops`` walks the block and calls each
op's torch lowering eagerly, on the tensors of the run's device.

Autodiff: the JAX package lowers the symbolic ``backward`` op by replaying
the preceding region under jax.vjp. The port runs eagerly, so it records
that region once with torch.autograd (``_run_training``) and calls
``torch.autograd.grad`` at the op.

Control flow: a while, cond or static_rnn op runs its sub-block through
``run_ops`` on a copy of the env at the op (ops/control_ops.py), as the
JAX package traces it into lax.while_loop / cond / scan.

Liveness: XLA drops what the reference's compiled step computes and never
reads. The port runs eagerly, so :class:`LivePlan` marks, once per
(program, version, fetch names), the ops the fetches need, going backward
from the fetch list through the sub-blocks; every other op is skipped,
and ``static_rnn`` stacks only its live step outputs. An op that writes
a persistable, draws from the run's generator (:data:`DRAWS`), has no
outputs, or is a ``backward`` op always runs, with what it reads.
"""
import contextlib
import threading

import torch
from torch.profiler import record_function

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
    try:
        outs = fn(ctx, ins, op.attrs)
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


def _later_slice(what):
    return NotImplementedError(
        "%s is not ported yet: it comes with a later training slice of "
        "paddle_tpu_torch (ROADMAP.md, Queue 1)" % what)


def _run_training(op_list, env, ctx):
    """One ``backward`` op on torch.autograd. Every target bound at program
    start becomes a fresh leaf (the tensors the caller holds are never
    marked); the ops before the backward op run under enable_grad; the op
    calls torch.autograd.grad with the seed ``InitGrad`` (ones by
    default), and a target the loss does not reach gets zeros, as jax.vjp
    gives. A target produced inside the region is differentiated at the
    value its last writer left. The ops after it (the optimizer's) run
    under no_grad, and the env comes back detached, so no graph outlives
    the run. The three phases are profiler ranges
    (``paddle_tpu_torch::forward``, ``::backward``, ``::optimizer``)."""
    at = [i for i, op in enumerate(op_list) if op.type == "backward"]
    if len(at) > 1:
        raise _later_slice("a second 'backward' op in one block")
    idx = at[0]
    bw_op = op_list[idx]
    if any(bw_op.attrs.get("checkpoints") or ()):
        raise _later_slice("recompute (the backward op's 'checkpoints')")
    region = op_list[:idx]
    for op in region:
        if any(a in op.attrs for a in _BLOCK_ATTRS):
            raise _later_slice(
                "autograd through a control-flow op ('%s' before the "
                "'backward' op)" % op.type)
    targets = bw_op.attrs["targets"]
    env = dict(env)
    producer = producer_map(region)
    leaves = {}  # targets bound at program start, as jax.vjp's primals
    for n in targets:
        if n in env:
            leaves[n] = env[n] = env[n].detach().requires_grad_()
        elif n not in producer:
            raise OpLoweringError(
                "backward target '%s' is neither a parameter/feed/state var "
                "nor produced before the backward op" % n)
    # no_grad_set vars produced in the region are constants from there on
    stop_at = {}
    for n in bw_op.attrs.get("no_grad", ()) or ():
        if n in producer and n not in env:
            stop_at.setdefault(producer[n], []).append(n)
    with torch.enable_grad():
        with record_function("paddle_tpu_torch::forward"):
            for j, op in enumerate(region):
                env = apply_op(op, env, ctx)
                for n in stop_at.get(j, ()):
                    env[n] = env[n].detach()
        with record_function("paddle_tpu_torch::backward"):
            loss = env[bw_op.input("Loss")[0]]
            init = bw_op.input("InitGrad")
            seed = (env[init[0]].detach().to(loss.dtype).expand_as(loss)
                    if init else torch.ones_like(loss))
            grads = _grads(loss, [leaves[n] if n in leaves else env[n]
                                  for n in targets], seed)
    for n, g in zip(bw_op.output("Grads"), grads):
        env[n] = g
    with torch.no_grad(), record_function("paddle_tpu_torch::optimizer"):
        for op in op_list[idx + 1:]:
            env = apply_op(op, env, ctx)
    return {n: v.detach() for n, v in env.items()}


# the attrs by which an op names the blocks it runs (while, static_rnn,
# conditional_block: sub_block; cond: true_block and false_block)
_BLOCK_ATTRS = ("sub_block", "true_block", "false_block")


def _grads(loss, inputs, seed):
    """d loss / d input for each of `inputs`, zeros where loss does not
    depend on it."""
    live = [i for i, t in enumerate(inputs) if t.requires_grad]
    got = [None] * len(inputs)
    if live and loss.requires_grad:
        for i, g in zip(live, torch.autograd.grad(
                loss, [inputs[i] for i in live], grad_outputs=seed,
                allow_unused=True)):
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
                   "sampling_id", "fused_multihead_attention"})


def _sub_blocks(op):
    return [op.block.program.block(op.attrs[a]) for a in _BLOCK_ATTRS
            if a in op.attrs]


class LivePlan:
    """The ops a run that fetches `fetch_names` executes, block by block.

    ``ops[idx]`` lists block idx's live ops in program order; ``rnn[id(op)]``
    holds a live ``static_rnn``'s live output positions and carried memory
    positions. An op is live when a later live op, a fetch or its block's
    outputs read what it writes, or when it has an effect
    (:meth:`has_effect`). A control-flow op reads its inputs and what its
    sub-blocks' live ops read from the outer env."""

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
                op.type == "backward" or op.type in DRAWS or not outs
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
        if op.type == "static_rnn":
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
                  grad_comm=None):
    """Return step(state, feeds, generator) -> (fetches, new_state).

    ``state`` / ``feeds`` are dicts name -> tensor on `device` (the
    device random and constant ops create their tensors on);
    ``new_state`` holds every persistable var with a value after the run.
    The ops run eagerly under ``torch.inference_mode()`` when `is_test`
    and under ``torch.no_grad()`` otherwise; a ``backward`` op turns
    autograd on for the region it differentiates (:func:`run_ops`). On
    the card they run under :func:`f32_precision`.
    Only the ops of :func:`live_plan` run.
    ``grad_comm``, the JAX package's gradient-communication hook, waits for
    the port's parallel slice."""
    if grad_comm is not None:
        raise NotImplementedError(
            "the gradient-communication hook (grad_comm) is not ported yet: "
            "it comes with the parallel slice of paddle_tpu_torch "
            "(ROADMAP.md, Queue 1)")
    block = program.global_block()
    plan = live_plan(program, fetch_names)      # None: every op runs
    op_list = list(block.ops) if plan is None else plan.ops[0]
    persist = set(persistable_names(program))
    device = torch.device(device)

    def step(state, feeds, generator=None):
        ctx = LowerContext(device, generator=generator, is_test=is_test,
                           program=program, run_ops=run_ops, plan=plan)
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
        return fetches, new_state

    return step
