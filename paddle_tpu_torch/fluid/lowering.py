"""Program → torch execution.

Port of paddle_tpu/fluid/lowering.py, forward part. The JAX package traces
a block into one jax function for XLA; here ``run_ops`` walks the block
and calls each op's torch lowering eagerly, on the tensors of the run's
device. The symbolic ``backward`` op (training) is not ported yet and
raises.
"""
import torch

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
            env[n] = v


def apply_op(op, env, ctx):
    fn = get_lowering(op.type)
    ins = resolve_inputs(op, env)
    try:
        outs = fn(ctx, ins, op.attrs)
    except (OpLoweringError, NotImplementedError):
        raise
    except Exception as e:
        raise OpLoweringError(
            "lowering op '%s' failed: %s: %s\n  op: %s\n  defined at:\n%s"
            % (op.type, type(e).__name__, e, op, _format_callstack(op))
        ) from e
    bind_outputs(op, outs, env)
    return env


def run_ops(block, op_list, env, ctx):
    """Run a list of ops in order on `env` (name -> tensor)."""
    for op in op_list:
        if op.type == "backward":
            raise NotImplementedError(
                "the 'backward' op (training) is not ported yet: it comes "
                "with the BERT training slice (torch.autograd in place of "
                "jax.vjp); this slice runs forward programs only")
        env = apply_op(op, env, ctx)
    return env


def persistable_names(program):
    return [v.name for v in program.global_block().vars.values()
            if v.persistable]


def build_step_fn(program, feed_names, fetch_names, device, is_test=False):
    """Return step(state, feeds, generator) -> (fetches, new_state).

    ``state`` / ``feeds`` are dicts name -> tensor on `device` (the
    device random and constant ops create their tensors on);
    ``new_state`` holds every persistable var with a value after the run.
    The ops run eagerly under ``torch.inference_mode()`` when `is_test`
    and under ``torch.no_grad()`` otherwise (no op of this slice needs
    autograd)."""
    block = program.global_block()
    op_list = list(block.ops)
    persist = set(persistable_names(program))
    device = torch.device(device)

    def step(state, feeds, generator=None):
        ctx = LowerContext(device, generator=generator, is_test=is_test)
        env = dict(state)
        env.update(feeds)
        guard = torch.inference_mode() if is_test else torch.no_grad()
        with guard:
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
