"""Op lowering registry.

Port of paddle_tpu/ops/registry.py. Each op type maps to ONE lowering
function written in torch; the executor calls them eagerly, op by op.

Lowering signature::

    def lower(ctx, ins, attrs) -> {output_slot: [torch tensors]}

``ins`` maps input slot -> list of tensors (missing optional slots are
empty lists). ``ctx`` is a LowerContext carrying the run's device, its
random generator and train/test mode, and for the control-flow ops the
program, the env at the op and the runner of a block.
"""
import torch

LOWERINGS = {}


def register_op(name):
    def deco(fn):
        if name in LOWERINGS:
            raise ValueError("op %s registered twice" % name)
        LOWERINGS[name] = fn
        return fn

    return deco


def get_lowering(op_type):
    fn = LOWERINGS.get(op_type)
    if fn is None:
        raise NotImplementedError(
            "op '%s' has no torch lowering yet: paddle_tpu_torch ports "
            "paddle_tpu slice by slice and this slice covers %d ops (%s); "
            "see ROADMAP.md for the slice that brings it"
            % (op_type, len(LOWERINGS), ", ".join(sorted(LOWERINGS)))
        )
    return fn


class LowerContext:
    """Run-time state handed to every lowering of one program run.

    ``generator`` is the ``torch.Generator`` random ops draw from (on
    ``device``); the JAX package threads a PRNG key instead, so the
    values drawn differ between the packages — parity tests copy
    parameters across rather than re-drawing them. A random op inside a
    loop body draws fresh values every iteration by itself (jax folds an
    iteration token into its key for that).

    The control-flow lowerings (ops/control_ops.py) run their sub-blocks
    through ``run_ops(block, ops, env, ctx)`` on a copy of
    ``current_env``, the env as it stands when the op runs (set by
    ``fluid/lowering.py`` ``apply_op`` with ``current_op``): a sub-block
    reads the outer block's values, the parameters among them, by name.
    ``plan``, the run's ``fluid/lowering.py`` ``LivePlan`` (None: every
    op is live), says which ops of a block run (:meth:`live_ops`) and
    which outputs and memories a ``static_rnn`` keeps (:meth:`rnn_live`).
    """

    def __init__(self, device, generator=None, is_test=False, program=None,
                 run_ops=None, plan=None):
        self.device = device
        self._generator = generator
        self._seed_generator = None
        self.is_test = is_test
        self.program = program
        self.run_ops = run_ops
        self.plan = plan
        self.current_env = None
        self.current_op = None
        self._constants = {}

    def live_ops(self, block):
        """The ops of `block` this run executes, in order."""
        if self.plan is None:
            return block.ops
        return self.plan.ops.get(block.idx, block.ops)

    def rnn_live(self, n_out, n_mem):
        """(live output positions, live memory positions) of the
        ``static_rnn`` op being lowered."""
        got = None if self.plan is None else self.plan.rnn.get(
            id(self.current_op))
        return got or (set(range(n_out)), set(range(n_mem)))

    def constant(self, key, make):
        """``make()``'s tensor, made once a run for the object `key` (an op's
        attr): a constant op inside a loop body runs every iteration."""
        hit = self._constants.get(id(key))
        if hit is None or hit[0] is not key:
            hit = self._constants[id(key)] = (key, make())
        return hit[1]

    def next_rng(self):
        """The generator random draws come from; raises if the run has
        none (a random op in a program run without one)."""
        if self._generator is None:
            raise RuntimeError(
                "op requires randomness but the run has no torch.Generator"
            )
        return self._generator

    def next_seed(self):
        """An int32 seed for a kernel that makes its own random bits (the
        flash-attention dropout hash). It is drawn on the host, from a CPU
        generator seeded like the run's generator, so a draw never waits
        for the device."""
        if self._seed_generator is None:
            self._seed_generator = torch.Generator()
            self._seed_generator.manual_seed(self.next_rng().initial_seed())
        return int(torch.randint(0, 2 ** 31 - 1, (1,),
                                 generator=self._seed_generator))


def single(val):
    """Helper: wrap a single output value for the conventional 'Out' slot."""
    return {"Out": [val]}
