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


# op type -> its layout rule under tensor and sequence parallelism, and the
# op types whose rule runs with whole inputs too (parallel/tensor_parallel.py)
LAYOUT_RULES = {}
ACTIVE_RULES = set()


def register_layout_rule(*op_types, active=False):
    """Register ``rule(ctx, ins, attrs, lays) -> (outs, out_lays) or None``
    for `op_types` (parallel/tensor_parallel.py ``run``). ``lays`` maps
    each input slot to its values' layouts, ``out_lays`` each output slot
    to its values' (a missing slot is whole); None means the rule does not
    fit and the op takes the fallback. `active`: the rule runs with whole
    inputs too, whenever the run has a tp or sp axis."""
    def deco(fn):
        for t in op_types:
            if t in LAYOUT_RULES:
                raise ValueError("layout rule for %s registered twice" % t)
            LAYOUT_RULES[t] = fn
            if active:
                ACTIVE_RULES.add(t)
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
    which outputs and memories a ``static_rnn`` or ``dynamic_rnn`` keeps
    (:meth:`rnn_live`).
    ``keep_names``, the run's fetches and persistables, stay live across
    a recompute segment's end.

    Data parallel (paddle_tpu_torch/parallel): ``mesh_axes`` maps a
    collective op's ``ring_id`` (or ``"collective"``) to a mesh axis, as
    the JAX package's lowering context does, and ``mesh`` is the rank
    group whose axis that is; a collective with no axis bound is the
    identity. ``batch_stats_group``, when set, is the group over which
    ``batch_norm`` takes its batch statistics (the global batch's, as
    GSPMD gives them in the JAX package). ``shared_generator`` draws what
    every rank must draw alike (:meth:`next_rng` with ``replicated``);
    ``generator`` is offset by rank, for draws over a rank's own slice
    of the batch.

    Tensor and sequence parallel (parallel/tensor_parallel.py):
    ``layouts`` maps each env name whose value is split or partial over
    a mesh axis to its ``Layout`` (None: the run has no such axis, and
    every op runs its ordinary lowering); ``groups`` maps each mesh axis
    of more than one rank to this rank's line along it, and
    ``split_axes`` holds the tp and sp axes among them.
    """

    def __init__(self, device, generator=None, is_test=False, program=None,
                 run_ops=None, plan=None, mesh_axes=None, mesh=None,
                 shared_generator=None):
        self.device = device
        self._generator = generator
        self._shared_generator = shared_generator
        self._seed_generator = None
        self.mesh_axes = mesh_axes or {}
        self.mesh = mesh
        self.batch_stats_group = None
        self.is_test = is_test
        self.program = program
        self.run_ops = run_ops
        self.plan = plan
        self.current_env = None
        self.current_op = None
        self.keep_names = ()
        self._constants = {}
        self.layouts = None
        self.groups = {}
        self.split_axes = ()

    def live_ops(self, block):
        """The ops of `block` this run executes, in order."""
        if self.plan is None:
            return block.ops
        return self.plan.ops.get(block.idx, block.ops)

    def rnn_live(self, n_out, n_mem):
        """(live output positions, live memory positions) of the
        ``static_rnn`` or ``dynamic_rnn`` op being lowered."""
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

    def next_rng(self, replicated=False):
        """The generator random draws come from; raises if the run has
        none (a random op in a program run without one). `replicated`:
        a draw every rank of a data-parallel run makes alike (a tensor
        of a static shape, an update of replicated state), from the
        generator shared by the ranks; otherwise the rank's own."""
        if self._generator is None:
            raise RuntimeError(
                "op requires randomness but the run has no torch.Generator"
            )
        if replicated and self._shared_generator is not None:
            return self._shared_generator
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

    def rng_states(self):
        """The states of the run's generator and of the seed generator
        (None for one not made yet), for :meth:`set_rng_states`: a
        recomputed segment draws again what its first pass drew."""
        return tuple(None if g is None else g.get_state()
                     for g in (self._generator, self._seed_generator,
                               self._shared_generator))

    def set_rng_states(self, states):
        gen, seed, shared = states
        if gen is not None:
            self._generator.set_state(gen)
        if shared is not None:
            self._shared_generator.set_state(shared)
        if seed is None:        # made anew, from the same seed, when drawn
            self._seed_generator = None
        else:
            if self._seed_generator is None:
                self._seed_generator = torch.Generator()
            self._seed_generator.set_state(seed)


def has_lowering(op_type):
    return op_type in LOWERINGS


def single(val):
    """Helper: wrap a single output value for the conventional 'Out' slot."""
    return {"Out": [val]}
