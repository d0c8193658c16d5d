"""Op lowering registry.

Port of paddle_tpu/ops/registry.py. Each op type maps to ONE lowering
function written in torch; the executor calls them eagerly, op by op.

Lowering signature::

    def lower(ctx, ins, attrs) -> {output_slot: [torch tensors]}

``ins`` maps input slot -> list of tensors (missing optional slots are
empty lists). ``ctx`` is a LowerContext carrying the run's device, its
random generator and train/test mode.
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
    parameters across rather than re-drawing them.
    """

    def __init__(self, device, generator=None, is_test=False):
        self.device = device
        self._generator = generator
        self._seed_generator = None
        self.is_test = is_test

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
