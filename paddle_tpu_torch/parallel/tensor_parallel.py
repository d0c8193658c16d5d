"""Layouts over a mesh's axes, and the differentiable collectives that move
a value between them (tensor and sequence parallelism, ZeRO-1).

The JAX package jits one global step over a Mesh and lets XLA's SPMD
partitioner decide where each value is split and which collective makes
it whole. The port runs one eager process per rank, so it decides that
itself, op by op. Each value of a run's env has, over each mesh axis, one
of three layouts (:class:`Layout`):

- *whole*: every rank of the axis holds all of it (the default);
- *split* on one dim into equal blocks, rank coordinate c holding block c;
- *partial*: a sum over the axis that has not been taken yet.

An op whose inputs are all whole runs its ordinary lowering. An op with a
split or partial input runs its layout rule (``register_layout_rule`` in
ops/registry.py, the rules beside each lowering in ``ops/``), which says
where its outputs are split; an op without a rule, or whose rule does not
fit the shapes, takes the fallback: every split input is gathered and every partial one reduced,
then the ordinary lowering runs (:func:`run`). The fallback is exact and
costs bytes; it is counted by op type and axis (:data:`RESHARDS`, and the
hub counter ``parallel.reshard_total.<op>.<axis>``).

Gradients come from three differentiable collectives (Megatron's f and g,
and gather), so one ``torch.autograd`` tape gives every rank the gradient
of the one-device run, block by block:

- :func:`enter` (f): identity forward, sum over the axis backward. A whole
  value goes through it wherever it meets a value split over the axis;
  :func:`scatter` is f followed by the cut to the rank's block, whose
  backward is one all-gather;
- :func:`reduce` (g): all-reduce forward, identity backward; it makes a
  partial value whole;
- :func:`gather`: all-gather forward, the rank's block backward.

Every collective of a run is counted by kind and axis in
:data:`COLLECTIVES` (calls and bytes sent), so a run can report what the
layouts cost.
"""
import collections

import torch

from .. import observability as obs
from ..ops.registry import ACTIVE_RULES, LAYOUT_RULES

__all__ = ["Layout", "WHOLE", "enter", "reduce", "gather", "scatter", "cut",
           "run", "whole", "conform", "resolve_partial", "unary",
           "rng_block", "RESHARDS", "COLLECTIVES", "reset_counts",
           "global_shape", "block_range"]

# (op type, axis) -> fallbacks taken; (kind, axis) -> [calls, bytes]
RESHARDS = collections.Counter()
COLLECTIVES = collections.defaultdict(lambda: [0, 0])


def reset_counts():
    RESHARDS.clear()
    COLLECTIVES.clear()


def _count(kind, axis, t):
    c = COLLECTIVES[(kind, axis)]
    c[0] += 1
    c[1] += t.numel() * t.element_size()


class Layout:
    """Where a value lies over the mesh's axes: ``split`` maps an axis to
    the dim split over it, ``partial`` holds the axes it is a pending sum
    over; an axis in neither is whole."""

    __slots__ = ("split", "partial")

    def __init__(self, split=(), partial=()):
        self.split = dict(split)
        self.partial = frozenset(partial)

    @property
    def whole(self):
        return not self.split and not self.partial

    def axis_on(self, dim):
        """The axis `dim` is split over, or None."""
        for a, d in self.split.items():
            if d == dim:
                return a
        return None

    def with_split(self, axis, dim):
        s = dict(self.split)
        s[axis] = dim
        return Layout(s, self.partial - {axis})

    def moved(self, dim_map):
        """The layout after dims move (``dim_map[old] = new``); None when a
        split dim has no image."""
        s = {}
        for a, d in self.split.items():
            if dim_map.get(d) is None:
                return None
            s[a] = dim_map[d]
        return Layout(s, self.partial)

    def __eq__(self, other):
        return (isinstance(other, Layout) and self.split == other.split
                and self.partial == other.partial)

    def __hash__(self):
        return hash((tuple(sorted(self.split.items())), self.partial))

    def __repr__(self):
        parts = ["%s:%d" % kv for kv in sorted(self.split.items())]
        parts += ["%s:partial" % a for a in sorted(self.partial)]
        return "Layout(%s)" % ", ".join(parts)


WHOLE = Layout()


def block_range(group, length):
    """(start, size) of this rank's block of a dim of global `length`."""
    size = length // group.size
    return group.rank * size, size


def global_shape(shape, lay, groups):
    """The whole value's shape of a block of `shape` laid out as `lay`."""
    shape = list(shape)
    for a, d in lay.split.items():
        shape[d] *= groups[a].size
    return tuple(shape)


# ---------------------------------------------------------------------------
# the differentiable collectives
# ---------------------------------------------------------------------------
def _all_gather(x, group, dim):
    stacked = group.stack(x.contiguous())
    return torch.cat(list(stacked.unbind(0)), dim=dim)


class _Enter(torch.autograd.Function):
    """f: identity forward, sum over the group backward."""

    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis = group, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        _count("f", ctx.axis, g)
        return ctx.group.all_reduce(g), None, None


class _Reduce(torch.autograd.Function):
    """g: sum over the group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group, axis):
        x = x.contiguous()
        _count("g", axis, x)
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """All-gather along `dim` forward, the rank's block backward."""

    @staticmethod
    def forward(ctx, x, group, axis, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        _count("gather", axis, x)
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.group.rank * ctx.n, ctx.n)
                .contiguous(), None, None, None)


class _Scatter(torch.autograd.Function):
    """f then the cut to the rank's block along `dim`: the block forward,
    an all-gather of the blocks' gradients backward."""

    @staticmethod
    def forward(ctx, x, group, axis, dim):
        ctx.group, ctx.axis, ctx.dim = group, axis, dim
        start, size = block_range(group, x.shape[dim])
        return x.narrow(dim, start, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        _count("f_gather", ctx.axis, g)
        return _all_gather(g, ctx.group, ctx.dim), None, None, None


def _live(group):
    return group is not None and group.size > 1 and group.group is not None


def enter(x, group, axis):
    """f over `group`: `x` unchanged; its gradient summed over the group."""
    if not _live(group) or not x.requires_grad:
        return x
    return _Enter.apply(x, group, axis)


def reduce(x, group, axis):
    """g over `group`: the sum of the ranks' `x`; the gradient passes."""
    if not _live(group):
        return x
    if not x.requires_grad:
        x = x.contiguous()
        _count("g", axis, x)
        return group.all_reduce(x)
    return _Reduce.apply(x, group, axis)


def gather(x, group, axis, dim):
    """The ranks' blocks along `dim`, concatenated in rank order; the
    gradient is cut back to the rank's block."""
    if not _live(group):
        return x
    if not x.requires_grad:
        _count("gather", axis, x)
        return _all_gather(x, group, dim)
    return _Gather.apply(x, group, axis, dim)


def scatter(x, group, axis, dim):
    """The rank's block of a whole `x` along `dim`, entered through f."""
    if group is None or group.size == 1:
        return x
    if not x.requires_grad or not _live(group):
        return cut(x, group, dim)
    return _Scatter.apply(x, group, axis, dim)


def cut(x, group, dim):
    """The rank's block of `x` along `dim` (no gradient rule)."""
    start, size = block_range(group, x.shape[dim])
    return x.narrow(dim, start, size).contiguous()


# ---------------------------------------------------------------------------
# the rules and the fallback
# ---------------------------------------------------------------------------
def whole(ctx, x, lay, op_type=None):
    """`x` made whole over every axis of `lay`: each split gathered, each
    partial reduced. With `op_type`, counted as that op's fallback."""
    for a, d in sorted(lay.split.items()):
        if op_type is not None:
            _reshard(op_type, a)
        x = gather(x, ctx.groups[a], a, d)
    for a in sorted(lay.partial):
        if op_type is not None:
            _reshard(op_type, a)
        x = reduce(x, ctx.groups[a], a)
    return x


def _reshard(op_type, axis):
    RESHARDS[(op_type, axis)] += 1
    obs.inc("parallel.reshard_total.%s.%s" % (op_type, axis))


def conform(ctx, x, have, want):
    """`x` (laid out as `have`) laid out as `want`, which has no partial
    axes: made whole where the two differ, then cut (no gradient)."""
    if have == want:
        return x
    keep = {a: d for a, d in have.split.items() if want.split.get(a) == d}
    x = whole(ctx, x, Layout({a: d for a, d in have.split.items()
                              if a not in keep}, have.partial))
    for a, d in sorted(want.split.items()):
        if a not in keep:
            x = cut(x, ctx.groups[a], d)
    return x


def run(op_type, fn, ctx, ins, attrs, lays):
    """One op under layouts: (outs, out_lays). The op's rule when it has
    one that fits, else its ordinary lowering on whole inputs."""
    laid = any(not lay.whole for ls in lays.values() for lay in ls)
    rule = LAYOUT_RULES.get(op_type)
    if rule is not None and (laid or (op_type in ACTIVE_RULES
                                      and ctx.split_axes)):
        got = rule(ctx, ins, attrs, lays)
        if got is not None:
            return got
    if laid:
        ins = {slot: [whole(ctx, x, lay, op_type)
                      for x, lay in zip(vals, lays[slot])]
               for slot, vals in ins.items()}
    return fn(ctx, ins, attrs), {}


# ---------------------------------------------------------------------------
# helpers the rules share
# ---------------------------------------------------------------------------
def resolve_partial(ctx, x, lay, keep=frozenset()):
    """`x` with every partial axis but those in `keep` reduced (g); the
    layout's split axes stay."""
    for a in sorted(lay.partial - keep):
        x = reduce(x, ctx.groups[a], a)
    return x, Layout(lay.split, lay.partial & keep)


def unary(ctx, ins, attrs, lays, fn, linear=False):
    """An elementwise op of one input X: it runs on the rank's block and
    its output lies as the input; a partial input is reduced first unless
    the op is `linear`."""
    x, lay = ins["X"][0], lays["X"][0]
    if not linear:
        x, lay = resolve_partial(ctx, x, lay)
    return fn(ctx, dict(ins, X=[x]), attrs), {"Out": [lay]}


def rng_block(ctx, shape, lay, draw):
    """`draw(global shape)` (a random tensor of the whole value's shape,
    from the run's generator), cut to this rank's block of `lay`: a split
    value draws the whole value's bits, as the one-device run does."""
    t = draw(global_shape(shape, lay, ctx.groups))
    for a, d in sorted(lay.split.items()):
        t = cut(t, ctx.groups[a], d)
    return t
