"""Pipeline parallelism over the ``pp`` axis of a rank group (port of
paddle_tpu/parallel/pipeline.py).

The JAX package runs the GPipe schedule inside one ``shard_map``: every
device of the 'pp' axis holds one stage, activations move around the
ring with ``lax.ppermute`` inside a ``lax.scan`` over (microbatches +
stages - 1) ticks, and ``jax.vjp`` of that scan is the backward
schedule. The port runs one process per rank, each its own stage:

- :class:`Ring` is the tick loop of one rank of a pp line. At tick t
  stage s works on microbatch t - s: stage 0 injects microbatch t, and
  what a stage hands on reaches the next stage for its next tick, so the
  last stage finishes microbatch t - (S - 1). Run in reverse, the same
  loop is the backward schedule: the last stage starts from the newest
  microbatch, and each stage hands the cotangents of what it received
  back to the stage before it.
- Moving a payload (the tensors one stage hands the next, packed into
  one byte buffer): over nccl a ``batch_isend_irecv`` pair between the
  two neighbours; over gloo, which cannot send a CUDA tensor point to
  point, the line's all-gather (every rank's buffer, padded to the
  tick's largest, the sender's row kept), as
  :meth:`.mesh.RankGroup.ppermute` does. A receiver learns the shapes
  of a payload once, from an object all-gather on the first ticks that
  carry it (:attr:`Ring.specs`).
- The backward is autograd: each stage records its forward under
  ``torch.autograd`` with what it received as fresh leaves, and in the
  reverse loop calls ``torch.autograd.grad`` of what it sent with the
  cotangents it got back. No gradient is written by hand.

:func:`gpipe` is the per-rank schedule of one homogeneous stage
function; :func:`gpipe_sharded` and :func:`gpipe_composed` are its
global entries over stacked stage weights (every rank is given the whole
stack and the whole batch, as every rank of a
:class:`.sharding.DistributedProgram` is given the global feed). The
outputs come back whole on every rank of the line (the JAX package
psums the last stage's record), and so does every gradient:
``gpipe_sharded``'s stacked weights and input take their gradient summed
over the line. ``gpipe_composed`` keeps a ``dp`` axis beside ``pp``:
each dp line runs the pipeline on its slice of the batch, the output is
gathered over dp and the weights' gradient summed there. Tensor
parallelism inside ``gpipe_composed`` (the JAX package's stacked
weights laid out ``P('pp', ..., 'tp')``) waits (ROADMAP.md Queue 1).
"""
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from . import tensor_parallel as tpl
from .mesh import get_default_mesh

__all__ = ["gpipe", "gpipe_sharded", "gpipe_composed", "Ring"]

# byte alignment of each tensor in a packed payload (so every slice of the
# received buffer can be viewed as its dtype in place)
_ALIGN = 8


def _nbytes(spec):
    shape, dtype = spec
    n = dtype.itemsize
    for d in shape:
        n *= int(d)
    return -(-n // _ALIGN) * _ALIGN


def _pack(tensors, size, device):
    """One uint8 buffer of `size` bytes holding `tensors` in order."""
    buf = torch.zeros(size, dtype=torch.uint8, device=device)
    at = 0
    for t in tensors:
        raw = t.detach().contiguous().reshape(-1).view(torch.uint8)
        buf[at:at + raw.numel()].copy_(raw)
        at += _nbytes((t.shape, t.dtype))
    return buf


def _unpack(buf, specs):
    out, at = [], 0
    for shape, dtype in specs:
        n = dtype.itemsize
        for d in shape:
            n *= int(d)
        out.append(buf[at:at + n].view(dtype).reshape(shape).clone())
        at += _nbytes((shape, dtype))
    return out


def _spec(tensors):
    return [(tuple(t.shape), t.dtype) for t in tensors]


class Ring:
    """The GPipe tick loop of this rank of `line` (a pp line of a
    :class:`.mesh.RankGroup`) over `n_micro` microbatches.

    :meth:`run` calls ``work(m, got)`` at each tick this rank has
    microbatch m, with `got` the list of tensors the neighbouring stage
    handed on for m (None at the first stage of the direction), and
    hands what `work` returns to the next stage (forward) or the one
    before (``reverse=True``). ``specs`` maps (direction, sending stage)
    to the payload's [(shape, dtype)]; ``bytes`` adds up the bytes this
    rank sent."""

    def __init__(self, line, n_micro, device):
        self.line = line
        self.n_micro = int(n_micro)
        self.device = torch.device(device)
        self.specs = {}
        self.bytes = 0

    @property
    def ticks(self):
        return self.n_micro + self.line.size - 1

    def run(self, work, reverse=False):
        n, s, m_all = self.line.size, self.line.rank, self.n_micro
        inbox = {}
        for t in range(self.ticks):
            tt = self.ticks - 1 - t if reverse else t
            m = tt - s
            out = None
            if 0 <= m < m_all:
                out = work(m, inbox.pop(m, None))
            senders = [b for b in (range(1, n) if reverse else range(n - 1))
                       if 0 <= tt - b < m_all]
            if senders:
                self._move(-1 if reverse else 1, tt, senders, out, inbox)

    def _move(self, step, tt, senders, out, inbox):
        line = self.line
        s = line.rank
        mine = out if s in senders else None
        if s in senders and out is None:
            raise RuntimeError("pipeline stage %d handed nothing on at tick "
                               "%d" % (s, tt))
        missing = [b for b in senders if (step, b) not in self.specs]
        if missing:
            got = [None] * line.size
            dist.all_gather_object(got, None if mine is None else
                                   _spec(mine), group=line.group)
            for b in missing:
                self.specs[(step, b)] = got[b]
        if mine is not None and _spec(mine) != self.specs[(step, s)]:
            raise RuntimeError(
                "pipeline stage %d hands on %s, not the %s of the first "
                "step" % (s, _spec(mine), self.specs[(step, s)]))
        src = s - step                  # the stage that sends to this one
        take = src in senders
        sizes = {b: sum(_nbytes(x) for x in self.specs[(step, b)])
                 for b in senders}
        if line.backend == "nccl":
            ops = []
            if mine is not None:
                buf = _pack(mine, sizes[s], self.device)
                ops.append(dist.P2POp(dist.isend, buf,
                                      line.ranks[s + step], group=line.group))
                self.bytes += buf.numel()
            if take:
                rbuf = torch.empty(sizes[src], dtype=torch.uint8,
                                   device=self.device)
                ops.append(dist.P2POp(dist.irecv, rbuf, line.ranks[src],
                                      group=line.group))
            for req in dist.batch_isend_irecv(ops) if ops else ():
                req.wait()
        else:
            size = max(sizes.values())
            if size:
                buf = _pack(mine or [], size, self.device)
                rows = line.stack(buf)
                if mine is not None:
                    self.bytes += sizes[s]
                rbuf = rows[src] if take else None
            else:
                rbuf = torch.empty(0, dtype=torch.uint8, device=self.device)
        if take:
            inbox[tt - src] = _unpack(rbuf, self.specs[(step, src)])


# ---------------------------------------------------------------------------
# the homogeneous-stage schedule
# ---------------------------------------------------------------------------
class _GPipe(torch.autograd.Function):
    """gpipe's schedule: forward ticks, outputs broadcast from the last
    stage; backward, the reverse ticks from the last stage's copy of the
    outputs' gradient."""

    @staticmethod
    def forward(ctx, stage_fn, spec, line, xm, *leaves):
        n, s, m_all = line.size, line.rank, xm.shape[0]
        ring = Ring(line, m_all, xm.device)
        for b in range(n):      # every payload is one microbatch's shape
            ring.specs[(1, b)] = ring.specs[(-1, b)] = [
                (tuple(xm.shape[1:]), xm.dtype)]
        with torch.enable_grad():
            params = [p.detach().requires_grad_(p.requires_grad)
                      for p in leaves]
            tree = pytree.tree_unflatten(params, spec)
            ins, outs = {}, {}

            def work(m, got):
                x = (xm[m] if s == 0 else got[0]).detach()
                x.requires_grad_(x.is_floating_point())
                y = stage_fn(tree, x)
                if tuple(y.shape) != tuple(x.shape) or y.dtype != x.dtype:
                    raise ValueError(
                        "gpipe's stages hand on what they take: stage %d "
                        "maps %s %s to %s %s" % (s, tuple(x.shape), x.dtype,
                                                 tuple(y.shape), y.dtype))
                ins[m], outs[m] = x, y
                return [y] if s < n - 1 else None

            ring.run(work)
        if s == n - 1:
            rec = torch.stack([outs[m].detach() for m in range(m_all)])
        else:
            rec = torch.empty_like(xm)
        rec = line.broadcast(rec, root=n - 1)
        ctx.state = (ring, params, ins, outs)
        ctx.x_grad = xm.requires_grad
        return rec

    @staticmethod
    def backward(ctx, g):
        ring, params, ins, outs = ctx.state
        line = ring.line
        n, s = line.size, line.rank
        live = [p for p in params if p.requires_grad]
        sums = [None] * len(live)
        gx = (torch.zeros((ring.n_micro,) + tuple(ins[0].shape),
                          dtype=ins[0].dtype, device=ins[0].device)
              if ctx.x_grad else None)

        def work(m, got):
            cot = g[m] if s == n - 1 else got[0]
            x = ins[m]
            wrt = live + ([x] if x.requires_grad else [])
            gs = torch.autograd.grad([outs[m]], wrt, [cot],
                                     allow_unused=True) if wrt else []
            for i, gi in enumerate(gs[:len(live)]):
                if gi is not None:
                    sums[i] = gi if sums[i] is None else sums[i] + gi
            dx = gs[len(live)] if x.requires_grad else None
            if dx is None:
                dx = torch.zeros_like(x)
            if s > 0:
                return [dx]
            if gx is not None:
                gx[m] = dx
            return None

        ring.run(work, reverse=True)
        ctx.state = None
        grads = iter(sums)
        leaf_grads = []
        for p in params:
            gp = next(grads) if p.requires_grad else None
            if p.requires_grad and gp is None:
                gp = torch.zeros_like(p)
            leaf_grads.append(gp)
        if gx is not None:
            # the input is whole on every rank: its gradient is too
            gx = line.all_reduce(gx)
        return (None, None, None, gx) + tuple(leaf_grads)


def _line(mesh, axis):
    mesh = mesh if mesh is not None else get_default_mesh()
    if axis not in mesh.shape:
        raise ValueError("mesh %s has no %r axis to pipeline over"
                         % (mesh.shape, axis))
    return mesh.axis_group(axis)


def gpipe(stage_fn, stage_params, x_microbatches, axis_name="pp",
          mesh=None):
    """Run a homogeneous-stage pipeline on this rank's stage.

    stage_fn(params, x) -> y     one stage's forward (torch), y shaped as x
    stage_params: this rank's stage weights (a tensor or a pytree of them)
    x_microbatches: (M, ...) microbatches, alike on every rank
    axis_name / mesh: the pp axis of `mesh` (default: the default mesh)
    Returns the (M, ...) outputs, whole on every rank of the line.
    Differentiable: the weights take this stage's gradient, the input
    the gradient of the whole pipeline."""
    line = _line(mesh, axis_name)
    leaves, spec = pytree.tree_flatten(stage_params)
    return _GPipe.apply(stage_fn, spec, line, x_microbatches, *leaves)


def _gpipe_global(stage_fn, stacked_params, x, line, n_microbatches):
    """Microbatch the batch `x` and run the stage row of `stacked_params`
    this rank of `line` holds; every stacked weight takes the gradient of
    all the stages (summed over the line)."""
    n = line.size
    mb = n_microbatches or n
    if x.shape[0] % mb:
        raise ValueError("batch %d not divisible by %d microbatches"
                         % (x.shape[0], mb))
    leaves, spec = pytree.tree_flatten(stacked_params)
    for p in leaves:
        if p.shape[0] != n:
            raise ValueError(
                "stacked stage weights carry a leading stage dim of %d, "
                "but the pp line has %d stages" % (p.shape[0], n))
    rows = [tpl.enter(p, line, "pp")[line.rank] for p in leaves]
    xm = x.reshape((mb, x.shape[0] // mb) + tuple(x.shape[1:]))
    out = _GPipe.apply(stage_fn, spec, line, xm, *rows)
    return out.reshape((x.shape[0],) + tuple(out.shape[2:]))


def gpipe_sharded(stage_fn, stacked_params, x, mesh, axis="pp",
                  n_microbatches=None):
    """Global entry: `stacked_params` has a leading stage dim equal to
    the size of `mesh`'s `axis`; `x` is the (B, ...) global batch, split
    into `n_microbatches` (default: one a stage). Every rank is given
    both whole and gets the (B, ...) output whole."""
    return _gpipe_global(stage_fn, stacked_params, x, _line(mesh, axis),
                         n_microbatches)


def gpipe_composed(stage_fn, stacked_params, x, mesh, axis="pp",
                   n_microbatches=None):
    """dp x pp composed stacked-stage pipeline: like
    :func:`gpipe_sharded`, but each line of `mesh`'s ``dp`` axis runs the
    pipeline on its slice of the (B, ...) batch `x`; the output is
    gathered over dp (whole on every rank) and the stacked weights'
    gradient summed over dp. A ``tp``, ``sp`` or ``ep`` axis of more than
    one rank raises: the stage function is plain torch, and the port
    lays out weights split over tp only through a Program's ops."""
    wide = sorted(a for a, k in mesh.shape.items()
                  if a not in (axis, "dp") and k > 1)
    if wide:
        raise NotImplementedError(
            "gpipe_composed over mesh axes %s: the port composes dp x pp; "
            "tensor parallelism inside the stacked-stage pipeline waits "
            "(ROADMAP.md Queue 1)" % wide)
    line = _line(mesh, axis)
    dp = mesh.axis_group("dp") if mesh.shape.get("dp", 1) > 1 else None
    if dp is None:
        return _gpipe_global(stage_fn, stacked_params, x, line,
                             n_microbatches)
    if x.shape[0] % dp.size:
        raise ValueError("batch %d not divisible over %d dp ranks"
                         % (x.shape[0], dp.size))
    mine = tpl.scatter(x, dp, "dp", 0)
    params = pytree.tree_map(lambda p: tpl.enter(p, dp, "dp"),
                             stacked_params)
    out = _gpipe_global(stage_fn, params, mine, line, n_microbatches)
    return tpl.gather(out, dp, "dp", 0)
