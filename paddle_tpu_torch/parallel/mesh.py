"""The rank group: the port's counterpart of paddle_tpu/parallel/mesh.py.

The JAX package is single-controller: one process holds every device and
lays them out as the named axes of a ``jax.sharding.Mesh``. The port runs
one process per rank on ``torch.distributed``, the same script on every
rank. A :class:`RankGroup` is a mesh of named axes (``"dp"``, ``"tp"``,
``"sp"``, ``"pp"``, ``"ep"``) over a set of those ranks, with this
process's place in it and the device it computes on. Rank coordinates are the JAX package's:
``np.array(ranks).reshape(sizes)`` in the caller's axis order, so
``{"dp": 2, "tp": 2}`` puts ranks 0 and 1 in one tp line.
:meth:`RankGroup.axis_group` is the line of the mesh along one axis that
holds this rank, a group of its own; ``mesh.shape``, ``mesh.axis_names``,
:func:`dp_size` and :func:`require_dp_axis` read as the JAX package's do.

Joining the world (:func:`init_group`):

- rank and world size come from an explicit call, or from the
  reference's environment as ``PaddleCloudRoleMaker`` reads it
  (``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``); with neither the
  world is one rank and no process group is made;
- the rendezvous is a ``store`` or ``init_method`` the caller gives,
  else ``tcp://`` the first of ``PADDLE_TRAINER_ENDPOINTS``, else torch's
  ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``);
- the backend is explicit: ``nccl`` when each rank has its own card,
  ``gloo`` on the CPU or when the caller asks for it. Ranks that share a
  card under ``nccl`` raise; nothing switches backend behind the
  caller's back.

The group's collectives (:meth:`RankGroup.all_reduce` and the rest) are
the identity on a group without a process group (one rank), as the JAX
package's collectives are outside any mesh axis.
"""
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["RankGroup", "P", "init_group", "world", "build_mesh",
           "shrink_mesh", "dp_size", "require_dp_axis", "factorizations",
           "get_default_mesh", "set_default_mesh", "all_reduce_sum"]

_default_mesh = None


class P(tuple):
    """A partition spec (the JAX package's ``jax.sharding.PartitionSpec``):
    for each dim, the mesh axis it is split over, or None."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P(%s)" % ", ".join(repr(a) for a in self)


def _env_int(name, default):
    raw = os.environ.get(name)
    return default if raw in (None, "") else int(raw)


def _as_device(device):
    if hasattr(device, "torch_device"):         # a fluid Place
        return device.torch_device()
    return torch.device(device)


def _rendezvous(init_method):
    if init_method is not None:
        return init_method
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    if eps:
        return "tcp://" + eps.split(",")[0].strip()
    return "env://"


def init_group(rank=None, world_size=None, backend=None, device=None,
               init_method=None, store=None, timeout=None):
    """Join the world of ranks (``torch.distributed.init_process_group``)
    and return the :class:`RankGroup` over all of it, which becomes the
    default mesh. `rank` / `world_size` default to ``PADDLE_TRAINER_ID``
    / ``PADDLE_TRAINERS_NUM`` (0 / 1). `device` is the device this rank
    computes on: by default the card ``cuda:<FLAGS_selected_gpus or
    rank>``; `backend` defaults to ``nccl`` on a card and ``gloo`` on the
    CPU. A world of one rank with no `store` or `init_method` makes no
    process group."""
    if dist.is_initialized():
        raise RuntimeError(
            "torch.distributed is initialized already; use build_mesh() "
            "to make a group over it")
    rank = _env_int("PADDLE_TRAINER_ID", 0) if rank is None else int(rank)
    world_size = (_env_int("PADDLE_TRAINERS_NUM", 1) if world_size is None
                  else int(world_size))
    if not 0 <= rank < world_size:
        raise ValueError("rank %d is outside a world of %d ranks"
                         % (rank, world_size))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible to torch; a data-parallel rank "
                "runs on the card unless asked otherwise — pass "
                "device=CPUPlace() (and backend='gloo') to run on the CPU")
        device = torch.device(
            "cuda", _env_int("FLAGS_selected_gpus", rank))
    device = _as_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs a card; %s is not one "
                             "(use backend='gloo' on the CPU)" % device)
        index = 0 if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                "rank %d has no card of its own: it asks for cuda:%d and "
                "%d card(s) are visible. nccl needs one card per rank; "
                "ranks that share a card run over backend='gloo'"
                % (rank, index, torch.cuda.device_count()))
    elif backend != "gloo":
        raise ValueError("backend %r: the port runs 'nccl' or 'gloo'"
                         % (backend,))
    if world_size == 1 and store is None and init_method is None:
        group = RankGroup([0], 0, None, backend, device)
        set_default_mesh(group)
        return group
    kw = {} if timeout is None else {"timeout": timeout}
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if store is not None:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size, **kw)
    else:
        dist.init_process_group(backend, init_method=_rendezvous(
            init_method), rank=rank, world_size=world_size, **kw)
    group = RankGroup(range(world_size), rank, dist.group.WORLD, backend,
                      device)
    if backend == "nccl" and world_size > 1:
        group.check_own_cards()
    set_default_mesh(group)
    return group


def world():
    """The group over every rank of the world: the initialized
    torch.distributed world, else one made from the environment
    (:func:`init_group`), else a world of one rank on the default
    device with no process group."""
    mesh = _default_mesh
    if mesh is not None and mesh.ranks == tuple(range(_world_size())) \
            and mesh.axis_names == ("dp",):
        return mesh
    if dist.is_initialized():
        backend = dist.get_backend()
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else _default_device())
        return RankGroup(range(dist.get_world_size()), dist.get_rank(),
                         dist.group.WORLD, backend, device)
    if _env_int("PADDLE_TRAINERS_NUM", 1) > 1:
        return init_group()
    return RankGroup([0], 0, None, None, _default_device())


def _world_size():
    return dist.get_world_size() if dist.is_initialized() else 1


def _default_device():
    return (torch.device("cuda", torch.cuda.current_device())
            if torch.cuda.is_available() else torch.device("cpu"))


class RankGroup:
    """A mesh of named axes over `ranks` (global ranks, in the order of
    ``np.array(ranks).reshape(sizes)``); by default the one ``"dp"`` axis.

    ``rank`` is this process's position in `ranks` (None when it is not
    a member), ``group`` the torch ProcessGroup over all of them (None:
    one rank, collectives are the identity), ``device`` the device it
    computes on. ``lines`` maps each axis of a mesh of more than one
    axis to the :class:`RankGroup` of this rank's line along it
    (:func:`build_mesh` makes them)."""

    def __init__(self, ranks, rank, group, backend, device, axes=None,
                 lines=None):
        self.ranks = tuple(int(r) for r in ranks)
        self.rank = rank
        self.group = group
        self.backend = backend
        self.device = torch.device(device)
        self._axes = dict(axes) if axes else {"dp": len(self.ranks)}
        self._lines = dict(lines or {})

    @property
    def size(self):
        return len(self.ranks)

    @property
    def shape(self):
        return dict(self._axes)

    @property
    def axis_names(self):
        return tuple(self._axes)

    def coords(self):
        """{axis: this rank's coordinate along it}."""
        if self.rank is None:
            return None
        at = np.unravel_index(self.rank, tuple(self._axes.values()))
        return {a: int(c) for a, c in zip(self._axes, at)}

    def axis_group(self, axis):
        """The group of this rank's line along mesh axis `axis`, whose
        ``rank`` is the rank's coordinate on that axis."""
        if axis not in self._axes:
            raise ValueError("mesh %s has no axis %r" % (self.shape, axis))
        if len(self._axes) == 1:
            return self
        return self._lines[axis]

    def __repr__(self):
        return "RankGroup(%s, rank=%s, backend=%s, device=%s)" % (
            ", ".join("%s=%d" % kv for kv in self._axes.items()), self.rank,
            self.backend, self.device)

    def check_own_cards(self):
        """Raise when two ranks of the group compute on one card: nccl
        needs a card per rank."""
        me = (socket.gethostname(), str(self.device))
        seen = [None] * self.size
        dist.all_gather_object(seen, me, group=self.group)
        if len(set(seen)) != len(seen):
            raise RuntimeError(
                "ranks share a card under nccl: %s. nccl needs one card "
                "per rank; ranks that share a card run over "
                "backend='gloo'" % (seen,))

    # -- collectives: the identity with no process group ----------------
    def _live(self):
        return self.group is not None

    def all_reduce(self, x, op="sum"):
        """A new tensor: `x` reduced over the group (sum, max, min or
        prod; prod is exact, gathered then multiplied in rank order)."""
        if not self._live():
            return x
        if op == "prod":
            return torch.prod(self.stack(x), dim=0, dtype=x.dtype)
        out = x.detach().clone()
        dist.all_reduce(out, op=_OPS[op], group=self.group)
        return out

    def stack(self, x):
        """(size, *x.shape): every rank's `x`, in rank order."""
        if not self._live():
            return x.unsqueeze(0)
        x = x.detach().contiguous()
        outs = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(outs, x, group=self.group)
        return torch.stack(outs)

    def all_gather(self, x):
        """Every rank's `x` concatenated along dim 0, in rank order."""
        if not self._live():
            return x
        s = self.stack(x)
        return s.reshape((-1,) + tuple(x.shape[1:]))

    def broadcast(self, x, root=0):
        """The `root` rank's `x`, on every rank."""
        if not self._live():
            return x
        out = x.detach().clone().contiguous()
        dist.broadcast(out, src=self.ranks[root], group=self.group)
        return out

    def reduce_scatter(self, x):
        """This rank's 1/size slice (dim 0) of `x` summed over the
        group."""
        if not self._live():
            return x
        x = x.detach().contiguous()
        out = torch.empty((x.shape[0] // self.size,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x, group=self.group)
        return out

    def all_to_all(self, x, split_axis=0, concat_axis=0):
        """Tiled all-to-all: `x` split into size chunks along
        `split_axis`, chunk j sent to rank j, the chunks received
        concatenated along `concat_axis` in rank order."""
        if not self._live():
            return x
        chunks = torch.stack(torch.chunk(x.detach(), self.size,
                                         dim=split_axis))
        out = torch.empty_like(chunks)
        dist.all_to_all_single(out, chunks.contiguous(), group=self.group)
        return torch.cat(list(out.unbind(0)), dim=concat_axis)

    def ppermute(self, x, shift=1):
        """Ring permute: rank i's `x` lands on rank (i + shift) % size.
        Every rank's `x` is gathered and the sender's row kept: gloo's
        point-to-point send of a CUDA tensor fails ("writev: Bad
        address", torch 2.11), its all-gather does not."""
        n = self.size
        if not self._live() or shift % n == 0:
            return x
        return self.stack(x)[(self.rank - shift) % n]

    def barrier(self):
        if self._live():
            dist.barrier(group=self.group)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group whose gradient is the group sum of the
    incoming gradients: each rank's input reaches every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous()), None


def all_reduce_sum(x, group):
    """`x` summed over `group`, differentiable (:class:`_AllReduceSum`)."""
    if not group._live():
        return x
    return _AllReduceSum.apply(x, group)


def dp_size(mesh):
    """Size of the mesh's data-parallel axis (1 when there is none)."""
    return mesh.shape.get("dp", 1) if mesh is not None else 1


def require_dp_axis(mesh, who="this mode"):
    """Validate and return the dp axis size; raises the standard
    "dp mesh axis" error for modes that only make sense with >1 data
    shard (LocalSGD, explicit gradient sync)."""
    n = dp_size(mesh)
    if n <= 1:
        raise ValueError(
            "%s requires a dp mesh axis of size > 1 (got mesh %s)"
            % (who, dict(mesh.shape) if mesh is not None else None))
    return n


def factorizations(n_devices, axes=("dp", "tp", "pp")):
    """Every way to lay ``n_devices`` out over the named ``axes``:
    ordered tuples of sizes (one per axis, >= 1) whose product is the
    device count, emitted as ``{axis: size}`` dicts with size-1 axes
    dropped. Deterministic order (sizes enumerated ascending per axis,
    first axis outermost) so planner candidate lists are byte-stable
    across processes."""
    n = int(n_devices)
    if n < 1:
        raise ValueError("n_devices must be >= 1, got %d" % n)
    axes = tuple(axes)
    out = []

    def rec(rest, i, acc):
        if i == len(axes) - 1:
            out.append(acc + [rest])
            return
        d = 1
        while d <= rest:
            if rest % d == 0:
                rec(rest // d, i + 1, acc + [d])
            d += 1

    if len(axes) == 1:
        out.append([n])
    else:
        rec(n, 0, [])
    return [{a: s for a, s in zip(axes, sizes) if s > 1} or
            {axes[0]: 1} for sizes in out]


def build_mesh(axes=None, ranks=None):
    """The :class:`RankGroup` of `axes` (``{axis: size}``, in order; the
    ``"dp"``, ``"tp"``, ``"sp"``, ``"pp"`` and ``"ep"`` axes) over `ranks`
    (global ranks; default every rank of :func:`world`). A -1 size is
    inferred; the sizes must multiply to the number of ranks. A mesh of
    more than one axis makes a ``torch.distributed.new_group`` for every
    line of every axis (:meth:`RankGroup.axis_group`), and a group over
    part of the world is one too: every rank of the world calls it,
    members or not, so that the groups are made in one order."""
    w = world()
    ranks = list(w.ranks if ranks is None else ranks)
    n = len(ranks)
    sizes = dict(axes or {"dp": n})
    if -1 in sizes.values():
        known = 1
        for s in sizes.values():
            if s != -1:
                known *= int(s)
        for k, s in sizes.items():
            if s == -1:
                sizes[k] = n // known
    sizes = {a: int(s) for a, s in sizes.items()}
    total = 1
    for s in sizes.values():
        total *= s
    if total != n:
        raise ValueError(
            "mesh axes %s multiply to %d but %d ranks available"
            % (sizes, total, n))
    bad = [r for r in ranks if r not in w.ranks]
    if bad:
        raise ValueError("ranks %s are outside a world of %d"
                         % (bad, w.size))
    me = ranks.index(w.rank) if w.rank in ranks else None
    if ranks == list(w.ranks):
        if list(sizes) == ["dp"]:
            return w
        group = w.group
    else:
        group = dist.new_group(ranks) if w.group is not None else None
    lines = {}
    if len(sizes) > 1:
        grid = np.array(ranks).reshape(tuple(sizes.values()))
        for i, (axis, size) in enumerate(sizes.items()):
            rows = np.moveaxis(grid, i, -1).reshape(-1, size)
            for row in rows:
                row = [int(r) for r in row]
                if size == 1:
                    pg = None
                elif size == n:
                    pg = group
                else:
                    pg = dist.new_group(row) if w.group is not None else None
                if w.rank in row:
                    lines[axis] = RankGroup(row, row.index(w.rank), pg,
                                            w.backend, w.device,
                                            {axis: size})
    return RankGroup(ranks, me, group, w.backend, w.device, sizes, lines)


def shrink_mesh(mesh, survivors=None, dead=None):
    """Shrink-to-survivors rebuild: a new pure-dp group over the subset
    of `mesh`'s ranks named by `survivors` (positions on its dp axis)
    or, equivalently, everything NOT in `dead`. Every rank of the world
    calls it (``new_group``). Only data parallelism can absorb lost
    ranks — a tp/sp-split tensor has no complete copy on the survivors —
    so meshes with a non-trivial second axis are refused."""
    nontrivial = [n for n in mesh.axis_names
                  if n != "dp" and mesh.shape[n] > 1]
    if nontrivial:
        raise NotImplementedError(
            "shrink_mesh only supports pure-dp meshes: axis %s > 1 means "
            "parameter shards (not copies) lived on the lost device"
            % nontrivial)
    ranks = list(mesh.ranks)
    if survivors is None:
        gone = set(dead or ())
        survivors = [i for i in range(len(ranks)) if i not in gone]
    survivors = sorted(set(survivors))
    if not survivors:
        raise ValueError("shrink_mesh with no survivors")
    bad = [i for i in survivors if not 0 <= i < len(ranks)]
    if bad:
        raise ValueError(
            "survivor positions %s out of range for a %d-rank mesh"
            % (bad, len(ranks)))
    return build_mesh({"dp": len(survivors)},
                      ranks=[ranks[i] for i in survivors])


def set_default_mesh(mesh):
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh():
    global _default_mesh
    if _default_mesh is None:
        _default_mesh = world()
    return _default_mesh
