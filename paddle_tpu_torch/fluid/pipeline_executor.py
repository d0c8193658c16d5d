"""Pipeline-parallel execution of a fluid Program, the PipelineOptimizer
path (port of paddle_tpu/fluid/pipeline_executor.py).

The forward region (the ops before the ``backward`` op) is split at the
cut vars' producing ops into S stages, as the JAX package splits it.
The JAX package then runs all S stages in one ``shard_map`` over the
'pp' axis (``lax.switch`` on the axis index, ``lax.ppermute`` inside a
``lax.scan``) and differentiates it with ``jax.vjp``. The port runs one
process per rank, each rank its own stage (its coordinate on the mesh's
``pp`` axis), on the GPipe tick loop of parallel/pipeline.py
(:class:`~paddle_tpu_torch.parallel.pipeline.Ring`):

- every rank is given the global feed; feeds with the batch's leading
  dim are cut into microbatches, the rest replicated; a feed that
  ``feed_specs`` splits over ``dp`` is first cut to the dp rank's slice;
- at each tick a rank runs its stage's ops on one microbatch under
  ``torch.autograd`` (what it received as fresh leaves), then hands the
  vars that cross its boundary (those a later stage reads) to the next
  stage; the last stage records the loss and the fetches;
- the backward is the same loop in reverse: each stage calls
  ``torch.autograd.grad`` of what it sent with the cotangents the next
  stage sent back (the last stage: of its loss, 1 / (M · numel) each, so
  the loss is the mean of the microbatch means);
- the parameters are whole on every rank, as in the JAX package's one
  global scope: each gradient is summed over the pp line (a stage that
  does not read a parameter adds zeros), averaged over ``dp`` where the
  mesh has it (reduce-scattered there for optimizer state that
  ``opt_state_rules`` splits, ZeRO-1, as
  :class:`~paddle_tpu_torch.parallel.sharding.DistributedProgram` does),
  and every rank runs the post-backward ops (the updates, the LR
  schedule), so every rank ends the step with the same parameters;
- fetches: the loss is the mean of the microbatch losses, a recorded
  float fetch the mean over microbatches and an integer one the sum
  (the JAX package's rule), broadcast from the last stage and then made
  global over dp as a DistributedProgram fetch is;
- random draws: each (dp rank, microbatch, stage) draws from a
  generator of its own, so no two microbatches reuse a dropout mask or a
  flash-attention hash seed (the JAX package folds the microbatch index
  into its key).

Every rank runs its stage eagerly, so the hand-written CUDA kernels
(flash attention, LayerNorm) are on the path of every stage. The
refusals of the JAX package stay, with its messages. As there, stage
bodies must be stateless in the persistable sense: what an op of the
forward region writes to a persistable is not kept.
"""
import contextlib

import numpy as np
import torch
import torch.distributed as dist

from ..ops.registry import LowerContext
from ..parallel.sharding import DistributedProgram
from .executor import _as_name, to_numpy
from .lowering import (OpLoweringError, _run_span, _stop_gradient, apply_op,
                       f32_precision, op_read_names, run_ops, segment_cuts)

__all__ = ["run_pipeline_program", "PipelineProgram"]


def _cut_names(cut_list):
    names = []
    for c in cut_list or []:
        if isinstance(c, (list, tuple)):
            names.extend(_cut_names(c))
        else:
            names.append(c.name if hasattr(c, "name") else str(c))
    return names


def _split_stages(region, cut_list):
    """Partition the forward op span at each cut var's producing op
    (the cut op ends its stage, like the reference's section split)."""
    cuts = segment_cuts(region, _cut_names(cut_list))
    spans = []
    prev = 0
    for c in cuts:
        spans.append((prev, c + 1))
        prev = c + 1
    spans.append((prev, len(region)))
    return spans


def _boundary_vars(region, spans):
    """For each boundary b, the vars produced in stage <= b and read in a
    later stage, in name order. Reads include while/cond sub-block
    closure reads (op_read_names), which the op's declared inputs would
    miss."""
    stage_of = {}
    for s, (lo, hi) in enumerate(spans):
        for j in range(lo, hi):
            for ns in region[j].outputs.values():
                for n in ns:
                    stage_of[n] = s
    last_read = {}
    for s, (lo, hi) in enumerate(spans):
        for j in range(lo, hi):
            for n in op_read_names(region[j]):
                if n in stage_of and stage_of[n] < s:
                    last_read[n] = s
    return [sorted(n for n, s in last_read.items() if stage_of[n] <= b < s)
            for b in range(len(spans) - 1)]


def run_pipeline_program(executor, program, feed, fetch_list, scope,
                         return_numpy):
    """Run one step of a PipelineOptimizer program on this rank
    (``Executor.run`` dispatches here): the JAX package's refusals, then
    :class:`PipelineProgram`."""
    from ..parallel.mesh import build_mesh, world

    info = program._parallel_info
    block = program.global_block()
    op_list = list(block.ops)
    bw_idx = next(
        (i for i, op in enumerate(op_list) if op.type == "backward"), None
    )
    if bw_idx is None:
        raise OpLoweringError(
            "pipeline mode needs a backward op: call "
            "PipelineOptimizer.minimize(loss) before Executor.run"
        )
    region = op_list[:bw_idx]
    bw_op = op_list[bw_idx]
    post_ops = op_list[bw_idx + 1:]
    spans = _split_stages(region, info.get("cut_list"))
    n_stages = len(spans)
    if n_stages < 2:
        raise OpLoweringError(
            "PipelineOptimizer cut_list produced %d stage(s); pass the "
            "boundary activation vars as cut_list=[...]" % n_stages
        )
    mesh = info.get("mesh")
    ranks = mesh.size if mesh is not None else world().size
    if ranks < n_stages:
        raise OpLoweringError(
            "pipeline needs one device per stage: %d stages but only %d "
            "device(s) visible (one rank each)" % (n_stages, ranks)
        )
    fetch_names = [_as_name(f) for f in fetch_list or []]
    loss_name = bw_op.input("Loss")[0]
    last_lo, last_hi = spans[-1]
    last_stage_produced = {
        n for j in range(last_lo, last_hi)
        for ns in region[j].outputs.values() for n in ns
    }
    post_produced = {
        n for op in post_ops for ns in op.outputs.values() for n in ns
    }
    persist_names = {
        v.name for v in block.vars.values() if v.persistable
    }
    for f in fetch_names:
        if (f != loss_name and f not in last_stage_produced
                and f not in post_produced and f not in persist_names):
            raise OpLoweringError(
                "pipeline fetch '%s' is produced mid-pipeline; only "
                "last-stage vars (loss, metrics), post-backward vars "
                "(lr, counters) and persistable state are fetchable in "
                "pipeline mode" % f
            )
    record_names = sorted(
        (set(fetch_names) & last_stage_produced) | {loss_name}
    )
    for n in bw_op.attrs["targets"]:
        if scope.find_value(n) is None:
            raise OpLoweringError(
                "pipeline backward target '%s' missing from scope — run the "
                "startup program first" % n
            )
    n_micro = info.get("n_microbatches") or n_stages
    dim0s = [np.shape(v)[0] for v in feed.values() if np.ndim(v) > 0]
    batch_dim = max(dim0s) if dim0s else 0
    if batch_dim and batch_dim % n_micro:
        raise OpLoweringError(
            "feed batch %d not divisible by %d microbatches"
            % (batch_dim, n_micro)
        )
    if info.get("param_rules"):
        raise OpLoweringError(
            "PipelineOptimizer(param_rules=...) is not supported: each "
            "heterogeneous stage body runs on the ranks of its own pp "
            "coordinate with its weights whole, and a weight split over "
            "another axis would need its collectives inside one stage's "
            "branch only. Shard the batch over 'dp' via feed_specs (dp "
            "groups stay within one pp coordinate), or use the "
            "stacked-stage pipeline "
            "(paddle_tpu_torch.parallel.pipeline.gpipe_composed).")
    if mesh is None:
        mesh = info.get("_default_mesh")
        if mesh is None:
            # every rank of the world makes it, members or not
            mesh = info["_default_mesh"] = build_mesh(
                {"pp": n_stages}, ranks=list(range(n_stages)))
    else:
        if "pp" not in mesh.axis_names:
            raise OpLoweringError(
                "PipelineOptimizer mesh must carry a 'pp' axis; got axes %s"
                % (mesh.axis_names,))
        if mesh.shape["pp"] != n_stages:
            raise OpLoweringError(
                "mesh 'pp' axis has size %d but cut_list produced %d "
                "stages" % (mesh.shape["pp"], n_stages))
    feed_specs = info.get("feed_specs") or {}
    unknown = set(feed_specs) - set(feed)
    if unknown:
        raise OpLoweringError(
            "PipelineOptimizer feed_specs name(s) %s match no feed "
            "(feeds: %s) — a typo here would silently replicate the "
            "batch instead of sharding it"
            % (sorted(unknown), sorted(feed)))
    runner = info.get("_runner")
    if runner is None or runner._mesh is not mesh:
        runner = info["_runner"] = PipelineProgram(program, mesh, info)
    return runner.step(executor, feed, fetch_names, record_names, scope,
                       return_numpy)


class PipelineProgram(DistributedProgram):
    """This rank's part of a PipelineOptimizer program over `mesh` (a
    rank group with a ``pp`` axis, and a ``dp`` axis or not). The
    DistributedProgram machinery gives it the first run's broadcast of
    rank 0's state, the dp slice of the feeds ``feed_specs`` split, the
    ZeRO-1 split of optimizer state (``opt_state_rules``), the dp
    gradient hook and the global fetches; saves of split state write the
    global values (fluid/io.py reads ``program._distributed``)."""

    def __init__(self, program, mesh, info):
        super().__init__(program, mesh, feed_axis=None,
                         feed_specs=info.get("feed_specs"),
                         opt_state_rules=info.get("opt_state_rules"))
        self._info = info
        self._pp = mesh.axis_group("pp")
        self._stages = (None, None)
        self._rings = {}
        self.last_step = {}

    # -- the program's stages, once per program version ---------------------
    def _stage_plan(self):
        program = self._program
        if self._stages[0] == program._version:
            return self._stages[1]
        op_list = list(program.global_block().ops)
        bw_idx = next(i for i, op in enumerate(op_list)
                      if op.type == "backward")
        region = op_list[:bw_idx]
        bw_op = op_list[bw_idx]
        spans = _split_stages(region, self._info.get("cut_list"))
        sends = _boundary_vars(region, spans)
        targets = list(bw_op.attrs["targets"])
        _, lays = self._state_plan()
        split_read = set()
        for op in region:
            split_read |= op_read_names(op) & set(lays)
        if split_read:
            raise OpLoweringError(
                "opt_state_rules matched %r, which the pipeline forward "
                "region READS — sharding it would put collectives inside "
                "one stage's body. Only post-pipeline optimizer state may "
                "shard." % sorted(split_read)[0])
        plan = dict(region=region, bw_op=bw_op,
                    post_ops=op_list[bw_idx + 1:], spans=spans,
                    sends=sends, targets=targets,
                    stop_at=_stop_gradient(region + [bw_op], [bw_idx],
                                           set()),
                    grad_names=list(bw_op.output("Grads")),
                    persist={v.name for v in
                             program.global_block().vars.values()
                             if v.persistable})
        self._stages = (program._version, plan)
        return plan

    def _ring(self, key, n_micro, device):
        from ..parallel.pipeline import Ring

        ring = self._rings.get(key)
        if ring is None:
            ring = self._rings[key] = Ring(self._pp, n_micro, device)
        ring.bytes = 0
        return ring

    # -- one step --------------------------------------------------------
    def step(self, executor, feed, fetch_names, record_names, scope,
             return_numpy):
        from ..parallel import tensor_parallel as tpl

        group = self._mesh
        if group.rank is None:
            raise RuntimeError(
                "this process (a rank outside the pipeline's group %s) "
                "cannot run its program" % (group,))
        program = self._program
        device = executor.device
        plan = self._stage_plan()
        block = program.global_block()
        feeds, split, _ = self._local_feeds(executor, program, feed)
        state = executor._gather_state(program, scope)
        self._sync(program, state, scope, device)
        _, lays = self._state_plan()
        n_micro = self._info.get("n_microbatches") or len(plan["spans"])
        dims = [v.shape[0] for v in feeds.values() if v.dim() > 0]
        batch = max(dims) if dims else 0
        if batch and batch % n_micro:
            raise OpLoweringError(
                "feed batch %d (this dp rank's slice) not divisible by %d "
                "microbatches" % (batch, n_micro))
        per = batch // n_micro if batch else 0
        micro = [{k: (v[m * per:(m + 1) * per]
                      if v.dim() > 0 and v.shape[0] == batch and batch
                      else v) for k, v in feeds.items()}
                 for m in range(n_micro)]
        seed = executor._next_seed(program, base=self._base_seed)
        d = self._dp_line.rank
        line = self._pp
        n_st, s = line.size, line.rank
        lo, hi = plan["spans"][s]
        region, stop_at = plan["region"], plan["stop_at"]
        loss_name = plan["bw_op"].input("Loss")[0]
        key = (program._version, n_micro, tuple(record_names), tuple(sorted(
            (k, tuple(v.shape), str(v.dtype)) for k, v in feeds.items())))
        ring = self._ring(key, n_micro, device)
        send = plan["sends"][s] if s < n_st - 1 else []
        leaves = {n: state[n].detach().requires_grad_(
            state[n].is_floating_point()) for n in plan["targets"]}
        base = dict(state)
        base.update(leaves)
        recv, sent, recs = {}, {}, {}
        sums = (f32_precision() if device.type == "cuda"
                else contextlib.nullcontext())

        def forward(m, got):
            env = dict(base)
            env.update(micro[m])
            if got is not None:
                names = plan["sends"][s - 1]
                got = [t.requires_grad_() if t.is_floating_point() else t
                       for t in got]
                env.update(zip(names, got))
                recv[m] = got
            gen = executor._seeded(hash((seed, d, m, s)) % (2 ** 62))
            ctx = LowerContext(device, generator=gen, is_test=False,
                               program=program, run_ops=run_ops)
            with torch.enable_grad():
                env = _run_span(region, lo, hi, env, ctx, stop_at, [None])
            if s < n_st - 1:
                sent[m] = [env[n] for n in send]
                return sent[m]
            recs[m] = {n: env[n] for n in record_names}
            return None

        live = [leaves[n] for n in plan["targets"]
                if leaves[n].requires_grad]
        acc = [None] * len(live)

        def backward(m, got):
            if s == n_st - 1:
                loss = recs[m][loss_name]
                outs = [loss]
                cots = [torch.full_like(loss, 1.0 / (n_micro * loss.numel()))]
            else:
                outs, cots, it = [], [], iter(got)
                for t in sent[m]:
                    if t.is_floating_point():
                        c = next(it)
                        if t.requires_grad:
                            outs.append(t)
                            cots.append(c)
            mine = [t for t in recv.get(m, []) if t.is_floating_point()]
            wrt = live + mine
            gs = (torch.autograd.grad(outs, wrt, cots, allow_unused=True)
                  if outs and wrt else [None] * len(wrt))
            for i, g in enumerate(gs[:len(live)]):
                if g is not None:
                    acc[i] = g if acc[i] is None else acc[i] + g
            if s == 0:
                return None
            return [torch.zeros_like(t) if g is None else g
                    for t, g in zip(mine, gs[len(live):])]

        with torch.no_grad(), sums:
            ring.run(forward)
            ring.run(backward, reverse=True)
            grads, it = {}, iter(acc)
            for t, gname in zip(plan["targets"], plan["grad_names"]):
                g = next(it) if leaves[t].requires_grad else None
                grads[gname] = (torch.zeros_like(state[t]) if g is None
                                else g.detach())
            del recv, sent, leaves, live, acc
            grads = self._sum_over_line(grads)
            record = self._records(recs, record_names, loss_name, key,
                                   device)
            del recs
            env = dict(state)
            env.update(feeds)
            env.update(record)
            hook = self._grad_comm()
            ctx = LowerContext(device, generator=executor._seeded(seed),
                               is_test=False, program=program,
                               run_ops=run_ops)
            if hook is not None:
                synced = hook(grads)
                grads.update(synced)
            if lays:
                ctx.layouts = {n: lay for n, lay in lays.items()
                               if n in state}
                ctx.layouts.update(getattr(hook, "grad_layouts", {}))
                ctx.groups = {"dp": self._dp_line}
            env.update(grads)
            for op in plan["post_ops"]:
                env = apply_op(op, env, ctx)
            end = ctx.layouts or {}
            for k in sorted(plan["persist"] & set(env)):
                v = env[k]
                if lays:
                    v = tpl.conform(self, v, end.get(k, tpl.WHOLE),
                                    lays.get(k, tpl.WHOLE))
                scope.update(k, v)
            out = [self._fetch(block, n, env[n], split and n not in record,
                               end.get(n, tpl.WHOLE))
                   for n in fetch_names]
        self.last_step = {"ring_bytes": ring.bytes, "stage": s,
                          "microbatches": n_micro}
        if return_numpy:
            return [to_numpy(v) for v in out]
        return out

    def _sum_over_line(self, grads):
        """Each gradient summed over the pp line: one all-reduce per
        dtype, of every gradient flattened into one buffer."""
        line = self._pp
        names = sorted(grads)
        by_dtype = {}
        for n in names:
            by_dtype.setdefault(grads[n].dtype, []).append(n)
        out = {}
        for dtype, ns in by_dtype.items():
            flat = line.all_reduce(torch.cat([grads[n].reshape(-1)
                                              for n in ns]))
            at = 0
            for n in ns:
                k = grads[n].numel()
                out[n] = flat[at:at + k].view_as(grads[n])
                at += k
        return out

    def _records(self, recs, record_names, loss_name, key, device):
        """The loss (the mean of the microbatch losses) and each recorded
        fetch (float: the microbatch mean; integer: the sum), made on the
        last stage and broadcast over the pp line."""
        line = self._pp
        last = line.size - 1
        vals = None
        if line.rank == last:
            vals = []
            for n in record_names:
                r = torch.stack([recs[m][n].detach()
                                 for m in sorted(recs)])
                if n == loss_name:
                    vals.append(r.float().mean())
                elif r.is_floating_point():
                    vals.append(r.float().mean(0).to(r.dtype))
                else:
                    vals.append(r.sum(0))
        specs = self._rings[key].specs
        if ("records",) not in specs:
            got = [None]
            if line.rank == last:
                got = [[(tuple(v.shape), v.dtype) for v in vals]]
            dist.broadcast_object_list(got, src=line.ranks[last],
                                       group=line.group)
            specs[("records",)] = got[0]
        from ..parallel.pipeline import _nbytes, _pack, _unpack

        spec = specs[("records",)]
        size = sum(_nbytes(x) for x in spec)
        buf = (_pack(vals, size, device) if vals is not None else
               torch.zeros(size, dtype=torch.uint8, device=device))
        got = _unpack(line.broadcast(buf, root=last), spec)
        return dict(zip(record_names, got))
