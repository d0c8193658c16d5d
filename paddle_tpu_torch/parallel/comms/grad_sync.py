"""Explicit dp gradient sync: bucketed (optionally quantized) allreduce
of the raw gradients every step (port of
paddle_tpu/parallel/comms/grad_sync.py).

Where :class:`..sharding.DistributedProgram` averages each gradient with
its own all-reduce, this program OWNS the gradient collectives: the
``grad_comm`` hook (fluid/lowering.py) hands it each rank's raw
gradients between the backward op and the optimizer ops, and
:func:`..comms.bucketing.sync_bucketed` reduces them bucket by bucket —
block-scaled int8/fp8 payloads (:mod:`.quantize`), error-feedback
residuals kept in each rank's scope as its own persistables,
reverse-backward bucket order.

Determinism contract: the bucket plan is a pure function of the program
(backward-op targets + parameter shapes) and the config — identical
across ranks and restarts, so every rank issues the same collectives in
the same order and the residual shapes are stable and checkpointable.

Telemetry (through the observability hub, gated on
``PADDLE_TPU_TELEMETRY``), under the JAX package's names:

- ``comm.bytes_sent`` / ``comm.bytes_saved`` counters — wire bytes per
  step across the dp group, and bytes the quantized path avoided vs
  fp32;
- ``comm.compression_ratio`` gauge — fp32 bytes / actual bytes for one
  gradient sync (1.0 on the exact path);
- ``comm.overlap_ratio`` gauge — fraction of comm bytes with overlap
  opportunity (deterministic, from the plan; 0.0 when overlap is off
  or there is a single bucket).

The JAX package also records ``comm.allreduce_seconds``, a cost-model
prediction of the comm leg (wire bytes over the device profile's
interconnect bandwidth, ``analysis/costs.py``). The port records it when
that cost model is ported, with ROADMAP.md Queue 1 item 11.

Every step goes through
:func:`paddle_tpu_torch.ops.collective_ops.collective_guard`
("grad_sync"), so collective deadlines and ``PADDLE_TPU_FAULT_SPEC``
drills at the ``collective`` site cover it like the c_* ops.
"""
import torch

from ... import observability as obs
from ...fluid.executor import global_scope
from ..sharding import StackedDpProgram
from .allreduce import CommConfig, allreduce_wire_bytes
from .bucketing import (bucket_padded_len, plan_buckets, residual_name,
                        sync_bucketed)

__all__ = ["GradSyncProgram"]


class GradSyncProgram(StackedDpProgram):
    """Every-step synchronous dp with explicit, configurable gradient
    collectives. Each rank keeps its own state (use
    :meth:`consolidate_scope` before saving persistables)."""

    _mode_name = "GradSync"

    def __init__(self, program, mesh, comm_config=None, **kw):
        super().__init__(program, mesh, **kw)
        self._cfg = comm_config or CommConfig()
        self._plans = self._build_plans()
        self._residual_names = []
        self._residual_shapes = {}
        self._residuals = {}
        if self._cfg.quantized and self._cfg.error_feedback:
            ndp = mesh.size
            for plan in self._plans:
                for b in plan.buckets:
                    n = residual_name(b)
                    self._residual_shapes[n] = (
                        bucket_padded_len(b, ndp, self._cfg.block_size),)
                    self._residual_names.append(n)
            self._local_names |= set(self._residual_names)
        self._wire_stats = self._compute_wire_stats()

    # -- host-side planning -----------------------------------------------
    def _build_plans(self):
        """One deterministic BucketPlan per backward op, over the grads
        of trainable float params with static shapes. Bucket indices are
        globally renumbered so residual state names never collide."""
        block = self._program.global_block()
        trainable = {
            v.name: v for v in block.all_parameters()
            if getattr(v, "trainable", True)
        }
        plans, counter = [], 0
        for op in block.ops:
            if op.type != "backward":
                continue
            items = []
            for t, g in zip(op.attrs.get("targets", ()),
                            op.output("Grads")):
                var = trainable.get(t)
                if var is None:
                    continue
                shape = tuple(getattr(var, "shape", ()) or ())
                if not shape or not all(
                        isinstance(d, int) and d > 0 for d in shape):
                    continue
                items.append((g, shape))
            if not items:
                continue
            plan = plan_buckets(items, self._cfg.bucket_bytes)
            for b in plan.buckets:
                b.index = counter
                counter += 1
            plans.append(plan)
        return plans

    def _compute_wire_stats(self):
        """Deterministic per-step wire accounting across the dp group:
        (bytes_sent, bytes_fp32, overlap_ratio)."""
        ndp = self._mesh.size
        cfg = self._cfg
        sent = fp32 = 0.0
        for plan in self._plans:
            for b in plan.buckets:
                padded = bucket_padded_len(
                    b, ndp, cfg.block_size if cfg.quantized else 1)
                fp32 += ndp * allreduce_wire_bytes(padded, ndp)
                sent += ndp * allreduce_wire_bytes(
                    padded, ndp, quantized=cfg.quantized,
                    block_size=cfg.block_size, wire_dtype=cfg.wire_dtype)
        if len(self._plans) == 1:
            overlap = self._plans[0].overlap_ratio(cfg.overlap)
        elif self._plans:
            # multi-backward programs: weight each plan's ratio by bytes
            tot = sum(p.total_elements for p in self._plans)
            overlap = sum(
                p.overlap_ratio(cfg.overlap) * p.total_elements
                for p in self._plans) / max(tot, 1)
        else:
            overlap = 0.0
        return {"bytes_sent": sent, "bytes_fp32": fp32,
                "overlap_ratio": overlap}

    # -- DistributedProgram hooks -------------------------------------------
    def _seed_extra_state(self, state, scope, device):
        """Each rank's residuals (zeros before its first step), read by
        the hook and written back to the rank's scope after the step."""
        res = {}
        for n in self._residual_names:
            v = scope.find_value(n)
            if v is None:
                v = torch.zeros(self._residual_shapes[n],
                                dtype=torch.float32, device=device)
            res[n] = torch.as_tensor(v).to(device)
        self._residuals = res

    def _grad_comm(self):
        cfg, plans, group = self._cfg, self._plans, self._mesh
        owner = self

        def hook(grads):
            synced = {}
            for plan in plans:
                names = {n for b in plan.buckets for n in b.names}
                if not names <= set(grads):
                    continue
                s, new_res = sync_bucketed(grads, group, cfg, plan,
                                           residuals=owner._residuals)
                synced.update(s)
                owner._residuals.update(new_res)
            return synced

        return hook

    def _executor_run(self, executor, feed, fetch_list, scope,
                      return_numpy):
        out = super()._executor_run(executor, feed, fetch_list, scope,
                                    return_numpy)
        scope = scope if scope is not None else global_scope()
        for n, v in self._residuals.items():
            scope.update(n, v)
        return out

    def _on_dispatch(self):
        if not self._plans:
            return
        from ...ops.collective_ops import collective_guard

        collective_guard("grad_sync")
        stats = self._wire_stats
        obs.inc("comm.bytes_sent", int(stats["bytes_sent"]))
        obs.inc("comm.bytes_saved",
                int(stats["bytes_fp32"] - stats["bytes_sent"]))
        if stats["bytes_sent"]:
            obs.set_gauge("comm.compression_ratio",
                          stats["bytes_fp32"] / stats["bytes_sent"])
        obs.set_gauge("comm.overlap_ratio", stats["overlap_ratio"])
