"""paddle_tpu_torch.parallel — the distributed subsystem (port of
paddle_tpu/parallel) on torch.distributed, one process per rank:

- :mod:`.mesh` — the rank group (the ``"dp"`` axis over the world or a
  subset of its ranks, nccl or gloo) and its collectives;
- :mod:`.sharding` — ``DistributedProgram``: data-parallel execution of
  a Program (feeds sliced by rank, gradients averaged in the gradient
  hook, global batch-norm moments, global fetches);
- :mod:`.fleet` — the fleet API (``init``, ``distributed_optimizer``,
  ``DistributedStrategy``, the role makers);
- :mod:`.comms` — the gradient-communication subsystem: the block codec,
  the quantized two-shot allreduce, bucketing and ``GradSyncProgram``;
- :mod:`.elastic` — heartbeat stores (:class:`InMemoryStore`,
  :class:`FileStore`) and the :class:`HeartbeatMonitor` the serving
  routers classify replicas with.

ZeRO and tensor-parallel rules (ROADMAP.md Queue 1 item 8.3), ring
attention (8.4), pipeline, MoE and LocalSGD (8.5), checkpointing and
``FleetGuard`` (8.6) and the transpilers and launchers (8.7) wait for
their items.
"""
from . import mesh  # noqa: F401
from . import sharding  # noqa: F401
from . import fleet  # noqa: F401
from . import comms  # noqa: F401
from . import elastic  # noqa: F401
