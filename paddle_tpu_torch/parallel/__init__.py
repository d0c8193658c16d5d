"""paddle_tpu_torch.parallel — the distributed subsystem (port of
paddle_tpu/parallel) on torch.distributed, one process per rank:

- :mod:`.mesh` — the rank group: a mesh of ``dp``, ``tp``, ``sp``,
  ``pp`` and ``ep`` axes over the world or a subset of its ranks (nccl or
  gloo), its lines along each axis, and their collectives;
- :mod:`.sharding` — ``DistributedProgram``: data, tensor, sequence and
  expert parallel execution of a Program and ZeRO-1 (feeds sliced by
  rank, parameters and optimizer state split by rules, gradients
  averaged over dp in the gradient hook, global batch-norm moments,
  global fetches);
- :mod:`.tensor_parallel` — the layouts of a run's values over the mesh
  axes, the differentiable collectives that move between them, and the
  fallback of an op without a layout rule;
- :mod:`.ring_attention` — ring attention over the ``sp`` axis, plain
  and on the flash kernels;
- :mod:`.pipeline` — the GPipe schedule over the ``pp`` axis
  (``gpipe``, ``gpipe_sharded``, ``gpipe_composed``), which
  ``fluid.optimizer.PipelineOptimizer`` programs run on
  (fluid/pipeline_executor.py);
- :mod:`.moe` — the Switch-MoE FFN (``switch_ffn``) and its experts'
  split over ``ep`` (``moe_ep_rules``);
- :mod:`.local_sgd` — ``LocalSGDProgram``: k-step local updates and
  periodic parameter averaging over dp;
- :mod:`.fleet` — the fleet API (``init``, ``distributed_optimizer``,
  ``DistributedStrategy``, the role makers);
- :mod:`.comms` — the gradient-communication subsystem: the block codec,
  the quantized two-shot allreduce, bucketing and ``GradSyncProgram``;
- :mod:`.checkpoint` — step-managed checkpoints: atomic steps,
  retention, background saves, digest manifests and the consensus
  markers of an elastic fleet;
- :mod:`.elastic` — heartbeat stores (:class:`InMemoryStore`,
  :class:`FileStore`), the :class:`HeartbeatMonitor` the serving
  routers classify replicas with, and :class:`FleetGuard`, the elastic
  training driver (guarded steps, store all-reduce over the live
  members, consensus checkpoints, shrink-to-survivors).

The transpilers and launchers (ROADMAP.md Queue 1 item 8.7) and the
retrieval tables over ``ep`` (10) wait for their items.
"""
from . import mesh  # noqa: F401
from . import sharding  # noqa: F401
from . import tensor_parallel  # noqa: F401
from . import ring_attention  # noqa: F401
from . import fleet  # noqa: F401
from . import comms  # noqa: F401
from . import checkpoint  # noqa: F401
from . import elastic  # noqa: F401
from . import pipeline  # noqa: F401
from . import moe  # noqa: F401
from . import local_sgd  # noqa: F401
