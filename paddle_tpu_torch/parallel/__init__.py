"""paddle_tpu_torch.parallel — the distributed subsystem (port of
paddle_tpu/parallel), as far as the serving fleet needs it:

- :mod:`.elastic` — heartbeat stores (:class:`InMemoryStore`,
  :class:`FileStore`) and the :class:`HeartbeatMonitor` the serving
  routers classify replicas with;
- :mod:`.comms.quantize` — the EQuARX block-scaled codec the KV handoff
  rides.

The mesh, sharding, fleet, pipeline, checkpointing and the rest of
``comms`` wait for ROADMAP.md Queue 1 item 8.
"""
from . import elastic  # noqa: F401
