"""paddle_tpu_torch.serving — online inference on the card (port of
paddle_tpu/serving)::

    ModelRegistry          named models, isolated scopes, atomic hot reload
      └─ ServingRouter     N replicas, heartbeat-driven health, least-
                           loaded dispatch, shed-aware failover, warm
                           standby autoscale, rolling version rollout
        └─ ServingEngine   bounded queue + dispatch thread, dynamic
                           micro-batching, deadlines, load shedding
             └─ Predictor  eager forward, parameters resident on the card
    DecodeEngine           slotted KV cache, continuous batching,
                           streaming; int8-resident cache, decode-only role
      ├─ Predictor         one per prefill bucket + one step program,
                           sharing one device copy of the parameters
      ├─ PrefixPool        prefix digest -> prefilled KV rows (adopt +
                           delta-prefill the suffix); SessionTier parks
                           retired sessions' KV on the host
      └─ DraftModel        speculative decoding: k draft proposals, one
                           verify block per dispatch
    DisaggRouter           prefill replicas (PrefillEngine) hand int8 KV
                           handoffs to step-only decode replicas;
                           session-affine, migrates by re-prefill,
                           tenant quotas and priorities
    ServingServer          stdlib HTTP/JSON frontend (/v1/models/<name>:
                           predict, chunked :generate, /healthz, /metrics)

A fleet publishes like one engine —
``reg.publish("m", router.local_fleet(dir, n_replicas=4))`` — because the
router wears the engine's duck type; likewise
``reg.publish("gpt", disagg.disagg_fleet(cfg, scope))``.

Every layer reports to :mod:`paddle_tpu_torch.observability` under the
JAX package's metric names, the fleet layer included:
``serving.replicas_live`` / ``serving.rollout_state`` gauges,
``serving.failovers`` / ``serving.router_retry`` /
``serving.replica_dead`` counters and the ``serving.dispatch_seconds``
histogram. KV reuse and speculation (``prefix_pool.py``, ``spec.py``)
attach to the engines — ``DecodeEngine(cfg, scope, draft=...,
prefix_pool=..., session_tier=...)``, ``PrefillEngine(...,
prefix_pool=...)`` — and report ``serving.prefix.*``, ``serving.tier.*``
and ``serving.spec.accept_rate``, with a ``reuse`` block in
``/healthz``.
"""
from .batcher import BucketSpec, assemble, round_up_pow2, tail_signature  # noqa: F401
from .decode import (  # noqa: F401
    DecodeEngine, DecodeStream, default_prompt_buckets, kv_slot_bytes,
)
from .engine import (  # noqa: F401
    DeadlineExceededError, EngineClosedError, ServingEngine, ShedError,
)
from .http import ServingHandler, ServingServer  # noqa: F401
from .prefix_pool import PrefixPool, SessionTier, prefix_digest  # noqa: F401
from .registry import ModelRegistry  # noqa: F401
from .spec import DraftModel  # noqa: F401
from .router import (  # noqa: F401
    LocalReplica, NoReplicasError, ReplicaGoneError, ReplicaWorker,
    RolloutError, ServingRouter, StoreReplica, local_fleet,
    make_engine_factory,
)
from .disagg import (  # noqa: F401  (after .decode/.router: it layers on them)
    DisaggReplica, DisaggRouter, DisaggStream, KVHandoff, PrefillEngine,
    PrefillTicket, TenantSpec, TenantTable, disagg_fleet,
)

__all__ = [
    "BucketSpec", "DeadlineExceededError", "DecodeEngine", "DecodeStream",
    "DisaggReplica", "DisaggRouter", "DisaggStream", "DraftModel",
    "EngineClosedError", "KVHandoff", "LocalReplica", "ModelRegistry",
    "NoReplicasError", "PrefillEngine", "PrefillTicket", "PrefixPool",
    "ReplicaGoneError", "ReplicaWorker", "RolloutError", "ServingEngine",
    "ServingHandler", "ServingRouter", "ServingServer", "SessionTier",
    "ShedError", "StoreReplica", "TenantSpec", "TenantTable", "assemble",
    "default_prompt_buckets", "disagg_fleet", "kv_slot_bytes",
    "local_fleet", "make_engine_factory", "prefix_digest", "round_up_pow2",
    "tail_signature",
]
