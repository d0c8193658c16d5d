"""fleet distributed-training API (port of paddle_tpu/parallel/fleet.py;
ref: python/paddle/fluid/incubate/fleet/collective/__init__.py and
incubate/fleet/base/fleet_base.py).

Same surface: init(role_maker) / distributed_optimizer(opt, strategy) /
minimize / main_program. ``init`` joins the world of ranks the role
maker describes (parallel/mesh.py ``init_group``: ``PADDLE_TRAINER_ID``
/ ``PADDLE_TRAINERS_NUM`` for ``PaddleCloudRoleMaker``), and
``minimize`` hands back the program every rank runs through the
ordinary Executor: a :class:`..sharding.DistributedProgram` over the
mesh ``{"dp": W / (tp·sp), "tp": tp, "sp": sp}`` with the strategy's
``tensor_parallel_rules`` and, for ``sharding_degree > 1``, ZeRO-1's
``ShardingRule(".*", P("dp"))`` on the optimizer state
(``grad_sync_mode="gspmd"``, the default), a
:class:`..comms.GradSyncProgram` (bucketed, optionally quantized
gradient sync, ``"comms"``, pure dp), or with ``use_local_sgd`` a
:class:`..local_sgd.LocalSGDProgram` (``local_sgd_k_steps``,
``local_sgd_quantized_sync``, pure dp).

The JAX package's refusals and warnings stay (``use_dgc``, pipeline
degree, pserver mode, the exclusions among LocalSGD, comms, tp/sp and
ZeRO, and ``sharding_degree`` without a dp axis). Saves go through the
program's ``consolidated_scope`` where it keeps per-rank state
(LocalSGD, comms).
"""
import os
import warnings

import torch.distributed as dist

from ..fluid import framework
from .mesh import P, build_mesh, init_group, world
from .sharding import DistributedProgram, ShardingRule

__all__ = [
    "init", "is_worker", "is_server", "worker_num", "worker_index",
    "distributed_optimizer", "DistributedStrategy", "PaddleCloudRoleMaker",
    "UserDefinedRoleMaker", "fleet", "FleetNotInitializedError",
]


class FleetNotInitializedError(RuntimeError):
    """A fleet/role-maker API that needs ``fleet.init(role_maker)`` (or
    ``RoleMakerBase.__init__``) was called before initialization. Raised
    instead of the bare AttributeError the half-constructed object would
    otherwise produce."""


# accepted for API parity: the port has one communicator per group and
# one all-reduce per gradient (or per bucket, in comms mode)
PARITY_ONLY_STRATEGY_ATTRS = frozenset({
    "nccl_comm_num", "fuse_all_reduce_ops",
})


class DistributedStrategy:
    """Collective-mode strategy knobs (ref: fleet DistributedStrategy +
    DistributedStrategy in collective fleet), the JAX package's."""

    def __init__(self):
        self.mode = "collective"
        self.nccl_comm_num = 1  # parity only
        # LocalSGD collective mode (ref transpiler/collective.py LocalSGD):
        # k-step local updates + periodic param averaging over dp
        self.use_local_sgd = False
        self.local_sgd_k_steps = 1
        self.local_sgd_quantized_sync = False
        # explicit gradient-communication subsystem (parallel/comms):
        # "gspmd" (default) averages each gradient with its own
        # all-reduce; "comms" runs GradSyncProgram — bucketed allreduces
        # in reverse-backward order, optionally block-scaled quantized
        # with error feedback. Pure-dp only.
        self.grad_sync_mode = "gspmd"
        self.grad_quantize = False
        self.grad_quantize_block = 256
        self.grad_wire_dtype = "int8"
        self.grad_error_feedback = True
        self.grad_bucket_bytes = 4 << 20
        self.grad_overlap = True
        self.use_dgc = False
        self.fuse_all_reduce_ops = True  # parity only
        # mesh layout
        self.tensor_parallel_degree = 1
        self.sequence_parallel_degree = 1
        self.pipeline_parallel_degree = 1
        # ep: embedding-parallel width for retrieval/embedding programs
        # — carried by the strategy, never read by _build
        self.embedding_parallel_degree = 1
        self.sharding_degree = 1  # ZeRO-style optimizer-state sharding
        # name-pattern tensor-parallel rules: [(regex, spec tuple)]
        self.tensor_parallel_rules = []
        self.amp = False
        self.recompute = False
        self.recompute_checkpoints = []

    @classmethod
    def from_plan(cls, plan, workload="train"):
        """Build a strategy from a planner plan — a
        :class:`paddle_tpu.planner.ParallelPlan`, the dict its
        ``to_dict`` emits, or a whole ``--json-out`` plan document
        (the ``best.plan`` entry is used).

        ``workload`` picks the program family the strategy will drive:
        the default ``"train"`` is the dense collective build (dp/tp/sp
        meshes); ``"retrieval"`` / ``"embedding"`` / ``"lookup"``
        additionally accept ``ep`` meshes — the degree lands in
        ``embedding_parallel_degree`` for
        :func:`paddle_tpu.retrieval.ep_mesh` to consume. For dense
        training, ep/pp plans still raise NotImplementedError, naming
        the search's best fleet-runnable alternative when a full plan
        document is given."""
        d = plan
        if hasattr(d, "to_dict"):
            d = d.to_dict()
        if not isinstance(d, dict):
            raise TypeError(
                "from_plan wants a ParallelPlan or its dict, got %r"
                % type(plan).__name__)
        # accept the full search document too (keep its ranked list so
        # a rejection can name the best runnable alternative)
        ranked = d.get("ranked") if isinstance(d.get("ranked"), list) else None
        if "plan" in d and isinstance(d["plan"], dict):
            d = d["plan"]
            if ranked is None and isinstance(d.get("ranked"), list):
                ranked = d["ranked"]
        if "best" in d and isinstance(d["best"], dict):
            d = d["best"].get("plan", d["best"])
        mesh = d.get("mesh") or {}
        retrieval = workload in ("retrieval", "embedding", "lookup")
        allowed = ("dp", "tp", "sp", "ep") if retrieval else ("dp", "tp", "sp")
        bad = [a for a in mesh if a not in allowed]
        if bad:
            alt = None
            for entry in ranked or []:
                p = entry.get("plan", entry) if isinstance(entry, dict) else {}
                if p.get("fleet_runnable") or all(
                        a in ("dp", "tp", "sp")
                        for a in (p.get("mesh") or {})):
                    alt = p.get("name")
                    break
            hint = ("; best fleet-runnable alternative in this search: "
                    "%r" % alt) if alt else ""
            if "ep" in bad and not retrieval:
                hint += ("; for embedding/retrieval programs pass "
                         "workload='retrieval' — ep plans run through "
                         "paddle_tpu.retrieval sharded tables")
            raise NotImplementedError(
                "plan %r uses mesh axes %s the fleet collective build "
                "does not run for %r workloads (pp -> fluid.optimizer."
                "PipelineOptimizer, ep -> paddle_tpu.retrieval)%s"
                % (d.get("name", "?"), sorted(bad), workload, hint))
        s = cls()
        s.tensor_parallel_degree = int(mesh.get("tp", 1))
        s.sequence_parallel_degree = int(mesh.get("sp", 1))
        s.embedding_parallel_degree = int(mesh.get("ep", 1))
        s.grad_sync_mode = d.get("grad_sync_mode", "gspmd")
        s.grad_quantize = bool(d.get("grad_quantize", False))
        s.grad_quantize_block = int(d.get("grad_quantize_block", 256))
        s.grad_bucket_bytes = int(d.get("grad_bucket_bytes", 4 << 20))
        s.grad_overlap = bool(d.get("grad_overlap", True))
        s.sharding_degree = int(d.get("sharding_degree", 1))
        s.amp = bool(d.get("amp", False))
        return s

class RoleMakerBase:
    def __init__(self):
        self._worker_num = 1
        self._index = 0
        self._role_generated = False

    def _require_init(self, what):
        # a subclass that skipped super().__init__() (or a caller poking
        # a bare class) must get the actionable error, not AttributeError
        if not hasattr(self, "_worker_num") or not hasattr(self, "_index"):
            raise FleetNotInitializedError(
                "%s called on an uninitialized role maker — call "
                "RoleMakerBase.__init__ (via super().__init__()) and "
                "generate_role() first" % what)

    def worker_num(self):
        self._require_init("worker_num()")
        return self._worker_num

    def worker_index(self):
        self._require_init("worker_index()")
        return self._index

    def is_worker(self):
        return True

    def is_server(self):
        return False

    def generate_role(self):
        self._require_init("generate_role()")
        self._role_generated = True


class PaddleCloudRoleMaker(RoleMakerBase):
    def __init__(self, is_collective=True):
        super().__init__()
        self._worker_num = int(os.environ.get("PADDLE_TRAINERS_NUM", 1))
        self._index = int(os.environ.get("PADDLE_TRAINER_ID", 0))


class UserDefinedRoleMaker(RoleMakerBase):
    def __init__(self, current_id=0, role=None, worker_num=1,
                 server_endpoints=None):
        super().__init__()
        self._worker_num = worker_num
        self._index = current_id


class Fleet:
    def __init__(self):
        self._role_maker = None
        self._strategy = None
        self._mesh = None
        self._origin_program = None
        self._distributed_program = None
        self._optimizer = None
        self._elastic = None  # an elastic guard (item 8.6), if any

    # -- lifecycle -------------------------------------------------------
    def init(self, role_maker=None, is_collective=True):
        """Take the role maker and, when it describes more than one
        worker and torch.distributed is not initialized yet, join that
        world (:func:`..mesh.init_group`: the card ``cuda:<rank>`` over
        nccl, the rendezvous from the environment). A caller that made
        its group itself (``init_group`` with a store, a CPU device or
        gloo) keeps it."""
        self._role_maker = role_maker or PaddleCloudRoleMaker()
        n = self._role_maker.worker_num()
        if n > 1 and not dist.is_initialized():
            init_group(rank=self._role_maker.worker_index(), world_size=n)
        return self

    def is_worker(self):
        return self._role_maker is None or self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker is not None and self._role_maker.is_server()

    def is_first_worker(self):
        return self.worker_index() == 0

    def worker_num(self):
        ranks = dist.get_world_size() if dist.is_initialized() else 1
        return max(ranks,
                   self._role_maker.worker_num() if self._role_maker else 1)

    def worker_index(self):
        return self._role_maker.worker_index() if self._role_maker else 0

    def worker_endpoints(self, to_string=False):
        eps = [e for e in os.environ.get(
            "PADDLE_TRAINER_ENDPOINTS", "").split(",") if e]
        if not eps:
            eps = ["rank:%d" % i for i in range(self.worker_num())]
        return ",".join(eps) if to_string else eps

    def attach_elastic(self, guard):
        """Wire an elastic guard in: barriers go through its heartbeat
        store (real cross-worker rendezvous with deadlines) instead of
        the group's barrier. The port's FleetGuard comes with ROADMAP.md
        Queue 1 item 8.6."""
        self._elastic = guard
        return self

    def barrier_worker(self, timeout=None):
        """Rendezvous across workers. Requires ``init()``; honors the
        ``barrier`` fault site and any armed collective deadline (checked
        before the barrier is issued), then waits on the group's
        ``torch.distributed.barrier``; with an elastic guard attached,
        blocks at most `timeout` seconds on its store."""
        if self._role_maker is None:
            raise FleetNotInitializedError(
                "Fleet.barrier_worker called before fleet.init() — call "
                "fleet.init(role_maker) first")
        from ..fluid.resilience import collective_check

        collective_check("Fleet.barrier_worker", site="barrier")
        if self._elastic is not None:
            return self._elastic.barrier("fleet", timeout=timeout)
        world().barrier()

    # -- programs --------------------------------------------------------
    @property
    def main_program(self):
        return self._distributed_program or framework.default_main_program()

    @property
    def startup_program(self):
        return framework.default_startup_program()

    def distributed_optimizer(self, optimizer, strategy=None):
        self._strategy = strategy or DistributedStrategy()
        self._optimizer = DistributedOptimizer(optimizer, self._strategy, self)
        return self._optimizer

    def _build(self, program):
        s = self._strategy or DistributedStrategy()
        if s.mode != "collective":
            raise NotImplementedError(
                "DistributedStrategy.mode=%r: only 'collective' is "
                "implemented (pserver mode lives in "
                "fleet.parameter_server / the DistributeTranspiler "
                "surface)" % (s.mode,)
            )
        if s.use_dgc:
            raise NotImplementedError(
                "DistributedStrategy.use_dgc is not wired into the "
                "collective build; use fluid.optimizer."
                "DGCMomentumOptimizer directly (its top-k sparsified "
                "local-accumulation semantics are implemented there)"
            )
        if s.pipeline_parallel_degree > 1:
            raise NotImplementedError(
                "DistributedStrategy.pipeline_parallel_degree: pipeline "
                "parallelism runs through fluid.optimizer."
                "PipelineOptimizer + fluid.pipeline_executor (gpipe "
                "microbatch schedule over the 'pp' axis), not the "
                "fleet collective build"
            )
        tp = max(1, s.tensor_parallel_degree)
        sp = max(1, s.sequence_parallel_degree)
        if s.use_local_sgd:
            if s.sharding_degree > 1:
                raise NotImplementedError(
                    "use_local_sgd with sharding_degree>1: ZeRO shards "
                    "optimizer state over dp, LocalSGD keeps divergent "
                    "per-dp-shard state — pick one"
                )
            if tp > 1 or sp > 1:
                raise NotImplementedError(
                    "use_local_sgd with tensor/sequence parallelism: "
                    "LocalSGD stacks whole per-dp-shard param copies, "
                    "which would silently override the tp/sp sharding "
                    "rules — run LocalSGD pure-dp"
                )
            if s.grad_sync_mode == "comms":
                raise NotImplementedError(
                    "grad_sync_mode='comms' with use_local_sgd: LocalSGD "
                    "averages PARAMETERS every k steps, the comms "
                    "subsystem allreduces GRADIENTS every step — the "
                    "two sync disciplines exclude each other (LocalSGD's "
                    "quantized payload is local_sgd_quantized_sync)"
                )
            from .local_sgd import LocalSGDProgram

            self._mesh = build_mesh({"dp": world().size})
            self._distributed_program = LocalSGDProgram(
                program, self._mesh, k_steps=s.local_sgd_k_steps,
                quantized_sync=s.local_sgd_quantized_sync,
                param_rules=[ShardingRule(p, spec)
                             for p, spec in s.tensor_parallel_rules])
            return self._distributed_program
        if s.grad_sync_mode == "comms":
            from .comms import CommConfig, GradSyncProgram

            if tp > 1 or sp > 1:
                raise NotImplementedError(
                    "grad_sync_mode='comms' with tensor/sequence "
                    "parallelism: GradSync keeps whole per-rank param "
                    "copies, which would silently override the tp/sp "
                    "sharding rules — run it pure-dp"
                )
            if s.sharding_degree > 1:
                raise NotImplementedError(
                    "grad_sync_mode='comms' with sharding_degree>1: "
                    "ZeRO shards optimizer state over dp, GradSync "
                    "keeps per-rank state — pick one"
                )
            self._mesh = build_mesh({"dp": world().size})
            self._distributed_program = GradSyncProgram(
                program, self._mesh,
                comm_config=CommConfig(
                    quantized=s.grad_quantize,
                    block_size=s.grad_quantize_block,
                    wire_dtype=s.grad_wire_dtype,
                    error_feedback=s.grad_error_feedback,
                    bucket_bytes=s.grad_bucket_bytes,
                    overlap=s.grad_overlap,
                ),
            )
            return self._distributed_program
        if s.grad_sync_mode not in ("gspmd", None):
            raise NotImplementedError(
                "grad_sync_mode=%r: 'gspmd' (one all-reduce per "
                "gradient) or 'comms' (parallel/comms explicit "
                "bucketed/quantized gradient sync)" % (s.grad_sync_mode,)
            )
        # the mesh as the JAX package lays it out: dp takes the ranks
        # tp and sp leave
        ndev = world().size
        axes = {}
        used = tp * sp
        if ndev // used >= 1:
            axes["dp"] = ndev // used
        if tp > 1:
            axes["tp"] = tp
        if sp > 1:
            axes["sp"] = sp
        self._mesh = build_mesh(axes)
        rules = [ShardingRule(p, spec) for p, spec in s.tensor_parallel_rules]
        opt_rules = []
        if s.sharding_degree > 1:
            # ZeRO-1: optimizer state (moments etc.) split over dp;
            # params keep their tp/replicated layout. Any degree > 1
            # splits over the FULL dp axis, as the JAX package does.
            dp = axes.get("dp", 1)
            if dp <= 1:
                warnings.warn(
                    "sharding_degree=%d has no effect: the dp mesh axis "
                    "is size %d (all devices consumed by tp/sp) — "
                    "optimizer state stays replicated"
                    % (s.sharding_degree, dp)
                )
            else:
                opt_rules.append(ShardingRule(r".*", P("dp")))
        self._distributed_program = DistributedProgram(
            program, self._mesh, param_rules=rules,
            opt_state_rules=opt_rules)
        return self._distributed_program

    def _first_worker_saves(self, save, main_program):
        """`save` under the consolidated scope where the program keeps
        per-rank state (every rank takes part in that collective), on
        rank 0 only."""
        dist_prog = self._distributed_program
        snap = None
        if hasattr(dist_prog, "consolidated_scope"):
            from ..fluid.executor import global_scope

            snap = dist_prog.consolidated_scope(global_scope())
        if world().rank != 0:
            return None
        program = main_program or framework.default_main_program()
        if snap is None:
            return save(program)
        from ..fluid.executor import scope_guard

        with scope_guard(snap):
            return save(program)

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None,
                             export_for_deployment=True):
        """Rank 0 writes the inference model (the other ranks return
        None)."""
        from ..fluid import io

        return self._first_worker_saves(
            lambda prog: io.save_inference_model(
                dirname, feeded_var_names, target_vars, executor, prog),
            main_program)

    def save_persistables(self, executor, dirname, main_program=None):
        """Rank 0 writes the persistables (the other ranks return None);
        per-rank state (comms mode) is averaged first, as the JAX
        package collapses its stacked copies."""
        from ..fluid import io

        return self._first_worker_saves(
            lambda prog: io.save_persistables(executor, dirname, prog),
            main_program)


class DistributedOptimizer:
    def __init__(self, optimizer, strategy, fleet_obj):
        self._optimizer = optimizer
        self._strategy = strategy
        self._fleet = fleet_obj

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        opt = self._optimizer
        if self._strategy.recompute:
            from ..fluid.optimizer import RecomputeOptimizer

            opt = RecomputeOptimizer(opt)
            opt._set_checkpoints(self._strategy.recompute_checkpoints)
        if self._strategy.amp:
            from ..fluid.contrib.mixed_precision import decorate

            opt = decorate(opt)
        result = opt.minimize(
            loss, startup_program, parameter_list, no_grad_set
        )
        self._fleet._build(loss.block.program)
        return result

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


fleet = Fleet()


def init(role_maker=None, is_collective=True):
    return fleet.init(role_maker, is_collective)


def is_worker():
    return fleet.is_worker()


def is_server():
    return fleet.is_server()


def worker_num():
    return fleet.worker_num()


def worker_index():
    return fleet.worker_index()


def distributed_optimizer(optimizer, strategy=None):
    return fleet.distributed_optimizer(optimizer, strategy)
