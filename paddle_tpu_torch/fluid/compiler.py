"""CompiledProgram: data-parallel execution
(ref: python/paddle/fluid/compiler.py + framework/parallel_executor.cc).

Port of paddle_tpu/fluid/compiler.py. The JAX package jits one global
step over a device Mesh and lets XLA insert the gradient all-reduces.
The port runs one process per rank: ``with_data_parallel`` runs the
program as a :class:`~paddle_tpu_torch.parallel.sharding.
DistributedProgram` over the rank group of the world (parallel/mesh.py;
one rank when no group was made), which slices each feed's batch axis
by rank, averages the gradients over the ranks and returns the global
batch's fetches. Without ``with_data_parallel`` the program runs as the
Executor runs it.
"""
from .framework import Variable

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]


class BuildStrategy:
    """Accepted for API parity: the reference's graph-pass knobs. The port
    runs eagerly and averages each gradient over the ranks (the
    reference's ``CoeffNumDevice`` gradient scale)."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = (
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        )
        self.memory_optimize = None
        self.enable_inplace = None
        self.fuse_all_reduce_ops = True
        self.fuse_all_optimizer_ops = False
        self.fuse_elewise_add_act_ops = False
        self.sync_batch_norm = False
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 100
        self.num_iteration_per_run = 1
        self.use_thread_barrier = True


class CompiledProgram:
    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._is_data_parallel = False
        self._loss_name = None
        self._places = None
        self._share_vars_from = None
        self._mesh = None
        self._dist = None

    def with_data_parallel(
        self,
        loss_name=None,
        build_strategy=None,
        exec_strategy=None,
        share_vars_from=None,
        places=None,
    ):
        """Run the program data-parallel over the ranks of the world.
        `places` is accepted as in the JAX package, where it picks the
        mesh's devices; here each rank computes on its executor's
        place."""
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._share_vars_from = share_vars_from
        self._places = places
        return self

    def with_inference_optimize(self, config):
        return self

    def _get_mesh(self):
        if self._mesh is None:
            from ..parallel.mesh import get_default_mesh

            self._mesh = get_default_mesh()
        return self._mesh

    # called by Executor.run when program is a CompiledProgram
    def _executor_run(self, executor, feed, fetch_list, scope, return_numpy):
        if not self._is_data_parallel:
            return executor.run(self._program, feed, fetch_list,
                                scope=scope, return_numpy=return_numpy)
        if self._dist is None:
            from ..parallel.sharding import DistributedProgram

            self._dist = DistributedProgram(self._program, self._get_mesh())
        fetch_list = [f.name if isinstance(f, Variable) else f
                      for f in (fetch_list or [])]
        return self._dist._executor_run(executor, feed, fetch_list, scope,
                                        return_numpy)
