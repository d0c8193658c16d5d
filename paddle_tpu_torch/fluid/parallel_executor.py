"""ParallelExecutor (ref: python/paddle/fluid/parallel_executor.py) — port of
paddle_tpu/fluid/parallel_executor.py: a thin wrapper over
CompiledProgram.with_data_parallel, over the ranks of the world
(parallel/mesh.py)."""
from . import core, framework
from .compiler import CompiledProgram
from .executor import Executor, global_scope

__all__ = ["ParallelExecutor"]


class ParallelExecutor:
    def __init__(
        self,
        use_cuda=False,
        loss_name=None,
        main_program=None,
        share_vars_from=None,
        exec_strategy=None,
        build_strategy=None,
        num_trainers=1,
        trainer_id=0,
        scope=None,
    ):
        # use_cuda selects the card; each rank runs on its own
        self._main_program = main_program or framework.default_main_program()
        self._scope = scope or global_scope()
        self._exe = Executor(
            core.default_place() if use_cuda else core.CPUPlace()
        )
        self._compiled = CompiledProgram(
            self._main_program, build_strategy
        ).with_data_parallel(
            loss_name=loss_name,
            exec_strategy=exec_strategy,
            share_vars_from=share_vars_from
            and share_vars_from._compiled,
        )

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        return self._exe.run(
            program=self._compiled,
            feed=feed,
            fetch_list=fetch_list,
            scope=self._scope,
            return_numpy=return_numpy,
        )

    @property
    def device_count(self):
        """The number of ranks the program runs over (the world size)."""
        return self._compiled._get_mesh().size

    def drop_local_exe_scopes(self):
        pass
