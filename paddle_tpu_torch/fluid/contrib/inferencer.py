"""High-level Inferencer API (ref: python/paddle/fluid/contrib/
inferencer.py:31). Port of paddle_tpu/fluid/contrib/inferencer.py: loads
params saved by Trainer.save_params / io.save_persistables and runs the
inference graph on the card unless given ``place=CPUPlace()``.
``parallel=True`` builds a CompiledProgram, which the port brings with
ROADMAP.md Queue 1 item 8, and raises until then."""
import numpy as np

from .. import framework, io, unique_name
from ..executor import Executor, Scope, scope_guard

__all__ = ["Inferencer"]


class Inferencer:
    def __init__(self, infer_func, param_path, place=None, parallel=False):
        if parallel:
            raise NotImplementedError(
                "Inferencer(parallel=True) builds a CompiledProgram "
                "(fluid/compiler.py), which the port brings with "
                "ROADMAP.md Queue 1 item 8")
        self.param_path = param_path
        self.scope = Scope()
        self.place = place
        self.parallel = parallel

        self.inference_program = framework.Program()
        startup = framework.Program()
        with framework.program_guard(self.inference_program, startup):
            with unique_name.guard():
                self.predict_var = infer_func()

        self.exe = Executor(place)
        with scope_guard(self.scope):
            self.exe.run(startup)
            io.load_persistables(
                self.exe, param_path, self.inference_program)
        self.inference_program = self.inference_program.clone(
            for_test=True)

    def infer(self, inputs, return_numpy=True):
        if not isinstance(inputs, dict):
            raise ValueError(
                "inputs should be a map of {'input_name': input_var}")
        with scope_guard(self.scope):
            results = self.exe.run(
                self.inference_program, feed=inputs,
                fetch_list=[self.predict_var],
                return_numpy=return_numpy)
        return results
