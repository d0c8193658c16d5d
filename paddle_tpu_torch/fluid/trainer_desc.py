"""Trainer descriptors (ref: python/paddle/fluid/trainer_desc.py).

The reference assembles TrainerDesc protobufs for the C++ trainer
runtime; here (a port of paddle_tpu/fluid/trainer_desc.py) a desc is a
plain dict consumed by
Executor.train_from_dataset (see trainer_factory.py). The class split is
kept so fleet-style code that selects a trainer by name works:
MultiTrainer (single-machine Hogwild contract), DistMultiTrainer
(collective fleet), PipelineTrainer (pipeline parallelism).
"""

__all__ = ["TrainerDesc", "MultiTrainer", "DistMultiTrainer",
           "PipelineTrainer"]


class TrainerDesc:
    def __init__(self):
        self.proto_desc = {"thread_num": 1, "fetch_config": {}}
        self._program = None
        self._device_worker = None
        self._infer = False

    def _set_fetch_var_and_info(self, fetch_vars, fetch_info, print_period):
        self.proto_desc["fetch_config"] = {
            "fetch_var_names": [
                getattr(v, "name", v) for v in fetch_vars or []],
            "fetch_var_str_format": list(fetch_info or []),
            "print_period": int(print_period),
        }

    def _set_debug(self, debug):
        self.proto_desc["debug"] = bool(debug)

    def _set_thread(self, thread_num):
        self.proto_desc["thread_num"] = int(thread_num)

    def _set_device_worker(self, device_worker):
        self._device_worker = device_worker
        if device_worker is not None:
            device_worker._gen_worker_desc(self.proto_desc)

    def _set_infer(self, infer):
        self._infer = bool(infer)
        if self._device_worker is not None:
            self._device_worker._set_infer(infer)

    def _set_program(self, program):
        self._program = program

    def _desc(self):
        return dict(self.proto_desc)


class MultiTrainer(TrainerDesc):
    def __init__(self):
        super().__init__()
        self.proto_desc["class_name"] = "MultiTrainer"


class DistMultiTrainer(TrainerDesc):
    def __init__(self):
        super().__init__()
        self.proto_desc["class_name"] = "DistMultiTrainer"


class PipelineTrainer(TrainerDesc):
    def __init__(self):
        super().__init__()
        self.proto_desc["class_name"] = "PipelineTrainer"
