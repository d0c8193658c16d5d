"""Device workers (ref: python/paddle/fluid/device_worker.py).

The reference's DeviceWorker subclasses generate protobuf trainer descs
consumed by C++ worker threads (HogwildWorker, DownpourSGD pserver
workers, Section pipeline workers). Port of
paddle_tpu/fluid/device_worker.py. There is one execution stream: the
"worker" is the executor's step, and concurrency lives in host-side
parsing + the native staging ring. These classes keep
the reference's configuration surface and emit a plain-dict desc that
`trainer_factory` and `Executor.train_from_dataset` consume.
"""

__all__ = [
    "DeviceWorker", "Hogwild", "DownpourSGD", "Section",
    "DeviceWorkerFactory",
]


class DeviceWorker:
    """ref device_worker.py:19."""

    def __init__(self):
        self._program = None
        self._infer = None
        self._fleet_desc = None

    def _set_infer(self, infer=False):
        self._infer = bool(infer)

    def _set_fleet_desc(self, fleet_desc):
        self._fleet_desc = fleet_desc

    def _set_program(self, program):
        self._program = program

    def _gen_worker_desc(self, trainer_desc):
        raise NotImplementedError(
            "DeviceWorker does not implement gen_worker_desc; use a "
            "subclass (Hogwild/Section)"
        )


class Hogwild(DeviceWorker):
    """ref device_worker.py:70. The 'Hogwild' execution contract (each
    worker repeatedly runs the program on its next batch) maps to the
    executor's step, one batch after another; there are no lock-free
    shared-memory updates because one stream updates the parameters."""

    def __init__(self):
        super().__init__()

    def _gen_worker_desc(self, trainer_desc):
        trainer_desc["device_worker_name"] = "HogwildWorker"
        if self._infer:
            trainer_desc["hogwild_param"] = {
                "skip_ops": ["backward", "sgd", "momentum", "adam"]
            }
        return trainer_desc


class DownpourSGD(DeviceWorker):
    """ref device_worker.py:93 — pserver push/pull worker. The pserver
    architecture is re-mapped to sharded embeddings + collectives; a
    Downpour-style async worker has no counterpart, so constructing one
    is a loud error."""

    def __init__(self):
        raise NotImplementedError(
            "DownpourSGD device worker: pserver push/pull is replaced by "
            "sharded embeddings + collectives, which come with the "
            "parallel slice (ROADMAP.md Queue 1, item 8)"
        )


class Section(DeviceWorker):
    """ref device_worker.py:193 — pipeline-parallel section worker; the
    port's pipeline is parallel/pipeline.py (the GPipe schedule over the
    ``pp`` axis of a rank group, one stage a rank)."""

    def __init__(self):
        super().__init__()
        self._section_config = {}

    def _gen_worker_desc(self, trainer_desc):
        trainer_desc["device_worker_name"] = "SectionWorker"
        trainer_desc["section_param"] = dict(self._section_config)
        return trainer_desc


class DeviceWorkerFactory:
    """ref device_worker.py:241."""

    def _create_device_worker(self, worker_type):
        classes = {"Hogwild": Hogwild, "DownpourSGD": DownpourSGD,
                   "Section": Section}
        key = worker_type[0].upper() + worker_type[1:]
        if key not in classes:
            raise ValueError(
                "unknown device worker %r (have %s)"
                % (worker_type, sorted(classes))
            )
        return classes[key]()
