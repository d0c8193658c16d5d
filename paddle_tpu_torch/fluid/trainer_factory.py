"""Trainer factory + fetch monitor (ref: python/paddle/fluid/
trainer_factory.py).

The reference instantiates C++ trainer descs (MultiTrainer /
DistMultiTrainer / PipelineTrainer) pairing a trainer with a device
worker. Here (a port of paddle_tpu/fluid/trainer_factory.py) the trainer
desc is a plain dict driving
`Executor.train_from_dataset`'s loop; `FetchHandler` /
`FetchHandlerMonitor` keep the reference's asynchronous fetch-callback
contract (a daemon thread periodically handing the handler a dict of
fetched vars from the scope).
"""
import threading
import time

import numpy as np
import torch

from .executor import to_numpy

__all__ = ["TrainerFactory", "FetchHandler", "FetchHandlerMonitor"]


class _TrainerDesc:
    def __init__(self, class_name):
        self.class_name = class_name
        self.desc = {"trainer_name": class_name}
        self.device_worker = None

    def _set_device_worker(self, worker):
        self.device_worker = worker
        if worker is not None:
            worker._gen_worker_desc(self.desc)

    def _set_thread(self, n):
        self.desc["thread_num"] = int(n)


class TrainerFactory:
    """ref trainer_factory.py:33."""

    def __init__(self):
        pass

    def _create_trainer(self, opt_info=None):
        from .device_worker import DeviceWorkerFactory

        if not opt_info:
            trainer = _TrainerDesc("MultiTrainer")
            trainer._set_device_worker(
                DeviceWorkerFactory()._create_device_worker("Hogwild"))
            return trainer
        trainer = _TrainerDesc(opt_info.get("trainer", "MultiTrainer"))
        worker_name = opt_info.get("device_worker", "Hogwild")
        trainer._set_device_worker(
            DeviceWorkerFactory()._create_device_worker(worker_name))
        return trainer


class FetchHandler:
    """User-overridable fetch callback (ref executor FetchHandler):
    ``var_dict`` maps display names to scope var names; ``handler`` is
    invoked every ``period_secs`` with {display_name: np.ndarray}."""

    def __init__(self, var_dict=None, period_secs=60):
        self.var_dict = var_dict or {}
        self.period_secs = period_secs

    def handler(self, res_dict):
        for k, v in res_dict.items():
            print("%s: %s" % (k, v))

    @staticmethod
    def help():
        print(
            "subclass FetchHandler and override handler(res_dict); "
            "var_dict={'loss': loss_var.name}, period_secs=N"
        )


class FetchHandlerMonitor:
    """ref trainer_factory.py:93 — daemon thread sampling scope vars."""

    def __init__(self, scope, handler):
        self.scope = scope
        self.handler = handler
        self._running = False
        self._thread = None

    def handler_launch_func(self, scope, handler):
        """ref trainer_factory.py:106 — run the sampling loop for an
        explicit (scope, handler) pair; start() uses the instance's."""
        self.scope, self.handler = scope, handler
        self._loop()

    def _loop(self):
        while self._running:
            time.sleep(self.handler.period_secs)
            if not self._running:
                return
            res = {}
            for disp, varname in self.handler.var_dict.items():
                name = getattr(varname, "name", varname)
                val = self.scope.find_value(name)
                if isinstance(val, torch.Tensor):
                    res[disp] = to_numpy(val)
                elif val is not None:
                    res[disp] = np.asarray(val)
            self.handler.handler(res)

    def start(self):
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._running = False
