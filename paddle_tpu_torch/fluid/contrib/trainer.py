"""High-level Trainer API (ref: python/paddle/fluid/contrib/trainer.py).

Port of paddle_tpu/fluid/contrib/trainer.py. The Trainer runs on the
card unless given ``place=CPUPlace()``; ``parallel=True`` builds a
CompiledProgram, which the port brings with ROADMAP.md Queue 1 item 8,
and raises until then. Checkpointing goes through
io.save/load_persistables per CheckpointConfig. The event-loop contract
(Begin/EndEpochEvent, Begin/EndStepEvent with metrics as host arrays,
event_handler, trainer.stop()) is the reference's; with
``fetch_metrics = False`` a step fetches nothing and reads nothing back.
"""
import numpy as np

from .. import framework, io, unique_name
from ..data_feeder import DataFeeder
from ..executor import Executor, Scope, scope_guard

__all__ = [
    "BeginEpochEvent", "EndEpochEvent", "BeginStepEvent", "EndStepEvent",
    "CheckpointConfig", "Trainer",
]


class BeginEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class EndEpochEvent:
    def __init__(self, epoch_id):
        self.epoch = epoch_id


class BeginStepEvent:
    def __init__(self, epoch_id, step_id):
        self.epoch = epoch_id
        self.step = step_id
        # the handler may flip this off to skip fetching metrics
        self.fetch_metrics = True


class EndStepEvent:
    def __init__(self, epoch_id, step_id, metrics):
        self.epoch = epoch_id
        self.step = step_id
        self.metrics = metrics


class CheckpointConfig:
    """ref trainer.py:100 — epoch/step-interval checkpointing."""

    def __init__(self, checkpoint_dir=None, max_num_checkpoints=3,
                 epoch_interval=1, step_interval=10):
        self.checkpoint_dir = checkpoint_dir or "checkpoints"
        self.max_num_checkpoints = max_num_checkpoints
        self.epoch_interval = max(int(epoch_interval), 1)
        self.step_interval = max(int(step_interval), 1)


class Trainer:
    """ref trainer.py:169. `train_func` builds the model and returns the
    loss (or [loss, *metrics]); `optimizer_func` returns the Optimizer."""

    def __init__(self, train_func, optimizer_func, param_path=None,
                 place=None, parallel=False, checkpoint_config=None):
        if parallel:
            raise NotImplementedError(
                "Trainer(parallel=True) builds a CompiledProgram "
                "(fluid/compiler.py), which the port brings with "
                "ROADMAP.md Queue 1 item 8")
        self.__stop = False
        self.parallel = parallel
        self.checkpoint_cfg = checkpoint_config
        self._ckpt_serial = 0
        self.scope = Scope()
        self.place = place

        self.startup_program = framework.Program()
        self.train_program = framework.Program()
        with framework.program_guard(self.train_program,
                                     self.startup_program):
            with unique_name.guard():
                outs = train_func()
                self.train_func_outputs = (
                    list(outs) if isinstance(outs, (list, tuple))
                    else [outs])
                self.loss = self.train_func_outputs[0]
                # test program sees the graph BEFORE optimizer ops
                self.test_program = self.train_program.clone(for_test=True)
                optimizer = optimizer_func()
                optimizer.minimize(self.loss)

        self.exe = Executor(place)
        with scope_guard(self.scope):
            self.exe.run(self.startup_program)
            if param_path:
                io.load_persistables(
                    self.exe, param_path, self.train_program)

        self._run_program = self.train_program

    def stop(self):
        """Stop training after the current step (ref trainer.py:373)."""
        self.__stop = True

    def _feeder(self, feed_order, program):
        if feed_order is None:
            raise ValueError(
                "feed_order must list the data var names in reader-tuple "
                "order, e.g. ['image', 'label']")
        # DataFeeder handles ragged (lod) rows: pads + builds the
        # @SEQ_LEN companions, and casts to the declared dtypes
        return DataFeeder(list(feed_order), self.place, program=program)

    def _save_checkpoint(self):
        import os

        cfg = self.checkpoint_cfg
        serial = self._ckpt_serial
        self._ckpt_serial += 1
        path = os.path.join(cfg.checkpoint_dir, "checkpoint_%d" % serial)
        io.save_persistables(self.exe, path, self.train_program)
        # retention window (ref CheckpointConfig.max_num_checkpoints)
        import shutil

        # keep exactly max_num_checkpoints (ref _scroll_delete)
        drop = serial - cfg.max_num_checkpoints
        if drop >= 0:
            old = os.path.join(cfg.checkpoint_dir, "checkpoint_%d" % drop)
            shutil.rmtree(old, ignore_errors=True)

    def train(self, num_epochs, event_handler, reader=None,
              feed_order=None):
        feeder = self._feeder(feed_order, self.train_program)
        handler = event_handler or (lambda e: None)
        self.__stop = False  # a previous stop() must not latch
        with scope_guard(self.scope):
            for epoch_id in range(num_epochs):
                handler(BeginEpochEvent(epoch_id))
                for step_id, data in enumerate(reader()):
                    if self.__stop:
                        return
                    begin = BeginStepEvent(epoch_id, step_id)
                    handler(begin)
                    feed = feeder.feed(data)
                    fetch = ([v for v in self.train_func_outputs]
                             if begin.fetch_metrics else [])
                    metrics = self.exe.run(
                        self._run_program, feed=feed, fetch_list=fetch)
                    handler(EndStepEvent(
                        epoch_id, step_id,
                        [np.asarray(m) for m in (metrics or [])]))
                    cfg = self.checkpoint_cfg
                    if cfg and (step_id + 1) % cfg.step_interval == 0:
                        self._save_checkpoint()
                handler(EndEpochEvent(epoch_id))
                cfg = self.checkpoint_cfg
                if cfg and (epoch_id + 1) % cfg.epoch_interval == 0:
                    self._save_checkpoint()

    def test(self, reader, feed_order):
        """Mean metrics of the test-mode program over `reader`
        (ref trainer.py:407)."""
        feeder = self._feeder(feed_order, self.test_program)
        sums, count = None, 0
        with scope_guard(self.scope):
            for data in reader():
                feed = feeder.feed(data)
                outs = self.exe.run(
                    self.test_program, feed=feed,
                    fetch_list=list(self.train_func_outputs))
                vals = [float(np.asarray(o).mean()) for o in outs]
                sums = (vals if sums is None
                        else [a + b for a, b in zip(sums, vals)])
                count += 1
        if not count:
            raise ValueError("test reader yielded no batches")
        return [s / count for s in sums]

    def save_params(self, param_path):
        with scope_guard(self.scope):
            io.save_persistables(self.exe, param_path, self.train_program)

    def save_inference_model(self, param_path, feeded_var_names,
                             target_var_indexes):
        targets = [self.train_func_outputs[i] for i in target_var_indexes]
        with scope_guard(self.scope):
            io.save_inference_model(
                param_path, feeded_var_names, targets, self.exe,
                self.test_program)
