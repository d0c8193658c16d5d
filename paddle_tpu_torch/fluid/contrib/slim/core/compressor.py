"""Compressor: yaml-configured multi-strategy compression orchestration
(ref: python/paddle/fluid/contrib/slim/core/compressor.py).

Port of paddle_tpu/fluid/contrib/slim/core/compressor.py. The reference
drives C++ CompiledPrograms; here the context carries the symbolic
train/eval GraphWrappers and one ``Executor.run`` a batch does the work,
on the Compressor's place. Checkpointing persists params + strategy
state per epoch (``fluid.io.save_persistables``).
"""
import json
import os

import numpy as np

from ....data_feeder import DataFeeder
from ..graph import GraphWrapper
from .strategy import Strategy

__all__ = ["Compressor", "Context", "cached_reader"]


def cached_reader(reader, sampled_rate, cache_path, cached_id):
    """Sample ~sampled_rate of the reader's batches and cache them to
    disk; evaluations sharing cached_id replay the identical sample
    (ref compressor.py:42)."""
    rng = np.random.default_rng(cached_id)
    cache_dir = os.path.join(cache_path, str(cached_id))

    def s_reader():
        list_path = os.path.join(cache_dir, "list")
        if os.path.isdir(cache_dir) and os.path.exists(list_path):
            with open(list_path) as f:
                for file_name in f:
                    yield list(np.load(
                        os.path.join(cache_dir, file_name.strip()),
                        allow_pickle=True))
            return
        os.makedirs(cache_dir, exist_ok=True)
        with open(list_path, "w") as list_file:
            batch = 0
            for data in reader():
                if batch == 0 or rng.uniform() < sampled_rate:
                    np.save(
                        os.path.join(cache_dir, "batch%d" % batch),
                        np.asarray(data, dtype=object),
                        allow_pickle=True)
                    list_file.write("batch%d.npy\n" % batch)
                    batch += 1
                    yield data

    return s_reader


class Context:
    """ref compressor.py:77 — everything strategies may touch."""

    def __init__(self, place, scope, train_graph=None, train_reader=None,
                 eval_graph=None, eval_reader=None, teacher_graphs=None,
                 train_optimizer=None, distiller_optimizer=None,
                 search_space=None):
        self.place = place
        self.scope = scope
        self.train_graph = train_graph
        self.train_reader = train_reader
        self.eval_graph = eval_graph
        self.eval_reader = eval_reader
        self.teacher_graphs = teacher_graphs or []
        self.train_optimizer = train_optimizer
        self.distiller_optimizer = distiller_optimizer
        self.search_space = search_space
        self.optimize_graph = None
        self.epoch_id = 0
        self.batch_id = 0
        self.eval_results = {}
        self.skip_training = False
        self._cache = {}

    def put(self, key, value):
        self._cache[key] = value

    def get(self, key):
        return self._cache.get(key)

    def eval_converged(self, metric_name, delta=0.001):
        results = self.eval_results.get(metric_name)
        if results is None or len(results) < 2:
            return False
        return abs(results[-1] - results[-2]) < delta

    def run_eval_graph(self, sampled_rate=None, cached_id=0):
        from ....executor import Executor

        if self.eval_graph is None or self.eval_reader is None:
            raise ValueError("context has no eval graph/reader")
        exe = Executor(self.place)
        graph = self.eval_graph
        feed_vars = [
            graph.var(n)._var for n in graph.in_nodes.values()
        ]
        fetch = [graph.var(n)._var for n in graph.out_nodes.values()]
        feeder = DataFeeder(feed_vars, self.place, program=graph.program)
        totals = np.zeros(len(fetch), dtype=np.float64)
        count = 0
        reader = self.eval_reader
        if sampled_rate:
            import tempfile

            cache_root = getattr(self, "_eval_cache_dir", None)
            if cache_root is None:
                cache_root = tempfile.mkdtemp(prefix="slim_eval_cache_")
                self._eval_cache_dir = cache_root
            reader = cached_reader(
                reader, sampled_rate, cache_root, cached_id)
        for batch in reader():
            vals = exe.run(graph.program, feed=feeder.feed(batch),
                           fetch_list=fetch, scope=self.scope)
            totals += np.array([float(np.mean(v)) for v in vals])
            count += 1
        if count == 0:
            raise ValueError("eval reader yielded no batches")
        means = totals / count
        names = list(graph.out_nodes.keys())
        return dict(zip(names, means)), names

    # checkpoint serialization of plain context state
    def to_file(self, file_name):
        with open(file_name, "w") as f:
            json.dump({"epoch_id": self.epoch_id,
                       "eval_results": self.eval_results}, f)

    def from_file(self, file_name):
        with open(file_name) as f:
            d = json.load(f)
        self.epoch_id = d["epoch_id"]
        self.eval_results = d["eval_results"]


class Compressor:
    """ref compressor.py:238 — same constructor surface; see the
    reference docstring for argument meaning. feed/fetch lists are
    [(display_name, var_name), ...]."""

    def __init__(self, place, scope, train_program, train_reader=None,
                 train_feed_list=None, train_fetch_list=None,
                 eval_program=None, eval_reader=None, eval_feed_list=None,
                 eval_fetch_list=None, eval_func=None, save_eval_model=True,
                 prune_infer_model=None, teacher_programs=(),
                 checkpoint_path=None, train_optimizer=None,
                 distiller_optimizer=None, search_space=None,
                 log_period=20):
        for nm, fl in (("train_feed_list", train_feed_list),
                       ("eval_feed_list", eval_feed_list)):
            if fl is not None and not isinstance(fl, list):
                raise AssertionError(
                    "%s should be a list of tuples like "
                    "[('image', image.name)]" % nm)
        self.strategies = []
        self.epoch = 0
        self.place = place
        self.scope = scope
        self.train_graph = GraphWrapper(
            train_program, in_nodes=train_feed_list,
            out_nodes=train_fetch_list)
        self.eval_graph = GraphWrapper(
            eval_program, in_nodes=eval_feed_list,
            out_nodes=eval_fetch_list) if eval_program is not None else None
        self.train_reader = train_reader
        self.eval_reader = eval_reader
        self.eval_func = eval_func
        self.save_eval_model = save_eval_model
        self.prune_infer_model = prune_infer_model
        self.teacher_graphs = [GraphWrapper(t) for t in teacher_programs]
        self.checkpoint_path = checkpoint_path
        self.eval_epoch = 1
        self.train_optimizer = train_optimizer
        self.distiller_optimizer = distiller_optimizer
        self.init_model = None
        self.search_space = search_space
        self.log_period = int(log_period)
        assert self.log_period > 0

    def _add_strategy(self, strategy):
        self.strategies.append(strategy)
        self.epoch = max(strategy.end_epoch, self.epoch)

    def config(self, config_file):
        """Load strategies + compressor settings from a yaml file."""
        from .config import ConfigFactory

        factory = ConfigFactory(config_file)
        self.epoch = factory.compressor["epoch"]
        for strategy in factory.compressor["strategies"]:
            self._add_strategy(strategy)
        if "eval_epoch" in factory.compressor:
            self.eval_epoch = int(factory.compressor["eval_epoch"])
        if "init_model" in factory.compressor:
            self.init_model = factory.compressor["init_model"]
        if "checkpoint_path" in factory.compressor:
            self.checkpoint_path = factory.compressor["checkpoint_path"]

    # ------------------------------------------------------------------
    def _build_context(self):
        ctx = Context(
            place=self.place, scope=self.scope,
            train_graph=self.train_graph, train_reader=self.train_reader,
            eval_graph=self.eval_graph, eval_reader=self.eval_reader,
            teacher_graphs=self.teacher_graphs,
            train_optimizer=self.train_optimizer,
            distiller_optimizer=self.distiller_optimizer,
            search_space=self.search_space)
        # the optimize graph: train program + backward + updates
        if self.train_optimizer is not None:
            ctx.optimize_graph = self.train_graph.get_optimize_graph(
                self.train_optimizer, self.place, self.scope)
        else:
            ctx.optimize_graph = self.train_graph
        return ctx

    def _load_checkpoint(self, context):
        from .... import io as _io
        from ....executor import Executor

        path = self.checkpoint_path
        if not path or not os.path.isdir(path):
            return context
        serials = sorted(
            int(d) for d in os.listdir(path)
            if d.isdigit() and os.path.isdir(os.path.join(path, d))
        )
        if not serials:
            return context
        last = os.path.join(path, str(serials[-1]))
        context.from_file(os.path.join(last, "context.json"))
        _io.load_persistables(
            Executor(self.place), last, context.optimize_graph.program)
        context.epoch_id += 1
        for strategy in self.strategies:
            strategy.restore_from_checkpoint(context)
        return context

    def _save_checkpoint(self, context):
        from .... import io as _io
        from ....executor import Executor

        if not self.checkpoint_path:
            return
        d = os.path.join(self.checkpoint_path, str(context.epoch_id))
        os.makedirs(d, exist_ok=True)
        context.to_file(os.path.join(d, "context.json"))
        _io.save_persistables(
            Executor(self.place), d, context.optimize_graph.program)

    def _train_one_epoch(self, context):
        from ....executor import Executor

        # strategies (LightNAS) may swap the context graphs/readers per
        # epoch, and retrain_epoch=0 search skips training entirely
        if getattr(context, "skip_training", False):
            return
        train_reader = context.train_reader or self.train_reader
        if train_reader is None:
            return
        exe = Executor(self.place)
        graph = context.optimize_graph
        train_graph = context.train_graph or self.train_graph
        feed_vars = [
            graph.var(n)._var for n in train_graph.in_nodes.values()
        ]
        fetch_names = list(train_graph.out_nodes.keys())
        fetch = [graph.var(n)._var
                 for n in train_graph.out_nodes.values()]
        feeder = DataFeeder(feed_vars, self.place, program=graph.program)
        for batch_id, batch in enumerate(train_reader()):
            context.batch_id = batch_id
            for s in self._active(context):
                s.on_batch_begin(context)
            vals = exe.run(graph.program, feed=feeder.feed(batch),
                           fetch_list=fetch, scope=self.scope)
            if batch_id % self.log_period == 0:
                msg = ", ".join(
                    "%s=%.6g" % (n, float(np.mean(v)))
                    for n, v in zip(fetch_names, vals))
                print("[compress] epoch %d batch %d: %s"
                      % (context.epoch_id, batch_id, msg))
            for s in self._active(context):
                s.on_batch_end(context)

    def _eval(self, context):
        if self.eval_func is not None:
            for name, func in self.eval_func.items():
                val = func(
                    (context.eval_graph or context.train_graph).program,
                    self.scope)
                context.eval_results.setdefault(name, []).append(
                    float(val))
            return
        if context.eval_graph is None or context.eval_reader is None:
            return
        results, names = context.run_eval_graph()
        for n in names:
            context.eval_results.setdefault(n, []).append(
                float(results[n]))
        print("[compress] eval at epoch %d: %s"
              % (context.epoch_id, results))

    def _active(self, context):
        return [
            s for s in self.strategies
            if s.start_epoch <= context.epoch_id <= s.end_epoch
        ]

    def run(self):
        context = self._build_context()
        if self.init_model and os.path.isdir(self.init_model):
            from .... import io as _io
            from ....executor import Executor

            _io.load_persistables(
                Executor(self.place), self.init_model,
                context.optimize_graph.program)
        context = self._load_checkpoint(context)
        for s in self.strategies:
            s.on_compression_begin(context)
        start = context.epoch_id
        for epoch in range(start, self.epoch):
            context.epoch_id = epoch
            # per-epoch flag: a strategy (LightNAS retrain_epoch=0) must
            # re-request the skip every epoch, or training would stay
            # silently disabled after its window ends
            context.skip_training = False
            for s in self._active(context):
                s.on_epoch_begin(context)
            self._train_one_epoch(context)
            # eval BEFORE on_epoch_end, like the reference
            # (ref compressor.py:592-598): strategies that consume
            # eval_results in on_epoch_end (LightNAS reward) see this
            # epoch's numbers
            if self.eval_epoch and (epoch + 1) % self.eval_epoch == 0:
                self._eval(context)
            for s in self._active(context):
                s.on_epoch_end(context)
            self._save_checkpoint(context)
        for s in self.strategies:
            s.on_compression_end(context)
        return context
