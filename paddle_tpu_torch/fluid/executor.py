"""Executor + Scope.

Port of paddle_tpu/fluid/executor.py (ref python/paddle/fluid/
executor.py and paddle/fluid/framework/scope.cc). The Scope holds torch
tensors (or host arrays not yet moved, which the first run moves to its
device and writes back); ``Executor.run`` runs the program's ops eagerly
on the place's device. No jit, compile cache or executable ledger: torch
runs eagerly. A run of a ``minimize``d program trains: autograd is on only
for the region its ``backward`` op differentiates, and the values written
back to the scope are detached, so no graph outlives the run
(fluid/lowering.py).

``train_from_dataset`` / ``infer_from_dataset`` (ref executor.py:1033,
1103) run the step on every batch of a ``fluid.dataset``, one ``run``
after another: the reference's k-step ``lax.scan`` dispatch has no eager
counterpart, so a dataset epoch equals a ``run`` loop over the same
batches.

``run`` with no feed pops one batch from a started py_reader attached to
the program (``layers.py_reader``), raising ``core.EOFException`` at the
end of its epoch; ``run_pipelined`` (fluid/async_pipeline.py) prepares
the next batch's feeds on a stager thread while the current step runs.
A program that runs itself — a ``CompiledProgram``, a data-parallel
``DistributedProgram`` or ``GradSyncProgram`` — is handed the run
(``_executor_run``), as in the JAX package; a program that
``PipelineOptimizer.minimize`` built runs this rank's stage of the GPipe
schedule (fluid/pipeline_executor.py).
"""
import warnings

import numpy as np
import torch

from . import core
from .. import observability as obs
from .framework import Variable, default_main_program
from .lod import LoDTensor
from .lowering import build_step_fn
from .resilience import fault_check

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "to_numpy"]


class _TensorView:
    """Compat shim for ``scope.find_var(name).get_tensor()`` usage."""

    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def get_tensor(self):
        return self._scope[self._name]

    def set(self, value, place=None):
        self._scope.set(self._name, value)

    def __array__(self, dtype=None, copy=None):
        v = self._scope[self._name]
        arr = to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
        return arr.astype(dtype) if dtype else arr


class Scope:
    """name -> tensor mapping (device-resident between runs)."""

    def __init__(self, parent=None):
        self._vars = {}
        self._parent = parent
        self._kids = []

    def set(self, name, value):
        self._vars[name] = value

    def __getitem__(self, name):
        return self._vars[name]

    def __contains__(self, name):
        return name in self._vars

    def get(self, name, default=None):
        return self._vars.get(name, default)

    def keys(self):
        return self._vars.keys()

    def items(self):
        return self._vars.items()

    def pop(self, name, default=None):
        return self._vars.pop(name, default)

    def find_var(self, name):
        """Look up a var here or in any ancestor scope (ref
        framework/scope.cc Scope::FindVar parent-chain semantics)."""
        scope = self
        while scope is not None:
            if name in scope._vars:
                return _TensorView(scope, name)
            scope = scope._parent
        return None

    def var(self, name):
        return _TensorView(self, name)

    def find_value(self, name, default=None):
        """Parent-chain value lookup (FindVar semantics, raw value)."""
        scope = self
        while scope is not None:
            if name in scope._vars:
                return scope._vars[name]
            scope = scope._parent
        return default

    def update(self, name, value):
        """Write to the scope in the chain that owns `name`; a new name is
        set here."""
        scope = self
        while scope is not None:
            if name in scope._vars:
                scope._vars[name] = value
                return
            scope = scope._parent
        self._vars[name] = value

    def new_scope(self):
        kid = Scope(parent=self)
        self._kids.append(kid)
        return kid

    def drop_kids(self):
        self._kids = []


_scope_stack = [Scope()]


def global_scope():
    return _scope_stack[-1]


class scope_guard:
    def __init__(self, scope):
        self._scope = scope

    def __enter__(self):
        _scope_stack.append(self._scope)
        return self._scope

    def __exit__(self, *exc):
        _scope_stack.pop()


def _as_name(v):
    if isinstance(v, Variable):
        return v.name
    if isinstance(v, str):
        return v
    raise TypeError("fetch/feed entry must be Variable or str, got %r" % (v,))


def to_tensor(value, device, dtype=None):
    """A tensor of `value` (tensor, numpy array or nested list) on
    `device`, cast to `dtype` when given."""
    t = value if isinstance(value, torch.Tensor) else torch.as_tensor(
        np.asarray(value))
    return t.to(device=device, dtype=dtype)


def stage_tensor(value, device, dtype=None):
    """`value` as a tensor on `device`, cast to `dtype` when given, its
    copy to the card issued without waiting: a host array is copied from
    page-locked memory with ``non_blocking=True``. The block comes from
    torch's caching host allocator, which keeps it until the copy that
    reads it has completed on the stream, so the caller does not wait
    for the work queued ahead of the copy (a copy from pageable memory
    would). Off the card, and for a tensor, this is :func:`to_tensor`."""
    if isinstance(value, torch.Tensor) or device.type != "cuda":
        return to_tensor(value, device, dtype)
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    return t.pin_memory().to(device, non_blocking=True)


def to_numpy(t):
    """Host numpy copy of a tensor; bfloat16, which numpy lacks, is widened
    to float32."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def expand_lod_feeds(block, feed):
    """`feed` with each ``LoDTensor`` (fluid/lod.py) replaced by its padded
    (B, T, ...) array and, where `block` declares the var's ``@SEQ_LEN``
    companion and the caller does not feed it, the companion added: the
    tensor's own lengths, or full ones, (B,) int32 of T, for a plain
    array or a LoDTensor without lengths."""
    feed = dict(feed)
    for name in list(feed):
        value = feed[name]
        lens = None
        if isinstance(value, LoDTensor):
            lens = value.seq_lens
            value = feed[name] = value._ndarray
        seq_name = name + "@SEQ_LEN"
        if block.has_var(seq_name) and seq_name not in feed:
            if lens is None:
                shape = np.shape(value)      # a tensor's own shape
                lens = np.full((shape[0],), shape[1], "int32")
            feed[seq_name] = np.asarray(lens, "int32")
    return feed


def feed_dtypes(program, feed_names):
    """name -> torch dtype the program declares for each feed (None when
    the program does not say)."""
    block = program.global_block()
    out = {}
    for n in feed_names:
        var = block.vars.get(n)
        out[n] = core.torch_dtype(var.dtype) if (
            var is not None and var.dtype is not None) else None
    return out


class Executor:
    """Runs Programs on the device of `place` (default: the card)."""

    def __init__(self, place=None):
        self.place = place if place is not None else core.default_place()
        self.device = self.place.torch_device()
        self._run_counter = 0
        self._closed = False

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True, use_prune=False):
        """Run `program` once (ref executor.py run, the same parameters in
        the same order). `feed_var_name`, `fetch_var_name` and
        `use_prune` are accepted and not read, as in the JAX package;
        `use_program_cache` is not read either: the port runs eagerly and
        keeps no compile cache for it to skip."""
        if self._closed:
            raise RuntimeError("Executor is closed")
        # fault-injection hook (site "run"): before the reader pop, so an
        # injected fault does not consume a batch
        fault_check("run")
        program = program if program is not None else default_main_program()
        if not feed:
            # a started py_reader attached to the program supplies the
            # batch; it raises core.EOFException at the end of its epoch.
            # A CompiledProgram wraps the Program that holds the readers.
            src = getattr(program, "_program", program)
            readers = getattr(src, "_py_readers", ())
            for reader in readers:
                batch = reader._next_feed()
                if batch is not None:
                    feed = dict(batch)
                    break
            else:
                self._check_unstarted_readers(src, readers)
        # a CompiledProgram or a data-parallel program runs itself
        if hasattr(program, "_executor_run"):
            return program._executor_run(self, feed, fetch_list, scope,
                                         return_numpy)
        scope = scope if scope is not None else global_scope()
        # PipelineOptimizer-annotated programs run the GPipe schedule
        info = getattr(program, "_parallel_info", None)
        if info and info.get("mode") == "pipeline" and not getattr(
                program, "_is_start_up_program", False):
            from .pipeline_executor import run_pipeline_program

            return run_pipeline_program(self, program, feed or {},
                                        fetch_list or [], scope,
                                        return_numpy)
        feed = feed or {}
        fetch_names = [_as_name(f) for f in (fetch_list or [])]
        with obs.span("executor.run"):
            with obs.span("executor.feed_convert"):
                feeds = self._prepare_feeds(program, feed)
                state = self._gather_state(program, scope)
            step = build_step_fn(program, list(feeds), fetch_names,
                                 self.device)
            fetches, new_state = step(state, feeds,
                                      self._next_generator(program))
            for k, v in new_state.items():
                scope.update(k, v)
            if return_numpy:
                return [to_numpy(v) for v in fetches]
            return list(fetches)

    def run_pipelined(self, program=None, feeds=None, fetch_list=None,
                      scope=None, return_numpy=True, depth=None,
                      window=None):
        """Pipelined step loop: returns an iterable of per-step fetch
        lists where the feeds of batch N+1 are prepared and their copy
        to the card issued on a stager thread while batch N runs, and
        fetches materialize behind a bounded in-flight window. ``feeds``
        is an iterable of feed dicts, or None to pull from the program's
        started py_reader until EOF. Step results are bit-identical to
        calling :meth:`run` in a loop: the same feed preparation, the same
        generator sequence, the same dispatch order. See
        :mod:`paddle_tpu_torch.fluid.async_pipeline`."""
        from .async_pipeline import PipelinedRunner

        return PipelinedRunner(
            self, program, feeds, fetch_list, scope,
            return_numpy=return_numpy, depth=depth, window=window)

    def _prepare_feeds(self, program, feed, non_blocking=False):
        """Feed values as tensors on the device, coerced to the dtype the
        program declares for each feed; a tensor already there stays
        there. Sequence feeds expand as :func:`expand_lod_feeds` says.
        With `non_blocking`, host arrays are copied to the card without
        waiting (:func:`stage_tensor`)."""
        feed = expand_lod_feeds(program.global_block(), feed)
        want = feed_dtypes(program, list(feed))
        put = stage_tensor if non_blocking else to_tensor
        return {name: put(v, self.device, want[name])
                for name, v in feed.items()}

    @staticmethod
    def _check_unstarted_readers(program, readers):
        """No feed given and no attached reader produced a batch: if a
        decorated but unstarted reader feeds vars the program's ops
        read, fail here with the fix, instead of deep in lowering with a
        missing-value error."""
        idle = [r for r in readers
                if r._paddle_reader is not None and not r._started]
        if not idle:
            return
        consumed = set()
        for op in program.global_block().ops:
            consumed.update(op.input_arg_names)
        for r in idle:
            needed = [v.name for v in r._feed_list if v.name in consumed]
            if needed:
                raise core.ReaderNotStartedError(
                    "Executor.run got no feed and py_reader %r (feeding "
                    "%s) is not started — call reader.start() before "
                    "run(); after core.EOFException call reader.reset() "
                    "then reader.start() for the next epoch"
                    % (r._name, ", ".join(needed))
                )

    def _gather_state(self, program, scope):
        """The program's persistable values on the device; host values are
        moved once and written back to the scope that holds them."""
        state = {}
        for v in program.global_block().vars.values():
            if not v.persistable:
                continue
            val = scope.find_value(v.name)
            if val is None:
                continue
            if not (isinstance(val, torch.Tensor)
                    and val.device == self.device):
                val = to_tensor(val, self.device)
                scope.update(v.name, val)
            state[v.name] = val
        return state

    # -- dataset trainer path (ref executor.py:1033,1103) --------------
    def train_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None):
        """Run the program's step on every batch of ``dataset``, in order
        (ref executor.py train_from_dataset). The reference fans the work
        across C++ Hogwild threads; here `thread` sets host-side parsing
        parallelism, batches stage through the native C++ slot ring
        (fluid/reader.py), and one ``run`` a batch trains on this
        executor's device. With ``fetch_list``, every ``print_period``-th
        step (each one with ``debug``) prints the fetched values;
        ``fetch_handler`` samples the scope from a thread."""
        return self._run_from_dataset(
            program, dataset, scope, thread, False, debug, fetch_list,
            fetch_info, print_period, fetch_handler)

    def infer_from_dataset(self, program=None, dataset=None, scope=None,
                           thread=0, debug=False, fetch_list=None,
                           fetch_info=None, print_period=100,
                           fetch_handler=None):
        """Like train_from_dataset but runs a clone without the training
        ops (:meth:`_strip_training_ops`): no backward op, no parameter
        update, and nothing that depends on them; forward and metric ops
        (``auc``'s statistics among them) still run, as the reference's
        infer-mode skip_ops do."""
        return self._run_from_dataset(
            program, dataset, scope, thread, True, debug, fetch_list,
            fetch_info, print_period, fetch_handler)

    def _run_from_dataset(self, program, dataset, scope, thread, is_infer,
                          debug, fetch_list, fetch_info, print_period,
                          fetch_handler):
        from .reader import _GeneratorLoader
        from .trainer_factory import FetchHandlerMonitor, TrainerFactory

        if dataset is None:
            raise ValueError(
                "train/infer_from_dataset requires a dataset (build one "
                "with fluid.DatasetFactory().create_dataset())"
            )
        program = program if program is not None else default_main_program()
        run_prog = self._strip_training_ops(program) if is_infer else program
        # trainer desc for parity/introspection (Hogwild contract)
        trainer = TrainerFactory()._create_trainer(
            getattr(program, "_fleet_opt", None))
        trainer.device_worker._set_infer(is_infer)
        trainer._set_thread(thread or dataset.thread_num)

        dataset._prepare_to_run()
        dataset._dynamic_adjust_before_train(thread or dataset.thread_num)
        monitor = None
        if fetch_handler is not None:
            monitor = FetchHandlerMonitor(
                scope or global_scope(), fetch_handler)
            monitor.start()
        fetch_vars = list(fetch_list or [])
        infos = list(fetch_info or [
            getattr(v, "name", str(v)) for v in fetch_vars])
        # One loader (and its native C++ pipe: page-locked arena + worker
        # pool) per (dataset, feed names, place), reused across calls;
        # the cache lives ON the dataset, so its lifetime tracks the data
        # (DatasetBase._release_loader frees it).
        cache_key = (
            tuple(v.name for v in dataset.use_vars),
            type(self.place).__name__,
        )
        cached = getattr(dataset, "_loader_cache", None)
        if cached is not None and cached[0] == cache_key:
            loader = cached[1]
            # the key matches on NAMES; refresh the Variable objects so a
            # same-named feed list from another program can't feed
            # through stale dtype/shape metadata
            loader._feed_list = list(dataset.use_vars)
        else:
            loader = _GeneratorLoader(
                feed_list=dataset.use_vars, capacity=8)
            dataset._loader_cache = (cache_key, loader)
        loader.set_sample_list_generator(
            lambda: dataset._batch_iterator(thread), places=self.place)
        step = 0
        try:
            for feed in loader():
                step += 1
                want_fetch = fetch_vars and (
                    debug or step % print_period == 0)
                out = self.run(
                    run_prog, feed=feed,
                    fetch_list=fetch_vars if want_fetch else None,
                    scope=scope,
                )
                if want_fetch:
                    msg = ", ".join(
                        "%s=%s" % (i, np.asarray(v).reshape(-1)[:8])
                        for i, v in zip(infos, out)
                    )
                    print("[dataset step %d] %s" % (step, msg))
        finally:
            if monitor is not None:
                monitor.stop()
            dataset._dynamic_adjust_after_train()
            dataset._finish_to_run()
        return None

    # per-param update op types (mirror of the reference infer-mode
    # skip-ops list: grad + optimizer ops)
    _OPT_UPDATE_TYPES = frozenset({
        "sgd", "momentum", "dgc_momentum", "lars_momentum", "adagrad",
        "decayed_adagrad", "adadelta", "adam", "adamax", "rmsprop",
        "ftrl", "lamb", "dpsgd",
    })

    @classmethod
    def _strip_training_ops(cls, program):
        """Clone with the training ops removed: the symbolic `backward`
        op, per-param update ops, and anything dataflow-dependent on
        their outputs (clip/regularizer/loss-scaling ops consuming @GRAD
        vars). Forward/metric ops appended AFTER minimize() survive —
        the reference infer mode skips op types, it doesn't truncate."""
        pruned = program.clone()
        block = pruned.global_block()
        dead = set()
        defined = set()  # vars produced by kept ops so far
        kept = []
        for op in block.ops:
            drop = (
                op.type == "backward"
                or op.type in cls._OPT_UPDATE_TYPES
                or any(n in dead for n in op.input_arg_names)
            )
            if drop:
                ins = set(op.input_arg_names)
                for n in op.output_arg_names:
                    # only fresh vars die: in-place writes, vars a kept
                    # op already produced, and persistable vars (their
                    # startup-initialized value stays valid — e.g. an
                    # AMP loss-scaling var whose update op is dropped)
                    var = block.vars.get(n)
                    if (n not in ins and n not in defined
                            and not (var is not None and var.persistable)):
                        dead.add(n)
            else:
                kept.append(op)
                defined.update(op.output_arg_names)
                dead.difference_update(op.output_arg_names)
        if len(kept) != len(block.ops):
            block.ops = kept
            pruned._bump_version()
        return pruned

    def close(self):
        """Mark the executor closed (ref executor.py close): a later
        ``run`` raises. Flushes pending ``wait=False`` checkpoint writes
        (parallel.checkpoint.finalize) so a process exiting right after
        an async save can't lose it. Idempotent."""
        if self._closed:
            return
        self._closed = True
        from ..parallel import checkpoint as _ckpt

        try:
            _ckpt.finalize()
        except Exception as e:  # noqa: BLE001 — closing must not raise
            warnings.warn("checkpoint finalize on Executor.close failed: "
                          "%s: %s" % (type(e).__name__, e))

    def _next_generator(self, program):
        """A fresh generator per run: seeded from ``program.random_seed``
        (0 means one seed per program) and the run count."""
        return self._seeded(self._next_seed(program))

    def _next_seed(self, program, base=None):
        """The seed of the next run's generator: `base` (by default
        ``program.random_seed``, or one per program when that is 0)
        plus a step per run of this executor."""
        self._run_counter += 1
        if base is None:
            base = program_seed(program)
        return base + 1000003 * self._run_counter

    def _seeded(self, seed):
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen


def program_seed(program):
    """``program.random_seed``, or when that is 0 one seed per program
    (salted per process: str hashing is)."""
    return program.random_seed or (hash(("paddle_tpu_torch", program._uid))
                                   % (2 ** 31))
