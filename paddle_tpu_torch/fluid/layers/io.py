"""Data input layers (ref: python/paddle/fluid/layers/io.py); port of
paddle_tpu/fluid/layers/io.py.

``data`` declares a feed. A ``lod_level`` > 0 feed is a dense padded
array with a ``name@SEQ_LEN`` int32 companion of per-row lengths, as in
the JAX package: a ``LoDTensor`` feed gives its own lengths, and the
Executor fills full lengths for a plain array.

``py_reader`` / ``create_py_reader_by_data`` rebuild the reference's
C++ reader-op pipeline (ref io.py:537, :815, operators/reader/) on the
host: a producer thread fills a bounded queue, and ``Executor.run``
with no feed pops one batch a step from a started reader attached to
the program, raising ``core.EOFException`` at the end of the epoch.
``prefetch_to_device`` adds a stager thread that copies each batch to
the card ahead of the step that reads it. This reader belongs to a
program; ``fluid.reader.PyReader`` / ``DataLoader`` are the iterator
kind."""
import numpy as np

from .. import core
from ..framework import default_main_program
from ..unique_name import generate as _unique_name

__all__ = ["data", "py_reader", "create_py_reader_by_data",
           "double_buffer", "read_file", "load"]


def data(
    name,
    shape,
    append_batch_size=True,
    dtype="float32",
    lod_level=0,
    type=core.VarType.LOD_TENSOR,
    stop_gradient=True,
):
    """Declare a feed variable (ref layers/io.py:data). With
    append_batch_size=True a leading -1 batch dim is added."""
    helper_shape = list(shape)
    if append_batch_size:
        helper_shape = [-1] + helper_shape
    block = default_main_program().current_block()
    main = block.create_var(
        name=name,
        shape=helper_shape,
        dtype=dtype,
        type=type,
        stop_gradient=stop_gradient,
        lod_level=lod_level,
        is_data=True,
        need_check_feed=True,
    )
    if lod_level and lod_level > 0:
        # sequences are fed dense-padded with a per-row length vector
        block.create_var(
            name=name + "@SEQ_LEN",
            shape=[-1],
            dtype="int32",
            stop_gradient=True,
            is_data=True,
        )
    return main


def _is_error(item):
    return isinstance(item, tuple) and len(item) == 2 and \
        item[0] == "__error__"


class _Staged(dict):
    """A batch the stager copied to the card: its tensors, and the event
    recorded on the stager's stream after their copies were issued."""

    stream = None
    ready = None

    def hand_over(self):
        """On the consumer's thread: a consumer on another stream than
        the stager's waits for the copies, and the caching allocator is
        told that stream uses the tensors (else it could reuse their
        memory while that stream still reads it). On one stream, the
        stream's order is enough."""
        import torch

        if self.ready is None:
            return self
        cur = torch.cuda.current_stream(self.stream.device)
        if cur != self.stream:
            cur.wait_event(self.ready)
            for v in self.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(cur)
        return self


class _ProgramReader:
    """The object py_reader/create_py_reader_by_data return: owns the data
    vars, a bounded prefetch queue and the producer thread. While started
    and attached, `Executor.run(program)` with no feed pops one batch per
    step and raises core.EOFException at end of epoch."""

    def __init__(self, feed_list, capacity, use_double_buffer=True,
                 name=None):
        self._feed_list = list(feed_list)
        # double buffering = one extra prefetch slot beyond the queue depth
        self._capacity = capacity + (2 if use_double_buffer else 0)
        self._name = name or "py_reader"
        self._paddle_reader = None
        self._queue = None
        self._thread = None    # this epoch's producer thread
        self._generation = 0   # bumped by reset() so stale pumps abandon
        self._started = False
        self._stage_place = None   # device staging (prefetch_to_device)
        self._stage_depth = 2
        self._staged = None        # device-resident queue, per generation
        program = default_main_program()
        program._py_readers = getattr(program, "_py_readers", [])
        program._py_readers.append(self)

    # -- decoration (same surface as ref py_reader) ----------------------
    def decorate_paddle_reader(self, reader, places=None):
        from ..data_feeder import DataFeeder

        def _feeder():
            feeder = DataFeeder(self._feed_list, places)
            for samples in reader():
                yield feeder.feed(samples)

        self._paddle_reader = _feeder
        return self

    decorate_sample_list_generator = decorate_paddle_reader

    def decorate_tensor_provider(self, reader, places=None):
        def _named():
            for batch in reader():
                if isinstance(batch, dict):
                    yield batch
                else:
                    yield {
                        v.name: np.asarray(b)
                        for v, b in zip(self._feed_list, batch)
                    }

        self._paddle_reader = _named
        return self

    decorate_batch_generator = decorate_tensor_provider

    # -- lifecycle -------------------------------------------------------
    def start(self):
        import queue as _queue_mod
        import threading

        if self._paddle_reader is None:
            raise RuntimeError(
                "%s: decorate a reader before start()" % self._name
            )
        self._generation += 1
        gen = self._generation
        # the queue is BOUND into the pump closure: a later reset()+start()
        # creates a fresh queue and the stale thread can never write into it
        q = _queue_mod.Queue(self._capacity)
        self._queue = q
        self._started = True

        def _put(item):
            # bounded put that abandons when this epoch was reset
            while self._generation == gen:
                try:
                    q.put(item, timeout=0.1)
                    return True
                except _queue_mod.Full:
                    continue
            return False

        def _pump():
            try:
                for item in self._paddle_reader():
                    if not _put(item):
                        return
            except BaseException as e:  # surface producer errors, not EOF
                _put(("__error__", e))
                return
            _put(None)

        self._thread = threading.Thread(target=_pump, daemon=True)
        self._thread.start()
        if self._stage_place is not None:
            self._engage_staging()

    def prefetch_to_device(self, place, depth=2):
        """Enable device-side staging: a background thread pops host
        batches off the producer queue and copies them to `place` ahead
        of consumption into a second bounded queue (`depth` slots — 2 is
        classic double buffering), so the Executor pops tensors already
        on the device. On the card each array is copied from page-locked
        memory with ``non_blocking=True`` (``Executor._prepare_feeds``'s
        staging); on the CPU it becomes a tensor. Staged batches are
        bound to the reader generation: ``reset()``/``restart()``
        discards them. Engages immediately when the reader is already
        started, else on the next ``start()``."""
        self._stage_place = place
        self._stage_depth = max(1, int(depth))
        if self._started and self._queue is not None \
                and self._staged is None:
            self._engage_staging()
        return self

    def _engage_staging(self):
        import queue as _queue_mod
        import threading

        from ..executor import stage_tensor

        gen = self._generation
        q = self._queue
        sq = _queue_mod.Queue(self._stage_depth)
        self._staged = sq
        dev = self._stage_place.torch_device()

        def _sput(item):
            while self._generation == gen:
                try:
                    sq.put(item, timeout=0.1)
                    return True
                except _queue_mod.Full:
                    continue
            return False

        def _stage():
            import torch

            from ... import observability as obs

            while self._generation == gen:
                try:
                    item = q.get(timeout=0.1)
                except _queue_mod.Empty:
                    continue
                if item is None or _is_error(item):
                    _sput(item)   # sentinel/error passes through
                    return
                try:
                    with obs.span("reader.stage_feed"):
                        # plain arrays move; anything else keeps its host
                        # path through the executor
                        staged = _Staged(item)
                        for k, v in staged.items():
                            if isinstance(v, np.ndarray):
                                staged[k] = stage_tensor(v, dev)
                        if dev.type == "cuda":
                            staged.stream = torch.cuda.current_stream(dev)
                            staged.ready = torch.cuda.Event()
                            staged.ready.record(staged.stream)
                except BaseException as e:  # surfaced at the consumer
                    _sput(("__error__", e))
                    return
                if not _sput(staged):
                    return

        threading.Thread(target=_stage, daemon=True,
                         name="%s-device-stager" % self._name).start()

    def reset(self):
        self._generation += 1  # stale pump + stager threads abandon
        self._started = False
        self._queue = None
        self._staged = None    # staged device batches are invalidated

    def restart(self):
        """reset() + start(): rebuild the producer thread on a fresh
        epoch — the recovery move for a dead/poisoned feeder."""
        self.reset()
        self.start()

    def thread_alive(self):
        """True while this epoch's producer thread is running."""
        t = getattr(self, "_thread", None)
        return bool(t is not None and t.is_alive())

    def _next_feed(self):
        from ... import observability as obs
        from ..resilience import fault_check

        if not self._started or self._queue is None:
            return None
        # fault-injection hook: models a feeder that dies mid-epoch
        # (site "feed" in PADDLE_TPU_FAULT_SPEC); placed after the
        # started check so only real batch pops count
        fault_check("feed")
        # with device staging engaged, the consumer pops device-resident
        # batches from the staged queue (the stager drains self._queue)
        q = self._staged if self._staged is not None else self._queue
        if obs.enabled():
            # queue depth BEFORE the pop: 0 here plus a long pop wait
            # below means the producer is the bottleneck (reader-bound
            # step); a full queue with near-zero pop waits means the
            # card is the bottleneck
            import time as _time

            obs.set_gauge("reader.queue_depth", q.qsize())
            t0 = _time.monotonic()
            item = q.get()
            obs.observe("reader.pop_wait_seconds",
                        _time.monotonic() - t0)
        else:
            item = q.get()
        if _is_error(item):
            self._started = False
            raise item[1]  # the producer's exception, at the training loop
        if item is None:
            self._started = False
            raise core.EOFException(
                "%s exhausted — catch fluid.core.EOFException and call "
                "reader.reset()" % self._name
            )
        if isinstance(item, _Staged):
            item.hand_over()
        return item


def py_reader(capacity, shapes, dtypes, lod_levels=None, name=None,
              use_double_buffer=True):
    """Create feed vars + a prefetching reader (ref layers/io.py:537).
    Returns the reader object; read_file(reader) yields the data vars."""
    name = name or _unique_name("py_reader")
    lod_levels = lod_levels or [0] * len(shapes)
    feed_vars = []
    for i, (shape, dtype, lod) in enumerate(zip(shapes, dtypes, lod_levels)):
        feed_vars.append(
            data(
                name="%s_slot%d" % (name, i),
                shape=list(shape),
                append_batch_size=False,
                dtype=dtype,
                lod_level=lod,
            )
        )
    return _ProgramReader(feed_vars, capacity, use_double_buffer, name)


def create_py_reader_by_data(capacity, feed_list, name=None,
                             use_double_buffer=True):
    """ref layers/io.py:706 — reader over pre-declared fluid.data vars."""
    return _ProgramReader(feed_list, capacity, use_double_buffer, name)


def double_buffer(reader, place=None, name=None):
    """ref layers/io.py:815. Prefetch-ahead is already built into every
    reader's bounded queue; widen it by the double-buffer depth."""
    if isinstance(reader, _ProgramReader):
        reader._capacity += 2
    return reader


def read_file(reader):
    """ref layers/io.py:846 — the data vars this reader feeds."""
    vs = reader._feed_list
    return vs[0] if len(vs) == 1 else vs


def load(out, file_path, load_as_fp16=None):
    """ref layers/io.py:884 (load op). Loads a single saved variable's
    value into `out` in the global scope, on the host at build time; the
    first run moves it to its device."""
    from ..executor import global_scope

    arr = np.load(file_path, allow_pickle=False)
    if hasattr(arr, "files"):  # npz archive: take the sole entry
        names = list(arr.files)
        arr = arr[names[0]]
    if load_as_fp16:
        arr = arr.astype(np.float16)
    global_scope().update(out.name, arr)
    return out
