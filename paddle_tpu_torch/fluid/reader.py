"""DataLoader / py_reader equivalents (ref: python/paddle/fluid/reader.py,
operators/reader/*). Port of paddle_tpu/fluid/reader.py. The C++
blocking-queue + prefetch worker pipeline is ``native/dataloader.cpp``;
this module is the python surface. It falls back to a pure-python thread
pipeline when the native library cannot be built or loaded, and each
loader says which one ran (``pipeline``: "native" or "python"; ``pinned``:
whether the native ring's arena is page-locked).

On a CUDA place (``use_double_buffer``) the next batch's copy to the card
is issued before the current batch is yielded (:meth:`_device_ahead`).
"""
import threading

import numpy as np
import torch

from .data_feeder import DataFeeder

__all__ = ["DataLoader", "PyReader"]


class _GeneratorLoader:
    def __init__(self, feed_list, capacity, iterable=True,
                 return_list=False, use_double_buffer=True):
        self._feed_list = feed_list or []
        self._capacity = capacity
        self._iterable = iterable
        self._return_list = return_list
        self._use_double_buffer = use_double_buffer
        self._batch_reader = None
        self._places = None
        self._thread = None
        self._running = False
        self._pipe = None
        # the pipeline the last iteration ran: "native" (the C++ slot
        # ring) or "python" (a thread and a queue); None before one ran
        self.pipeline = None
        self.pinned = False

    # -- decorators ------------------------------------------------------
    def set_sample_generator(self, reader, batch_size, drop_last=True,
                             places=None):
        from ..reader_utils import batch as batch_fn

        def _batched():
            for b in batch_fn(reader, batch_size, drop_last)():
                yield b

        return self.set_sample_list_generator(_batched, places)

    def set_sample_list_generator(self, reader, places=None):
        def _feeder():
            feeder = DataFeeder(self._feed_list, places)
            for samples in reader():
                yield feeder.feed(samples)

        self._batch_reader = _feeder
        self._places = places
        return self

    def set_batch_generator(self, reader, places=None):
        def _named():
            for batch in reader():
                if isinstance(batch, dict):
                    yield batch
                else:
                    yield {
                        v.name: np.asarray(b)
                        for v, b in zip(self._feed_list, batch)
                    }

        self._batch_reader = _named
        self._places = places
        return self

    # -- iteration (prefetch via the native C++ pipeline when available) --
    def _pump(self, native_pipe):
        try:
            for item in self._batch_reader():
                if not self._running:
                    break
                native_pipe.put(item)
        finally:
            native_pipe.put(None)

    def _pump_native(self, pipe):
        try:
            for item in self._batch_reader():
                if not self._running or not pipe.put(item):
                    return
        except BaseException as e:  # surface at the training loop, not EOF
            pipe.put_error("%s: %s" % (type(e).__name__, e))
            return
        pipe.put(None)

    def _native_pipe(self):
        """One C++ pipe per loader, reused across epochs (the arena alloc
        + mlock cost is paid once, not per __iter__); None when the
        native library is unavailable."""
        from ..native import pipeline

        if self._pipe is not None:
            return self._pipe
        try:
            self._pipe = pipeline.NativeBatchPipe(
                capacity=max(2, min(self._capacity, 8))
            )
        except RuntimeError:
            self._pipe = None
        return self._pipe

    def __iter__(self):
        it = self._iter_host()
        if self._use_double_buffer:
            it = self._device_ahead(it)
        yield from it

    def _device(self):
        """The CUDA device the loader feeds, or None (a CPU place, several
        places, or none)."""
        place = self._places
        if isinstance(place, (list, tuple)):
            if len(place) != 1:
                return None
            place = place[0]
        if place is None or not hasattr(place, "torch_device"):
            return None
        dev = place.torch_device()
        return dev if dev.type == "cuda" else None

    def _device_ahead(self, it):
        """use_double_buffer's device half (ref double_buffer op: a
        device-side prefetch buffer between the reader and the executor).
        The NEXT batch's host->card copy is ISSUED (``non_blocking``)
        before the current batch is yielded, so it overlaps the step the
        consumer runs on the current one. Engages only when the loader
        targets one CUDA place; CPU runs, multi-place and placeless
        loaders keep yielding numpy. Each batch was copied out of its
        ring slot before the slot was released (:meth:`_iter_host`); its
        arrays are staged in page-locked memory from torch's caching host
        allocator, which keeps a block until the copy that reads it has
        completed on the stream (an async copy from pageable memory would
        first wait for the stream, the step in flight)."""
        dev = self._device()
        if dev is None:
            yield from it
            return

        def _put(v):
            # only plain dense arrays move; anything else keeps its host
            # path through the executor
            if isinstance(v, np.ndarray):
                return torch.from_numpy(v).pin_memory().to(
                    dev, non_blocking=True)
            return v

        pending = None
        while True:
            try:
                item = next(it)
            except StopIteration:
                break
            except BaseException:
                # reader failed mid-epoch: hand over the already-staged
                # batch first so no good batch is silently dropped
                if pending is not None:
                    yield pending
                raise
            if isinstance(item, dict):
                nxt = {k: _put(v) for k, v in item.items()}
            elif isinstance(item, (list, tuple)):
                nxt = [_put(v) for v in item]
            else:
                nxt = item
            if pending is not None:
                yield pending
            pending = nxt
        if pending is not None:
            yield pending

    def _iter_host(self):
        # Preferred path: batch bytes staged through the C++ slot ring
        # (copy worker pool + best-effort page-locked arena), so host
        # prep and staging overlap the device step. Batches are copied
        # out of the ring before the slot is released (a slot's views
        # are valid only until then) — consumers may retain them freely.
        # Fallback: token queue (objects stay in python; still
        # prefetched by the producer thread).
        pipe = self._native_pipe()
        if pipe is None:
            self.pipeline, self.pinned = "python", False
            yield from self._iter_queue()
            return
        self.pipeline, self.pinned = "native", pipe.pinned
        self._running = True
        pump = threading.Thread(
            target=self._pump_native, args=(pipe,), daemon=True
        )
        pump.start()
        clean_eof = False
        try:
            while True:
                item, release = pipe.get()
                if item is None:
                    clean_eof = True
                    break
                item = {k: np.array(v) for k, v in item.items()}
                release()
                if self._return_list:
                    yield [item[v.name] for v in self._feed_list]
                else:
                    yield item
        finally:
            self._running = False
            if not clean_eof:
                # early exit / consumer error: unblock the producer, let
                # it observe the abort, then re-arm for the next epoch
                pipe.abort()
                pump.join(timeout=10)
                pipe.reset()
            else:
                pump.join(timeout=10)

    def _iter_queue(self):
        from ..native import pipeline

        pipe = pipeline.make_queue(self._capacity)
        self._running = True
        self._thread = threading.Thread(
            target=self._pump, args=(pipe,), daemon=True
        )
        self._thread.start()
        try:
            while True:
                item = pipe.get()
                if item is None:
                    break
                if self._return_list:
                    yield [item[v.name] for v in self._feed_list]
                else:
                    yield item
        finally:
            self._running = False

    def __call__(self):
        return self.__iter__()

    # non-iterable (start/reset) mode for PyReader parity ----------------
    def start(self):
        self._gen = iter(self)

    def reset(self):
        self._running = False
        self._gen = None


class DataLoader:
    @staticmethod
    def from_generator(feed_list=None, capacity=64, use_double_buffer=True,
                       iterable=True, return_list=False):
        return _GeneratorLoader(
            feed_list, capacity, iterable, return_list, use_double_buffer
        )

    @staticmethod
    def from_dataset(dataset, places, drop_last=True):
        """Iterate a fluid.dataset (Queue/InMemory) as a DataLoader
        (ref reader.py from_dataset): batches flow through the same
        native staging ring as from_generator loaders."""
        dataset._prepare_to_run()
        place = places[0] if isinstance(places, (list, tuple)) else places
        loader = _GeneratorLoader(
            feed_list=dataset.use_vars, capacity=8
        )

        def batches():
            # the configured batch size is the truth — with QueueDataset's
            # multi-threaded per-thread tails a PARTIAL batch can arrive
            # first, so inferring "full" from the first batch would leak
            # partials through drop_last
            full = getattr(dataset, "batch_size", None)
            for b in dataset._batch_iterator():
                if drop_last:
                    if full is None:
                        full = len(b)
                    if len(b) < full:
                        continue
                yield b

        return loader.set_sample_list_generator(batches, places=place)


class PyReader(_GeneratorLoader):
    """ref reader.py PyReader."""

    def __init__(self, feed_list=None, capacity=64, use_double_buffer=True,
                 iterable=True, return_list=False):
        super().__init__(
            feed_list, capacity, iterable, return_list, use_double_buffer
        )

    def decorate_sample_generator(self, sample_generator, batch_size,
                                  drop_last=True, places=None):
        return self.set_sample_generator(
            sample_generator, batch_size, drop_last, places
        )

    def decorate_sample_list_generator(self, reader, places=None):
        return self.set_sample_list_generator(reader, places)

    def decorate_batch_generator(self, reader, places=None):
        return self.set_batch_generator(reader, places)
