"""Pipelined dispatch: overlap host-side feed staging with the step.

Port of paddle_tpu/fluid/async_pipeline.py. The synchronous step loop
serializes phases that have no data dependency across adjacent steps:
the feeds of batch N+1 could be prepared and their copy to the card
issued while batch N runs, and the fetch of batch N could wait until
batch N+1 has been dispatched. :class:`PipelinedRunner` (surfaced as
``Executor.run_pipelined``) rebuilds the loop that way:

- a **stager thread** pulls feed dicts from the caller's iterable (or
  from the program's started py_reader) and runs
  ``Executor._prepare_feeds`` — dtype coercion, and on the card the copy
  from page-locked memory issued with ``non_blocking=True`` — into a
  bounded queue (``depth``, default 2: double buffering);
- the **consumer loop** (the generator you iterate) pops staged batches
  and dispatches ``Executor.run(..., return_numpy=False)``, which
  returns the fetched tensors without waiting for the card;
- a bounded **in-flight window** (default ``depth``) caps how many
  dispatched but unmaterialized steps exist at once: a step's fetches
  materialize (a host copy, or a ``torch.cuda.Event`` recorded after its
  dispatch and synchronized) before the loop dispatches further ahead.

Step results are bit-identical to the sync loop: batches are dispatched
in order on one thread, so the executor's run count, which seeds each
step's generator, advances as it would have, the stager draws nothing,
and the staged tensors hold the values the sync path's feeds hold.

Streams: the stager issues its copies on its thread's current stream,
which is the default stream, the one the consumer's steps run on. So a
copy is ordered after the step in flight and before the step that reads
it: correct, and its host side overlaps the step; its device side does
not (a feed of a few KB). A consumer on another stream waits for the
copies (:meth:`_Staged.hand_over`).

Telemetry: staging runs under ``executor.stage_feed`` spans (on the
stager thread) and the dispatch under the ``executor.run`` spans, so a
trace-mode flight recording shows the overlap; the
``executor.overlap_ratio`` gauge summarizes it (the fraction of staging
seconds that ran while at least one step was in flight).

Invalidation contract: ``close()`` (also called when the generator is
exhausted, errors, or is dropped) stops the stager and discards staged
batches (a ``staging_discard`` event counts them).
"""
import collections
import os
import queue as _queue_mod
import threading
import time

import torch

from . import core
from .. import observability as obs
from .executor import to_numpy
from .layers.io import _Staged

__all__ = ["PipelinedRunner", "ASYNC_DEPTH_ENV"]

ASYNC_DEPTH_ENV = "PADDLE_TPU_ASYNC_DEPTH"

_END = object()


class PipelinedRunner:
    """Iterate per-step fetch lists with feed staging pipelined against
    the step. Single-use: iterate it once.

    ``feeds`` is an iterable of feed dicts; ``None`` pulls from the
    program's started py_reader(s) until EOF (the run then ends
    normally instead of raising ``core.EOFException``).
    """

    def __init__(self, executor, program=None, feeds=None, fetch_list=None,
                 scope=None, return_numpy=True, depth=None, window=None):
        from .framework import default_main_program

        self._exe = executor
        self._program = program if program is not None \
            else default_main_program()
        self._feeds = feeds
        self._fetch_list = fetch_list
        self._scope = scope
        self._return_numpy = return_numpy
        if depth is None:
            depth = int(os.environ.get(ASYNC_DEPTH_ENV, "2"))
        self._depth = max(1, int(depth))
        self._window = max(1, int(window if window is not None else depth))
        self._q = _queue_mod.Queue(self._depth)
        self._stop = threading.Event()
        self._thread = None
        self._iterated = False
        self._on_card = executor.device.type == "cuda"
        # timing records for the overlap gauge (and for tests):
        # stage = [(t0, t1), ...] per staged batch (stager thread),
        # busy  = [(dispatch_t0, results_t1), ...] per step (consumer)
        self.stage_intervals = []
        self.busy_intervals = []
        self.steps = 0

    # -- stager thread -----------------------------------------------------
    def _feed_source(self):
        if self._feeds is not None:
            for feed in self._feeds:
                yield feed
            return
        readers = getattr(self._program, "_py_readers", [])
        started = [r for r in readers if getattr(r, "_started", False)]
        if not started:
            raise core.ReaderNotStartedError(
                "run_pipelined with feeds=None needs a started py_reader "
                "attached to the program")
        while True:
            try:
                for r in started:
                    batch = r._next_feed()
                    if batch is not None:
                        yield batch
                        break
                else:
                    return
            except core.EOFException:
                return

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except _queue_mod.Full:
                continue
        return False

    def _stage_loop(self):
        try:
            for feed in self._feed_source():
                if self._stop.is_set():
                    return
                t0 = time.monotonic()
                with obs.span("executor.stage_feed"):
                    staged = _Staged(self._exe._prepare_feeds(
                        self._program, feed, non_blocking=True))
                    if self._on_card:
                        dev = self._exe.device
                        staged.stream = torch.cuda.current_stream(dev)
                        staged.ready = torch.cuda.Event()
                        staged.ready.record(staged.stream)
                t1 = time.monotonic()
                self.stage_intervals.append((t0, t1))
                if not self._put((staged, t0, t1)):
                    return
        except BaseException as e:  # surfaced at the consumer
            self._put(("__error__", e))
            return
        self._put(_END)

    # -- consumer ----------------------------------------------------------
    def _materialize(self, entry):
        fetches, done, t0 = entry
        if self._return_numpy:
            out = [to_numpy(v) for v in fetches]
        else:
            # still fence the step, so the in-flight window really bounds
            # the steps queued on the card, then hand back the tensors
            if done is not None:
                done.synchronize()
            out = fetches
        self.busy_intervals.append((t0, time.monotonic()))
        self.steps += 1
        return out

    def __iter__(self):
        if self._iterated:
            raise RuntimeError("PipelinedRunner is single-use; build a "
                               "fresh one per run")
        self._iterated = True
        return self._iterate()

    def _iterate(self):
        self._thread = threading.Thread(
            target=self._stage_loop, daemon=True,
            name="paddle_tpu_torch-feed-stager")
        self._thread.start()
        inflight = collections.deque()
        try:
            while True:
                item = self._q.get()
                if item is _END:
                    break
                if isinstance(item, tuple) and item[0] == "__error__":
                    raise item[1]
                staged, _s0, _s1 = item
                t0 = time.monotonic()
                fetches = self._exe.run(
                    self._program, feed=staged.hand_over(),
                    fetch_list=self._fetch_list, scope=self._scope,
                    return_numpy=False)
                done = None
                if self._on_card:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self._exe.device))
                inflight.append((fetches, done, t0))
                if len(inflight) >= self._window:
                    yield self._materialize(inflight.popleft())
            while inflight:
                yield self._materialize(inflight.popleft())
        finally:
            self.close()

    # -- teardown / reporting ----------------------------------------------
    def overlap_ratio(self):
        """Fraction of feed-staging seconds that overlapped an in-flight
        step (dispatch→materialize). 0.0 when nothing was staged."""
        total = sum(t1 - t0 for t0, t1 in self.stage_intervals)
        if total <= 0.0:
            return 0.0
        busy = sorted(self.busy_intervals)
        merged = []
        for b0, b1 in busy:
            if merged and b0 <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b1))
            else:
                merged.append((b0, b1))
        overlapped = 0.0
        for s0, s1 in self.stage_intervals:
            for b0, b1 in merged:
                lo, hi = max(s0, b0), min(s1, b1)
                if hi > lo:
                    overlapped += hi - lo
        return min(1.0, overlapped / total)

    def close(self):
        """Stop the stager and discard staged batches. Safe to call
        repeatedly; iteration calls it on exhaustion/error."""
        self._stop.set()
        dropped = 0
        while True:
            try:
                item = self._q.get_nowait()
                if item is not _END and not (
                        isinstance(item, tuple) and item[0] == "__error__"):
                    dropped += 1
            except _queue_mod.Empty:
                break
        if dropped:
            obs.event("staging_discard", source="executor", count=False,
                      dropped=dropped)
        if self.stage_intervals:
            obs.set_gauge("executor.overlap_ratio", self.overlap_ratio())
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=2.0)
