"""Host data pipeline facade.

Uses the C++ ring-buffer queue (dataloader.cpp, built on first use) when
available; otherwise a python queue. The C++ path exists because the
reference's reader stack is C++ (paddle/fluid/operators/reader/
blocking_queue.h) — feeding the card at full rate needs the GIL out of the
producer path for real workloads. Port of paddle_tpu/native/pipeline.py.
"""
import queue as _pyqueue

from . import build


class _PyQueue:
    def __init__(self, capacity):
        self._q = _pyqueue.Queue(maxsize=capacity)

    def put(self, item):
        self._q.put(item)

    def get(self):
        return self._q.get()


class _NativeQueue:
    """ctypes wrapper over the C++ SPSC ring buffer. Python objects are
    passed via an index table (the C++ side manages slot tokens + blocking),
    so arbitrary numpy batches ride through without serialization."""

    def __init__(self, capacity, lib):
        self._lib = lib
        self._handle = lib.ptq_create(capacity)
        self._slots = {}
        self._next = 0

    def put(self, item):
        self._next += 1
        token = self._next
        self._slots[token] = item
        self._lib.ptq_put(self._handle, token)

    def get(self):
        token = self._lib.ptq_get(self._handle)
        return self._slots.pop(token)

    def __del__(self):
        try:
            self._lib.ptq_destroy(self._handle)
        except Exception:
            pass


def make_queue(capacity=64):
    lib = build.load_native()
    if lib is not None:
        try:
            return _NativeQueue(capacity, lib)
        except Exception:
            pass
    return _PyQueue(capacity)


class NativeBatchPipe:
    """Batch bytes staged through the C++ slot ring (pipe_* in
    dataloader.cpp) — the rebuild of the reference's buffered_reader +
    pinned allocator.

    Producer thread: put(dict_of_numpy) — acquires a slot (blocking when
    the ring is full = back-pressure), submits per-array memcpy jobs to
    the C++ worker pool, waits, commits. The copies and all blocking run
    outside the GIL, so staging overlaps the consumer's device step.

    Consumer: get() -> (dict_of_views, release) — numpy arrays mapped
    ZERO-COPY onto the slot's (best-effort mlocked) arena memory, valid
    ONLY until release() is called; call it once the batch has been
    consumed (a device copy straight from the views must have completed,
    not only been issued). A sentinel (None) put is
    passed through for end-of-stream; put_error() forwards a producer
    failure to the consumer, which re-raises from get().

    Shutdown: abort() unblocks every waiter (put returns False, get
    returns end-of-stream); destroy the C++ object with close() only
    after the producer thread has observed the abort and stopped. An
    aborted pipe can be re-armed with reset() for the next epoch.
    """

    _ERROR = "__paddle_tpu_torch_pipe_error__"

    def __init__(self, capacity=4, slot_bytes=64 << 20, n_workers=2):
        import ctypes

        self._lib = build.load_native()
        if self._lib is None:
            raise RuntimeError("native runtime unavailable: %s"
                               % build.load_error)
        self._ctypes = ctypes
        self._handle = self._lib.pipe_create(capacity, slot_bytes, n_workers)
        self._slot_bytes = slot_bytes
        self._meta = {}          # slot -> list[(name, dtype, shape, offset)]

    @property
    def pinned(self):
        return bool(self._lib.pipe_is_pinned(self._handle))

    def put(self, batch):
        """Stage one batch; returns False when the pipe was aborted."""
        import numpy as np

        slot = self._lib.pipe_acquire_write(self._handle)
        if slot < 0:
            return False
        if batch is None or (
            isinstance(batch, tuple) and batch and batch[0] == self._ERROR
        ):
            self._meta[slot] = batch
            self._lib.pipe_commit(self._handle, slot)
            return True
        try:
            meta, offset = [], 0
            # `keep` pins the source arrays until the worker copies finish
            keep = []
            for name, arr in batch.items():
                arr = np.ascontiguousarray(arr)
                n = arr.nbytes
                if offset + n > self._slot_bytes:
                    raise ValueError(
                        "batch (%d bytes+) exceeds pipe slot size %d — "
                        "raise slot_bytes"
                        % (offset + n, self._slot_bytes)
                    )
                self._lib.pipe_submit_write(
                    self._handle, slot, offset,
                    arr.ctypes.data_as(self._ctypes.c_void_p), n,
                )
                keep.append(arr)
                meta.append((name, arr.dtype, arr.shape, offset))
                offset += (n + 63) & ~63
            self._lib.pipe_wait_writes(self._handle, slot)  # GIL released
            del keep
        except BaseException:
            # copies for this slot must finish before the slot is recycled
            self._lib.pipe_wait_writes(self._handle, slot)
            self._lib.pipe_release(self._handle, slot)
            raise
        self._meta[slot] = meta
        self._lib.pipe_commit(self._handle, slot)
        return True

    def put_error(self, message):
        """Forward a producer-side failure; the consumer's get() raises."""
        return self.put((self._ERROR, str(message)))

    def get(self):
        import numpy as np

        slot = self._lib.pipe_acquire_read(self._handle)  # GIL released
        if slot < 0:  # aborted
            return None, lambda: None
        meta = self._meta.pop(slot)
        if meta is None:
            self._lib.pipe_release(self._handle, slot)
            return None, lambda: None
        if isinstance(meta, tuple) and meta and meta[0] == self._ERROR:
            self._lib.pipe_release(self._handle, slot)
            raise RuntimeError("data pipeline producer failed: %s" % meta[1])
        base = self._lib.pipe_slot_ptr(self._handle, slot)
        out = {}
        for name, dtype, shape, offset in meta:
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            buf = (self._ctypes.c_char * n).from_address(base + offset)
            out[name] = np.frombuffer(buf, dtype=dtype).reshape(shape)

        released = []

        def release():
            if not released:
                released.append(True)
                self._lib.pipe_release(self._handle, slot)

        return out, release

    def abort(self):
        if self._handle:
            self._lib.pipe_abort(self._handle)

    def reset(self):
        if self._handle:
            self._lib.pipe_reset(self._handle)
            self._meta.clear()

    def close(self):
        if self._handle:
            self._lib.pipe_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
