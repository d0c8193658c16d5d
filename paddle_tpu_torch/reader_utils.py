"""Reader decorators (ref: python/paddle/reader/decorator.py +
python/paddle/batch.py). Port of paddle_tpu/reader_utils.py, which is
jax-free."""
import itertools
import random

__all__ = ["batch", "shuffle", "buffered", "map_readers", "chain", "compose",
           "firstn", "xmap_readers", "cache", "ComposeNotAligned",
           "multiprocess_reader", "retry_reader"]


def batch(reader, batch_size, drop_last=False):
    def batch_reader():
        r = reader()
        b = []
        for instance in r:
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    if batch_size <= 0:
        raise ValueError("batch_size should be positive")
    return batch_reader


def shuffle(reader, buf_size):
    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def buffered(reader, size):
    import queue
    import threading

    class _End:
        pass

    def data_reader():
        r = reader()
        q = queue.Queue(maxsize=size)

        def _fill():
            for d in r:
                q.put(d)
            q.put(_End)

        t = threading.Thread(target=_fill, daemon=True)
        t.start()
        while True:
            e = q.get()
            if e is _End:
                break
            yield e

    return data_reader


def map_readers(func, *readers):
    def reader():
        rs = [r() for r in readers]
        for vals in zip(*rs):
            yield func(*vals)

    return reader


def chain(*readers):
    def reader():
        for r in readers:
            for item in r():
                yield item

    return reader



class ComposeNotAligned(ValueError):
    """Raised by compose(check_alignment=True) when component readers
    yield different numbers of samples (ref reader/decorator.py)."""


def compose(*readers, **kwargs):
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if check_alignment:
            _end = object()
            for outputs in itertools.zip_longest(*rs, fillvalue=_end):
                if any(o is _end for o in outputs):
                    if all(o is _end for o in outputs):
                        return
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned (different "
                        "lengths); pass check_alignment=False to zip the "
                        "shorter length"
                    )
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                yield sum(
                    list(map(make_tuple, [o for o in outputs if o is not None])),
                    (),
                )

    return reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    # Thread-pool map with a bounded in-flight window of ``buffer_size``
    # futures (pool.map would eagerly consume the whole source reader).
    # Results always come back in input order, which satisfies order=True;
    # order=False merely permits reordering we don't need to exploit.
    import collections
    import concurrent.futures

    def data_reader():
        with concurrent.futures.ThreadPoolExecutor(process_num) as pool:
            pending = collections.deque()
            for sample in reader():
                pending.append(pool.submit(mapper, sample))
                if len(pending) >= max(int(buffer_size), 1):
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()

    return data_reader


def cache(reader):
    all_data = []
    filled = []

    def cache_reader():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        for d in all_data:
            yield d

    return cache_reader



def retry_reader(reader, retries=2, exceptions=(IOError, RuntimeError),
                 delay=0.0, on_error=None):
    """Restart-on-failure decorator for flaky sources (network storage,
    preprocessing races): when the wrapped reader raises one of
    `exceptions` mid-epoch, the underlying reader is RE-OPENED from the
    start of the epoch and items already yielded this epoch are fast-
    forwarded past (not re-yielded), up to `retries` restarts per epoch.
    Budget exhausted — or any other exception — re-raises. `on_error`
    (if given) sees ``(exception, restart_number)`` before each restart;
    `delay` seconds are slept between restarts."""
    import time as _time

    def retry_wrapped():
        yielded = 0
        restarts = 0
        while True:
            it = reader()
            skip = yielded
            try:
                for item in it:
                    if skip:
                        skip -= 1
                        continue
                    yield item
                    yielded += 1
                return
            except exceptions as e:  # noqa: PERF203 — per-epoch, not per-item
                restarts += 1
                if restarts > retries:
                    raise
                if on_error is not None:
                    on_error(e, restarts)
                if delay:
                    _time.sleep(delay)

    if retries < 0:
        raise ValueError("retries must be >= 0")
    return retry_wrapped


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """ref reader/decorator.py multiprocess_reader. Thread-based here:
    the payloads are numpy batches, and the producers' work (IO, numpy
    prep, the C++ staging pipe) releases the GIL, so threads deliver the
    overlap without fork()ing a process that may hold a CUDA context
    (which does not survive fork)."""
    import queue as _q
    import threading

    def reader():
        out = _q.Queue(maxsize=queue_size)
        alive = [len(readers)]
        lock = threading.Lock()

        def pump(r):
            try:
                for item in r():
                    out.put(item)
            finally:
                with lock:
                    alive[0] -= 1
                    if alive[0] == 0:
                        out.put(None)

        for r in readers:
            threading.Thread(target=pump, args=(r,), daemon=True).start()
        while True:
            item = out.get()
            if item is None:
                return
            yield item

    return reader
