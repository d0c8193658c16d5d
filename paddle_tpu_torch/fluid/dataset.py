"""Dataset trainer path (ref: python/paddle/fluid/dataset.py). Port of
paddle_tpu/fluid/dataset.py, which is jax-free.

The reference feeds MultiSlot text files through C++ DataFeed channels
into multi-threaded Hogwild trainers. This keeps the whole user API —
DatasetFactory / QueueDataset / InMemoryDataset, the MultiSlot file
format, pipe_command preprocessing, local/global shuffle — but maps
execution differently: parser THREADS do host-side work (pipe_command
subprocess + tokenizing, both GIL-releasing), assembled batches stage
through the native C++ slot ring (see reader.py), and the executor runs
the program's step on each batch in turn, on one CUDA stream. Hogwild's
lock-free concurrent updates have no counterpart there, so `thread_num`
controls parsing parallelism only — same contract (thread count tunes
throughput), different machinery.

MultiSlot line format, one sample per line, slots in ``set_use_var``
order: ``<n> v1 .. vn`` per slot. Sparse slots (lod_level>0 vars) are
ragged id lists; dense slots (lod_level==0) must carry exactly
prod(shape[1:]) values.
"""
import os
import queue as _queue
import subprocess
import threading

import numpy as np

from . import core
from .framework import Variable

__all__ = ["DatasetFactory", "InMemoryDataset", "QueueDataset"]


class DatasetFactory:
    """ref dataset.py:22 — create a dataset by class name."""

    def __init__(self):
        pass

    def create_dataset(self, datafeed_class="QueueDataset"):
        try:
            cls = globals()[datafeed_class]
        except KeyError:
            raise ValueError(
                "DatasetFactory: unknown dataset class %r (have "
                "QueueDataset, InMemoryDataset, FileInstantDataset)"
                % (datafeed_class,)
            )
        return cls()


class DatasetBase:
    """ref dataset.py:64 — shared config + MultiSlot parsing."""

    def __init__(self):
        self.proto_desc_name = "MultiSlotDataFeed"
        self.batch_size = 32
        self.thread_num = 1
        self.filelist = []
        self.use_vars = []
        self.pipe_command = "cat"
        self._prepared = False

    # -- configuration (ref API) ---------------------------------------
    def set_pipe_command(self, pipe_command):
        """Shell command each file is piped through before parsing (the
        reference contract: e.g. a data_generator script printing
        MultiSlot lines). 'cat' short-circuits to direct reads."""
        self.pipe_command = pipe_command

    def set_batch_size(self, batch_size):
        self.batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self.thread_num = max(int(thread_num), 1)

    def set_filelist(self, filelist):
        self.filelist = list(filelist)

    def set_use_var(self, var_list):
        for v in var_list:
            if not isinstance(v, Variable):
                raise TypeError("set_use_var expects Variables")
        self.use_vars = list(var_list)

    def set_hdfs_config(self, fs_name, fs_ugi):
        raise NotImplementedError(
            "set_hdfs_config: no HDFS client in this environment; stage "
            "files to local disk (or a FUSE mount) and use set_filelist "
            "— fs_name=%r ugi=%r" % (fs_name, fs_ugi)
        )

    def set_fea_eval(self, record_candidate_size, fea_eval=True):
        raise NotImplementedError(
            "set_fea_eval/slots_shuffle (feature-importance shuffling) "
            "is not implemented; shuffle slots offline in pipe_command"
        )

    def slots_shuffle(self, slots):
        raise NotImplementedError(
            "slots_shuffle is not implemented; shuffle the slot in your "
            "pipe_command instead"
        )

    def desc(self):
        """Text-proto description (ref returns the protobuf dump)."""
        from .data_feed_desc import DataFeedDesc

        lines = ['name: "%s"' % self.proto_desc_name,
                 "batch_size: %d" % self.batch_size, "multi_slot_desc {"]
        for v in self.use_vars:
            lines += [
                "  slots {",
                '    name: "%s"' % v.name,
                '    type: "%s"' % (
                    "uint64" if "int" in str(v.dtype) else "float"),
                "    is_dense: %s" % str(v.lod_level == 0).lower(),
                "    is_used: true",
                "  }",
            ]
        lines.append("}")
        text = "\n".join(lines) + "\n"
        # round-trips through DataFeedDesc by construction
        DataFeedDesc(text)
        return text

    # -- lifecycle ------------------------------------------------------
    def _prepare_to_run(self):
        if not self.use_vars:
            raise ValueError(
                "dataset: call set_use_var([...]) before running"
            )
        if not self.filelist:
            raise ValueError(
                "dataset: call set_filelist([...]) before running"
            )
        self._prepared = True

    def _finish_to_run(self):
        self._prepared = False

    def _release_loader(self):
        """Free the cached trainer loader (and its native pipe's
        mlock'd arena — capacity x 64MB of locked host memory). The
        cache (set by Executor.train_from_dataset) otherwise lives as
        long as the dataset so epochs reuse the pipe; call this (or
        InMemoryDataset.release_memory, which calls it) when done
        training from this dataset."""
        cached = getattr(self, "_loader_cache", None)
        if cached is None:
            return
        self._loader_cache = None
        pipe = getattr(cached[1], "_pipe", None)
        if pipe is not None:
            cached[1]._pipe = None
            try:
                pipe.close()
            except Exception:  # noqa: BLE001 — release is best-effort
                pass

    # ref internal hooks, kept for API parity with fleet integrations
    def _dynamic_adjust_before_train(self, thread_num):
        pass

    def _dynamic_adjust_after_train(self):
        pass

    # -- parsing --------------------------------------------------------
    def _slot_spec(self):
        """Per-use_var (is_int, dense_dim-or-None) parsed from the var."""
        spec = []
        for v in self.use_vars:
            is_int = "int" in str(v.dtype)
            if v.lod_level == 0:
                dim = 1
                for s in (v.shape or [1])[1:]:
                    dim *= int(s) if s not in (None, -1) else 1
                spec.append((is_int, max(dim, 1)))
            else:
                spec.append((is_int, None))
        return spec

    def _iter_lines(self, fname):
        if self.pipe_command in (None, "", "cat"):
            with open(fname) as f:
                yield from f
            return
        with open(fname, "rb") as src:
            proc = subprocess.Popen(
                ["/bin/sh", "-c", self.pipe_command],
                stdin=src, stdout=subprocess.PIPE, text=True,
            )
            try:
                yield from proc.stdout
            finally:
                proc.stdout.close()
                rc = proc.wait()
                if rc != 0:
                    raise RuntimeError(
                        "pipe_command %r failed with exit code %d on %s"
                        % (self.pipe_command, rc, fname)
                    )

    def _parse_line(self, line, spec):
        toks = line.split()
        if not toks:
            return None
        sample = []
        pos = 0
        for si, (is_int, dense_dim) in enumerate(spec):
            if pos >= len(toks):
                raise ValueError(
                    "MultiSlot parse error: line ended before slot %d "
                    "(%r...)" % (si, line[:80])
                )
            n = int(toks[pos])
            pos += 1
            vals = toks[pos:pos + n]
            if len(vals) != n:
                raise ValueError(
                    "MultiSlot parse error: slot %d declares %d values, "
                    "found %d (%r...)" % (si, n, len(vals), line[:80])
                )
            pos += n
            conv = int if is_int else float
            vals = [conv(x) for x in vals]
            if dense_dim is not None and n != dense_dim:
                raise ValueError(
                    "dense slot %d (%s) expects %d values per sample, "
                    "got %d" % (si, self.use_vars[si].name, dense_dim, n)
                )
            sample.append(vals)
        return tuple(sample)

    def _parse_file(self, fname, spec):
        for line in self._iter_lines(fname):
            s = self._parse_line(line, spec)
            if s is not None:
                yield s


class QueueDataset(DatasetBase):
    """Streaming dataset (ref dataset.py:646): files are parsed on the
    fly by `thread_num` parser threads, each assembling its own batches
    (per-thread tails stay partial, like the reference's per-channel
    DataFeed)."""

    def __init__(self):
        super().__init__()
        self.proto_desc_name = "MultiSlotDataFeed"

    def local_shuffle(self):
        raise NotImplementedError(
            "QueueDataset streams files and cannot shuffle; use "
            "InMemoryDataset.local_shuffle (ref raises the same way)"
        )

    def global_shuffle(self, fleet=None):
        raise NotImplementedError(
            "QueueDataset cannot global_shuffle; use InMemoryDataset "
            "(ref raises the same way)"
        )

    def _batch_iterator(self, thread=0):
        spec = self._slot_spec()
        bs_rows = self.batch_size
        nthread = min(
            thread or self.thread_num, max(len(self.filelist), 1)
        )
        out = _queue.Queue(maxsize=max(2 * nthread, 4))
        FIN = object()
        errors = []

        def worker(files):
            batch = []
            try:
                for fn in files:
                    for s in self._parse_file(fn, spec):
                        batch.append(s)
                        if len(batch) == bs_rows:
                            out.put(batch)
                            batch = []
                if batch:
                    out.put(batch)
            except BaseException as e:  # surfaced at the consumer
                errors.append(e)
            finally:
                out.put(FIN)

        shards = [self.filelist[i::nthread] for i in range(nthread)]
        for sh in shards:
            threading.Thread(target=worker, args=(sh,), daemon=True).start()
        live = nthread
        while live:
            item = out.get()
            if item is FIN:
                live -= 1
                continue
            yield item
        if errors:
            raise errors[0]


class InMemoryDataset(DatasetBase):
    """ref dataset.py:276 — parse everything into host memory first,
    shuffle there, then batch."""

    def __init__(self):
        super().__init__()
        self.proto_desc_name = "MultiSlotInMemoryDataFeed"
        self.queue_num = None
        self.parse_ins_id = False
        self.parse_content = False
        self.merge_size = -1
        self.fleet_send_batch_size = 1024
        self.fleet_send_sleep_seconds = 0
        self._memory = None
        self._preload_threads = None
        self._shuffle_seed = 0
        # columnar fast path cache: None = not built yet, False = not
        # columnarizable (ragged / LoD slots), list = per-slot arrays
        self._columns = None

    # -- ref knobs ------------------------------------------------------
    def set_queue_num(self, queue_num):
        """Kept for parity; parsing fan-in is thread_num here (no C++
        channel array to size)."""
        self.queue_num = int(queue_num)

    def set_parse_ins_id(self, parse_ins_id):
        """When true, each line starts with an instance id token before
        the slots (ref MultiSlotInMemoryDataFeed.parse_ins_id)."""
        self.parse_ins_id = bool(parse_ins_id)

    def set_parse_content(self, parse_content):
        self.parse_content = bool(parse_content)

    def set_merge_by_lineid(self, merge_size=2):
        """Merge samples sharing an instance id (requires
        set_parse_ins_id(True)): slot value lists are concatenated."""
        self.merge_size = int(merge_size)
        self.parse_ins_id = True

    def set_fleet_send_batch_size(self, fleet_send_batch_size=1024):
        self.fleet_send_batch_size = int(fleet_send_batch_size)

    def set_fleet_send_sleep_seconds(self, fleet_send_sleep_seconds=0):
        self.fleet_send_sleep_seconds = int(fleet_send_sleep_seconds)

    # -- loading --------------------------------------------------------
    def _parse_line(self, line, spec):
        if not self.parse_ins_id:
            return super()._parse_line(line, spec)
        toks = line.split(None, 1)
        if not toks:
            return None
        ins_id, rest = toks[0], (toks[1] if len(toks) > 1 else "")
        s = super()._parse_line(rest, spec)
        return None if s is None else (ins_id,) + s

    def load_into_memory(self):
        spec = self._slot_spec()
        if not self.filelist:
            raise ValueError("set_filelist before load_into_memory")
        mem = []
        lock = threading.Lock()
        nthread = min(self.thread_num, len(self.filelist))
        errors = []

        def worker(files):
            local = []
            try:
                for fn in files:
                    local.extend(self._parse_file(fn, spec))
            except BaseException as e:
                errors.append(e)
            with lock:
                mem.extend(local)

        ts = [
            threading.Thread(
                target=worker, args=(self.filelist[i::nthread],),
                daemon=True)
            for i in range(nthread)
        ]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errors:
            raise errors[0]
        if self.merge_size > 0:
            mem = self._merge_by_lineid(mem)
        self._memory = mem
        self._columns = None

    def _merge_by_lineid(self, mem):
        import collections

        grouped = collections.OrderedDict()
        for s in mem:
            grouped.setdefault(s[0], []).append(s[1:])
        merged = []
        for ins_id, group in grouped.items():
            acc = [list(slot) for slot in group[0]]
            for s in group[1:self.merge_size]:
                for slot_acc, slot_vals in zip(acc, s):
                    slot_acc.extend(slot_vals)
            merged.append((ins_id,) + tuple(acc))
        return merged

    def preload_into_memory(self, thread_num=None):
        if thread_num is not None:
            self.set_thread(thread_num)
        # parse/pipe_command failures surface in wait_preload_done, not a
        # misleading "call load_into_memory first" later
        self._preload_error = []

        def _load():
            try:
                self.load_into_memory()
            except BaseException as e:
                self._preload_error.append(e)

        t = threading.Thread(target=_load, daemon=True)
        t.start()
        self._preload_threads = [t]

    def wait_preload_done(self):
        for t in self._preload_threads or ():
            t.join()
        self._preload_threads = None
        errs = getattr(self, "_preload_error", None)
        if errs:
            self._preload_error = []
            raise errs[0]

    # -- shuffle --------------------------------------------------------
    def _require_memory(self):
        if self._memory is None:
            raise RuntimeError(
                "call load_into_memory() (or preload_into_memory + "
                "wait_preload_done) first"
            )

    def local_shuffle(self):
        self._require_memory()
        rng = np.random.default_rng(self._shuffle_seed)
        self._shuffle_seed += 1
        perm = rng.permutation(len(self._memory))
        self._memory = [self._memory[i] for i in perm]
        if isinstance(self._columns, list):
            self._columns = [c[perm] for c in self._columns]

    def global_shuffle(self, fleet=None, thread_num=12):
        """Single-host: identical to local_shuffle. Multi-host: every
        worker shuffles its own shard — the cross-worker sample exchange
        the reference does over pserver channels is unnecessary when each
        worker already reads a disjoint filelist shard (the launch-time
        sharding this framework's distributed.launch performs)."""
        self._require_memory()
        self.local_shuffle()

    def release_memory(self):
        self._memory = None
        self._columns = None
        self._release_loader()

    def get_memory_data_size(self, fleet=None):
        """Local sample count; with a fleet, the reference all-reduces the
        count — here every worker reads a disjoint filelist shard, so the
        global size is worker_count * local (callers needing the exact
        global sum can psum it via layers.collective)."""
        self._require_memory()
        n = len(self._memory)
        if fleet is not None:
            n = n * max(int(getattr(fleet, "worker_num", lambda: 1)()), 1)
        return n

    def get_shuffle_data_size(self, fleet=None):
        return self.get_memory_data_size(fleet)

    # -- batching -------------------------------------------------------
    def _try_columnarize(self):
        """Stack the in-memory samples into one dense array per slot
        (the DataFeeder.ColumnarBatch fast path). Possible iff every
        use_var is lod_level 0 AND every sample's value list for a slot
        has the same length — true by contract for dense slots and in
        practice for fixed-width id lists (e.g. Criteo's 26 categorical
        fields). Ragged or LoD slots keep the per-sample path (which
        builds LoDTensors). Cost is paid once; every epoch after
        batches as O(1) numpy slices."""
        if self._columns is not None:
            return self._columns
        if any(v.lod_level for v in self.use_vars):
            self._columns = False
            return False
        strip = 1 if self.parse_ins_id else 0
        spec = self._slot_spec()
        try:
            self._columns = [
                np.array([s[strip + si] for s in self._memory],
                         dtype=np.int64 if is_int else np.float32)
                for si, (is_int, _dim) in enumerate(spec)
            ]
        except (ValueError, TypeError):  # ragged slot somewhere
            self._columns = False
        return self._columns

    def _batch_iterator(self, thread=0):
        self._require_memory()
        bs = self.batch_size
        cols = self._try_columnarize()
        if cols is not False:
            from .data_feeder import ColumnarBatch

            for i in range(0, len(self._memory), bs):
                yield ColumnarBatch([c[i:i + bs] for c in cols])
            return
        strip = 1 if self.parse_ins_id else 0
        mem = self._memory
        for i in range(0, len(mem), bs):
            chunk = mem[i:i + bs]
            yield [s[strip:] for s in chunk]


class FileInstantDataset(DatasetBase):
    """ref dataset.py:729 — streams like QueueDataset (the 'instant'
    C++ feed variant has no behavioral difference at this layer)."""

    def __init__(self):
        super().__init__()
        self.proto_desc_name = "MultiSlotFileInstantDataFeed"

    _batch_iterator = QueueDataset._batch_iterator

    def local_shuffle(self):
        raise NotImplementedError(
            "FileInstantDataset cannot local_shuffle (ref raises too)"
        )

    def global_shuffle(self, fleet=None):
        raise NotImplementedError(
            "FileInstantDataset cannot global_shuffle (ref raises too)"
        )


class BoxPSDataset(InMemoryDataset):
    """ref dataset.py:767 — BoxPS is a GPU parameter-server cache, which
    the reference does not port; embedding tables shard over the mesh
    instead."""

    def __init__(self):
        raise NotImplementedError(
            "BoxPSDataset targets the BoxPS parameter-server cache, which "
            "is not ported; use InMemoryDataset (embedding tables shard "
            "with the parallel slice, ROADMAP.md Queue 1, item 8)"
        )
