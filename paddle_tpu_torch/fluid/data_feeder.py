"""DataFeeder (ref: python/paddle/fluid/data_feeder.py): converts python /
numpy minibatch rows into the feed dict of dense arrays. Port of
paddle_tpu/fluid/data_feeder.py, which is jax-free. A ``lod_level`` > 0
slot becomes a ``LoDTensor`` padded to the batch's longest sequence
(fluid/lod.py), whose lengths the executor feeds as the var's
``@SEQ_LEN`` companion."""
import numpy as np

from . import core
from .framework import Variable

__all__ = ["DataFeeder"]


class ColumnarBatch:
    """A minibatch already materialized as per-slot batch-major arrays.

    Produced by InMemoryDataset's columnar fast path (dataset.py): when
    every slot is fixed-length the whole in-memory dataset is stacked
    into one dense array per slot ONCE, and each batch is a zero-copy
    slice of those columns. DataFeeder.feed passes the columns through
    with only a dtype/shape adjustment instead of re-stacking thousands
    of per-sample lists — the difference between an O(batch) python
    loop and an O(1) numpy view per step (the reference pays neither:
    its C++ DataFeed writes straight into LoDTensor buffers).

    Iteration/indexing fall back to sample tuples so consumers written
    against the sample-list contract keep working.
    """

    __slots__ = ("columns",)

    def __init__(self, columns):
        self.columns = list(columns)

    def __len__(self):
        return len(self.columns[0]) if self.columns else 0

    def __getitem__(self, i):
        return tuple(c[i] for c in self.columns)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class DataToLoDTensorConverter:
    def __init__(self, place, lod_level, shape, dtype):
        self.place = place
        self.lod_level = lod_level
        self.shape = [s if s not in (None, -1) else None for s in shape]
        self.dtype = core.np_dtype(core.convert_dtype(dtype))
        self.data = []

    def feed(self, data):
        self.data.append(np.asarray(data, dtype=self.dtype))

    def done(self):
        if self.lod_level == 0:
            arr = np.stack(
                [d.reshape([s for s in self.shape[1:] if s is not None] or d.shape)
                 if None not in self.shape[1:] else d
                 for d in self.data]
            )
            return arr
        # LoD case: pad to max length, companion lengths array
        from .lod import LoDTensor

        return LoDTensor.from_sequences(self.data)


class DataFeeder:
    def __init__(self, feed_list, place, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        for each_var in feed_list:
            if isinstance(each_var, str):
                from .framework import default_main_program

                each_var = (program or default_main_program()).global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("feed_list should contain Variables")
            self.feed_dtypes.append(each_var.dtype)
            self.feed_names.append(each_var.name)
            self.feed_lod_level.append(each_var.lod_level)
            self.feed_shapes.append(each_var.shape)
        self.place = place

    def feed(self, iterable):
        if isinstance(iterable, ColumnarBatch):
            return self._feed_columns(iterable.columns)
        converters = [
            DataToLoDTensorConverter(self.place, lod, shape, dtype)
            for lod, shape, dtype in zip(
                self.feed_lod_level, self.feed_shapes, self.feed_dtypes
            )
        ]
        for each_sample in iterable:
            assert len(each_sample) == len(converters), (
                "sample has %d fields, expected %d"
                % (len(each_sample), len(converters))
            )
            for value, converter in zip(each_sample, converters):
                converter.feed(value)
        return {
            name: conv.done()
            for name, conv in zip(self.feed_names, converters)
        }

    def _feed_columns(self, columns):
        if len(columns) != len(self.feed_names):
            raise ValueError(
                "columnar batch has %d slots, feed_list expects %d"
                % (len(columns), len(self.feed_names))
            )
        out = {}
        for name, dtype, shape, col in zip(
            self.feed_names, self.feed_dtypes, self.feed_shapes, columns
        ):
            arr = np.asarray(col)
            want = core.np_dtype(core.convert_dtype(dtype))
            if arr.dtype != want:
                arr = arr.astype(want)
            # same rule as DataToLoDTensorConverter.done: only reshape
            # when the per-sample shape is fully static
            dims = tuple(
                None if s in (None, -1) else s for s in (shape or [])[1:])
            if dims and None not in dims and arr.shape[1:] != dims:
                arr = arr.reshape((arr.shape[0],) + dims)
            out[name] = arr
        return out

    def feed_parallel(self, iterable, num_places=None):
        yield self.feed(iterable)

    def decorate_reader(self, reader, multi_devices=False, num_places=None,
                        drop_last=True):
        # drop_last (ref data_feeder.py): a trailing batch smaller than the
        # established batch size is dropped (the reference's compiled step
        # would compile anew for a ragged final batch). The
        # batch size is established from the FIRST batch; a stream whose
        # only batch is ragged has no size reference and passes through.
        def __reader_creator__():
            full = None
            for item in reader():
                if full is None:
                    full = len(item)
                if drop_last and len(item) < full:
                    continue
                yield self.feed(item)

        return __reader_creator__
