"""User-defined data generators for the Dataset trainer path
(ref: python/paddle/fluid/incubate/data_generator/__init__.py). Port of
paddle_tpu/fluid/incubate/data_generator, which is stdlib only.

A DataGenerator subclass turns raw input lines into MultiSlot text the
dataset feed parses: ``dataset.set_pipe_command("python my_gen.py")``
runs the script over each file via stdin/stdout. ``generate_sample``
returns an iterator factory over ``[(slot_name, [values...]), ...]``
records; ``generate_batch`` optionally post-processes each batch of
parsed samples (e.g. in-batch negative sampling).
"""
import sys

__all__ = [
    "DataGenerator", "MultiSlotDataGenerator",
    "MultiSlotStringDataGenerator",
]


class DataGenerator:
    """ref data_generator/__init__.py:21."""

    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32
        self._line_limit = None

    def _set_line_limit(self, line_limit):
        if not isinstance(line_limit, int):
            raise ValueError(
                "line_limit must be int, got %s" % type(line_limit)
            )
        if line_limit < 1:
            raise ValueError("line_limit can not be less than 1")
        self._line_limit = line_limit

    def set_batch(self, batch_size):
        """Batch size used to group samples before generate_batch."""
        self.batch_size_ = int(batch_size)

    # -- drivers --------------------------------------------------------
    def _drain(self, batch, out):
        for sample in self.generate_batch(batch)():
            out.write(self._gen_str(sample))

    def _run(self, lines, out):
        batch = []
        n_lines = 0
        for line in lines:
            for parsed in self.generate_sample(line)():
                if parsed is None:
                    continue
                batch.append(parsed)
                if len(batch) == self.batch_size_:
                    self._drain(batch, out)
                    batch = []
            n_lines += 1
            if self._line_limit and n_lines >= self._line_limit:
                break
        if batch:
            self._drain(batch, out)

    def run_from_memory(self, out=None):
        """Emit samples produced by generate_sample(None) — debugging and
        synthetic-corpus generation."""
        self._run([None], out or sys.stdout)

    def run_from_stdin(self, out=None):
        """Filter mode: raw lines on stdin -> MultiSlot text on stdout
        (what dataset.set_pipe_command runs)."""
        self._run(sys.stdin, out or sys.stdout)

    # -- user overrides -------------------------------------------------
    def generate_sample(self, line):
        raise NotImplementedError(
            "override generate_sample(line) returning an iterator "
            "factory over [(slot_name, [values]), ...] records"
        )

    def generate_batch(self, samples):
        def local_iter():
            for s in samples:
                yield s

        return local_iter

    def _gen_str(self, line):
        raise NotImplementedError(
            "use MultiSlotDataGenerator or MultiSlotStringDataGenerator"
        )


class MultiSlotStringDataGenerator(DataGenerator):
    """String-valued slots; fastest path — no type bookkeeping
    (ref data_generator/__init__.py:238)."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "generate_sample must yield a list/tuple of "
                "(name, [str, ...]) pairs, got %s" % type(line)
            )
        parts = []
        for name, elements in line:
            parts.append(str(len(elements)))
            parts.extend(str(e) for e in elements)
        return " ".join(parts) + "\n"


class MultiSlotDataGenerator(DataGenerator):
    """Typed slots: first sample fixes each slot's type (int -> uint64,
    any float -> float) and later samples must conform
    (ref data_generator/__init__.py:300)."""

    def _gen_str(self, line):
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "generate_sample must yield a list/tuple of "
                "(name, [value, ...]) pairs, got %s" % type(line)
            )
        if self._proto_info is None:
            self._proto_info = []
            for name, elements in line:
                if not isinstance(name, str):
                    raise ValueError(
                        "slot name must be str, got %s" % type(name)
                    )
                if not isinstance(elements, list) or not elements:
                    raise ValueError(
                        "slot %r: elements must be a non-empty list "
                        "(pad empty fields in generate_sample)" % name
                    )
                slot_type = "uint64"
                if any(isinstance(e, float) for e in elements):
                    slot_type = "float"
                self._proto_info.append((name, slot_type))
        else:
            if len(line) != len(self._proto_info):
                raise ValueError(
                    "sample has %d slots, first sample had %d"
                    % (len(line), len(self._proto_info))
                )
        parts = []
        for i, (name, elements) in enumerate(line):
            known_name, known_type = self._proto_info[i]
            if name != known_name:
                raise ValueError(
                    "slot %d name %r != first sample's %r"
                    % (i, name, known_name)
                )
            if known_type == "uint64" and any(
                    isinstance(e, float) for e in elements):
                # widen, like the reference's type promotion
                self._proto_info[i] = (name, "float")
            parts.append(str(len(elements)))
            parts.extend(str(e) for e in elements)
        return " ".join(parts) + "\n"
