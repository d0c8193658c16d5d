"""ref import path python/paddle/reader; the decorators live in
reader_utils (thread-based designs documented there)."""
from .. import reader_utils as decorator  # noqa: F401  paddle.reader.decorator
from ..reader_utils import (  # noqa: F401
    ComposeNotAligned,
    buffered,
    cache,
    chain,
    compose,
    firstn,
    map_readers,
    multiprocess_reader,
    retry_reader,
    shuffle,
    xmap_readers,
)

__all__ = [
    "cache", "map_readers", "buffered", "compose", "chain", "shuffle",
    "ComposeNotAligned", "firstn", "xmap_readers", "multiprocess_reader",
    "retry_reader",
]
