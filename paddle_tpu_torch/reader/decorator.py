"""ref import path python/paddle/reader/decorator.py; one shared
implementation in reader_utils.py of this package."""
from ..reader_utils import (  # noqa: F401
    ComposeNotAligned,
    batch,
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
