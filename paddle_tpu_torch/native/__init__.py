"""Native (C++) host runtime: prefetching data pipeline + page-locked
staging arena (analogue of paddle/fluid/operators/reader/ +
paddle/fluid/memory/). Port of paddle_tpu/native. Built lazily with g++
into the package's ``_build/``; a pure-python fallback keeps the
framework working without a compiler."""
from . import pipeline  # noqa: F401
