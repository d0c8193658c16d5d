"""ref import path python/paddle/batch.py; implementation in
reader_utils (one shared copy for paddle.batch and paddle.reader)."""
from .reader_utils import batch  # noqa: F401

__all__ = ["batch"]
