"""Signature-preserving decorator helpers
(ref: python/paddle/fluid/wrapped_decorator.py) — functools.wraps keeps
the metadata; no external `decorator` package dependency."""
import contextlib
import functools

__all__ = ["wrap_decorator", "signature_safe_contextmanager"]


def wrap_decorator(decorator_func):
    def _outer(func):
        wrapped = decorator_func(func)

        @functools.wraps(func)
        def _impl(*args, **kwargs):
            return wrapped(*args, **kwargs)

        return _impl

    return _outer


signature_safe_contextmanager = wrap_decorator(contextlib.contextmanager)
