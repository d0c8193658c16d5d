"""Deprecation decorator (ref: python/paddle/fluid/annotations.py)."""
import functools
import sys

__all__ = ["deprecated"]


def deprecated(since, instead, extra_message=""):
    def decorator(func):
        err_msg = (
            "API %s is deprecated since %s. Please use %s instead."
            % (func.__name__, since, instead)
        )
        if extra_message:
            err_msg += "\n" + extra_message

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            print(err_msg, file=sys.stderr)
            return func(*args, **kwargs)

        wrapper.__doc__ = (wrapper.__doc__ or "") + "\n    " + err_msg
        return wrapper

    return decorator
