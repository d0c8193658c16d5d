"""py2/3 compat helpers (ref: python/paddle/compat.py). Python 3 only
here, so these are thin but behavior-matching."""
import math

__all__ = [
    "long_type", "to_text", "to_bytes", "round", "floor_division",
    "get_exception_message",
]

long_type = int


def _map(obj, fn, encoding, inplace):
    if obj is None:
        return obj
    if isinstance(obj, (list, set)):
        if inplace:
            items = [_map(o, fn, encoding, inplace) for o in obj]
            if isinstance(obj, list):
                obj[:] = items
                return obj
            obj.clear()
            obj.update(items)
            return obj
        return type(obj)(_map(o, fn, encoding, inplace) for o in obj)
    return fn(obj, encoding)


def to_text(obj, encoding="utf-8", inplace=False):
    """bytes/list/set -> str recursively (ref compat.py:36)."""
    def one(o, enc):
        if isinstance(o, bytes):
            return o.decode(enc)
        return str(o) if not isinstance(o, str) else o

    return _map(obj, one, encoding, inplace)


def to_bytes(obj, encoding="utf-8", inplace=False):
    """str/list/set -> bytes recursively (ref compat.py:120)."""
    def one(o, enc):
        if isinstance(o, str):
            return o.encode(enc)
        return bytes(o) if not isinstance(o, bytes) else o

    return _map(obj, one, encoding, inplace)


def round(x, d=0):
    """py2-style banker's-free rounding (ref compat.py:193)."""
    p = 10 ** d
    if x > 0:
        return float(math.floor((x * p) + 0.5)) / p
    if x < 0:
        return float(math.ceil((x * p) - 0.5)) / p
    return 0.0


def floor_division(x, y):
    return x // y


def get_exception_message(exc):
    return str(exc)
