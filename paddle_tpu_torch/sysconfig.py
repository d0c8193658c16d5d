"""Install introspection (ref: python/paddle/sysconfig.py): paths for
native extension consumers — here the C++ host runtime's directory."""
import os

__all__ = ["get_include", "get_lib"]


def get_include():
    """Directory of the native runtime sources/headers."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "native")


def get_lib():
    """Directory containing the built native shared library."""
    return get_include()
