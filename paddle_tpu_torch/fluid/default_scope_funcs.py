"""Thread-local scope stack helpers
(ref: python/paddle/fluid/default_scope_funcs.py), over the python
Scope from fluid.executor; port of paddle_tpu/fluid/default_scope_funcs.py,
which is jax-free."""
import threading

__tl_scope__ = threading.local()

__all__ = [
    "get_cur_scope", "enter_local_scope", "leave_local_scope", "var",
    "find_var", "scoped_function",
]


def get_cur_scope():
    stack = getattr(__tl_scope__, "cur_scope", None)
    if stack is None:
        __tl_scope__.cur_scope = []
    if not __tl_scope__.cur_scope:
        from .executor import Scope

        __tl_scope__.cur_scope.append(Scope())
    return __tl_scope__.cur_scope[-1]


def enter_local_scope():
    cur = get_cur_scope()
    __tl_scope__.cur_scope.append(cur.new_scope())


def leave_local_scope():
    __tl_scope__.cur_scope.pop()


def var(name):
    return get_cur_scope().var(name)


def find_var(name):
    return get_cur_scope().find_var(name)


def scoped_function(func):
    """Run func inside a fresh local scope."""
    enter_local_scope()
    try:
        func()
    finally:
        leave_local_scope()
