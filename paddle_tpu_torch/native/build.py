"""Lazy g++ build + ctypes loader for the native host runtime.

Port of paddle_tpu/native/build.py. The library is built at first use
into the package's gitignored ``_build/`` directory (never beside the
source), as ``libpaddle_tpu_torch_native-<digest>.so``, where ``<digest>``
hashes the source and the flags, so an edited source is rebuilt and a
stale library is never loaded. When g++ is missing or the library does
not load, :func:`load_native` returns None and the reader runs its
Python pipeline instead (``fluid/reader.py``, which says which ran).
"""
import ctypes
import hashlib
import os
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "dataloader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")
_lock = threading.Lock()
_lib = None
_tried = False
# why the last load_native() returned None (the build's or loader's error)
load_error = None


def library_path():
    h = hashlib.sha256()
    with open(SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, "libpaddle_tpu_torch_native-%s.so"
                        % h.hexdigest()[:16])


def _compile(path):
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    try:
        subprocess.run(["g++", *FLAGS, SRC, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, path)   # atomic: a loader never sees half a library
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_native():
    """Return the ctypes lib, building it on first call; None on failure
    (``load_error`` says why)."""
    global _lib, _tried, load_error
    with _lock:
        if _lib is not None:
            return _lib
        if _tried:
            return None
        _tried = True
        try:
            path = library_path()
            if not os.path.exists(path):
                _compile(path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError) as e:
            load_error = "%s: %s" % (type(e).__name__, e)
            return None
        lib.ptq_create.restype = ctypes.c_void_p
        lib.ptq_create.argtypes = [ctypes.c_int]
        lib.ptq_put.argtypes = [ctypes.c_void_p, ctypes.c_long]
        lib.ptq_get.restype = ctypes.c_long
        lib.ptq_get.argtypes = [ctypes.c_void_p]
        lib.ptq_destroy.argtypes = [ctypes.c_void_p]
        lib.arena_create.restype = ctypes.c_void_p
        lib.arena_create.argtypes = [ctypes.c_size_t]
        lib.arena_is_locked.restype = ctypes.c_int
        lib.arena_is_locked.argtypes = [ctypes.c_void_p]
        lib.arena_alloc.restype = ctypes.c_void_p
        lib.arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.arena_reset.argtypes = [ctypes.c_void_p]
        lib.arena_destroy.argtypes = [ctypes.c_void_p]
        lib.pipe_create.restype = ctypes.c_void_p
        lib.pipe_create.argtypes = [
            ctypes.c_int, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.pipe_is_pinned.restype = ctypes.c_int
        lib.pipe_is_pinned.argtypes = [ctypes.c_void_p]
        lib.pipe_acquire_write.restype = ctypes.c_int
        lib.pipe_acquire_write.argtypes = [ctypes.c_void_p]
        lib.pipe_slot_ptr.restype = ctypes.c_void_p
        lib.pipe_slot_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pipe_write.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.pipe_submit_write.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.pipe_wait_writes.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pipe_commit.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pipe_acquire_read.restype = ctypes.c_int
        lib.pipe_acquire_read.argtypes = [ctypes.c_void_p]
        lib.pipe_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.pipe_abort.argtypes = [ctypes.c_void_p]
        lib.pipe_reset.argtypes = [ctypes.c_void_p]
        lib.pipe_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib
