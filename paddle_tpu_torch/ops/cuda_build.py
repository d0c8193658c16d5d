"""Build the port's hand-written CUDA kernels with nvcc and load them with
ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``_build/<name>-<digest>.so`` beside the package, where ``<digest>``
hashes the source, every header of ``csrc/`` and the flags, so an edited
source or header is rebuilt and a stale library is never loaded. Nothing
is compiled at import: a kernel is built at its first launch
(:func:`load`), or all at once, one nvcc process per source running
together (:func:`build_all`).
"""
import ctypes
import glob
import hashlib
import os
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
KERNELS = ("flash_attn_fwd", "layer_norm_fwd", "flash_attn_bwd",
           "layer_norm_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs = {}
# nvcc's stderr of each build of this process (-Xptxas=-v: registers,
# shared memory and spills of every kernel), by kernel name
build_logs = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def nvcc_path():
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def source_path(name):
    return os.path.join(CSRC_DIR, name + ".cu")


def library_path(name):
    h = hashlib.sha256()
    for path in [source_path(name)] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, h.hexdigest()[:16]))


def _start(name):
    """Start nvcc for `name` unless its library exists; returns
    (process, tmp_path, final_path) or None."""
    path = library_path(name)
    if os.path.exists(path):
        return None
    nvcc = nvcc_path()
    if not os.path.exists(nvcc):
        raise KernelBuildError(
            "nvcc not found at %s (set CUDA_HOME): the CUDA kernel %r "
            "cannot be built" % (nvcc, name))
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (path, os.getpid())
    proc = subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, path


def _finish(name, started):
    proc, tmp, path = started
    out, err = proc.communicate()
    build_logs[name] = (out or "") + (err or "")
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise KernelBuildError(
            "nvcc failed (%d) on %s:\n%s"
            % (proc.returncode, source_path(name), build_logs[name]))
    os.replace(tmp, path)  # atomic: a reader never sees half a library


def build_all(names=KERNELS):
    """Compile every kernel in `names` that is not built yet, all nvcc
    processes at once; returns the wall seconds spent."""
    t0 = time.monotonic()
    with _lock:
        started = {n: _start(n) for n in names}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    return time.monotonic() - t0


def load(name):
    """The ctypes library of kernel `name`, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
    return lib


def check(err, name):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: cudaError %d"
                           % (name, err))
