"""Device places and dtype plumbing, on torch devices.

Port of paddle_tpu/fluid/core.py. A Place names the torch device a
program's tensors live on. ``CUDAPlace`` is a real CUDA device here (in
the JAX package it is an alias of the TPU place), and ``default_place()``
is the card: with no CUDA device it raises rather than carry on on the
CPU, so running on the CPU is always the caller's explicit choice
(``CPUPlace()``).
"""
import os

import numpy as np
import torch


class Place:
    """Base device placement."""

    _device_type = "cpu"

    def __init__(self, device_id=0):
        self._device_id = int(device_id)

    def torch_device(self):
        if self._device_type == "cpu":
            return torch.device("cpu")
        return torch.device(self._device_type, self._device_id)

    def __eq__(self, other):
        return (
            type(self) is type(other) and self._device_id == other._device_id
        )

    def __hash__(self):
        return hash((type(self).__name__, self._device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self._device_id)


class CPUPlace(Place):
    _device_type = "cpu"


class CUDAPlace(Place):
    """One NVIDIA card, ``torch.device("cuda", device_id)``."""

    _device_type = "cuda"


class CUDAPinnedPlace(CPUPlace):
    """Page-locked host memory: a host place, as in the JAX package."""


def is_compiled_with_cuda():
    """Whether this torch build has CUDA."""
    return torch.backends.cuda.is_built()


def globals_flags():
    return dict(os.environ)


def default_place():
    """The card: ``CUDAPlace(0)``. Raises when torch sees no CUDA device —
    pass ``place=CPUPlace()`` to run on the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible to torch; paddle_tpu_torch runs on "
            "the card unless asked otherwise — pass place=CPUPlace() to "
            "run on the CPU")
    return CUDAPlace(0)


class VarType:
    """dtype + variable-kind enums, mirroring VarDesc.VarType in
    framework.proto (ref: paddle/fluid/framework/framework.proto)."""

    # dtypes
    BOOL = "bool"
    INT8 = "int8"
    UINT8 = "uint8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FP16 = "float16"
    BF16 = "bfloat16"
    FP32 = "float32"
    FP64 = "float64"
    # var kinds
    LOD_TENSOR = "lod_tensor"
    SELECTED_ROWS = "selected_rows"
    FEED_MINIBATCH = "feed_minibatch"
    FETCH_LIST = "fetch_list"
    STEP_SCOPES = "step_scopes"
    LOD_TENSOR_ARRAY = "lod_tensor_array"
    RAW = "raw"


_TORCH = {
    VarType.BOOL: torch.bool,
    VarType.INT8: torch.int8,
    VarType.UINT8: torch.uint8,
    VarType.INT16: torch.int16,
    VarType.INT32: torch.int32,
    VarType.INT64: torch.int64,
    VarType.FP16: torch.float16,
    VarType.BF16: torch.bfloat16,
    VarType.FP32: torch.float32,
    VarType.FP64: torch.float64,
}
_FROM_TORCH = {v: k for k, v in _TORCH.items()}


def convert_dtype(dtype):
    """Normalise any dtype spec (np dtype, str, torch dtype) to a canonical
    string like 'float32'."""
    if dtype is None:
        return VarType.FP32
    if isinstance(dtype, str):
        aliases = {
            "float": "float32",
            "double": "float64",
            "int": "int32",
            "long": "int64",
            "half": "float16",
            "bfloat16": "bfloat16",
        }
        return aliases.get(dtype, dtype)
    if isinstance(dtype, torch.dtype):
        return _FROM_TORCH[dtype]
    return str(np.dtype(dtype))


def torch_dtype(dtype):
    """The torch dtype of a dtype spec."""
    return _TORCH[convert_dtype(dtype)]


def np_dtype(dtype):
    """The numpy dtype of a dtype spec; bfloat16, which numpy lacks, maps
    to float32 (host copies of bf16 tensors are widened)."""
    s = convert_dtype(dtype)
    return np.dtype("float32" if s == VarType.BF16 else s)


class EOFException(Exception):
    """Raised by Executor.run when an attached py_reader is exhausted
    (ref: paddle/fluid/framework/reader.h EOFException): catch it to end
    the epoch, then reader.reset()."""


class ReaderNotStartedError(RuntimeError):
    """Raised by Executor.run when no feed was given and the program's
    py_reader is decorated but not started (or went EOF without a
    reset() and start()). A configuration error, not a transient one."""


def __getattr__(name):
    # deployment scripts reach AnalysisConfig / create_paddle_predictor
    # through fluid.core (the reference exposes them via pybind); lazy to
    # avoid a core <-> inference import cycle
    if name in ("AnalysisConfig", "create_paddle_predictor"):
        from . import inference

        return getattr(inference, name)
    raise AttributeError("module 'core' has no attribute %r" % name)
