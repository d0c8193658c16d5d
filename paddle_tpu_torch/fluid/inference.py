"""Inference engine — port of paddle_tpu/fluid/inference.py ``Predictor``
(ref: paddle/fluid/inference/api/analysis_predictor.cc).

The pruned inference program runs eagerly, op by op, under
``torch.inference_mode()``, with its parameters resident on the place's
device (the card unless the caller passes ``place=CPUPlace()``)::

    predictor = Predictor.from_model(dirname)          # load_inference_model
    out, = predictor.run({"x": batch})

There is no executable to compile, so ``warm`` runs the forward once (it
builds the CUDA kernels at their first launch). The JAX package's
analyzer gate and compile cache wait for their own slices.

Deployment scripts reach the predictor through the reference's inference
API, ``AnalysisConfig`` and ``create_paddle_predictor`` (also on
``fluid.core``). Unlike the JAX package's, whose config runs on the CPU
until ``enable_use_gpu()``, a fresh config here uses the card: the CPU is
an explicit ``disable_gpu()``.
"""
import time

import numpy as np
import torch

from . import core
from .executor import (Executor, Scope, expand_lod_feeds, feed_dtypes,
                       global_scope, to_numpy, to_tensor)
from .lowering import build_step_fn

__all__ = ["AnalysisConfig", "Predictor", "create_paddle_predictor"]


class Predictor:
    """Eager predictor over a pruned inference Program.

    ``scope`` is a ``Scope`` or any name -> value mapping. A tensor that
    is already on the place's device (in the dtype the policy keeps) is
    held as it is, not copied: every predictor built on one such dict
    shares one device copy of the parameters, as the programs of one
    ``DecodeEngine`` do. Host values are copied to the device.

    ``dtype_policy="bfloat16"`` stores every floating parameter in
    bfloat16, so the forward computes in bf16 (statistics and softmax stay
    f32 inside the kernels); bf16 fetches come back widened to float32.
    """

    def __init__(self, program, feed_names, fetch_vars, scope=None,
                 place=None, dtype_policy=None):
        if dtype_policy not in (None, "bfloat16"):
            raise ValueError("dtype_policy must be None or 'bfloat16', got %r"
                             % (dtype_policy,))
        self.program = program
        self.feed_names = list(feed_names)
        self.fetch_names = [
            v.name if hasattr(v, "name") else v for v in fetch_vars
        ]
        self.place = place if place is not None else core.default_place()
        self.device = self.place.torch_device()
        scope = scope if scope is not None else global_scope()
        state = {}
        for v in program.list_vars():
            if getattr(v, "persistable", False) and v.name in scope:
                t = to_tensor(scope[v.name], self.device)
                if dtype_policy == "bfloat16" and t.is_floating_point():
                    t = t.to(torch.bfloat16)
                state[v.name] = t
        self._state = state
        self._step = build_step_fn(
            program, self.feed_names, self.fetch_names, self.device,
            is_test=True)
        # feed dtype coercion targets (mirrors Executor._prepare_feeds)
        self._want_dtypes = feed_dtypes(program, self.feed_names)
        self.compile_seconds = {}

    @classmethod
    def from_model(cls, dirname, model_filename=None, params_filename=None,
                   **kw):
        """Load a save_inference_model directory (written by either
        package). Params land in a private scope per predictor unless
        ``scope=`` is passed."""
        from .io import load_inference_model

        scope = kw.pop("scope", None)
        if scope is None:
            scope = Scope()
        program, feed_names, fetch_vars = load_inference_model(
            dirname, Executor(core.CPUPlace()), model_filename,
            params_filename, scope=scope)
        return cls(program, feed_names, fetch_vars, scope=scope, **kw)

    def _prepare(self, feeds):
        """Normalize one request: dict (or feed_names-aligned list) ->
        {name: array}; a ``LoDTensor`` feed gives its padded array and its
        lengths as the ``@SEQ_LEN`` companion the program declares
        (:func:`expand_lod_feeds`). Host feeds become numpy arrays
        of the program's declared feed dtype (bfloat16 feeds stay float32
        on the host); tensors pass through, cast to it."""
        if not isinstance(feeds, dict):
            feeds = dict(zip(self.feed_names, feeds))
        feeds = expand_lod_feeds(self.program.global_block(), feeds)
        prepared = {}
        companions = [n + "@SEQ_LEN" for n in self.feed_names]
        for n in self.feed_names + [c for c in companions if c in feeds
                                    and c not in self.feed_names]:
            v = feeds[n]
            want = self._want_dtypes.get(n)
            if isinstance(v, torch.Tensor):
                if want is not None and v.dtype != want:
                    v = v.to(want)
            else:
                v = np.asarray(v)
                if want is not None and v.dtype != core.np_dtype(want):
                    v = v.astype(core.np_dtype(want))
            prepared[n] = v
        return prepared

    def warm(self, feeds):
        """Run the forward once on `feeds` (builds the kernels at their
        first launch) and wait for the device; returns ``"eager"``."""
        self.run(feeds)
        return "eager"

    def run(self, feeds, return_numpy=True):
        """feeds: dict name -> array (or list aligned with feed_names)."""
        prepared = self._prepare(feeds)
        sig = tuple((n, tuple(v.shape), core.convert_dtype(v.dtype))
                    for n, v in prepared.items())
        first = sig not in self.compile_seconds
        t0 = time.perf_counter() if first else None
        tensors = {n: to_tensor(v, self.device, self._want_dtypes.get(n))
                   for n, v in prepared.items()}
        fetches, _ = self._step(self._state, tensors)
        out = [to_numpy(o) for o in fetches] if return_numpy \
            else list(fetches)
        if first:
            self.compile_seconds[sig] = time.perf_counter() - t0
        return out

    __call__ = run

    def profile(self):
        """The JAX package's keys (ref inference.py:262). The port
        compiles nothing: ``n_engines`` counts the feed-shape signatures
        this predictor has run (one compiled executable each in the JAX
        package), and ``compile_seconds`` maps each to the host seconds
        of its first run, which carries the one-off costs (kernel builds
        at first launch, library handles, allocator growth)."""
        return {
            "n_engines": len(self.compile_seconds),
            "compile_seconds": dict(self.compile_seconds),
            "n_params": len(self._state),
        }


class AnalysisConfig:
    """Deployment config (ref: paddle/fluid/inference/api/
    paddle_analysis_config.h via core.AnalysisConfig).

    The place follows the port's rule: the card unless the caller asks
    for the CPU. A fresh config uses ``CUDAPlace(0)``,
    ``enable_use_gpu(device_id=i)`` picks ``CUDAPlace(i)``, and
    ``disable_gpu()`` is the explicit request for ``CPUPlace()``. The
    reference's IR passes, TensorRT and MKLDNN switches cannot apply to
    an eager torch forward; they are accepted and recorded, so
    deployment scripts run unchanged."""

    def __init__(self, model_dir=None, params_file=None):
        self.model_dir = model_dir
        self.params_file = params_file
        self._use_gpu = True
        self._device_id = 0
        self._switches = {}

    # -- device ----------------------------------------------------------
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._use_gpu = True
        self._device_id = device_id

    def disable_gpu(self):
        self._use_gpu = False

    def use_gpu(self):
        return self._use_gpu

    def gpu_device_id(self):
        return self._device_id

    def _place(self):
        """The place a predictor built from this config runs on."""
        if self._use_gpu:
            return core.CUDAPlace(self._device_id)
        return core.CPUPlace()

    # -- accepted no-op switches ------------------------------------------
    def switch_ir_optim(self, x=True):
        self._switches["ir_optim"] = x

    def enable_tensorrt_engine(self, **kw):
        self._switches["tensorrt"] = kw

    def enable_mkldnn(self):
        self._switches["mkldnn"] = True

    def switch_use_feed_fetch_ops(self, x=False):
        self._switches["feed_fetch_ops"] = x

    def switch_specify_input_names(self, x=True):
        self._switches["specify_input_names"] = x

    def set_cpu_math_library_num_threads(self, n):
        self._switches["cpu_threads"] = n


def create_paddle_predictor(config_or_dirname, **kw):
    """ref inference api: create_paddle_predictor(AnalysisConfig | dir).
    A dirname runs on the card, as ``Predictor.from_model`` does."""
    if isinstance(config_or_dirname, str):
        return Predictor.from_model(config_or_dirname, **kw)
    if isinstance(config_or_dirname, AnalysisConfig):
        cfg = config_or_dirname
        if not cfg.model_dir:
            raise ValueError("AnalysisConfig has no model_dir set")
        if cfg.use_gpu() and not torch.cuda.is_available():
            raise RuntimeError(
                "AnalysisConfig asks for the card, and no CUDA device is "
                "visible to torch; call disable_gpu() to run on the "
                "CPU (CPUPlace)")
        return Predictor.from_model(cfg.model_dir, place=cfg._place(), **kw)
    raise TypeError(
        "pass an AnalysisConfig or a save_inference_model dirname"
    )
