"""Post-training quantization (ref: python/paddle/fluid/contrib/slim/
quantization/post_training_quantization.py).

Port of paddle_tpu/fluid/contrib/slim/quantization/
post_training_quantization.py. Load a saved fp32 inference model, run
calibration batches, compute activation scales (abs-max or KL-divergence
threshold search), then rewrite the program onto the real-int8 ops of
quantization_pass and save. No retraining involved.

Calibration copies each activation the quantized ops read to the host
and keeps a strided subsample of at most 2^16 of its magnitudes, as the
JAX package does. ``timings`` records where a ``quantize()`` spent its
host seconds.
"""
import time

import numpy as np

from ..... import reader_utils
from ....executor import to_numpy
from ... import quant as _quant
from .quantization_pass import (
    ConvertToInt8Pass,
    QuantizationFreezePass,
    _channel_scales,
    _weight_quant_axis,
)

__all__ = ["PostTrainingQuantization"]


def _kl_threshold(samples, bins=2048, quant_levels=128):
    """TensorRT-style KL calibration: pick the clip threshold whose
    quantized distribution diverges least from the observed one.

    The JAX package's search, with each candidate's quantized histogram
    built from ``np.add.reduceat`` over ``np.array_split``'s chunk
    bounds instead of a Python loop over the chunks. The chunks hold
    histogram counts, whole numbers, so their sums are exact in any
    order and every q, KL value and threshold is the JAX package's, bit
    for bit (held in tests/test_torch_quant.py)."""
    amax = float(np.max(np.abs(samples)))
    if amax <= 0:
        return 1e-9
    hist, edges = np.histogram(np.abs(samples), bins=bins, range=(0, amax))
    hist = hist.astype(np.float64)
    best_kl, best_t = None, amax
    for i in range(quant_levels, bins + 1, 8):
        p = hist[:i].copy()
        p[i - 1] += hist[i:].sum()          # clip outliers into last bin
        if p.sum() == 0:
            continue
        # quantize the first i bins down to quant_levels then expand back:
        # array_split's chunks, the first i % quant_levels one longer
        size, extra = divmod(i, quant_levels)
        lens = np.full(quant_levels, size)
        lens[:extra] += 1
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        nonzero = p > 0
        means = np.add.reduceat(p, starts) / np.maximum(
            np.add.reduceat(nonzero.astype(np.int64), starts), 1)
        q = np.repeat(means, lens) * nonzero
        pn, qn = p / p.sum(), q / max(q.sum(), 1e-12)
        mask = pn > 0
        kl = float(np.sum(pn[mask] * np.log(pn[mask] /
                                            np.maximum(qn[mask], 1e-12))))
        if best_kl is None or kl < best_kl:
            best_kl, best_t = kl, float(edges[i])
    # guard against over-clipping when the histogram is dominated by the
    # post-ReLU zero mass (small nets / few channels): never clip below
    # the 99.9th percentile of observed magnitudes
    floor = float(np.percentile(samples, 99.9))
    return max(best_t, floor, 1e-9)


class PostTrainingQuantization:
    """ref post_training_quantization.py:36 — same constructor surface.

    algo: 'KL' (divergence threshold search) or 'direct'/'abs_max'
    (plain abs-max over calibration activations).
    """

    def __init__(self, executor, sample_generator, model_dir=None,
                 model_filename=None, params_filename=None, batch_size=10,
                 batch_nums=None, scope=None, algo="KL",
                 quantizable_op_type=["conv2d", "depthwise_conv2d", "mul"],
                 is_full_quantize=False, is_use_cache_file=False,
                 cache_dir="./temp_post_training",
                 program=None, feed_list=None, fetch_list=None):
        """``model_dir`` follows the reference contract. As in the JAX
        package, an in-memory ``program`` + ``feed_list``/``fetch_list``
        (feed var names, fetch Variables) may come instead: its params are
        already in the scope, so no disk round-trip is needed."""
        from ....executor import global_scope
        from .... import io as _io

        self._executor = executor
        self._sample_generator = sample_generator
        self._batch_size = int(batch_size)
        self._batch_nums = batch_nums
        self._scope = scope or global_scope()
        if algo not in ("KL", "direct", "abs_max"):
            raise ValueError("algo must be 'KL' or 'direct'/'abs_max'")
        self._algo = algo
        self._op_types = (
            ("conv2d", "depthwise_conv2d", "mul", "matmul")
            if is_full_quantize else tuple(quantizable_op_type)
        )
        # is_use_cache_file/cache_dir: calibration activations fit in host
        # memory here (samples are reduced to histograms immediately)
        if program is not None:
            if model_dir is not None:
                raise ValueError(
                    "pass model_dir OR program, not both (ambiguous "
                    "calibration source)")
            if feed_list is None or fetch_list is None:
                raise ValueError(
                    "program= requires feed_list (names) and "
                    "fetch_list (Variables)")
            # same contract as the model_dir path: calibration runs a
            # program pruned to the fetch targets (train-only tails that
            # need unfed labels must not survive)
            self._program = program._prune(list(fetch_list))
            self._feed_list = list(feed_list)
            self._fetch_list = list(fetch_list)
        elif model_dir is not None:
            self._program, self._feed_list, self._fetch_list = (
                _io.load_inference_model(
                    model_dir, executor, model_filename=model_filename,
                    params_filename=params_filename, scope=self._scope)
            )
        else:
            raise ValueError("pass model_dir or program")
        self._quantized_program = None
        self.timings = {}

    # ------------------------------------------------------------------
    def quantize(self):
        program = self._program
        # 1. find quantizable ops and the activations they consume
        targets = []  # (op, act_input_name, weight_name)
        gb = program.global_block()
        for op in gb.ops:
            if op.type not in self._op_types:
                continue
            if op.type in ("mul", "matmul"):
                act, wt = op.input("X")[0], op.input("Y")[0]
            else:
                act, wt = op.input("Input")[0], op.input("Filter")[0]
            if self._scope.find_var(wt) is None:
                continue  # second operand is not a parameter
            targets.append((op, act, wt))
        if not targets:
            raise ValueError(
                "no quantizable ops (%s) found in the loaded program"
                % (self._op_types,)
            )
        act_names = sorted({a for _, a, _ in targets})

        # 2. run calibration batches, collecting activation samples
        samples = {n: [] for n in act_names}
        batches = reader_utils.batch(
            self._sample_generator, self._batch_size, drop_last=False)
        from ....data_feeder import DataFeeder

        feeder = DataFeeder(list(self._feed_list), self._executor.place,
                            program=program)
        n_batches = 0
        t_run = t_host = 0.0
        for batch in batches():
            feed = feeder.feed(batch)
            t0 = time.perf_counter()
            vals = self._executor.run(
                program, feed=feed,
                fetch_list=[gb.var(n) for n in act_names],
                scope=self._scope, return_numpy=False)
            t1 = time.perf_counter()
            for n, v in zip(act_names, vals):
                a = np.abs(np.asarray(to_numpy(v), dtype=np.float32)
                           ).reshape(-1)
                # subsample big activations: the histogram needs the
                # distribution, not every element
                if a.size > 1 << 16:
                    a = a[:: max(a.size >> 16, 1)]
                samples[n].append(a)
            t_run += t1 - t0
            t_host += time.perf_counter() - t1
            n_batches += 1
            if self._batch_nums and n_batches >= self._batch_nums:
                break
        if n_batches == 0:
            raise ValueError("sample_generator yielded no data")

        # 3. activation scales
        t0 = time.perf_counter()
        act_scales = {}
        for n in act_names:
            flat = np.concatenate(samples[n])
            if self._algo == "KL":
                act_scales[n] = _kl_threshold(flat)
            else:
                act_scales[n] = max(float(np.max(flat)), 1e-9)
        t_scales = time.perf_counter() - t0

        # 4. rewrite: weights to int8 grid + quantized ops
        t0 = time.perf_counter()
        qmax = 127.0
        for op, act, wt in targets:
            w = np.asarray(self._scope.find_var(wt))
            axis = _weight_quant_axis(op.type, w.shape)
            wscales = _channel_scales(w, axis)
            shape = [1] * w.ndim
            shape[axis] = -1
            wq = np.clip(np.round(w / wscales.reshape(shape) * qmax),
                         -qmax, qmax)
            self._scope.set(wt, wq.astype(w.dtype))
            if op.type in ("mul", "matmul"):
                op.type = "quantized_mul"
                op.inputs = {"X": [act], "Y": [wt]}
                op.attrs = {
                    "act_scale": act_scales[act],
                    "weight_scale": [float(s) for s in wscales],
                    "quant_bits": 8,
                }
            else:
                op.attrs = dict(
                    op.attrs, act_scale=act_scales[act],
                    weight_scale=[float(s) for s in wscales], quant_bits=8)
                op.inputs = {"Input": [act], "Filter": [wt]}
                op.type = "quantized_conv2d"
        ConvertToInt8Pass(self._scope, self._executor.place).apply(program)
        program._bump_version()
        self.timings = {
            "batches": n_batches,
            # the calibration runs, fetches left on the device
            "run_seconds": t_run,
            # the fetches copied to the host and subsampled
            "host_sampling_seconds": t_host,
            "scale_seconds": t_scales,
            "rewrite_seconds": time.perf_counter() - t0,
        }
        self._quantized_program = program
        return program

    def save_quantized_model(self, save_model_path):
        from .... import io as _io

        if self._quantized_program is None:
            raise RuntimeError("call quantize() first")
        _io.save_inference_model(
            dirname=save_model_path,
            feeded_var_names=list(self._feed_list),
            target_vars=self._fetch_list,
            executor=self._executor,
            main_program=self._quantized_program,
            scope=self._scope,
        )


# re-export for freeze-path callers that import from this module (ref
# exposes both through the quantization package)
QuantizationFreezePass = QuantizationFreezePass
_ = _quant  # anchor: the fake-quant op lowerings must be registered
