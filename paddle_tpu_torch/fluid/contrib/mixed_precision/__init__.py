"""Automatic mixed precision (ref: python/paddle/fluid/contrib/
mixed_precision/decorator.py); port of paddle_tpu/fluid/contrib/
mixed_precision.

``decorate(optimizer, use_bf16=True)`` rewrites the program so the inputs
of every white-list op (the matrix products) are cast to bfloat16, while
master weights and the optimizer update stay fp32. bfloat16 has fp32's
exponent range and needs no loss scaling. No output is cast back: the
lowerings promote per op by jax's rules (ops/promotion.py), so the f32
bias add after a product gives f32 again, and a product whose output
reaches a loss unchanged (BERT's MLM logits) leaves the loss in bfloat16.

``use_bf16=False`` computes in fp32 (the reference has no fp16 compute
path) and only scales the loss: statically, or dynamically with
``use_dynamic_loss_scaling``, where a step whose gradients are not all
finite is skipped through the update ops' ``SkipGate`` input
(fluid/lowering.py ``apply_op``) and the scale follows the reference's
rule, floored at 1.
"""
import numpy as np
import torch

from ... import framework

__all__ = ["decorate", "AutoMixedPrecisionLists", "bf16_compute_guard"]

# ops whose inputs are worth computing in bf16 (the matrix products)
WHITE_LIST = {"mul", "matmul", "conv2d", "conv3d", "depthwise_conv2d"}
# ops that must stay fp32
BLACK_LIST = {
    "softmax_with_cross_entropy", "cross_entropy", "cross_entropy2",
    "mean", "sum", "exp", "log", "softmax",
}


class AutoMixedPrecisionLists:
    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.white_list = set(WHITE_LIST)
        self.black_list = set(BLACK_LIST)
        if custom_white_list:
            self.white_list |= set(custom_white_list)
        if custom_black_list:
            self.black_list |= set(custom_black_list)


def _rewrite_program_bf16(program, amp_lists):
    """Insert casts so white-list ops consume bf16 inputs.

    The products sum in fp32, as XLA's do in the reference (cuBLAS under
    fluid/lowering.py ``f32_precision`` on the card), so this is
    numerically the standard bf16 training recipe."""
    block = program.global_block()
    new_ops = []
    cast_cache = {}
    for op in list(block.ops):
        if op.type in amp_lists.white_list:
            for slot, names in op.inputs.items():
                if slot in ("Param",):
                    continue
                casted = []
                for n in names:
                    var = block.vars.get(n)
                    if var is None or var.dtype != "float32":
                        casted.append(n)
                        continue
                    key = n
                    if key not in cast_cache:
                        cast_name = n + ".cast_bf16"
                        block.create_var(
                            name=cast_name, shape=var.shape, dtype="bfloat16"
                        )
                        new_ops.append(
                            framework.Operator(
                                block,
                                "cast",
                                {"X": [n]},
                                {"Out": [cast_name]},
                                {"in_dtype": "float32",
                                 "out_dtype": "bfloat16"},
                            )
                        )
                        cast_cache[key] = cast_name
                    casted.append(cast_cache[key])
                op.inputs[slot] = casted
        new_ops.append(op)
        # outputs of white ops flow as bf16 until a black op needs fp32;
        # the lowerings promote per op (ops/promotion.py), so no output
        # casts are needed here.
    block.ops = new_ops
    program._bump_version()


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists, init_loss_scaling,
                 use_dynamic_loss_scaling, use_bf16=True,
                 incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 incr_ratio=2.0, decr_ratio=0.8):
        self._optimizer = optimizer
        self._amp_lists = amp_lists
        self._init_loss_scaling = float(init_loss_scaling)
        self._loss_scaling = init_loss_scaling
        self._use_dynamic_loss_scaling = use_dynamic_loss_scaling
        self._use_bf16 = use_bf16
        self._incr_every_n_steps = int(incr_every_n_steps)
        self._decr_every_n_nan_or_inf = int(decr_every_n_nan_or_inf)
        self._incr_ratio = float(incr_ratio)
        self._decr_ratio = float(decr_ratio)
        self._scale_var = None
        self._scaled_loss = None

    def get_loss_scaling(self):
        """The current loss-scaling: a graph Variable when dynamic scaling
        is active (fp16 path), else the static float."""
        return self._scale_var if self._scale_var is not None \
            else self._loss_scaling

    def get_scaled_loss(self):
        return self._scaled_loss

    def get_finite_flag(self):
        """The in-graph all-grads-finite flag (a [1] float32 Variable,
        1.0 = finite), or None before minimize()/on the bf16 path.
        Fetch it to observe overflow-skipped steps host-side."""
        return getattr(self, "_finite_flag", None)

    def publish_step_telemetry(self, scope=None, skipped=None):
        """Publish this step's AMP state to the telemetry hub: the
        ``amp.loss_scale`` gauge (read from the scope on the dynamic
        path, where the scale lives in the program's state; the static
        float otherwise) and the ``amp.skipped_steps`` counter when
        ``skipped`` is true (the skip gate zeroed this update). Returns
        the published scale, or None when the dynamic scale has no value
        in the scope yet."""
        from .... import observability as obs

        val = None
        if self._scale_var is not None:
            if scope is None:
                from ...executor import global_scope

                scope = global_scope()
            raw = scope.find_value(self._scale_var.name)
            if raw is not None:
                try:
                    if isinstance(raw, torch.Tensor):
                        val = float(raw.detach().reshape(-1)[0])
                    else:
                        val = float(np.asarray(raw).reshape(-1)[0])
                except (TypeError, ValueError, IndexError):
                    val = None
        else:
            val = float(self._loss_scaling)
        if val is not None:
            obs.set_gauge("amp.loss_scale", val)
        if skipped:
            obs.inc("amp.skipped_steps")
        return val

    def _ensure_scale_state(self):
        from ...layers import tensor

        if self._scale_var is not None:
            return
        from ... import unique_name

        # unique names: two decorated optimizers in one process must not
        # share loss-scaling state in the (name-keyed) global scope
        self._scale_var = tensor.create_global_var(
            shape=[1], value=self._init_loss_scaling, dtype="float32",
            persistable=True, name=unique_name.generate("amp_loss_scaling"),
        )
        self._good_steps = tensor.create_global_var(
            shape=[1], value=0.0, dtype="float32",
            persistable=True, name=unique_name.generate("amp_good_steps"),
        )
        self._bad_steps = tensor.create_global_var(
            shape=[1], value=0.0, dtype="float32",
            persistable=True, name=unique_name.generate("amp_bad_steps"),
        )

    def _append_dynamic_update(self, finite):
        """In-graph dynamic loss-scaling update (ref mixed_precision
        update_loss_scaling op): after ``incr_every_n_steps`` consecutive
        finite steps scale *= incr_ratio; after ``decr_every_n_nan_or_inf``
        consecutive non-finite steps scale *= decr_ratio. All branch-free
        arithmetic selects."""
        from ...layers import nn, tensor

        block = self._scale_var.block

        def assign(var, val):
            block.append_op(
                type="assign", inputs={"X": [val]}, outputs={"Out": [var]}
            )

        not_finite = nn.scale(finite, scale=-1.0, bias=1.0)
        good = nn.elementwise_mul(
            nn.scale(self._good_steps, bias=1.0), finite
        )
        bad = nn.elementwise_mul(
            nn.scale(self._bad_steps, bias=1.0), not_finite
        )
        bump = nn._layer(
            "greater_equal",
            {"X": good,
             "Y": tensor.fill_constant(
                 [1], "float32", float(self._incr_every_n_steps))},
            out_dtype="bool", out_shape=(1,),
        )
        bump = tensor.cast(bump, "float32")
        decay = nn._layer(
            "greater_equal",
            {"X": bad,
             "Y": tensor.fill_constant(
                 [1], "float32", float(self._decr_every_n_nan_or_inf))},
            out_dtype="bool", out_shape=(1,),
        )
        decay = tensor.cast(decay, "float32")
        factor = nn.elementwise_mul(
            nn.scale(bump, scale=self._incr_ratio - 1.0, bias=1.0),
            nn.scale(decay, scale=self._decr_ratio - 1.0, bias=1.0),
        )
        new_scale = nn.elementwise_mul(self._scale_var, factor)
        # floor at 1.0 like the reference kernel
        # (operators/amp/update_loss_scaling_op.h clamps the decremented
        # scale to 1) — without it a persistently-diverging run decays
        # the scale toward 0, and at scale==0 all grads are zero-finite
        # while 1/scale is inf: NaNs would APPLY through the SkipGate
        new_scale = nn.elementwise_max(
            new_scale, tensor.fill_constant([1], "float32", 1.0)
        )
        assign(self._scale_var, new_scale)
        assign(self._good_steps, nn.elementwise_mul(
            good, nn.scale(bump, scale=-1.0, bias=1.0)))
        assign(self._bad_steps, nn.elementwise_mul(
            bad, nn.scale(decay, scale=-1.0, bias=1.0)))

    def backward(self, loss, **kwargs):
        from ...layers import nn, tensor

        self._finite_flag = None
        if self._use_bf16:
            # bf16 path: no loss scaling needed (same exponent range as
            # fp32)
            self._scaled_loss = loss
            return self._optimizer.backward(self._scaled_loss, **kwargs)
        if self._use_dynamic_loss_scaling:
            self._ensure_scale_state()
            self._scaled_loss = nn.elementwise_mul(
                loss, nn.reduce_sum(self._scale_var)
            )
        else:
            self._scaled_loss = nn.scale(
                loss, scale=float(self._loss_scaling))
        params_grads = self._optimizer.backward(self._scaled_loss, **kwargs)
        if self._use_dynamic_loss_scaling:
            # check_finite_and_unscale: one scalar flag per grad (the
            # isfinite lowering reduces to a scalar itself), combined into
            # a global flag; each grad is unscaled AND — because NaN * 0
            # is NaN — zeroed via a select on overflow, so the optimizer
            # update becomes a no-op on bad steps.
            per_grad_flag = {}
            finite = None
            for _, g in params_grads:
                if g is None:
                    continue
                fb = nn._layer(
                    "isfinite", {"X": g}, out_dtype="bool", out_shape=()
                )
                per_grad_flag[g.name] = fb
                f = nn.reshape(tensor.cast(fb, "float32"), [1])
                finite = f if finite is None else nn.elementwise_mul(
                    finite, f)
            inv_s = nn.reduce_sum(nn.elementwise_div(
                tensor.fill_constant([1], "float32", 1.0), self._scale_var
            ))
            gate = nn.elementwise_mul(inv_s, nn.reduce_sum(finite))

            def _unscale_or_zero(g):
                zeros = nn._layer(
                    "fill_zeros_like", {"X": g}, out_shape=g.shape,
                    out_dtype=g.dtype,
                )
                cleaned = nn._layer(
                    "where",
                    {"Condition": per_grad_flag[g.name], "X": g, "Y": zeros},
                    out_shape=g.shape,
                )
                return nn.elementwise_mul(cleaned, gate)

            params_grads = [
                (p, g if g is None else _unscale_or_zero(g))
                for p, g in params_grads
            ]
            # minimize() attaches this as a SkipGate on the update ops so
            # overflow steps are TRUE skips (no beta-power advance, no
            # moment decay) — the reference's skip-update semantics
            self._finite_flag = finite
            self._append_dynamic_update(finite)
        elif self._loss_scaling != 1.0:
            inv = 1.0 / float(self._loss_scaling)
            params_grads = [
                (p, g if g is None else nn.scale(g, scale=inv))
                for p, g in params_grads
            ]
        return params_grads

    def apply_gradients(self, params_grads, grad_clip=None):
        return self._optimizer.apply_gradients(
            params_grads, grad_clip=grad_clip
        )

    def apply_optimize(self, loss, startup_program, params_grads,
                       grad_clip=None):
        return self._optimizer.apply_optimize(
            loss, startup_program, params_grads, grad_clip=grad_clip
        )

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        prog = loss.block.program
        if self._use_bf16:
            _rewrite_program_bf16(prog, self._amp_lists)
        params_grads = self.backward(
            loss,
            startup_program=startup_program,
            parameter_list=parameter_list,
            no_grad_set=no_grad_set,
        )
        optimize_ops = self.apply_optimize(
            loss, startup_program, params_grads
        )
        finite = getattr(self, "_finite_flag", None)
        if finite is not None:
            # true skip-update on overflow: gate every per-param update op
            # (param + accumulators + beta powers all keep their old
            # values — see lowering.apply_op's SkipGate handling)
            for op in optimize_ops:
                if op is not None and hasattr(op, "inputs"):
                    op.inputs["SkipGate"] = [finite.name]
            prog._bump_version()
        return optimize_ops, params_grads

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


def decorate(optimizer, amp_lists=None, init_loss_scaling=2**15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=True, use_bf16=True):
    """ref contrib/mixed_precision/decorator.py:decorate"""
    if amp_lists is None:
        amp_lists = AutoMixedPrecisionLists()
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling,
        use_dynamic_loss_scaling, use_bf16,
        incr_every_n_steps=incr_every_n_steps,
        decr_every_n_nan_or_inf=decr_every_n_nan_or_inf,
        incr_ratio=incr_ratio, decr_ratio=decr_ratio,
    )


class bf16_compute_guard:
    """Reserved context manager for scoped bf16 layer construction.
    Nothing consults it yet — entering raises instead of silently
    building fp32 layers; ``decorate(opt, use_bf16=True)`` is the
    working bf16 path (it rewrites the whole program's MXU ops)."""

    _active = [False]

    def __enter__(self):
        raise NotImplementedError(
            "bf16_compute_guard is not wired into layer construction; "
            "use mixed_precision.decorate(optimizer, use_bf16=True) — "
            "it casts every white-list op's inputs to bf16 program-wide"
        )

    def __exit__(self, *exc):
        bf16_compute_guard._active.pop()
