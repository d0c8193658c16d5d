"""Gradient clipping (ref: python/paddle/fluid/clip.py).

Port of paddle_tpu/fluid/clip.py: the same attrs append the same ops
(clip, clip_by_norm; squared_l2_norm, sum, sqrt and the scaling of the
global-norm group). With no clip attribute on any parameter,
append_gradient_clip_ops returns the (param, grad) pairs untouched."""
import copy

from . import framework

__all__ = [
    "ErrorClipByValue",
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "set_gradient_clip",
]


class BaseErrorClipAttr:
    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _append_clip_op(self, block, grad_name):
        block.append_op(
            type="clip",
            inputs={"X": [grad_name]},
            outputs={"Out": [grad_name]},
            attrs={"min": self.min, "max": self.max},
        )


def error_clip_callback(block, context):
    pass


class BaseGradientClipAttr:
    def _process_context(self, context, param, grad):
        raise NotImplementedError

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        block = grad.block
        new_grad = block.create_var(
            name=grad.name + "@CLIP", dtype=param.dtype, shape=param.shape
        )
        block.append_op(
            type="clip",
            inputs={"X": [grad]},
            outputs={"Out": [new_grad]},
            attrs={"min": self.min, "max": self.max},
        )
        return param, new_grad


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        block = grad.block
        new_grad = block.create_var(
            name=grad.name + "@CLIP", dtype=param.dtype, shape=param.shape
        )
        block.append_op(
            type="clip_by_norm",
            inputs={"X": [grad]},
            outputs={"Out": [new_grad]},
            attrs={"max_norm": self.clip_norm},
        )
        return param, new_grad


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """Global-norm clipping across all grads (ref clip.py)."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        context[self.group_name].append((param, grad))

    def _create_operators(self, param, grad):
        # actual ops created in append_gradient_clip_ops group pass
        return param, grad


def set_gradient_clip(clip, param_list=None, program=None):
    if not isinstance(clip, BaseGradientClipAttr):
        raise TypeError("clip must be BaseGradientClipAttr")
    program = program or framework.default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    param_list = [
        program.global_block().var(p) if isinstance(p, str) else p
        for p in param_list
    ]
    for param in param_list:
        param.gradient_clip_attr = copy.deepcopy(clip)


def _global_norm_clip_group(params_grads, clip_norm):
    """Append ops computing g *= clip_norm / max(global_norm, clip_norm)."""
    block = params_grads[0][1].block
    sq_sums = []
    for _, g in params_grads:
        sq = block.create_var(dtype=g.dtype, shape=())
        block.append_op(
            type="squared_l2_norm", inputs={"X": [g]}, outputs={"Out": [sq]}
        )
        sq_sums.append(sq)
    total = block.create_var(dtype="float32", shape=())
    block.append_op(
        type="sum", inputs={"X": sq_sums}, outputs={"Out": [total]}
    )
    gnorm = block.create_var(dtype="float32", shape=())
    block.append_op(
        type="sqrt", inputs={"X": [total]}, outputs={"Out": [gnorm]}
    )
    clip_var = block.create_var(dtype="float32", shape=())
    block.append_op(
        type="fill_constant",
        outputs={"Out": [clip_var]},
        attrs={"shape": [], "dtype": "float32", "value": clip_norm},
    )
    denom = block.create_var(dtype="float32", shape=())
    block.append_op(
        type="elementwise_max",
        inputs={"X": [gnorm], "Y": [clip_var]},
        outputs={"Out": [denom]},
        attrs={"axis": -1},
    )
    scale_v = block.create_var(dtype="float32", shape=())
    block.append_op(
        type="elementwise_div",
        inputs={"X": [clip_var], "Y": [denom]},
        outputs={"Out": [scale_v]},
        attrs={"axis": -1},
    )
    out = []
    for p, g in params_grads:
        ng = block.create_var(
            name=g.name + "@GCLIP", dtype=g.dtype, shape=g.shape
        )
        block.append_op(
            type="elementwise_mul",
            inputs={"X": [g], "Y": [scale_v]},
            outputs={"Out": [ng]},
            attrs={"axis": -1},
        )
        out.append((p, ng))
    return out


def append_gradient_clip_ops(param_grads):
    context = {}
    clips = []
    for p, g in param_grads:
        if g is None:
            continue
        clip_attr = getattr(p, "gradient_clip_attr", None)
        if clip_attr is None:
            clip_attr = NullGradientClipAttr()
        clip_attr._process_context(context, p, g)
        clips.append((p, g, clip_attr))

    res = []
    handled_groups = {}
    for p, g, clip_attr in clips:
        if isinstance(clip_attr, GradientClipByGlobalNorm):
            if clip_attr.group_name not in handled_groups:
                group = context[clip_attr.group_name]
                handled_groups[clip_attr.group_name] = dict(
                    (pp.name, (pp, gg))
                    for pp, gg in _global_norm_clip_group(
                        group, clip_attr.clip_norm
                    )
                )
            res.append(handled_groups[clip_attr.group_name][p.name])
        else:
            res.append(clip_attr._create_operators(p, g))
    # params without grads pass through
    for p, g in param_grads:
        if g is None:
            res.append((p, g))
    return res



# The reference's own docstrings import the dygraph GradClip* classes
# from fluid.clip (ref dygraph_grad_clip.py:70): both import paths resolve.
def __getattr__(name):
    if name in ("GradClipByValue", "GradClipByNorm",
                "GradClipByGlobalNorm"):
        from . import dygraph_grad_clip

        return getattr(dygraph_grad_clip, name)
    raise AttributeError("module 'fluid.clip' has no attribute %r" % name)
