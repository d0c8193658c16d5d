"""Learning-rate schedulers (ref: python/paddle/fluid/layers/
learning_rate_scheduler.py).

Port of paddle_tpu/fluid/layers/learning_rate_scheduler.py: the same eight
schedules append the same ops. Each returns a Variable computed by ops
from the ``@LR_DECAY_COUNTER@`` step counter, whose ``increment`` the
first schedule prepends to the block; each is branchless (masks instead
of control-flow ops), so a step runs no conditional and never waits for
the device."""
import math

from . import nn
from . import ops
from . import tensor

__all__ = [
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
    "noam_decay",
    "cosine_decay",
    "linear_lr_warmup",
]


def _decay_step_counter(begin=0):
    global_step = nn.autoincreased_step_counter(
        counter_name="@LR_DECAY_COUNTER@", begin=begin, step=1
    )
    global_step = tensor.cast(global_step, "float32")
    return global_step


def noam_decay(d_model, warmup_steps):
    """lr = d_model^-0.5 * min(step^-0.5, step*warmup^-1.5) (ref)."""
    global_step = _decay_step_counter(1)
    a = nn.elementwise_pow(
        global_step, tensor.fill_constant([1], "float32", -0.5)
    )
    b = nn.scale(global_step, scale=warmup_steps ** -1.5)
    lr_value = nn.scale(
        nn.elementwise_min(a, b), scale=d_model ** -0.5
    )
    return lr_value


def exponential_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    global_step = _decay_step_counter()
    div_res = nn.scale(global_step, scale=1.0 / decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    return nn.scale(
        nn.elementwise_pow(
            tensor.fill_constant([1], "float32", decay_rate), div_res
        ),
        scale=float(learning_rate),
    )


def natural_exp_decay(learning_rate, decay_steps, decay_rate, staircase=False):
    global_step = _decay_step_counter()
    div_res = nn.scale(global_step, scale=1.0 / decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    return nn.scale(
        ops.exp(nn.scale(div_res, scale=-decay_rate)),
        scale=float(learning_rate),
    )


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    global_step = _decay_step_counter()
    div_res = nn.scale(global_step, scale=1.0 / decay_steps)
    if staircase:
        div_res = ops.floor(div_res)
    denom = nn.scale(div_res, scale=decay_rate, bias=1.0)
    return nn.elementwise_div(
        tensor.fill_constant([1], "float32", float(learning_rate)), denom
    )


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    global_step = _decay_step_counter()
    if cycle:
        div_res = ops.ceil(nn.scale(global_step, scale=1.0 / decay_steps))
        # if step == 0 -> div = 1 (branchless: max(div, 1))
        div_res = nn.elementwise_max(
            div_res, tensor.fill_constant([1], "float32", 1.0)
        )
        decay_steps_var = nn.scale(div_res, scale=float(decay_steps))
        ratio = nn.elementwise_div(global_step, decay_steps_var)
    else:
        capped = nn.elementwise_min(
            global_step,
            tensor.fill_constant([1], "float32", float(decay_steps)),
        )
        ratio = nn.scale(capped, scale=1.0 / decay_steps)
    base = nn.scale(ratio, scale=-1.0, bias=1.0)
    powed = nn.elementwise_pow(
        base, tensor.fill_constant([1], "float32", power)
    )
    return nn.scale(
        powed,
        scale=float(learning_rate) - float(end_learning_rate),
        bias=float(end_learning_rate),
        bias_after_scale=True,
    )


def piecewise_decay(boundaries, values):
    """Branchless piecewise-constant schedule: lr = Σ v_i · 1[b_{i-1} ≤ s < b_i]."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    global_step = _decay_step_counter()
    lr = tensor.fill_constant([1], "float32", 0.0)
    prev = None
    for i, v in enumerate(values):
        seg = tensor.fill_constant([1], "float32", float(v))
        if i == 0:
            cond = tensor.cast(
                nn.logical_not(
                    _ge(global_step, boundaries[0])
                ),
                "float32",
            )
        elif i == len(values) - 1:
            cond = tensor.cast(_ge(global_step, boundaries[i - 1]), "float32")
        else:
            cond = tensor.cast(
                nn.logical_and(
                    _ge(global_step, boundaries[i - 1]),
                    nn.logical_not(_ge(global_step, boundaries[i])),
                ),
                "float32",
            )
        lr = nn.elementwise_add(lr, nn.elementwise_mul(seg, cond))
    return lr


def _ge(step_var, bound):
    from .nn import _layer

    b = tensor.fill_constant([1], "float32", float(bound))
    return _layer(
        "greater_equal", {"X": step_var, "Y": b}, out_dtype="bool",
        out_shape=(1,),
    )


def cosine_decay(learning_rate, step_each_epoch, epochs):
    global_step = _decay_step_counter()
    epoch = ops.floor(nn.scale(global_step, scale=1.0 / step_each_epoch))
    frac = nn.scale(epoch, scale=math.pi / epochs)
    cosv = ops.cos(frac)
    return nn.scale(
        nn.scale(cosv, scale=0.5, bias=0.5), scale=float(learning_rate)
    )


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """Branchless: lr = warmup ? start + (end-start)*s/W : learning_rate."""
    global_step = _decay_step_counter()
    in_warm = tensor.cast(
        nn.logical_not(_ge(global_step, warmup_steps)), "float32"
    )
    ramp = nn.scale(
        global_step,
        scale=(float(end_lr) - float(start_lr)) / float(warmup_steps),
        bias=float(start_lr),
    )
    if isinstance(learning_rate, (float, int)):
        learning_rate = tensor.fill_constant(
            [1], "float32", float(learning_rate)
        )
    return nn.elementwise_add(
        nn.elementwise_mul(ramp, in_warm),
        nn.elementwise_mul(
            learning_rate, nn.scale(in_warm, scale=-1.0, bias=1.0)
        ),
    )
