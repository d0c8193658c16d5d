"""Weight-decay regularizers (ref: python/paddle/fluid/regularizer.py).

Port of paddle_tpu/fluid/regularizer.py. With no regularizer, the
(param, grad) pairs pass through untouched. L2Decay's ops (scale,
elementwise_add) are lowered; L1Decay's ``sign`` has no torch lowering yet
and raises when the program runs.
"""

__all__ = ["L1Decay", "L2Decay", "L1DecayRegularizer", "L2DecayRegularizer"]


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(
            dtype=param.dtype, shape=param.shape, lod_level=param.lod_level
        )
        block.append_op(
            type="scale",
            inputs={"X": [param]},
            outputs={"Out": [decay]},
            attrs={"scale": self._regularization_coeff},
        )
        return decay

    def __str__(self):
        return "L2Decay, regularization_coeff=%f" % self._regularization_coeff


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def __call__(self, param, grad, block):
        sign = block.create_var(dtype=param.dtype, shape=param.shape)
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(
            type="sign", inputs={"X": [param]}, outputs={"Out": [sign]}
        )
        block.append_op(
            type="scale",
            inputs={"X": [sign]},
            outputs={"Out": [decay]},
            attrs={"scale": self._regularization_coeff},
        )
        return decay

    def __str__(self):
        return "L1Decay, regularization_coeff=%f" % self._regularization_coeff


def append_regularization_ops(parameters_and_grads, regularization=None):
    """grad += regularizer(param) for each param (ref regularizer.py)."""
    params_and_grads = []
    for param, grad in parameters_and_grads:
        if grad is None:
            params_and_grads.append((param, grad))
            continue
        regularization_term = None
        reg = getattr(param, "regularizer", None) or regularization
        if reg is not None:
            block = grad.block
            regularization_term = reg(param, grad, block)
        if regularization_term is None:
            params_and_grads.append((param, grad))
            continue
        block = grad.block
        new_grad = block.create_var(
            name=grad.name + "@REGULARIZED",
            dtype=param.dtype,
            shape=param.shape,
        )
        block.append_op(
            type="elementwise_add",
            inputs={"X": [grad], "Y": [regularization_term]},
            outputs={"Out": [new_grad]},
            attrs={"axis": -1},
        )
        params_and_grads.append((param, new_grad))
    return params_and_grads


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
