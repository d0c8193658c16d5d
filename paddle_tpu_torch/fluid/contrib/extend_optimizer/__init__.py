"""Decoupled weight decay (ref: fluid/contrib/extend_optimizer/
extend_optimizer_with_weight_decay.py, AdamW arXiv:1711.05101):
new_param = optimized_param - pre_update_param * coeff.

Port of paddle_tpu/fluid/contrib/extend_optimizer/__init__.py. The
snapshot ``assign`` of each parameter comes before the backward op and
reads the parameter only: it is no gradient path. The decay's
``elementwise_sub`` writes the parameter after the update ops."""
from ... import unique_name
from ...framework import Variable

__all__ = ["extend_with_decoupled_weight_decay"]


def extend_with_decoupled_weight_decay(base_optimizer):
    """Class decorator: returns base_optimizer subclassed with decoupled
    weight decay. Usage (ref contrib example)::

        AdamW = fluid.contrib.extend_with_decoupled_weight_decay(
            fluid.optimizer.Adam)
        AdamW(learning_rate=1e-3, coeff=0.01).minimize(loss)
    """

    class OptimizerWithDecoupledWeightDecay(base_optimizer):
        def __init__(self, *args, coeff=0.0,
                     apply_decay_param_fun=None, **kwargs):
            if not isinstance(coeff, (float, int, Variable)):
                raise TypeError("coeff should be float or Variable")
            super().__init__(*args, **kwargs)
            self._coeff = coeff
            self._apply_decay_param_fun = apply_decay_param_fun

        def minimize(self, loss, startup_program=None,
                     parameter_list=None, no_grad_set=None):
            block = loss.block
            program = block.program
            params = [
                p for p in program.all_parameters()
                if p.trainable
                and (parameter_list is None or p.name in parameter_list)
                and (self._apply_decay_param_fun is None
                     or self._apply_decay_param_fun(p.name))
            ]
            # snapshot BEFORE the update ops (decay couples to the
            # pre-optimization value, per the paper)
            pre = {}
            if not (isinstance(self._coeff, float) and self._coeff == 0.0):
                for p in params:
                    snap = block.create_var(
                        name=unique_name.generate(p.name + "_pre_decay"),
                        dtype=p.dtype, shape=p.shape,
                    )
                    block.append_op(
                        type="assign", inputs={"X": [p]},
                        outputs={"Out": [snap]},
                    )
                    pre[p.name] = snap
            result = super().minimize(
                loss, startup_program=startup_program,
                parameter_list=parameter_list, no_grad_set=no_grad_set,
            )
            for p in params:
                if p.name not in pre:
                    continue
                scaled = block.create_var(
                    name=unique_name.generate(p.name + "_decay"),
                    dtype=p.dtype, shape=p.shape,
                )
                if isinstance(self._coeff, Variable):
                    # runtime coefficient (e.g. a decayed-lr-coupled
                    # schedule): multiply by the variable
                    block.append_op(
                        type="elementwise_mul",
                        inputs={"X": [pre[p.name]], "Y": [self._coeff]},
                        outputs={"Out": [scaled]},
                        attrs={"axis": -1},
                    )
                else:
                    block.append_op(
                        type="scale", inputs={"X": [pre[p.name]]},
                        outputs={"Out": [scaled]},
                        attrs={"scale": float(self._coeff), "bias": 0.0,
                               "bias_after_scale": True},
                    )
                block.append_op(
                    type="elementwise_sub",
                    inputs={"X": [p], "Y": [scaled]},
                    outputs={"Out": [p]},
                    attrs={"axis": -1},
                )
            return result

    OptimizerWithDecoupledWeightDecay.__name__ = (
        base_optimizer.__name__ + "WithDecoupledWeightDecay"
    )
    return OptimizerWithDecoupledWeightDecay
