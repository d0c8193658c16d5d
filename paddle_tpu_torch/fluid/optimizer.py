"""Optimizers (ref: python/paddle/fluid/optimizer.py).

Port of the paddle_tpu/fluid/optimizer.py base class, SGD, Momentum and
Adam. minimize()
appends the symbolic ``backward`` op plus one update op per parameter, the
same ops and names as the JAX package; the Executor runs the forward
region under torch.autograd, differentiates it at the ``backward`` op and
runs the updates after it (fluid/lowering.py). The other optimizers,
ModelAverage, EMA, Recompute, Lookahead and Pipeline wait for later slices
(ROADMAP.md).
"""
from . import framework, unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops
from .framework import Variable, program_guard
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = ["Optimizer", "SGD", "SGDOptimizer", "Momentum",
           "MomentumOptimizer", "Adam", "AdamOptimizer"]


class Optimizer:
    """Base optimizer (ref optimizer.py:53)."""

    def __init__(self, learning_rate, regularization=None, name=None):
        if not isinstance(learning_rate, (float, int, Variable)):
            raise TypeError("learning_rate must be float or Variable")
        self._name = name
        self.regularization = regularization
        self._learning_rate = learning_rate
        self._learning_rate_map = {}
        self._accumulators = {}  # {acc_name: {param_name: acc_var}}
        self.helper = None

    # -- learning rate -----------------------------------------------------
    def _create_global_learning_rate(self):
        prog = framework.default_main_program()
        lr_var = self._learning_rate_map.get(prog)
        if lr_var is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._learning_rate_map[prog] = self._learning_rate
            return
        lr_name = unique_name.generate("learning_rate")
        helper = LayerHelper("learning_rate")
        lr_var = helper.create_or_get_global_variable(
            name=lr_name, dtype="float32", shape=[1], persistable=True
        )
        lr_var.stop_gradient = True
        helper.set_variable_initializer(
            lr_var, Constant(float(self._learning_rate))
        )
        self._learning_rate_map[prog] = lr_var

    def _global_learning_rate(self, program=None):
        program = program or framework.default_main_program()
        return self._learning_rate_map.get(program)

    def _create_param_lr(self, param_and_grad):
        param = param_and_grad[0]
        param_lr = getattr(param, "optimize_attr", {}).get("learning_rate", 1.0)
        base = self._global_learning_rate()
        if float(param_lr) == 1.0:
            return base
        from .layers import nn

        return nn.scale(base, scale=float(param_lr))

    @property
    def current_step_lr(self):
        return self._learning_rate

    # -- accumulators ------------------------------------------------------
    def _add_accumulator(
        self, name, param, dtype=None, fill_value=0.0, shape=None
    ):
        if name in self._accumulators and param.name in self._accumulators[name]:
            return self._accumulators[name][param.name]
        helper = LayerHelper(name)
        var = helper.create_global_variable(
            name=unique_name.generate("_".join([param.name, name])),
            persistable=True,
            dtype=dtype or param.dtype,
            shape=shape if shape is not None else param.shape,
            belong_to_optimizer=True,
        )
        var.stop_gradient = True
        helper.set_variable_initializer(var, Constant(float(fill_value)))
        self._accumulators.setdefault(name, {})[param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def _finish_update(self, block, parameters_and_grads):
        pass

    # -- pipeline ----------------------------------------------------------
    def backward(
        self,
        loss,
        startup_program=None,
        parameter_list=None,
        no_grad_set=None,
        callbacks=None,
    ):
        return append_backward(loss, parameter_list, no_grad_set)

    def _create_optimization_pass(self, parameters_and_grads):
        block = framework.default_main_program().global_block()
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_global_learning_rate()
        self._create_accumulators(
            block, [p for p, g in parameters_and_grads if g is not None]
        )
        optimize_ops = []
        for param_and_grad in parameters_and_grads:
            if param_and_grad[1] is None:
                continue
            if getattr(param_and_grad[0], "trainable", True):
                op = self._append_optimize_op(block, param_and_grad)
                optimize_ops.append(op)
        self._finish_update(block, parameters_and_grads)
        return optimize_ops

    def apply_gradients(self, params_grads, grad_clip=None):
        if grad_clip is not None:
            raise NotImplementedError(
                "grad_clip (the dygraph GradClip* classes) comes with a "
                "later slice of the port; set a fluid.clip attribute on the "
                "parameters instead")
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(
            params_grads, self.regularization
        )
        return self._create_optimization_pass(params_grads)

    def apply_optimize(self, loss, startup_program, params_grads,
                       grad_clip=None):
        prog = loss.block.program
        with program_guard(prog, startup_program):
            return self.apply_gradients(params_grads, grad_clip=grad_clip)

    def minimize(
        self,
        loss,
        startup_program=None,
        parameter_list=None,
        no_grad_set=None,
        grad_clip=None,
    ):
        if not isinstance(loss, Variable):
            raise NotImplementedError(
                "minimize() takes the loss Variable of a static Program; "
                "dygraph minimize comes with the port's dygraph slice")
        params_grads = self.backward(
            loss,
            startup_program=startup_program,
            parameter_list=parameter_list,
            no_grad_set=no_grad_set,
        )
        optimize_ops = self.apply_optimize(
            loss, startup_program, params_grads, grad_clip=grad_clip
        )
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    """ref optimizer.py:696"""

    def __init__(self, learning_rate, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        return block.append_op(
            type="sgd",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param]},
        )


class MomentumOptimizer(Optimizer):
    """ref optimizer.py:767"""

    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator(self._velocity_acc_str, param)
        return block.append_op(
            type="momentum",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "Velocity": [velocity],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class AdamOptimizer(Optimizer):
    """ref optimizer.py:1466"""

    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"
    _beta1_pow_acc_str = "beta1_pow_acc"
    _beta2_pow_acc_str = "beta2_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None,
                 lazy_mode=False):
        super().__init__(learning_rate, regularization, name)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._lazy_mode = lazy_mode

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)
            self._add_accumulator(
                self._beta1_pow_acc_str, p, fill_value=self._beta1, shape=[1]
            )
            self._add_accumulator(
                self._beta2_pow_acc_str, p, fill_value=self._beta2, shape=[1]
            )

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment1 = self._get_accumulator(self._moment1_acc_str, param)
        moment2 = self._get_accumulator(self._moment2_acc_str, param)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, param)
        beta2_pow = self._get_accumulator(self._beta2_pow_acc_str, param)
        return block.append_op(
            type=self.type,
            inputs={
                "Param": [param],
                "Grad": [grad],
                "LearningRate": [self._create_param_lr(param_and_grad)],
                "Moment1": [moment1],
                "Moment2": [moment2],
                "Beta1Pow": [beta1_pow],
                "Beta2Pow": [beta2_pow],
            },
            outputs={
                "ParamOut": [param],
                "Moment1Out": [moment1],
                "Moment2Out": [moment2],
                "Beta1PowOut": [beta1_pow],
                "Beta2PowOut": [beta2_pow],
            },
            attrs={
                "beta1": self._beta1,
                "beta2": self._beta2,
                "epsilon": self._epsilon,
                "lazy_mode": self._lazy_mode,
            },
        )


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
