"""Optimizers (ref: python/paddle/fluid/optimizer.py).

Port of paddle_tpu/fluid/optimizer.py: SGD, Momentum, DGCMomentum,
LarsMomentum, Adagrad, Adam, Adamax, Dpsgd, DecayedAdagrad, Adadelta,
RMSProp, Ftrl and Lamb, and the wrappers ModelAverage,
ExponentialMovingAverage, RecomputeOptimizer and LookaheadOptimizer.
minimize() appends the symbolic ``backward`` op plus the clip, regularizer
and update ops, the same ops and names as the JAX package; the Executor
runs the forward region under torch.autograd, differentiates it at the
``backward`` op and runs the updates after it (fluid/lowering.py).
RecomputeOptimizer puts its checkpoints on the backward op, and the
Executor replays each segment between two checkpoints in the backward
pass. PipelineOptimizer records its configuration on the program, which
the Executor runs through fluid/pipeline_executor.py; the dygraph
minimize waits for ROADMAP.md Queue 1 item 9.
"""
from . import framework, unique_name
from .backward import append_backward
from .clip import append_gradient_clip_ops
from .framework import Variable, program_guard
from .initializer import Constant
from .layer_helper import LayerHelper
from .regularizer import append_regularization_ops

__all__ = [
    "SGD", "Momentum", "Adagrad", "Adam", "Adamax", "Dpsgd", "DecayedAdagrad",
    "Ftrl", "SGDOptimizer", "MomentumOptimizer", "AdagradOptimizer",
    "AdamOptimizer", "AdamaxOptimizer", "DpsgdOptimizer",
    "DecayedAdagradOptimizer", "RMSPropOptimizer", "FtrlOptimizer", "Adadelta",
    "AdadeltaOptimizer", "ModelAverage", "LarsMomentum",
    "LarsMomentumOptimizer", "LambOptimizer", "ExponentialMovingAverage",
    "PipelineOptimizer", "RecomputeOptimizer", "LookaheadOptimizer",
    "DGCMomentumOptimizer", "DGCMomentum",
]


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
        self._opti_name_list = []

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
        # Contract: grad_clip is honored on the STATIC path — clip ops
        # are emitted over the grad vars under the current program
        # guard, BEFORE per-param clip attrs and regularization, so a
        # global-norm clip sees the raw gradients. minimize() routes
        # through here, and direct apply_gradients callers get
        # identical clipping (tests/test_round3_fixes.py pins the
        # clipped-vs-unclipped delta norm to max_norm).
        params_grads = sorted(params_grads, key=lambda x: x[0].name)
        params_grads, table_param_and_grad, table_optimize_op = (
            params_grads,
            None,
            None,
        )
        if grad_clip is not None:
            from .dygraph_grad_clip import GradClipBase

            if not isinstance(grad_clip, GradClipBase):
                raise TypeError(
                    "grad_clip must be a dygraph_grad_clip.GradClipBase "
                    "instance, got %r" % (grad_clip,)
                )
            params_grads = grad_clip(params_grads)
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(
            params_grads, self.regularization
        )
        optimize_ops = self._create_optimization_pass(params_grads)
        return optimize_ops

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
                "the dygraph minimize comes with the port's dygraph slice "
                "(ROADMAP.md Queue 1, item 9)")
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

    def load(self, state_dict):
        """A no-op, as in the JAX package: the executor's scope holds the
        accumulators' values, and ``fluid.io.load`` restores them."""


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


class DGCMomentumOptimizer(Optimizer):
    """Deep Gradient Compression momentum (ref optimizer.py:876,
    arXiv:1712.01887). The reference sparsifies gradients to cut
    communication; the optimizer's semantics (momentum correction, local
    accumulation of what is not applied, the rampup sparsity schedule)
    change training, so they are kept: the top-(1-s) magnitudes update the
    parameter now, the rest accumulate locally until large."""

    def __init__(self, learning_rate, momentum, rampup_begin_step,
                 rampup_step=1, sparsity=(0.999,), use_nesterov=False,
                 local_grad_clip_norm=None, num_trainers=None,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "dgc_momentum"
        self._momentum = momentum
        self._rampup_begin_step = int(rampup_begin_step)
        self._rampup_step = max(int(rampup_step), 1)
        self._sparsity = [float(s) for s in sparsity]
        self._local_grad_clip_norm = local_grad_clip_norm
        self._use_nesterov = bool(use_nesterov)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("dgc_u", p)
            self._add_accumulator("dgc_v", p)
            self._add_accumulator("dgc_step", p, shape=[1])

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        u = self._get_accumulator("dgc_u", param)
        v = self._get_accumulator("dgc_v", param)
        step = self._get_accumulator("dgc_step", param)
        return block.append_op(
            type="dgc_momentum",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "U": [u],
                "V": [v],
                "CurrentStep": [step],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [param],
                "UOut": [u],
                "VOut": [v],
                "StepOut": [step],
            },
            attrs={
                "mu": self._momentum,
                "rampup_begin_step": self._rampup_begin_step,
                "rampup_step": self._rampup_step,
                "sparsity": self._sparsity,
                "local_grad_clip_norm": (
                    float(self._local_grad_clip_norm)
                    if self._local_grad_clip_norm else -1.0
                ),
            },
        )


DGCMomentum = DGCMomentumOptimizer


class LarsMomentumOptimizer(Optimizer):
    """ref optimizer.py:1256"""

    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "lars_momentum"
        self._momentum = momentum
        self._lars_coeff = float(lars_coeff)
        self._lars_weight_decay = float(lars_weight_decay)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        velocity = self._get_accumulator(self._velocity_acc_str, param)
        return block.append_op(
            type="lars_momentum",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "Velocity": [velocity],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param], "VelocityOut": [velocity]},
            attrs={
                "mu": self._momentum,
                "lars_coeff": self._lars_coeff,
                "lars_weight_decay": self._lars_weight_decay,
            },
        )


class AdagradOptimizer(Optimizer):
    """ref optimizer.py:1356"""

    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1e-6, regularization=None,
                 name=None, initial_accumulator_value=0.0):
        super().__init__(learning_rate, regularization, name)
        self.type = "adagrad"
        self._epsilon = epsilon
        self.initial_accumulator_value = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(
                self._moment_acc_str, p,
                fill_value=self.initial_accumulator_value,
            )

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, param)
        return block.append_op(
            type="adagrad",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "Moment": [moment],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"epsilon": self._epsilon},
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


class AdamaxOptimizer(Optimizer):
    """ref optimizer.py:1741"""

    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"
    _beta1_pow_acc_str = "beta1_pow_acc"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "adamax"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)
            self._add_accumulator(
                self._beta1_pow_acc_str, p, fill_value=self._beta1, shape=[1]
            )

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, param)
        inf_norm = self._get_accumulator(self._inf_norm_acc_str, param)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, param)
        return block.append_op(
            type="adamax",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "LearningRate": [self._create_param_lr(param_and_grad)],
                "Moment": [moment],
                "InfNorm": [inf_norm],
                "Beta1Pow": [beta1_pow],
            },
            outputs={
                "ParamOut": [param],
                "MomentOut": [moment],
                "InfNormOut": [inf_norm],
            },
            attrs={
                "beta1": self._beta1,
                "beta2": self._beta2,
                "epsilon": self._epsilon,
            },
        )

    def _finish_update(self, block, parameters_and_grads):
        for param, grad in parameters_and_grads:
            if grad is None or not getattr(param, "trainable", True):
                continue
            beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, param)
            block.append_op(
                type="scale",
                inputs={"X": [beta1_pow]},
                outputs={"Out": [beta1_pow]},
                attrs={"scale": self._beta1},
            )


class DpsgdOptimizer(Optimizer):
    """ref optimizer.py:1900 — differentially-private SGD."""

    def __init__(self, learning_rate=0.001, clip=0.9, batch_size=0.999,
                 sigma=1e-8, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "dpsgd"
        self._clip = clip
        self._batch_size = batch_size
        self._sigma = sigma

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        return block.append_op(
            type="dpsgd",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param]},
            attrs={
                "clip": self._clip,
                "batch_size": self._batch_size,
                "sigma": self._sigma,
            },
        )


class DecayedAdagradOptimizer(Optimizer):
    """ref optimizer.py:1979"""

    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "decayed_adagrad"
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment = self._get_accumulator(self._moment_acc_str, param)
        return block.append_op(
            type="decayed_adagrad",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "Moment": [moment],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param], "MomentOut": [moment]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class AdadeltaOptimizer(Optimizer):
    """ref optimizer.py:2074"""

    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "adadelta"
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        g2 = self._get_accumulator(self._avg_squared_grad_acc_str, param)
        u2 = self._get_accumulator(self._avg_squared_update_acc_str, param)
        return block.append_op(
            type="adadelta",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "AvgSquaredGrad": [g2],
                "AvgSquaredUpdate": [u2],
            },
            outputs={
                "ParamOut": [param],
                "AvgSquaredGradOut": [g2],
                "AvgSquaredUpdateOut": [u2],
            },
            attrs={"epsilon": self._epsilon, "rho": self._rho},
        )


class RMSPropOptimizer(Optimizer):
    """ref optimizer.py:2180"""

    _momentum_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"
    _mean_grad_acc_str = "mean_grad"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "rmsprop"
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum
        self._centered = centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._momentum_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)
            self._add_accumulator(self._mean_grad_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        momentum_acc = self._get_accumulator(self._momentum_acc_str, param)
        mean_square_acc = self._get_accumulator(self._mean_square_acc_str, param)
        mean_grad_acc = self._get_accumulator(self._mean_grad_acc_str, param)
        return block.append_op(
            type="rmsprop",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "Moment": [momentum_acc],
                "MeanSquare": [mean_square_acc],
                "MeanGrad": [mean_grad_acc],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [param],
                "MomentOut": [momentum_acc],
                "MeanSquareOut": [mean_square_acc],
                "MeanGradOut": [mean_grad_acc],
            },
            attrs={
                "epsilon": self._epsilon,
                "decay": self._rho,
                "momentum": self._momentum,
                "centered": self._centered,
            },
        )


class FtrlOptimizer(Optimizer):
    """ref optimizer.py:2354"""

    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, name=None):
        super().__init__(learning_rate, regularization, name)
        self.type = "ftrl"
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        squared_acc = self._get_accumulator(self._squared_acc_str, param)
        linear_acc = self._get_accumulator(self._linear_acc_str, param)
        return block.append_op(
            type="ftrl",
            inputs={
                "Param": [param],
                "Grad": [grad],
                "SquaredAccumulator": [squared_acc],
                "LinearAccumulator": [linear_acc],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [param],
                "SquaredAccumOut": [squared_acc],
                "LinearAccumOut": [linear_acc],
            },
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
        )


class LambOptimizer(AdamOptimizer):
    """ref optimizer.py:2499 — layer-wise adaptive large-batch optimizer."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, regularization=None,
                 exclude_from_weight_decay_fn=None, name=None):
        super().__init__(
            learning_rate=learning_rate, beta1=beta1, beta2=beta2,
            epsilon=epsilon, regularization=regularization, name=name,
        )
        self.type = "lamb"
        self._weight_decay = lamb_weight_decay
        self._exclude_from_weight_decay_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, block, param_and_grad):
        param, grad = param_and_grad
        moment1 = self._get_accumulator(self._moment1_acc_str, param)
        moment2 = self._get_accumulator(self._moment2_acc_str, param)
        beta1_pow = self._get_accumulator(self._beta1_pow_acc_str, param)
        beta2_pow = self._get_accumulator(self._beta2_pow_acc_str, param)
        wd = self._weight_decay
        if self._exclude_from_weight_decay_fn is not None and \
                self._exclude_from_weight_decay_fn(param):
            wd = 0.0
        return block.append_op(
            type="lamb",
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
                "weight_decay": wd,
            },
        )


# ---------------------------------------------------------------------------
# meta optimizers
# ---------------------------------------------------------------------------
class ModelAverage(Optimizer):
    """Parameter averaging over a sliding window (ref optimizer.py:2657):
    the running sums are persistable state updated by ops in the step;
    apply() swaps their average into the scope."""

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization, name)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self.params_grads = []
        self._applied = False
        main = framework.default_main_program()
        for param in main.global_block().all_parameters():
            if getattr(param, "do_model_average", None) is not False:
                self.params_grads.append((param, None))
        block = main.global_block()
        self.helper = LayerHelper("model_average")
        self._shared = None  # per-program scalars built once below
        for param, _ in self.params_grads:
            self._append_average_accumulate_op(block, param)

    def _append_average_accumulate_op(self, block, param):
        # windowed accumulation (ref average_accumulates_op): sum_1
        # gathers the live window; when num_acc reaches the threshold
        # min(max_window, max(min_window, rate*num_updates)) the window
        # SHIFTS into sum_2 (kept, not dropped) and restarts — apply()
        # averages (sum_1 + sum_2) / (num_acc + old_num_acc), so a
        # restart never collapses the average to one snapshot. (The ref
        # keeps one further window in sum_3; two windows retained here.)
        sum_1 = self._add_accumulator("sum", param)
        sum_2 = self._add_accumulator("sum2", param)
        num_acc = self._add_accumulator(
            "cnt", param, dtype="float32", shape=[1])
        old_acc = self._add_accumulator(
            "old_cnt", param, dtype="float32", shape=[1])
        num_upd = self._add_accumulator(
            "nupd", param, dtype="float32", shape=[1])
        from .layers import control_flow as cf
        from .layers import nn as nn_l
        from .layers import tensor as t

        if self._shared is None:
            # shared scalar constants, built ONCE per program (every
            # param's accumulate ops reference the same three vars)
            self._shared = (
                t.fill_constant([1], "float32", 1.0),
                t.fill_constant([1], "float32",
                                float(self.max_average_window)),
                t.fill_constant([1], "float32",
                                float(self.min_average_window)),
            )
        one, max_w, min_w = self._shared
        summed = nn_l.elementwise_add(sum_1, param)
        bumped_acc = nn_l.elementwise_add(num_acc, one)
        bumped_upd = nn_l.elementwise_add(num_upd, one)
        # threshold = min(max_w, max(min_w, rate * num_updates))
        thresh = nn_l.elementwise_min(
            max_w,
            nn_l.elementwise_max(
                min_w,
                nn_l.scale(bumped_upd, scale=float(self.average_window))))
        shift = t.cast(cf.greater_equal(bumped_acc, thresh), "float32")
        keep = nn_l.elementwise_sub(one, shift)
        sp = t.cast(shift, param.dtype)
        kp = t.cast(keep, param.dtype)
        # on shift: sum_2 <- sum_1+param, sum_1 <- 0; else accumulate
        new_sum2 = nn_l.elementwise_add(
            nn_l.elementwise_mul(sp, summed),
            nn_l.elementwise_mul(kp, sum_2))
        new_sum1 = nn_l.elementwise_mul(kp, summed)
        new_old = nn_l.elementwise_add(
            nn_l.elementwise_mul(shift, bumped_acc),
            nn_l.elementwise_mul(keep, old_acc))
        new_acc = nn_l.elementwise_mul(keep, bumped_acc)
        for var, val in ((sum_2, new_sum2), (sum_1, new_sum1),
                         (old_acc, new_old), (num_acc, new_acc),
                         (num_upd, bumped_upd)):
            block.append_op(
                type="assign", inputs={"X": [val]}, outputs={"Out": [var]}
            )

    class _ApplyGuard:
        def __init__(self, outer, executor, scope, need_restore=True):
            self.outer = outer
            self.executor = executor
            self.scope = scope
            self.need_restore = need_restore
            self.backup = {}

        def __enter__(self):
            acc = self.outer._accumulators
            for param, _ in self.outer.params_grads:
                s1 = self.scope.get(acc["sum"][param.name].name)
                s2 = self.scope.get(acc["sum2"][param.name].name)
                c = self.scope.get(acc["cnt"][param.name].name)
                oc = self.scope.get(acc["old_cnt"][param.name].name)
                if s1 is None or c is None:
                    continue
                total = s1 if s2 is None else s1 + s2
                count = float(c.reshape(-1)[0])
                if oc is not None:
                    count += float(oc.reshape(-1)[0])
                self.backup[param.name] = self.scope[param.name]
                self.scope.set(param.name,
                               (total / max(count, 1.0)).to(total.dtype))
            return self

        def __exit__(self, *exc):
            # ref semantics: need_restore=False keeps the averaged weights
            # applied; ModelAverage.restore(exe) restores them later.
            if self.need_restore:
                self._do_restore()
            else:
                self.outer._pending_restore = dict(self.backup)

        def _do_restore(self):
            for name, val in self.backup.items():
                self.scope.set(name, val)

    def apply(self, executor, need_restore=True):
        from .executor import global_scope

        return ModelAverage._ApplyGuard(
            self, executor, global_scope(), need_restore
        )

    def restore(self, executor):
        """Restore the pre-average weights saved by an
        ``apply(need_restore=False)`` (ref optimizer.py ModelAverage)."""
        from .executor import global_scope

        pending = getattr(self, "_pending_restore", None)
        if not pending:
            return
        scope = global_scope()
        for name, val in pending.items():
            scope.set(name, val)
        self._pending_restore = {}


class ExponentialMovingAverage:
    """EMA of parameters (ref optimizer.py:2959)."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._name = name or ""
        self._ema_vars = {}
        self._params = []
        self._backup = {}

    def update(self):
        block = framework.default_main_program().global_block()
        helper = LayerHelper("ema")
        for param in block.all_parameters():
            if not getattr(param, "trainable", True):
                continue
            ema = helper.create_global_variable(
                name=unique_name.generate(param.name + ".ema"),
                shape=param.shape,
                dtype=param.dtype,
                persistable=True,
            )
            helper.set_variable_initializer(ema, Constant(0.0))
            self._ema_vars[param.name] = ema
            self._params.append(param)
            # ema = decay*ema + (1-decay)*param
            block.append_op(
                type="scale",
                inputs={"X": [ema]},
                outputs={"Out": [ema]},
                attrs={"scale": self._decay},
            )
            tmp = helper.create_variable_for_type_inference(param.dtype)
            tmp.shape = param.shape
            block.append_op(
                type="scale",
                inputs={"X": [param]},
                outputs={"Out": [tmp]},
                attrs={"scale": 1.0 - self._decay},
            )
            block.append_op(
                type="elementwise_add",
                inputs={"X": [ema], "Y": [tmp]},
                outputs={"Out": [ema]},
                attrs={"axis": -1},
            )

    class _ApplyGuard:
        def __init__(self, outer, executor, need_restore):
            self.outer = outer
            self.executor = executor
            self.need_restore = need_restore
            self.backup = {}

        def __enter__(self):
            from .executor import global_scope

            scope = global_scope()
            for pname, ema in self.outer._ema_vars.items():
                if ema.name in scope and pname in scope:
                    self.backup[pname] = scope[pname]
                    scope.set(pname, scope[ema.name])
            # bank on the instance so a standalone restore() call after
            # apply(need_restore=False) can put training weights back
            self._banked = dict(self.backup)
            self.outer._backup = self._banked
            return self

        def __exit__(self, *exc):
            if self.need_restore:
                # restore from the guard-local snapshot (nested guards /
                # a manual restore() inside the guard must not lose the
                # outer training weights)
                from .executor import global_scope

                scope = global_scope()
                for name, val in self.backup.items():
                    scope.set(name, val)
                if self.outer._backup is self._banked:
                    self.outer._backup = {}

    def apply(self, executor=None, need_restore=True):
        return ExponentialMovingAverage._ApplyGuard(
            self, executor, need_restore
        )

    def restore(self, executor=None):
        """Swap the training weights saved by the last apply() back into
        the scope (ref optimizer.py:2959 EMA.restore)."""
        from .executor import global_scope

        scope = global_scope()
        for name, val in self._backup.items():
            scope.set(name, val)
        self._backup = {}


class RecomputeOptimizer(Optimizer):
    """Activation rematerialisation (ref optimizer.py:3491): the
    checkpoint vars go on the backward op, and the Executor runs each
    segment between two of them under ``torch.utils.checkpoint``, so its
    activations are recomputed in the backward pass instead of kept
    (fluid/lowering.py)."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None):
        return append_backward(
            loss, parameter_list, no_grad_set, checkpoints=self._checkpoints
        )

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
                 no_grad_set=None, grad_clip=None):
        params_grads = self.backward(
            loss, startup_program, parameter_list, no_grad_set
        )
        optimize_ops = self.apply_optimize(
            loss, startup_program, params_grads, grad_clip=grad_clip
        )
        return optimize_ops, params_grads

    def __getattr__(self, item):
        return getattr(self._optimizer, item)


class LookaheadOptimizer:
    """ref optimizer.py:3784 — slow/fast weight lookahead."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        assert inner_optimizer is not None
        assert 0.0 <= alpha <= 1.0
        assert isinstance(k, int) and k > 0
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k

    def minimize(self, loss, startup_program=None):
        mini_out = self.inner_optimizer.minimize(
            loss, startup_program=startup_program
        )
        main_block = loss.block
        helper = LayerHelper("lookahead")
        params = [
            p for p in main_block.program.all_parameters()
            if getattr(p, "trainable", True)
        ]
        # step counter
        from .layers import nn as nn_layers
        from .layers import tensor as t

        step = nn_layers.autoincreased_step_counter(
            counter_name=unique_name.generate("lookahead_k"), begin=1
        )
        for param in params:
            slow = helper.create_global_variable(
                name=unique_name.generate(param.name + ".slow"),
                shape=param.shape,
                dtype=param.dtype,
                persistable=True,
            )
            helper.set_variable_initializer(slow, Constant(0.0))
            # every k steps: slow += alpha*(fast-slow); fast = slow
            # branchless: m = (step % k == 0)
            mod = nn_layers.elementwise_mod(
                step, t.fill_constant([1], "int64", self.k)
            )
            is_sync = t.cast(
                nn_layers.elementwise_equal(
                    mod, t.fill_constant([1], "int64", 0)
                ),
                "float32",
            )
            diff = nn_layers.elementwise_sub(param, slow)
            new_slow = nn_layers.elementwise_add(
                slow,
                nn_layers.elementwise_mul(
                    diff, nn_layers.scale(is_sync, self.alpha)
                ),
            )
            main_block.append_op(
                type="assign",
                inputs={"X": [new_slow]},
                outputs={"Out": [slow]},
            )
            # fast = (1-m)*fast + m*slow_new
            mixed = nn_layers.elementwise_add(
                nn_layers.elementwise_mul(
                    param,
                    nn_layers.scale(is_sync, -1.0, bias=1.0),
                ),
                nn_layers.elementwise_mul(new_slow, is_sync),
            )
            main_block.append_op(
                type="assign",
                inputs={"X": [mixed]},
                outputs={"Out": [param]},
            )
        return mini_out


class PipelineOptimizer:
    """Pipeline-parallel wrapper (ref optimizer.py:3193): minimizes with
    the wrapped optimizer and records the pipeline's configuration on the
    program, which ``Executor.run`` then runs through
    fluid/pipeline_executor.py (one stage a rank of the mesh's ``pp``
    axis, the GPipe microbatch schedule). ``mesh`` is a rank group with
    a ``pp`` axis (default: the first ``len(cut_list) + 1`` ranks of the
    world), beside which a ``dp`` axis may stand; ``feed_specs`` splits
    feeds over dp (``P("dp", ...)``); ``opt_state_rules`` splits
    optimizer state over dp (ZeRO-1). ``param_rules`` is accepted only
    to raise, as in the JAX package."""

    def __init__(self, optimizer, cut_list=None, place_list=None,
                 concurrency_list=None, queue_size=30, sync_steps=1,
                 start_cpu_core_id=0, num_microbatches=None,
                 mesh=None, feed_specs=None, param_rules=None,
                 opt_state_rules=None):
        self._optimizer = optimizer
        self._cut_list = cut_list
        self._place_list = place_list
        self._concurrency_list = concurrency_list
        self._queue_size = queue_size
        self._sync_steps = sync_steps
        self._num_microbatches = num_microbatches
        self._mesh = mesh
        self._feed_specs = feed_specs
        self._param_rules = param_rules
        self._opt_state_rules = opt_state_rules

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        out = self._optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set
        )
        prog = loss.block.program
        prog._parallel_info = {
            "mode": "pipeline",
            "cut_list": self._cut_list,
            "sync_steps": self._sync_steps,
            "n_microbatches": self._num_microbatches,
            "mesh": self._mesh,
            "feed_specs": self._feed_specs,
            "param_rules": self._param_rules,
            "opt_state_rules": self._opt_state_rules,
        }
        return out


SGD = SGDOptimizer
Momentum = MomentumOptimizer
LarsMomentum = LarsMomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
Dpsgd = DpsgdOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
