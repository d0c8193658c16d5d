"""LayerHelper: shared machinery for layer functions
(ref: python/paddle/fluid/layer_helper.py, layer_helper_base.py).

Port of paddle_tpu/fluid/layer_helper.py, static-graph part: creates
parameters in both startup (initializer op) and main programs (a
``WeightNormParamAttr`` one as g and v, with the weight computed each step
as g·v/||v||), appends ops, and applies activation/bias epilogues.
Dygraph waits for its own slice.
"""
import copy

from . import core
from . import unique_name
from .framework import Variable, default_main_program, default_startup_program
from .param_attr import ParamAttr, WeightNormParamAttr

__all__ = ["LayerHelper"]


class LayerHelper:
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        name = self.kwargs.get("name")
        if name is None:
            self.kwargs["name"] = unique_name.generate(layer_type)
        self.layer_type = layer_type

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return default_main_program()

    @property
    def startup_program(self):
        return default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    # ------------------------------------------------------------------
    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable) or not isinstance(
            inputs, (list, tuple)
        ):
            return [inputs]
        return list(inputs)

    def input(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        if len(inputs) != 1:
            raise ValueError("%s layer only takes one input" % self.layer_type)
        return inputs[0]

    @property
    def param_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr._to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [attr]
        if len(attr) != 1 and len(attr) != length:
            raise ValueError("parameter number mismatch")
        if len(attr) == 1 and length != 1:
            attr = [copy.deepcopy(attr[0]) for _ in range(length)]
        return attr

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        attrs = self.multiple_param_attr(len(inputs))
        return zip(inputs, attrs)

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for each in inputs:
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError(
                    "data types of inputs mismatch: %s vs %s"
                    % (dtype, each.dtype)
                )
        return dtype

    # ------------------------------------------------------------------
    def create_parameter(
        self,
        attr,
        shape,
        dtype=None,
        is_bias=False,
        default_initializer=None,
        stop_gradient=False,
    ):
        if attr is False:
            return None
        attr = attr if isinstance(attr, ParamAttr) else ParamAttr._to_attr(attr)
        # work on a copy: one attr instance is commonly shared across a
        # layer's weights, and setting a generated name / default
        # initializer on the caller's object would alias every later
        # parameter to the first one
        attr = copy.deepcopy(attr)
        if default_initializer is None:
            if is_bias:
                attr._set_default_bias_initializer()
            else:
                attr._set_default_param_initializer()
        else:
            attr._set_default_initializer(default_initializer)
        if attr.name is None:
            attr.name = unique_name.generate(".".join([self.name, "w"]))
        dtype = core.convert_dtype(dtype or "float32")
        shape = [int(s) for s in shape]

        if isinstance(attr, WeightNormParamAttr):
            return self._create_weight_normed_parameter(attr, shape, dtype)

        startup_block = self.startup_program.global_block()
        if not startup_block.has_var(attr.name):
            sp = startup_block.create_parameter(
                name=attr.name,
                shape=shape,
                dtype=dtype,
                **{
                    k: v
                    for k, v in attr._to_kwargs().items()
                    if k not in ("name",)
                }
            )
            attr.initializer(sp, startup_block)
        main_block = self.main_program.global_block()
        if main_block.has_var(attr.name):
            return main_block.var(attr.name)
        return main_block.create_parameter(
            name=attr.name,
            shape=shape,
            dtype=dtype,
            **{k: v for k, v in attr._to_kwargs().items() if k != "name"}
        )

    def _create_weight_normed_parameter(self, attr, shape, dtype):
        """Weight normalisation (ref layer_helper_base.py:88): the layer's
        weight is not a free parameter — it is computed each step as
        w = g * v / ||v|| from direction v (the initialised tensor) and
        magnitude g (seeded to ||v|| so w == v at step 0). Gradients flow
        to g and v; the optimizer updates those."""
        dim = attr.dim
        if dim is not None and dim < 0:
            dim += len(shape)
        attr_dim = -1 if dim is None else int(dim)
        g_shape = [1] if dim is None else [int(shape[dim])]

        v_attr = ParamAttr(
            name=attr.name + ".w_v", initializer=attr.initializer,
            learning_rate=attr.learning_rate, regularizer=attr.regularizer,
            trainable=attr.trainable, gradient_clip=attr.gradient_clip,
            do_model_average=attr.do_model_average,
        )
        v = self.create_parameter(v_attr, shape, dtype)

        # g parameter: created raw, then seeded in startup from ||v|| so
        # the startup value of w equals the plain initialised weight
        g_name = attr.name + ".w_g"
        startup_block = self.startup_program.global_block()
        if not startup_block.has_var(g_name):
            g_sp = startup_block.create_parameter(
                name=g_name, shape=g_shape, dtype=dtype,
                **{k: val for k, val in attr._to_kwargs().items()
                   if k != "name"}
            )
            startup_block.append_op(
                type="norm_except_dim",
                inputs={"V": [startup_block.var(v_attr.name)]},
                outputs={"Out": [g_sp]},
                attrs={"dim": attr_dim},
            )
        main_block = self.main_program.global_block()
        if main_block.has_var(g_name):
            g = main_block.var(g_name)
        else:
            g = main_block.create_parameter(
                name=g_name, shape=g_shape, dtype=dtype,
                **{k: val for k, val in attr._to_kwargs().items()
                   if k != "name"}
            )

        w = self.create_variable_for_type_inference(dtype)
        w.shape = tuple(int(s) for s in shape)
        self.append_op(
            type="weight_norm_reparam",
            inputs={"V": [v], "G": [g]},
            outputs={"Out": [w]},
            attrs={"dim": attr_dim},
        )
        type(attr).params_with_weight_norm.append(w.name)
        return w

    def get_parameter(self, name):
        """An existing parameter by name (ref layer_helper_base
        get_parameter): crf_decoding reads linear_chain_crf's transition
        matrix."""
        block = self.main_program.global_block()
        if not block.has_var(name):
            raise ValueError("parameter %r not found" % name)
        return block.var(name)

    def create_variable_for_type_inference(self, dtype, stop_gradient=False):
        return self.main_program.current_block().create_var(
            name=unique_name.generate(".".join([self.name, "tmp"])),
            dtype=core.convert_dtype(dtype) if dtype else None,
            persistable=False,
            stop_gradient=stop_gradient,
        )

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs
        )

    def create_or_get_global_variable(self, name, *args, **kwargs):
        block = self.main_program.global_block()
        if block.has_var(name):
            return block.var(name)
        return self.create_global_variable(name=name, *args, **kwargs)

    def set_variable_initializer(self, var, initializer):
        startup_block = self.startup_program.global_block()
        if not startup_block.has_var(var.name):
            sv = startup_block.create_var(
                name=var.name,
                shape=var.shape,
                dtype=var.dtype,
                persistable=True,
            )
            initializer(sv, startup_block)
        return var

    # ------------------------------------------------------------------
    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        bias_attr = self.bias_attr
        if bias_attr is False:
            return input_var
        size = list(input_var.shape[dim_start:dim_end])
        b = self.create_parameter(
            attr=bias_attr, shape=size, dtype=input_var.dtype, is_bias=True
        )
        if b is None:
            return input_var
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        tmp.shape = input_var.shape
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        else:
            act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_variable_for_type_inference(dtype=input_var.dtype)
        tmp.shape = input_var.shape
        self.append_op(
            type=act_type,
            inputs={"X": [input_var]},
            outputs={"Out": [tmp]},
            attrs=act,
        )
        return tmp

    def is_instance(self, param_name, cls):
        param = self.kwargs.get(param_name)
        if not isinstance(param, cls):
            raise TypeError(
                "%s of %s must be %s" % (param_name, self.layer_type, cls)
            )
