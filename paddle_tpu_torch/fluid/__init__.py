"""paddle_tpu_torch.fluid — the Fluid API of paddle_tpu, on PyTorch
(ref: python/paddle/fluid/__init__.py)."""
from . import core
from . import framework
from .framework import (  # noqa: F401
    Program,
    Variable,
    Operator,
    Parameter,
    default_main_program,
    default_startup_program,
    program_guard,
    name_scope,
    cpu_places,
    cuda_places,
)
from .core import CPUPlace, CUDAPlace  # noqa: F401
from . import executor
from .executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
from . import initializer
from . import layers
from . import nets
from .data import data  # noqa: F401
from . import unique_name
from . import param_attr
from .param_attr import ParamAttr  # noqa: F401
from . import layer_helper
from .layer_helper import LayerHelper  # noqa: F401
from . import io
from . import inference
from .inference import Predictor  # noqa: F401
from . import backward
from .backward import append_backward, gradients  # noqa: F401
from . import clip
from . import regularizer
from . import optimizer
from . import contrib
