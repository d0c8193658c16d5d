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
    in_dygraph_mode,
    cpu_places,
    cuda_places,
    cuda_pinned_places,
    is_compiled_with_cuda,
    require_version,
    load_op_library,
)
from .core import CPUPlace, CUDAPlace, CUDAPinnedPlace  # noqa: F401
from . import executor
from .executor import Executor, Scope, global_scope, scope_guard  # noqa: F401
from . import initializer
from . import layers
from . import nets
from . import metrics
from . import evaluator
from . import input
from .input import one_hot, embedding  # noqa: F401
from .data import data  # noqa: F401
from . import unique_name
from . import param_attr
from .param_attr import ParamAttr, WeightNormParamAttr  # noqa: F401
from . import layer_helper
from .layer_helper import LayerHelper  # noqa: F401
from . import io
from . import inference
from .inference import Predictor  # noqa: F401
from . import backward
from .backward import append_backward, gradients  # noqa: F401
from . import clip
from . import dygraph_grad_clip
from .dygraph_grad_clip import (  # noqa: F401
    GradClipByValue,
    GradClipByNorm,
    GradClipByGlobalNorm,
)
from . import regularizer
from . import optimizer
from . import contrib
from . import lod
from .lod import (  # noqa: F401
    LoDTensor,
    create_lod_tensor,
    create_random_int_lodtensor,
)
from . import lod_tensor
from . import data_feeder
from .data_feeder import DataFeeder  # noqa: F401
from . import data_feed_desc
from .data_feed_desc import DataFeedDesc  # noqa: F401
from . import reader
from .reader import DataLoader  # noqa: F401
from . import dataset
from .dataset import DatasetFactory, InMemoryDataset, QueueDataset  # noqa: F401
from . import device_worker
from . import trainer_desc
from .trainer_desc import (  # noqa: F401
    DistMultiTrainer,
    MultiTrainer,
    PipelineTrainer,
    TrainerDesc,
)
from . import trainer_factory
from .trainer_factory import FetchHandler  # noqa: F401
from . import compiler
from .compiler import CompiledProgram, BuildStrategy, ExecutionStrategy  # noqa: F401
from . import parallel_executor
from .parallel_executor import ParallelExecutor  # noqa: F401
from . import inferencer
from . import incubate
from . import average
from . import profiler
from . import annotations
from . import wrapped_decorator
from . import default_scope_funcs
from . import log_helper
from . import op
from . import layer_helper_base
from .io import save, load  # noqa: F401
from .layers import learning_rate_scheduler as learning_rate_decay  # noqa: F401

import numpy as _np

Tensor = _np.ndarray  # what Executor.run returns by default, as in paddle_tpu


class LoDTensorArray(list):
    """ref core.LoDTensorArray: a plain list of tensors on the host (the
    in-graph array type is layers.create_array's build-time list)."""
