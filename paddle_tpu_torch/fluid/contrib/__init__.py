"""fluid.contrib (ref: python/paddle/fluid/contrib). Port of
paddle_tpu/fluid/contrib: the same modules, imports, re-exports and
``__all__``."""
from . import layers  # noqa: F401
from .layers import (  # noqa: F401  (ref contrib/__init__ re-exports)
    fused_elemwise_activation, var_conv_2d, match_matrix_tensor,
    sequence_topk_avg_pooling, tree_conv, fused_embedding_seq_pool,
    multiclass_nms2, search_pyramid_hash, ctr_metric_bundle,
)
from . import decoder  # noqa: F401
from . import reader  # noqa: F401
from .reader import distributed_batch_reader  # noqa: F401
from . import mixed_precision
from .mixed_precision import decorate as mixed_precision_decorate  # noqa: F401
from . import quant  # noqa: F401
from . import quantize  # noqa: F401
from . import slim  # noqa: F401
from . import trainer  # noqa: F401
from .trainer import (  # noqa: F401
    BeginEpochEvent, EndEpochEvent, BeginStepEvent, EndStepEvent,
    CheckpointConfig, Trainer,
)
from . import inferencer  # noqa: F401
from .inferencer import Inferencer  # noqa: F401
from . import utils_stat
from .utils_stat import memory_usage, op_freq_statistic, summary  # noqa: F401
from . import memory_usage_calc  # noqa: F401
from . import op_frequence  # noqa: F401
from . import model_stat  # noqa: F401
from . import utils  # noqa: F401
from . import extend_optimizer
from .extend_optimizer import extend_with_decoupled_weight_decay  # noqa: F401

__all__ = [
    "layers", "mixed_precision", "quant", "slim", "Trainer", "Inferencer", "BeginEpochEvent", "EndEpochEvent", "BeginStepEvent", "EndStepEvent", "CheckpointConfig", "memory_usage", "op_freq_statistic",
    "summary", "extend_with_decoupled_weight_decay",
]
