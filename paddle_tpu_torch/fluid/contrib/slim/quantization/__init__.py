"""slim.quantization — the QAT transform lives in contrib.quant; freeze,
convert and PTQ live here (ref contrib/slim/quantization)."""
from ...quant import (  # noqa: F401
    QuantizationTransformPass,
    fake_quant_dequant_abs_max,
    quantize_program,
)
from . import quantization_pass  # noqa: F401
from .quantization_pass import (  # noqa: F401
    AddQuantDequantPass,
    ConvertToInt8Pass,
    OutScaleForInferencePass,
    OutScaleForTrainingPass,
    QuantizationFreezePass,
    TransformForMobilePass,
)
from . import post_training_quantization  # noqa: F401
from .post_training_quantization import PostTrainingQuantization  # noqa: F401
from . import quantization_strategy  # noqa: F401
from .quantization_strategy import QuantizationStrategy  # noqa: F401
