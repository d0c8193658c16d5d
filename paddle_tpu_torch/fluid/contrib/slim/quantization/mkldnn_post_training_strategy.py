"""ref import path contrib/slim/quantization/mkldnn_post_training_strategy.py — mkldnn is an x86
inference runtime; here int8 runs through quantized_mul and
quantized_conv2d (quantization_pass.py) on the card or the CPU. Using the
mkldnn entry points raises with that guidance."""

__all__ = []

_MSG = ("mkldnn int8 is an x86 runtime path; use "
        "QuantizationFreezePass/ConvertToInt8Pass or "
        "PostTrainingQuantization — their int8 ops run on the card")


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    raise NotImplementedError("%s.%s: %s" % (__name__, name, _MSG))
