"""fluid.contrib.slim — model compression (ref: contrib/slim).

Port of paddle_tpu/fluid/contrib/slim: ``core.strategy`` and
``quantization`` (QAT fake-quant with straight-through gradients, the
freeze into a real int8 program, PostTrainingQuantization). The
Compressor, its config, GraphWrapper, prune, distillation, searcher and
nas come with the rest of item 6.8 (ROADMAP.md Queue 1); asking for one
of them raises, naming that item.
"""
_UNPORTED = ("Compressor", "ConfigFactory", "Context", "GraphWrapper",
             "graph", "prune", "distillation", "searcher", "nas")


def _unported(module, names):
    """A module ``__getattr__`` that raises for `names`, naming item 6.8."""
    def __getattr__(name):
        if name in names:
            raise NotImplementedError(
                "%s.%s is not ported yet: it comes with the rest of "
                "fluid.contrib.slim (ROADMAP.md Queue 1, item 6.8)"
                % (module, name))
        raise AttributeError("module %r has no attribute %r"
                             % (module, name))
    return __getattr__


from . import core  # noqa: E402,F401
from .core import Strategy  # noqa: E402,F401
from . import quantization  # noqa: E402,F401

__getattr__ = _unported(__name__, _UNPORTED)
