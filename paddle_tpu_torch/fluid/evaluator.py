"""Deprecated Evaluator API (ref: python/paddle/fluid/evaluator.py — kept
there only as aliases steering users to fluid.metrics). Same here: thin
program-building wrappers over layers.metric_op / metrics for code written
against the old surface."""
import warnings

from . import layers
from .metrics import Accuracy as _AccuracyMetric

__all__ = ["Accuracy", "ChunkEvaluator", "EditDistance", "DetectionMAP"]


def _deprecation(name, new):
    warnings.warn(
        "fluid.evaluator.%s is deprecated — use %s" % (name, new),
        DeprecationWarning, stacklevel=3,
    )


class Accuracy:
    """Build-time accuracy evaluator (deprecated; fluid.metrics.Accuracy +
    layers.accuracy is the supported pair). The legacy protocol works:
    fetch `.metrics[0]` each batch (its value feeds `update`), or let
    `eval()` aggregate whatever was accumulated so far."""

    def __init__(self, input, label, k=1, **kwargs):
        _deprecation("Accuracy", "fluid.metrics.Accuracy")
        self.metrics = []
        acc = layers.accuracy(input=input, label=label, k=k)
        self.metrics.append(acc)
        self._state = _AccuracyMetric()

    def eval(self, executor=None, eval_program=None):
        try:
            return self._state.eval()
        except ValueError:
            raise RuntimeError(
                "evaluator.Accuracy.eval(): nothing accumulated. Fetch "
                "self.metrics[0] in your exe.run and call "
                "update(value=batch_acc, weight=batch_size) per batch — "
                "or migrate to fluid.metrics.Accuracy (this class is a "
                "deprecated shim)."
            )

    def update(self, value, weight):
        self._state.update(value, weight)

    def reset(self, executor=None, reset_program=None):
        self._state = _AccuracyMetric()


class ChunkEvaluator:
    def __init__(self, *args, **kwargs):
        _deprecation("ChunkEvaluator", "fluid.metrics.ChunkEvaluator")
        from .metrics import ChunkEvaluator as M

        self._m = M()

    def __getattr__(self, item):
        return getattr(self._m, item)


class EditDistance:
    def __init__(self, *args, **kwargs):
        _deprecation("EditDistance", "fluid.metrics.EditDistance")
        from .metrics import EditDistance as M

        self._m = M()

    def __getattr__(self, item):
        return getattr(self._m, item)


class DetectionMAP:
    def __init__(self, *args, **kwargs):
        _deprecation("DetectionMAP", "fluid.metrics.DetectionMAP")
        from .metrics import DetectionMAP as M

        self._m = M(*args, **kwargs) if args or kwargs else M()

    def __getattr__(self, item):
        return getattr(self._m, item)
