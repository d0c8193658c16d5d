"""Host-side weighted averaging helper (ref: python/paddle/fluid/average.py).

Pure-Python accumulator — it never touches the Program or the device; kept
for API parity with scripts that average fetched batch losses/accuracies.
"""
import warnings

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number(x):
    return isinstance(x, (int, float)) or (
        isinstance(x, np.ndarray) and x.size == 1
    )


def _is_number_or_matrix(x):
    return _is_number(x) or isinstance(x, np.ndarray)


class WeightedAverage:
    """Accumulate (value, weight) pairs; ``eval`` returns
    sum(v*w)/sum(w) (ref average.py:40)."""

    def __init__(self):
        warnings.warn(
            "The %s is deprecated, please use fluid.metrics.Accuracy "
            "instead." % self.__class__.__name__, Warning,
        )
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix(value):
            raise ValueError(
                "The 'value' must be a number(int, float) or a numpy "
                "ndarray.")
        if not _is_number(weight):
            raise ValueError("The 'weight' must be a number(int, float).")
        if self.numerator is None or self.denominator is None:
            self.numerator = value * weight
            self.denominator = weight
        else:
            self.numerator += value * weight
            self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator is None:
            raise ValueError(
                "There is no data to be averaged in WeightedAverage.")
        return self.numerator / self.denominator
