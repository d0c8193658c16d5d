"""ref import path contrib/slim/prune/auto_prune_strategy.py —
AutoPruneStrategy searches per-layer ratios with the SAController over
the sensitive-prune machinery.
Port of paddle_tpu/fluid/contrib/slim/prune/auto_prune_strategy.py."""
from ..searcher import SAController  # noqa: F401
from .prune_strategy import PruneStrategy

__all__ = ["AutoPruneStrategy"]


class AutoPruneStrategy(PruneStrategy):
    """Controller-driven ratio search (ref auto_prune_strategy.py:30).
    The search loop belongs to the Compressor run (slim.core) — this
    class carries the config; on_epoch_begin asks the controller for
    the next ratio vector exactly like the reference."""

    def __init__(self, pruner=None, controller=None, start_epoch=0,
                 end_epoch=10, min_ratio=0.5, max_ratio=0.7,
                 metric_name="top1_acc", pruned_params="conv.*_weights",
                 retrain_epoch=0, uniform_range=None, init_tokens=None):
        super().__init__(pruner=pruner, start_epoch=start_epoch,
                         end_epoch=end_epoch,
                         pruned_params=pruned_params)
        self._controller = controller
        self._min_ratio = min_ratio
        self._max_ratio = max_ratio
        self._metric_name = metric_name
        self._retrain_epoch = retrain_epoch
        self._uniform_range = uniform_range
        self._current_tokens = list(init_tokens or [])

    def next_tokens(self, reward=0.0):
        if self._controller is None:
            raise ValueError(
                "AutoPruneStrategy needs a controller (e.g. "
                "slim.searcher.SAController) to drive the ratio search")
        if self._current_tokens:
            # feed the measured reward back (simulated-annealing accept)
            self._controller.update(self._current_tokens, reward)
        self._current_tokens = self._controller.next_tokens(
            self._current_tokens or None)
        return self._current_tokens
