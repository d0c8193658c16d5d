"""Search-space protocol for LightNAS
(ref contrib/slim/nas/search_space.py:33 SearchSpace).

Port of paddle_tpu/fluid/contrib/slim/nas/search_space.py. Contract
additions (documented, enforced by the strategy):
``create_net`` returns the reference 7-tuple
``(startup_p, train_p, test_p, train_metrics, test_metrics,
train_reader, test_reader)`` where the *_metrics entries are
``[(display_name, var_name), ...]`` fetch lists, and the programs'
feed vars are ``fluid.data`` with names equal to the Compressor's
feed display names — token changes rebuild the net, but the feed
surface stays stable so the training loop can re-feed it."""

__all__ = ["SearchSpace"]


class SearchSpace:
    def init_tokens(self):
        """The starting token list."""
        raise NotImplementedError("Abstract method.")

    def range_table(self):
        """Per-position cardinality of the token space."""
        raise NotImplementedError("Abstract method.")

    def create_net(self, tokens=None):
        """Build the candidate architecture for ``tokens``. Returns
        (startup_p, train_p, test_p, train_metrics, test_metrics,
        train_reader, test_reader)."""
        raise NotImplementedError("Abstract method.")

    def get_model_latency(self, program):
        """Measured/estimated latency of ``program`` (only consulted
        when the strategy has target_latency > 0)."""
        raise NotImplementedError("Abstract method.")
