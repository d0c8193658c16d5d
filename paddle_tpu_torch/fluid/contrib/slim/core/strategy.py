"""Strategy lifecycle base (ref: contrib/slim/core/strategy.py)."""

__all__ = ["Strategy"]


class Strategy:
    """Epoch-windowed compression strategy: Compressor.run() invokes the
    hooks; a strategy acts only inside [start_epoch, end_epoch]."""

    def __init__(self, start_epoch=0, end_epoch=0):
        self.start_epoch = start_epoch
        self.end_epoch = end_epoch

    def on_compression_begin(self, context):
        pass

    def on_epoch_begin(self, context):
        pass

    def on_epoch_end(self, context):
        pass

    def on_batch_begin(self, context):
        pass

    def on_batch_end(self, context):
        pass

    def on_compression_end(self, context):
        pass

    def restore_from_checkpoint(self, context):
        pass
