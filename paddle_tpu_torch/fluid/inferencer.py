"""ref import path python/paddle/fluid/inferencer.py (the reference file
is a tombstone pointing at contrib); the working Inferencer lives in
fluid.contrib.inferencer. Port of paddle_tpu/fluid/inferencer.py."""
__all__ = []
