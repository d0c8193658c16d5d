"""Device placement helper (ref: python/paddle/fluid/layers/device.py).

``get_places`` is deprecated in the reference in favour of
ParallelExecutor; it is kept for old scripts and introspection. A copy of
paddle_tpu/fluid/layers/device.py with the cards as CUDA places.
"""
import torch

from ..framework import cpu_places, cuda_places

__all__ = []


def get_places(device_count=None, device_type=None):
    """Up to ``device_count`` Places of ``device_type`` ('CPU' or
    'CUDA'/'GPU'; the cards when any is visible, else the CPU); deprecated
    (ref layers/device.py:30)."""
    if device_type is None:
        device_type = "CUDA" if torch.cuda.is_available() else "CPU"
    dt = str(device_type).upper()
    if dt in ("CUDA", "GPU"):
        places = cuda_places()
    elif dt == "CPU":
        places = cpu_places()
    else:
        raise ValueError(
            "get_places supports device_type 'CPU' or 'CUDA' on this "
            "build, got %r" % device_type)
    # ref semantics: device_count 0/None means every available device
    if device_count:
        places = places[: int(device_count)]
    return places
