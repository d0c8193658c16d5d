"""Compatibility shim (port of paddle_tpu/parallel/quantized_collectives.py)
— the quantized collectives live in the :mod:`.comms` subsystem.

``pmean_int8`` (the tensor-wide-scale single-shot mean LocalSGD's delta
sync uses) lives in :mod:`.comms.allreduce`; import it from either
place.
"""
from .comms.allreduce import pmean_int8  # noqa: F401

__all__ = ["pmean_int8"]
