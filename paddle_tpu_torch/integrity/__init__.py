"""End-to-end data integrity (port of paddle_tpu/integrity, its
stdlib-only modules).

Every host<->disk and host<->host byte path of the serving fleet carries
a content digest, so torn writes, bit rot and silent corruption are
*detected and attributed* instead of deserialized into a replica:

- :mod:`~paddle_tpu_torch.integrity.digest` — sha256 content digests
  for byte payloads and tensors, plus :class:`IntegrityError` (an
  ``IOError`` subclass so fall-back paths treat a digest failure like
  any other unreadable artifact).
- :mod:`~paddle_tpu_torch.integrity.envelope` — the versioned wire
  format: sealed byte blobs, JSON manifests with per-tensor digests, and
  ``_integrity``-stamped JSON docs for FileStore mailboxes.
- :mod:`~paddle_tpu_torch.integrity.jsonl` — the one tolerant JSONL/JSON
  reader (torn/blank final-line skip + ``dropped`` count).

The formats and digests are the JAX package's byte for byte, so a KV
handoff or a mailbox doc sealed by one package verifies in the other.
The SDC sentinel (``sentinel``) waits for ROADMAP.md Queue 1 item 11.

Corruption is drillable end to end via the ``corrupt=`` fault-spec arms
(``PADDLE_TPU_FAULT_SPEC="wire:at=1:corrupt=bitflip"``, see
:mod:`paddle_tpu_torch.fluid.resilience`).

The package import is lazy — ``jsonl`` is pure stdlib.
"""

_SUBMODULES = ("digest", "envelope", "jsonl")
_NAMES = {
    "IntegrityError": "digest",
    "bytes_digest": "digest",
    "tensor_digest": "digest",
    "digest_state": "digest",
    "state_mismatches": "digest",
    "doc_digest": "digest",
}


def __getattr__(name):
    import importlib
    if name in _SUBMODULES:
        return importlib.import_module("." + name, __name__)
    mod = _NAMES.get(name)
    if mod is not None:
        return getattr(importlib.import_module("." + mod, __name__), name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


def __dir__():
    return sorted(list(_SUBMODULES) + list(_NAMES) + list(globals()))
