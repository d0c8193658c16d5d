"""Content digests for byte payloads and tensors (port of
paddle_tpu/integrity/digest.py: the same algorithm and textual form).

One algorithm (sha256), one textual form (``"sha256:<hex>"``), used by
every integrity surface: checkpoint manifests, KV-handoff wire docs,
compile-cache envelopes, FileStore mailbox stamps, and the SDC
sentinel's fetch-digest comparisons. Streaming-friendly —
:func:`bytes_digest` accepts an iterable of chunks and
:func:`file_digest` never holds more than one chunk in memory.

numpy is imported lazily so stdlib-only consumers (observability) can
import the sibling :mod:`~paddle_tpu_torch.integrity.jsonl` without pulling
the numeric stack.
"""
import hashlib
import json

DIGEST_ALGO = "sha256"
_PREFIX = DIGEST_ALGO + ":"


class IntegrityError(IOError):
    """A payload failed content-digest verification.

    Subclasses ``IOError`` deliberately: every existing "skip the bad
    artifact and fall back" path (``restore_latest``, compile-cache
    corrupt-evict, stream migration) already handles ``IOError``, so a
    digest failure is remediated by the same machinery that handles a
    torn file — but with attribution (``path``/``tensor``/``want``/
    ``got`` name exactly what lied).
    """

    def __init__(self, message, path=None, tensor=None, want=None,
                 got=None):
        super().__init__(message)
        self.path = path
        self.tensor = tensor
        self.want = want
        self.got = got


def bytes_digest(data):
    """``"sha256:<hex>"`` of a bytes-like object or iterable of chunks."""
    h = hashlib.sha256()
    if isinstance(data, (bytes, bytearray, memoryview)):
        h.update(data)
    else:
        for chunk in data:
            h.update(chunk)
    return _PREFIX + h.hexdigest()


def file_digest(path, chunk_size=1 << 20):
    """Streaming digest of a file's contents."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                break
            h.update(chunk)
    return _PREFIX + h.hexdigest()


def doc_digest(doc):
    """Digest of a JSON-serializable doc under a canonical encoding
    (sorted keys, minimal separators) — stable across a json
    round-trip, so a stamp computed at ``put`` verifies at read."""
    enc = json.dumps(doc, sort_keys=True, separators=(",", ":"),
                     default=str)
    return bytes_digest(enc.encode("utf-8"))


def tensor_digest(arr):
    """Digest of one tensor: dtype + shape header, then C-order bytes.

    Any array-like (numpy, a torch tensor, python scalar) is accepted;
    device tensors transfer once. Two tensors share a digest iff they
    are bit-identical with the same dtype and shape.
    """
    import numpy as np
    if hasattr(arr, "detach"):  # a torch tensor, wherever it lives
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256()
    h.update(("%s;%s;" % (a.dtype.str,
                          "x".join(str(d) for d in a.shape))).encode())
    h.update(a.data)  # zero-copy: hash the buffer, don't duplicate it
    return _PREFIX + h.hexdigest()


def digest_state(state):
    """Per-tensor digests of a state dict: ``{name: "sha256:..."}``."""
    return {str(k): tensor_digest(v) for k, v in state.items()}


def state_mismatches(state, digests):
    """Compare a state dict against recorded per-tensor digests.

    Returns ``[(name, want, got), ...]`` for every tensor whose digest
    disagrees (``got`` is ``None`` for a tensor missing from
    ``state``). Empty list means every recorded tensor verified.
    """
    out = []
    for name, want in sorted(digests.items()):
        if name not in state:
            out.append((name, want, None))
            continue
        got = tensor_digest(state[name])
        if got != want:
            out.append((name, want, got))
    return out
