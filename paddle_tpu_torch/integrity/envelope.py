"""Versioned content-digest envelopes for every byte path (port of
paddle_tpu/integrity/envelope.py, byte for byte).

Three envelope shapes, one version number:

- **Sealed blobs** (compile-cache entries): ``MAGIC`` +
  one JSON header line (version, kind, size, digest) + raw payload.
  :func:`unseal_bytes` verifies size then digest and raises
  :class:`~paddle_tpu_torch.integrity.digest.IntegrityError` with the check
  that failed.
- **Manifest docs** (checkpoint steps, done-markers): a JSON doc with
  per-tensor digests, written atomically next to (never inside) the
  orbax step dir.
- **Stamped docs** (FileStore mailboxes): the payload dict itself
  carries an ``_integrity`` key with a canonical-JSON digest of the
  rest of the doc; readers verify and strip the stamp so consumers
  see exactly the doc that was ``put``.

Writers route their encoded bytes through the ``save``/``load``/
``wire``/``mailbox`` corruption fault sites
(:func:`paddle_tpu_torch.fluid.resilience.fault_corrupt`) so every
detection path here is drillable from ``PADDLE_TPU_FAULT_SPEC``.
"""
import json
import os
import uuid

from .digest import IntegrityError, bytes_digest, doc_digest

FORMAT = "paddle-tpu-integrity"
VERSION = 1
MAGIC = b"PTIV1\n"
STAMP_KEY = "_integrity"


def _fault(site, data):
    """Route bytes through the corruption fault injector (lazy import
    so the envelope stays usable before fluid is importable)."""
    try:
        from ..fluid.resilience import fault_corrupt
    except Exception:  # pragma: no cover - circular/partial import
        return data
    return fault_corrupt(site, data)


# -- sealed byte blobs ----------------------------------------------------

def seal_bytes(payload, kind="blob", meta=None):
    """Wrap raw bytes in a digest envelope: MAGIC + header line + payload."""
    doc = {"fmt": FORMAT, "v": VERSION, "kind": kind,
           "size": len(payload), "digest": bytes_digest(payload)}
    if meta:
        doc.update(meta)
    header = json.dumps(doc, sort_keys=True,
                        separators=(",", ":")).encode("utf-8")
    return MAGIC + header + b"\n" + bytes(payload)


def is_sealed(data):
    return bytes(data[:len(MAGIC)]) == MAGIC


def unseal_bytes(data, kind=None, path=None):
    """Verify and strip a sealed envelope, returning the payload.

    Raises :class:`IntegrityError` naming the failing check: missing
    or torn header, version/kind mismatch, truncated payload, or
    digest mismatch.
    """
    if not is_sealed(data):
        raise IntegrityError(
            "missing integrity envelope (no %r magic): %s"
            % (MAGIC, path or "<bytes>"), path=path)
    body = bytes(data[len(MAGIC):])
    nl = body.find(b"\n")
    if nl < 0:
        raise IntegrityError(
            "torn integrity envelope header: %s" % (path or "<bytes>"),
            path=path)
    try:
        doc = json.loads(body[:nl].decode("utf-8"))
        if not isinstance(doc, dict):
            raise ValueError("header is not a dict")
    except (ValueError, UnicodeDecodeError) as e:
        raise IntegrityError(
            "unreadable integrity envelope header (%s): %s"
            % (e, path or "<bytes>"), path=path)
    if doc.get("fmt") != FORMAT or doc.get("v") != VERSION:
        raise IntegrityError(
            "unsupported integrity envelope %r v%r: %s"
            % (doc.get("fmt"), doc.get("v"), path or "<bytes>"),
            path=path)
    if kind is not None and doc.get("kind") != kind:
        raise IntegrityError(
            "integrity envelope kind %r, expected %r: %s"
            % (doc.get("kind"), kind, path or "<bytes>"), path=path)
    payload = body[nl + 1:]
    if len(payload) != doc.get("size"):
        raise IntegrityError(
            "truncated payload (%d of %s bytes): %s"
            % (len(payload), doc.get("size"), path or "<bytes>"),
            path=path, want=doc.get("digest"))
    got = bytes_digest(payload)
    if got != doc.get("digest"):
        raise IntegrityError(
            "payload digest mismatch (want %s got %s): %s"
            % (doc.get("digest"), got, path or "<bytes>"),
            path=path, want=doc.get("digest"), got=got)
    return payload


# -- manifest docs (checkpoints) ------------------------------------------

def make_manifest(digests, kind, **meta):
    doc = {"fmt": FORMAT, "v": VERSION, "kind": kind,
           "digests": dict(digests)}
    doc.update(meta)
    return doc


def write_manifest(path, doc):
    """Atomic (tmp + rename) manifest write, routed through the
    ``save`` corruption fault site."""
    data = json.dumps(doc, sort_keys=True).encode("utf-8")
    data = _fault("save", data)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = "%s.tmp.%d.%s" % (path, os.getpid(), uuid.uuid4().hex[:8])
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_manifest(path):
    """Read a manifest: ``None`` if absent; :class:`IntegrityError` if
    present but torn, unparseable, or the wrong format — a manifest
    that cannot be trusted fails verification rather than silently
    disabling it."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    data = _fault("load", data)
    try:
        doc = json.loads(data.decode("utf-8"))
        if not isinstance(doc, dict):
            raise ValueError("manifest is not a dict")
    except (ValueError, UnicodeDecodeError) as e:
        raise IntegrityError(
            "unreadable integrity manifest (%s): %s" % (e, path),
            path=path)
    if doc.get("fmt") != FORMAT or doc.get("v") != VERSION:
        raise IntegrityError(
            "unsupported integrity manifest %r v%r: %s"
            % (doc.get("fmt"), doc.get("v"), path), path=path)
    return doc


# -- stamped JSON docs (FileStore mailboxes) ------------------------------

def stamp_doc(doc):
    """Return a copy of ``doc`` carrying an ``_integrity`` stamp over
    its canonical JSON encoding (any pre-existing stamp is replaced)."""
    body = {k: v for k, v in doc.items() if k != STAMP_KEY}
    out = dict(body)
    out[STAMP_KEY] = {"v": VERSION, "digest": doc_digest(body)}
    return out


def check_doc(doc):
    """Verify a stamped doc: ``(ok, cleaned_doc)``.

    Unstamped docs pass unchanged (pre-integrity writers and foreign
    docs stay readable); stamped docs are verified and returned with
    the stamp stripped so consumers never see the envelope.
    """
    stamp = doc.get(STAMP_KEY)
    if stamp is None:
        return True, doc
    body = {k: v for k, v in doc.items() if k != STAMP_KEY}
    ok = (isinstance(stamp, dict)
          and stamp.get("digest") == doc_digest(body))
    return ok, body
