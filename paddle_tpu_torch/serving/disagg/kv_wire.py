"""Serialized KV handoff between prefill and decode replicas (port of
paddle_tpu/serving/disagg/kv_wire.py).

The disaggregated fleet splits one generation across two engines: a
prefill replica computes the prompt's KV cache and first token, then a
decode replica adopts that cache into a slot and steps. What crosses
between them is a :class:`KVHandoff` — the EQuARX block-scaled int8
format of :mod:`paddle_tpu_torch.parallel.comms.quantize`, applied per
**(layer, row)**: the block size IS the hidden width, so every cache row
carries its own fp32 scale. int8 payload + one fp32 scale per row cuts
the handoff ~3.9x vs fp32 (``handoff_wire_bytes``); ``wire_dtype=
"fp32"`` is the lossless escape hatch (bit-identical adoption) and
``"fp8_e4m3"`` rides the same codec (its payload travels as the e4m3
bit patterns in ``uint8``).

Per-(layer, row) scales are also exactly the layout the int8-
**resident** decode cache uses (``DecodeEngine(kv_dtype="int8")``), so
an int8 handoff whose block equals the hidden width drops straight
into the resident buffers — encode once at prefill, never requantize
on adoption.

Quantization here is idempotent for untouched rows: a row decoded from
``(payload, scale)`` re-encodes to the SAME payload and scale (the max
|element| is exactly ``127 * scale``), which is what lets the int8-
resident step program requantize the whole cache every step without
compounding error on rows it did not write.

Every handoff is sealed with a content digest at encode time
(``KVHandoff.digest``, riding ``to_wire`` docs unchanged); the decode
engine verifies it before adoption, so a corrupted handoff fails the
*inner* stream and the router's migration path re-prefills — garbage
is never installed into a slot and ``failed_streams`` stays 0. The
``wire`` corruption fault site (``wire:at=1:corrupt=bitflip``) perturbs
the payload after sealing, which is the end-to-end drill.

The handoff lives on the host, as the JAX package's does: the prefill
engine reads its cache back to numpy and quantizes it here, on the CPU
(torch ops, bit for bit the JAX package's jnp encode). Payloads, scales,
the digest and the ``to_wire`` doc are the JAX package's byte for byte,
so a handoff sealed by one package verifies and adopts in the other.
"""
import hashlib

import numpy as np
import torch

from ...integrity.digest import IntegrityError
from ...parallel.comms import quantize as Q

__all__ = [
    "KVHandoff", "encode_kv", "encode_kv_q", "decode_kv",
    "quantize_rows", "dequantize_rows", "handoff_wire_bytes",
    "handoff_compression",
]


def _host(a, dtype=None):
    """numpy view of an array-like (a torch tensor is read back first)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype) if dtype is not None else np.asarray(a)


def quantize_rows(cache, wire_dtype="int8"):
    """Per-(…, row) block-scaled encode of a float cache whose LAST
    axis is the hidden width: block size = hidden, so scales get shape
    ``cache.shape[:-1] + (1,)`` (broadcast-ready). Returns numpy
    ``(payload, scales)``; an fp8 payload is its e4m3 bit patterns as
    ``uint8``."""
    cache = _host(cache, np.float32)
    hidden = int(cache.shape[-1])
    payload, scales = Q.quantize_blocks(
        cache.reshape(-1), block_size=hidden, wire_dtype=wire_dtype)
    if payload.dtype != torch.int8:
        payload = payload.view(torch.uint8)
    return (payload.numpy().reshape(cache.shape),
            scales.numpy().astype(np.float32).reshape(
                cache.shape[:-1] + (1,)))


def dequantize_rows(payload, scales):
    """Inverse of :func:`quantize_rows` (fp32 numpy)."""
    payload = _host(payload)
    hidden = int(payload.shape[-1])
    # a handoff read off the wire is a read-only view
    flat = torch.from_numpy(
        np.require(payload, requirements=("C", "W")).reshape(-1))
    if flat.dtype == torch.uint8:  # fp8 e4m3 bit patterns
        flat = flat.view(Q.wire_info("fp8_e4m3")[0])
    out = Q.dequantize_blocks(
        flat, _host(scales, np.float32).reshape(-1), block_size=hidden)
    return out.numpy().astype(np.float32).reshape(payload.shape)


class KVHandoff:
    """One prefilled sequence, ready for a decode replica to adopt.

    Fields: ``k``/``v`` payloads shaped (layers, cache_len, hidden) —
    int8 (or fp8) with per-row fp32 ``k_scales``/``v_scales`` shaped
    (layers, cache_len, 1), or raw fp32 with scales ``None`` —
    ``next_token`` (the greedy token the prefill emitted, the stream's
    first token), ``plen`` (cache rows already written), and the
    ``prompt`` itself (migration re-prefills from it).
    """

    __slots__ = ("k", "v", "k_scales", "v_scales", "next_token",
                 "plen", "prompt", "wire_dtype", "trace", "digest")

    def __init__(self, k, v, k_scales, v_scales, next_token, plen,
                 prompt, wire_dtype, trace=None, digest=None):
        self.k = k
        self.v = v
        self.k_scales = k_scales
        self.v_scales = v_scales
        self.next_token = int(next_token)
        self.plen = int(plen)
        self.prompt = np.asarray(prompt, np.int64).reshape(-1)
        self.wire_dtype = str(wire_dtype)
        # TraceContext of the prefill-side span that produced this
        # handoff — the decode replica's adopt span parents to it so
        # one trace_id spans both processes
        self.trace = trace
        # content digest stamped by the sender (seal()); None means an
        # unsealed (hand-built) handoff, which adopts unverified
        self.digest = digest

    @property
    def shape(self):
        return tuple(int(s) for s in self.k.shape)  # (L, T, H)

    # -- content integrity -----------------------------------------------
    def content_digest(self):
        """sha256 over the handoff's semantic content: geometry +
        scalars + prompt + payloads + scales, in a fixed order."""
        h = hashlib.sha256()
        h.update(("%s;%s;%d;%d;" % (self.wire_dtype, self.shape,
                                    self.next_token, self.plen)).encode())
        h.update(np.ascontiguousarray(self.prompt).tobytes())
        for a in (self.k, self.v, self.k_scales, self.v_scales):
            if a is None:
                h.update(b";none")
            else:
                a = np.ascontiguousarray(a)
                h.update(a.dtype.str.encode())
                h.update(a.tobytes())
        return "sha256:" + h.hexdigest()

    def seal(self):
        """Stamp the sender-side content digest; returns self."""
        self.digest = self.content_digest()
        return self

    def verify(self):
        """Raise :class:`IntegrityError` if the payload no longer
        matches the sealed digest. Unsealed handoffs pass (there is
        nothing to verify against)."""
        if self.digest is None:
            return
        got = self.content_digest()
        if got != self.digest:
            raise IntegrityError(
                "KV handoff digest mismatch (want %s got %s): "
                "%d-layer cache, plen=%d, next_token=%d — refusing "
                "to adopt" % (self.digest, got, self.shape[0],
                              self.plen, self.next_token),
                tensor="kv_cache", want=self.digest, got=got)

    def dense(self):
        """The fp32 ``(k, v)`` cache pair this handoff decodes to."""
        if self.wire_dtype == "fp32":
            return (np.asarray(self.k, np.float32),
                    np.asarray(self.v, np.float32))
        return (dequantize_rows(self.k, self.k_scales),
                dequantize_rows(self.v, self.v_scales))

    def wire_bytes(self):
        """Bytes this handoff puts on the wire (payloads + scales +
        the int64 prompt; the two scalars are noise)."""
        n = int(np.prod(self.shape))
        if self.wire_dtype == "fp32":
            payload = 2 * n * 4
        else:
            itemsize = Q.WIRE_DTYPES[self.wire_dtype][0]
            rows = int(np.prod(self.shape[:-1]))
            payload = 2 * (n * itemsize + rows * 4)
        return payload + self.prompt.size * 8

    # -- serialization ---------------------------------------------------
    def to_wire(self):
        """Flat dict of bytes + metadata — what a cross-process
        transport (FileStore namespace, socket frame) would ship."""
        doc = {
            "wire_dtype": self.wire_dtype,
            "shape": list(self.shape),
            "next_token": self.next_token,
            "plen": self.plen,
            "prompt": np.asarray(self.prompt).tobytes(),
            "k": np.ascontiguousarray(self.k).tobytes(),
            "v": np.ascontiguousarray(self.v).tobytes(),
        }
        if self.k_scales is not None:
            doc["k_scales"] = np.ascontiguousarray(
                self.k_scales, np.float32).tobytes()
            doc["v_scales"] = np.ascontiguousarray(
                self.v_scales, np.float32).tobytes()
        if self.trace is not None:
            doc["trace"] = self.trace.to_doc()
        if self.digest is not None:
            doc["digest"] = self.digest
        return doc

    @classmethod
    def from_wire(cls, doc):
        from ...observability.distributed import TraceContext

        shape = tuple(int(s) for s in doc["shape"])
        wire_dtype = doc["wire_dtype"]
        pdt = {"fp32": np.float32, "fp8_e4m3": np.uint8}.get(
            wire_dtype, np.int8)
        k = np.frombuffer(doc["k"], pdt).reshape(shape)
        v = np.frombuffer(doc["v"], pdt).reshape(shape)
        ks = vs = None
        if "k_scales" in doc:
            sshape = shape[:-1] + (1,)
            ks = np.frombuffer(doc["k_scales"], np.float32).reshape(sshape)
            vs = np.frombuffer(doc["v_scales"], np.float32).reshape(sshape)
        return cls(k, v, ks, vs, doc["next_token"], doc["plen"],
                   np.frombuffer(doc["prompt"], np.int64), wire_dtype,
                   trace=TraceContext.from_doc(doc.get("trace")),
                   digest=doc.get("digest"))


def encode_kv(k, v, next_token, plen, prompt, wire_dtype="int8",
              trace=None):
    """Encode a prefilled slot cache pair (each (layers, cache_len,
    hidden) fp32 — a leading batch-of-1 axis is squeezed) into a
    :class:`KVHandoff`."""
    k = _host(k, np.float32)
    v = _host(v, np.float32)
    if k.ndim == 4:
        if k.shape[0] != 1:
            raise ValueError(
                "encode_kv wants one sequence, got batch %d" % k.shape[0])
        k, v = k[0], v[0]
    if wire_dtype == "fp32":
        h = KVHandoff(k, v, None, None, next_token, plen, prompt,
                      wire_dtype, trace=trace)
    else:
        kq, ks = quantize_rows(k, wire_dtype)
        vq, vs = quantize_rows(v, wire_dtype)
        h = KVHandoff(kq, vq, ks, vs, next_token, plen, prompt,
                      wire_dtype, trace=trace)
    h.seal()
    return _wire_fault(h)


def encode_kv_q(k, v, k_scales, v_scales, next_token, plen, prompt,
                wire_dtype="int8", trace=None):
    """Build a sealed :class:`KVHandoff` from ALREADY-quantized rows —
    an int8-**resident** engine's payload + per-row scale planes, each
    with an optional leading batch-of-1 axis. This is the session-
    hibernation path: the resident layout IS the wire layout (block =
    hidden width), so parking a slot costs a host copy and a digest,
    never a requantize — and re-adoption restores bit-identical
    payloads (the codec is idempotent on untouched rows)."""
    k = _host(k)
    v = _host(v)
    k_scales = _host(k_scales, np.float32)
    v_scales = _host(v_scales, np.float32)
    if k.ndim == 4:
        if k.shape[0] != 1:
            raise ValueError(
                "encode_kv_q wants one sequence, got batch %d"
                % k.shape[0])
        k, v = k[0], v[0]
        k_scales, v_scales = k_scales[0], v_scales[0]
    h = KVHandoff(k, v, k_scales, v_scales, next_token, plen, prompt,
                  wire_dtype, trace=trace)
    h.seal()
    return _wire_fault(h)


def _wire_fault(h):
    """The ``wire`` corruption fault site: perturb the sealed payload
    in transit (shape-preserving — the transport object must stay
    well-formed; the digest is what catches it on the decode side)."""
    from ...fluid.resilience import corrupt_array, fault_corrupt_mode

    mode = fault_corrupt_mode("wire")
    if mode is not None:
        h.k = corrupt_array(mode, h.k)
    return h


def decode_kv(handoff):
    """fp32 ``(k, v)`` pair of a handoff (convenience alias)."""
    return handoff.dense()


def handoff_wire_bytes(num_layers, cache_len, hidden,
                       wire_dtype="int8"):
    """Wire bytes for one cache PAIR of the given geometry (excluding
    the prompt — deterministic accounting for lint/bench)."""
    n = int(num_layers) * int(cache_len) * int(hidden)
    if wire_dtype == "fp32":
        return 2 * n * 4
    return 2 * Q.wire_bytes(n, block_size=int(hidden),
                            wire_dtype=wire_dtype)


def handoff_compression(num_layers, cache_len, hidden,
                        wire_dtype="int8"):
    """fp32 pair bytes over wire pair bytes — ~3.9x for int8 at the
    typical hidden widths (block = hidden)."""
    full = handoff_wire_bytes(num_layers, cache_len, hidden, "fp32")
    return full / float(
        handoff_wire_bytes(num_layers, cache_len, hidden, wire_dtype))
