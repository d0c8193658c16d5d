"""Cross-request KV reuse: prefix cache and session tiering (port of
paddle_tpu/serving/prefix_pool.py).

Shared-prefix traffic (every request opening with the same system
prompt, multi-turn chat resuming a transcript) makes most prefill
FLOPs redundant: the KV rows for a prompt prefix depend only on the
prefix tokens, so they can be computed once and adopted by every later
request that starts with the same tokens. Two stores implement that
reuse, both sized in bytes and LRU-evicted:

- :class:`PrefixPool` — content-addressed prefix -> prefilled KV rows.
  Keys are ``integrity.digest`` sha256 digests of the token bytes (the
  JAX package's keys, digest for digest), so lookup is exact-match over
  the declared prefix ladder (longest match wins); a hit lets the engine
  adopt ``plen`` rows verbatim and delta-prefill only the suffix
  (:func:`~paddle_tpu_torch.models.gpt.build_gpt_prefill_delta`). Entries
  are fp32 (``store_dtype="fp32"``, bit-exact adoption — what the parity
  tests pin) or int8 per-row block-scaled (``"int8"``, the kv_wire
  codec, ~3.9x more prefixes per byte). ``placement="hbm"`` keeps entries
  as tensors on the engine's device (adopt without a host-to-device
  copy); ``"host"`` (the default) keeps numpy arrays and pays an upload
  per adoption for zero device memory.

- :class:`SessionTier` — hibernated sessions keyed by session id. When
  a stream with a ``session`` id retires, the engine encodes the slot's
  live KV rows into the
  :class:`~paddle_tpu_torch.serving.disagg.kv_wire.KVHandoff` wire format
  (int8 by default — the same ~3.9x) and parks it in host RAM; a later
  ``submit(session=...)`` adopts the rows back into a free slot and
  delta-prefills only the new turn. Live-slot count stops bounding
  concurrent sessions: sessions per card = slots + whatever fits the
  tier's byte budget.

Metrics, under the JAX package's names: ``serving.prefix.hits`` /
``misses`` / ``evictions`` / ``inserts`` counters and
``serving.prefix.entries`` / ``bytes`` gauges;
``serving.tier.hibernated`` / ``resumed`` / ``evictions`` counters and
``serving.tier.sessions`` / ``bytes`` gauges.

Thread safety: both stores take a lock around every mutation — the
dispatch thread inserts while HTTP threads submit and look up. The locks
are plain ``threading`` locks (the JAX package's sanitizer-aware named
locks wait for ROADMAP.md Queue 1 item 11).
"""
import collections
import threading

import numpy as np
import torch

from .. import observability as obs
from ..integrity.digest import bytes_digest

__all__ = ["PrefixPool", "SessionTier", "prefix_digest"]


def prefix_digest(tokens):
    """Content digest of a token prefix: sha256 over the int64 bytes
    (the :mod:`paddle_tpu_torch.integrity.digest` form, so pool keys read
    like every other integrity surface's)."""
    return bytes_digest(np.ascontiguousarray(
        np.asarray(tokens, np.int64)).tobytes())


def _nbytes(a):
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    return int(a.nbytes)


class _PrefixEntry:
    __slots__ = ("digest", "plen", "k", "v", "k_scales", "v_scales",
                 "next_token", "store_dtype", "nbytes")

    def __init__(self, digest, plen, k, v, k_scales, v_scales,
                 next_token, store_dtype):
        self.digest = digest
        self.plen = int(plen)
        self.k = k
        self.v = v
        self.k_scales = k_scales
        self.v_scales = v_scales
        # greedy token for position plen — a FULL-prompt hit adopts
        # this as the stream's first token and runs no prefill at all
        self.next_token = None if next_token is None else int(next_token)
        self.store_dtype = store_dtype
        self.nbytes = sum(_nbytes(a) for a in
                          (k, v, k_scales, v_scales) if a is not None)

    @property
    def shape(self):
        return tuple(int(s) for s in self.k.shape)  # (L, T, H)

    def dense(self):
        """fp32 (k, v) pair shaped (L, cache_len, H): numpy for a host
        entry, tensors on the pool's device for a device-resident one
        (int8 entries are decoded where they live)."""
        if self.store_dtype == "fp32":
            return self.k, self.v
        if isinstance(self.k, torch.Tensor):
            # the codec's decode (payload · scale per row), on the device
            return (self.k.to(torch.float32) * self.k_scales,
                    self.v.to(torch.float32) * self.v_scales)
        from .disagg import kv_wire

        return (kv_wire.dequantize_rows(self.k, self.k_scales),
                kv_wire.dequantize_rows(self.v, self.v_scales))


class PrefixPool:
    """Slot-granular prefix cache: digest(prefix tokens) -> prefilled
    KV rows, LRU-evicted to ``capacity_bytes``.

    ``prefix_lens`` declares the prefix ladder the pool indexes (by
    default the engine's prompt buckets): :meth:`lookup` hashes each
    ladder length that fits the prompt, longest first, so a 24-token
    shared system prompt is found under its 16-token ladder entry even
    when callers append unique tails. ``min_tokens`` skips caching
    trivially short prefixes.

    A ``placement="hbm"`` pool follows the place of the engine it is
    attached to (:meth:`bind`); unattached, it keeps its entries on the
    default place's device.
    """

    def __init__(self, capacity_bytes=64 << 20, store_dtype="fp32",
                 placement="host", prefix_lens=None, min_tokens=4,
                 name="default"):
        if store_dtype not in ("fp32", "int8"):
            raise ValueError("store_dtype must be 'fp32' or 'int8', "
                             "got %r" % (store_dtype,))
        if placement not in ("host", "hbm"):
            raise ValueError("placement must be 'host' or 'hbm', "
                             "got %r" % (placement,))
        self.capacity_bytes = int(capacity_bytes)
        self.store_dtype = str(store_dtype)
        self.placement = str(placement)
        self.prefix_lens = (tuple(sorted({int(p) for p in prefix_lens}))
                            if prefix_lens else None)
        self.min_tokens = int(min_tokens)
        self.name = str(name)
        self.device = None
        self._lock = threading.Lock()
        self._entries = collections.OrderedDict()  # digest -> entry
        self._bytes = 0
        self._stats = collections.Counter()

    def bind(self, device):
        """Attach to an engine on ``device``: a device-resident pool keeps
        its entries there, and refuses an engine on another device."""
        device = torch.device(device)
        if self.placement == "hbm":
            if self.device is not None and self.device != device:
                raise ValueError(
                    "prefix pool %r keeps its entries on %s, not %s"
                    % (self.name, self.device, device))
            self.device = device
        return self

    def _store_device(self):
        if self.device is None:
            from ..fluid import core

            self.device = core.default_place().torch_device()
        return self.device

    # -- write side ------------------------------------------------------
    def put(self, tokens, k, v, next_token=None):
        """Cache the KV rows of ``tokens`` (a full prefix whose rows
        0..len-1 are written in ``k``/``v``, each (L, cache_len, H)
        fp32 — a leading batch-of-1 axis is squeezed; numpy arrays or
        tensors). Stores under the full-length digest AND every declared
        ladder length that prefixes it, so later lookups match on the
        shared head without re-prefilling. Returns the number of entries
        written."""
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        if self.placement == "hbm":
            dev = self._store_device()
            k = torch.as_tensor(k, dtype=torch.float32, device=dev)
            v = torch.as_tensor(v, dtype=torch.float32, device=dev)
        else:
            from .disagg.kv_wire import _host

            k = _host(k, np.float32)
            v = _host(v, np.float32)
        if k.ndim == 4:
            k, v = k[0], v[0]
        wrote = 0
        lens = {int(tokens.size)}
        if self.prefix_lens:
            lens.update(p for p in self.prefix_lens
                        if p < tokens.size)
        for plen in sorted(lens, reverse=True):
            if plen < self.min_tokens:
                continue
            nt = next_token if plen == tokens.size else None
            wrote += self._put_one(tokens[:plen], plen, k, v, nt)
        return wrote

    def _put_one(self, tokens, plen, k, v, next_token):
        digest = prefix_digest(tokens)
        # zero rows >= plen so an adopted entry matches the "zeros
        # beyond pos" cache invariant regardless of source geometry
        if isinstance(k, torch.Tensor):
            with torch.inference_mode():
                kp = torch.zeros_like(k)
                vp = torch.zeros_like(v)
                kp[:, :plen] = k[:, :plen]
                vp[:, :plen] = v[:, :plen]
        else:
            kp = np.zeros_like(k)
            vp = np.zeros_like(v)
            kp[:, :plen] = k[:, :plen]
            vp[:, :plen] = v[:, :plen]
        if self.store_dtype == "int8":
            from .disagg import kv_wire

            kq, ks = kv_wire.quantize_rows(kp)
            vq, vs = kv_wire.quantize_rows(vp)
            if self.placement == "hbm":
                dev = self._store_device()
                kq, vq, ks, vs = (torch.from_numpy(a).to(dev)
                                  for a in (kq, vq, ks, vs))
            entry = _PrefixEntry(digest, plen, kq, vq, ks, vs,
                                 next_token, "int8")
        else:
            entry = _PrefixEntry(digest, plen, kp, vp, None, None,
                                 next_token, "fp32")
        if entry.nbytes > self.capacity_bytes:
            return 0
        with self._lock:
            old = self._entries.pop(digest, None)
            if old is not None:
                self._bytes -= old.nbytes
                # keep a known next_token when the rewrite lacks one
                if entry.next_token is None:
                    entry.next_token = old.next_token
            self._entries[digest] = entry
            self._bytes += entry.nbytes
            self._stats["inserts"] += 1
            evicted = 0
            while self._bytes > self.capacity_bytes and self._entries:
                _, dead = self._entries.popitem(last=False)
                self._bytes -= dead.nbytes
                evicted += 1
            if evicted:
                self._stats["evictions"] += evicted
                obs.inc("serving.prefix.evictions", evicted)
            self._gauges_locked()
        obs.inc("serving.prefix.inserts")
        return 1

    # -- read side -------------------------------------------------------
    def lookup(self, prompt):
        """Longest cached prefix of ``prompt``: tries the full prompt
        first, then each declared ladder length, longest first.
        Returns the (LRU-refreshed) entry or None. A hit with
        ``entry.plen == len(prompt)`` and a known ``next_token`` needs
        NO prefill at all; a shorter hit wants a delta-prefill of the
        remaining suffix."""
        prompt = np.asarray(prompt, np.int64).reshape(-1)
        lens = [int(prompt.size)]
        if self.prefix_lens:
            lens += [p for p in self.prefix_lens if p < prompt.size]
        for plen in sorted(set(lens), reverse=True):
            if plen < self.min_tokens:
                break
            digest = prefix_digest(prompt[:plen])
            with self._lock:
                entry = self._entries.get(digest)
                if entry is not None:
                    self._entries.move_to_end(digest)
                    self._stats["hits"] += 1
                    obs.inc("serving.prefix.hits")
                    return entry
        with self._lock:
            self._stats["misses"] += 1
        obs.inc("serving.prefix.misses")
        return None

    # -- accounting ------------------------------------------------------
    def hbm_bytes(self):
        """Bytes this pool holds device-resident (0 for host
        placement)."""
        return self.capacity_bytes if self.placement == "hbm" else 0

    def _gauges_locked(self):
        obs.set_gauge("serving.prefix.entries", len(self._entries))
        obs.set_gauge("serving.prefix.bytes", self._bytes)

    def stats(self):
        with self._lock:
            out = dict(self._stats)
            out["entries"] = len(self._entries)
            out["bytes"] = self._bytes
        for key in ("hits", "misses", "evictions", "inserts"):
            out.setdefault(key, 0)
        out["capacity_bytes"] = self.capacity_bytes
        out["store_dtype"] = self.store_dtype
        out["placement"] = self.placement
        return out

    def __len__(self):
        with self._lock:
            return len(self._entries)


class SessionTier:
    """Host-RAM hibernation tier for idle sessions' KV state.

    Stores sealed :class:`~paddle_tpu_torch.serving.disagg.kv_wire.
    KVHandoff` payloads keyed by session id — ``handoff.prompt`` carries
    the FULL token history (prompt + generated), ``plen`` the written
    rows, and ``next_token`` the last emitted token, which is exactly
    what a resume must feed first. int8 wire (the default) stores ~3.9x
    more sessions per byte; ``wire_dtype="fp32"`` keeps resume bit-exact
    on fp32 engines (int8-resident engines are bit-exact under int8 wire
    too: requantization is idempotent on untouched rows)."""

    def __init__(self, capacity_bytes=256 << 20, wire_dtype="int8",
                 name="default"):
        self.capacity_bytes = int(capacity_bytes)
        self.wire_dtype = str(wire_dtype)
        self.name = str(name)
        self._lock = threading.Lock()
        self._sessions = collections.OrderedDict()  # sid -> KVHandoff
        self._bytes = 0
        self._stats = collections.Counter()

    def hibernate(self, session_id, handoff):
        """Park a session's sealed handoff; LRU-evicts to capacity
        (an evicted session simply cold-prefills on resume)."""
        sid = str(session_id)
        nbytes = handoff.wire_bytes()
        with self._lock:
            old = self._sessions.pop(sid, None)
            if old is not None:
                self._bytes -= old.wire_bytes()
            self._sessions[sid] = handoff
            self._bytes += nbytes
            self._stats["hibernated"] += 1
            evicted = 0
            while self._bytes > self.capacity_bytes and self._sessions:
                _, dead = self._sessions.popitem(last=False)
                self._bytes -= dead.wire_bytes()
                evicted += 1
            if evicted:
                self._stats["evictions"] += evicted
                obs.inc("serving.tier.evictions", evicted)
            self._gauges_locked()
        obs.inc("serving.tier.hibernated")
        return sid

    def resume(self, session_id):
        """Pop a hibernated session's handoff (verified against its
        sealed digest by the adopting engine). None = unknown/evicted,
        meaning the caller cold-prefills from its own transcript."""
        with self._lock:
            h = self._sessions.pop(str(session_id), None)
            if h is not None:
                self._bytes -= h.wire_bytes()
                self._stats["resumed"] += 1
                self._gauges_locked()
        if h is not None:
            obs.inc("serving.tier.resumed")
        return h

    def peek(self, session_id):
        """Non-destructive lookup (admission-time validation)."""
        with self._lock:
            return self._sessions.get(str(session_id))

    def _gauges_locked(self):
        obs.set_gauge("serving.tier.sessions", len(self._sessions))
        obs.set_gauge("serving.tier.bytes", self._bytes)

    def stats(self):
        with self._lock:
            out = dict(self._stats)
            out["sessions"] = len(self._sessions)
            out["bytes"] = self._bytes
        for key in ("hibernated", "resumed", "evictions"):
            out.setdefault(key, 0)
        out["capacity_bytes"] = self.capacity_bytes
        out["wire_dtype"] = self.wire_dtype
        return out

    def __len__(self):
        with self._lock:
            return len(self._sessions)
