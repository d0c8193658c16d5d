"""Deterministic gradient bucketing (port of
paddle_tpu/parallel/comms/bucketing.py).

One allreduce over ALL gradients cannot start until the last gradient of
the backward pass exists. Splitting the gradients into size-targeted
buckets in **reverse-backward order** (the order grads are produced:
last forward layer first) gives one collective per bucket, each of which
only depends on its own bucket's grads. Too-small buckets pay
per-collective latency; too-large buckets serialize — hence the
size-targeted greedy plan.

- :func:`plan_buckets` — pure function of (ordered name/size list,
  target bytes): same plan every call, every process, every restart.
  Determinism matters because bucket layout defines the residual state
  shapes checkpointed with the model, and every rank must issue the
  same collectives in the same order.
- :func:`sync_bucketed` — packs each bucket flat, applies error
  feedback, runs the (quantized or exact) allreduce per bucket over the
  rank group, and unpacks. The port runs it eagerly after the backward
  pass, so ``overlap`` changes no value and no schedule (the JAX
  package's ``overlap=False`` fences XLA's scheduler); it sets the
  reported ``overlap_ratio`` only.

``overlap_ratio`` is reported deterministically from the plan: the last
bucket's allreduce can never overlap backward compute, so ``1 -
last_bucket_bytes / total_bytes`` is the fraction of comm bytes with
overlap *opportunity*. 0.0 with a single bucket or with overlap off.
"""
import torch

from . import quantize as qz
from .allreduce import exact_allreduce_flat, quantized_allreduce_flat

__all__ = ["Bucket", "BucketPlan", "plan_buckets", "bucket_padded_len",
           "pack_bucket", "unpack_bucket", "sync_bucketed",
           "residual_name"]


class Bucket:
    """One size-targeted group of gradients, reduced together.

    ``names``/``shapes``/``sizes`` are parallel lists in
    reverse-backward order; ``offsets[i]`` is where tensor i starts in
    the bucket-flat vector; ``n_elements`` the unpadded flat length.
    """

    __slots__ = ("index", "names", "shapes", "sizes", "offsets",
                 "n_elements")

    def __init__(self, index, names, shapes, sizes):
        self.index = int(index)
        self.names = list(names)
        self.shapes = [tuple(s) for s in shapes]
        self.sizes = [int(s) for s in sizes]
        offs, off = [], 0
        for s in self.sizes:
            offs.append(off)
            off += s
        self.offsets = offs
        self.n_elements = off

    def to_dict(self):
        return {"index": self.index, "names": list(self.names),
                "n_elements": self.n_elements}

    def __repr__(self):
        return ("Bucket(%d, %d tensors, %d elements)"
                % (self.index, len(self.names), self.n_elements))


class BucketPlan:
    """The full schedule: buckets in launch order (reverse-backward)."""

    __slots__ = ("buckets", "target_bytes", "itemsize")

    def __init__(self, buckets, target_bytes, itemsize=4):
        self.buckets = list(buckets)
        self.target_bytes = int(target_bytes)
        self.itemsize = int(itemsize)

    @property
    def total_elements(self):
        return sum(b.n_elements for b in self.buckets)

    def overlap_ratio(self, overlap=True):
        """Fraction of comm bytes with overlap opportunity: everything
        except the last-launched bucket (which waits on the final
        grads). 0.0 when overlap is disabled or there is nothing to
        hide behind."""
        if not overlap or len(self.buckets) < 2:
            return 0.0
        total = self.total_elements
        if not total:
            return 0.0
        return 1.0 - self.buckets[-1].n_elements / float(total)

    def to_dict(self):
        return {"target_bytes": self.target_bytes,
                "n_buckets": len(self.buckets),
                "buckets": [b.to_dict() for b in self.buckets]}

    def __repr__(self):
        return ("BucketPlan(%d buckets, %d elements, target=%dB)"
                % (len(self.buckets), self.total_elements,
                   self.target_bytes))


def plan_buckets(named_sizes, target_bytes, itemsize=4):
    """Greedy size-targeted bucketing of ``[(name, shape), ...]``
    given in FORWARD parameter order; buckets come out in
    reverse-backward launch order. A bucket closes once it reaches
    ``target_bytes`` (fp32 accounting — the wire format doesn't change
    which grads belong together). Oversized single tensors get their
    own bucket. Pure and deterministic."""
    if target_bytes < 1:
        raise ValueError("target_bytes must be >= 1, got %d"
                         % target_bytes)
    items = list(reversed(list(named_sizes)))
    buckets, cur = [], []
    cur_bytes = 0
    for name, shape in items:
        size = 1
        for d in shape:
            size *= int(d)
        cur.append((name, tuple(shape), size))
        cur_bytes += size * itemsize
        if cur_bytes >= target_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
    if cur:
        buckets.append(cur)
    return BucketPlan(
        [Bucket(i, [n for n, _, _ in b], [s for _, s, _ in b],
                [z for _, _, z in b])
         for i, b in enumerate(buckets)],
        target_bytes, itemsize)


def bucket_padded_len(bucket, axis_size, block_size):
    """Flat length a bucket's wire vector is padded to: the quantized
    two-shot needs len divisible by ``axis_size * block_size`` so the
    reduce-scatter chunks split on block boundaries."""
    return qz.round_up(max(bucket.n_elements, 1),
                       int(axis_size) * int(block_size))


def pack_bucket(bucket, grads, padded_len):
    """Concatenate a bucket's gradients (fp32, flattened, in bucket
    order) and zero-pad to ``padded_len``."""
    parts = [grads[n].float().reshape(-1) for n in bucket.names]
    if padded_len > bucket.n_elements:
        parts.append(parts[0].new_zeros(padded_len - bucket.n_elements))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def unpack_bucket(bucket, flat, grads):
    """Split a reduced bucket-flat vector back into named tensors with
    the original shapes/dtypes."""
    out = {}
    for name, shape, size, off in zip(bucket.names, bucket.shapes,
                                      bucket.sizes, bucket.offsets):
        out[name] = flat[off:off + size].reshape(shape).to(
            grads[name].dtype)
    return out


def residual_name(bucket):
    """Scope name of a bucket's error-feedback residual state."""
    return "comm_ef_residual_%d" % bucket.index


def sync_bucketed(grads, group, cfg, plan, residuals=None):
    """Allreduce (mean) every gradient over `group`, one collective per
    bucket. Returns ``(synced_grads, new_residuals)``.

    ``residuals`` maps :func:`residual_name` -> padded flat residual
    (required when ``cfg.error_feedback`` and ``cfg.quantized``);
    ``new_residuals`` has the same keys with next step's values (empty
    dict when EF is off — callers keep it in the scope)."""
    mult = cfg.block_size if cfg.quantized else 1
    use_ef = cfg.quantized and cfg.error_feedback
    synced, new_residuals = {}, {}
    for bucket in plan.buckets:
        padded = bucket_padded_len(bucket, group.size, mult)
        flat = pack_bucket(bucket, grads, padded)
        send = (qz.error_feedback_apply(flat, residuals[residual_name(
            bucket)]) if use_ef else flat)
        if cfg.quantized:
            reduced, local_decoded = quantized_allreduce_flat(
                send, group, cfg.block_size, cfg.wire_dtype, mean=True)
        else:
            reduced, local_decoded = exact_allreduce_flat(send, group)
        if use_ef:
            new_residuals[residual_name(bucket)] = (
                qz.error_feedback_update(send, local_decoded))
        synced.update(unpack_bucket(bucket, reduced, grads))
    return synced, new_residuals
