"""Ring attention: sequence parallelism for long sequences (port of
paddle_tpu/parallel/ring_attention.py).

Each rank of the ``sp`` axis holds a sequence block of Q/K/V; the K/V
blocks travel around the ring while a flash-attention-style running
(max, sum, out) accumulator keeps the softmax exact, so a rank holds
O(T / sp) of the sequence.

- :func:`ring_attention` is the reference's block ring in plain torch
  (its ``_block_attn`` einsums, the (m, l, o) merge and the causal mask
  by block owner), differentiable through autograd: the CPU path and the
  oracle. Its K/V move by :func:`ring_pass`.
- On the card, :class:`RingFlash` runs the ring on the port's flash
  kernels (ops/cuda_attention.py). Forward: ``flash_attention`` on each
  visiting K/V block, causal on the diagonal block, unmasked below it
  and skipped above it, the blocks merged by their lse. Backward: the
  dQ and the dK/dV kernels on each block from the *global* lse, O and
  dO (the kernels re-form P from lse and take D = rowsum(dO∘O), so the
  global values give each block's exact gradient); the dK/dV
  accumulators travel with their block and come home after a full turn.
- :func:`ring_attention_sharded` takes global arrays, runs the ring on
  this rank's block and gathers the output.

:func:`ring_pass` moves blocks to the next rank with
``batch_isend_irecv`` over nccl. Gloo cannot send a CUDA tensor, so over
gloo the move is the group's all-gather route (``RankGroup.ppermute``).
No library attention is used.
"""
import torch
import torch.distributed as dist

from . import tensor_parallel as tpl

__all__ = ["ring_attention", "ring_attention_sharded", "full_attention",
           "ring_pass", "RingFlash"]

NEG = -1e30


def full_attention(q, k, v, causal=False, scale=None):
    """Reference single-device attention. q, k, v: (B, T, H, D)."""
    d = q.shape[-1]
    scale = scale or (d ** -0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        tq, tk = logits.shape[-2], logits.shape[-1]
        mask = torch.tril(torch.ones((tq, tk), dtype=torch.bool,
                                     device=q.device), tk - tq)
        logits = torch.where(mask, logits, torch.full_like(logits, NEG))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _block_attn(q, k, v, scale, mask):
    """One block's contribution: (m, l, o) partials. q: (B, Tq, H, D);
    k, v: (B, Tk, H, D); mask broadcastable to (Tq, Tk)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if mask is not None:
        logits = torch.where(mask[None, None], logits,
                             torch.full_like(logits, NEG))
    m = logits.amax(dim=-1)                           # (B, H, Tq)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)                                 # (B, H, Tq)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)         # (B, Tq, H, D)
    return m, l, o


class _Pass(torch.autograd.Function):
    """The block to the next rank of the ring; its gradient back to the
    previous one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return ring_pass(group, x)[0]

    @staticmethod
    def backward(ctx, g):
        return ring_pass(ctx.group, g.contiguous(), shift=-1)[0], None


def ring_pass(group, *tensors, shift=1):
    """Each tensor of rank i lands on rank (i + shift) % size: by
    ``batch_isend_irecv`` over nccl, by the group's all-gather route over
    gloo (which cannot send a CUDA tensor)."""
    n = group.size
    if n == 1 or group.group is None:
        return list(tensors)
    if group.backend != "nccl":
        out = []
        for t in tensors:
            tpl._count("ring", "sp", t)
            out.append(group.ppermute(t.contiguous(), shift))
        return out
    me = group.rank
    to = group.ranks[(me + shift) % n]
    frm = group.ranks[(me - shift) % n]
    ops, out = [], []
    for t in tensors:
        t = t.contiguous()
        tpl._count("ring", "sp", t)
        got = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, to, group=group.group))
        ops.append(dist.P2POp(dist.irecv, got, frm, group=group.group))
        out.append(got)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_attention(q, k, v, group, causal=False, scale=None):
    """Exact attention over a ring-sharded sequence, in plain torch. q, k,
    v are this rank's blocks (B, T_local, H, D) of the sequence split over
    `group` (the sp line of the mesh, rank coordinate c holding block
    c)."""
    d = q.shape[-1]
    t_local = q.shape[1]
    scale = scale or (d ** -0.5)
    n = group.size
    me = group.rank
    b, _, h, _ = q.shape
    m_acc = torch.full((b, h, t_local), NEG, dtype=torch.float32,
                       device=q.device)
    l_acc = torch.zeros((b, h, t_local), dtype=torch.float32, device=q.device)
    o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    ar = torch.arange(t_local, device=q.device)
    qf = q.float()
    k_blk, v_blk = k, v
    for step in range(n):
        owner = (me - step) % n
        mask = None
        if causal:
            mask = (me * t_local + ar[:, None]) >= (owner * t_local
                                                     + ar[None, :])
        m_b, l_b, o_b = _block_attn(qf, k_blk.float(), v_blk.float(), scale,
                                    mask)
        m_new = torch.maximum(m_acc, m_b)
        alpha = torch.exp(m_acc - m_new)
        beta = torch.exp(m_b - m_new)
        l_acc = l_acc * alpha + l_b * beta
        o_acc = (o_acc * alpha.transpose(1, 2)[..., None]
                 + o_b * beta.transpose(1, 2)[..., None])
        m_acc = m_new
        if step < n - 1:
            k_blk = _Pass.apply(k_blk, group)
            v_blk = _Pass.apply(v_blk, group)
    denom = l_acc.transpose(1, 2)[..., None]
    return (o_acc / torch.clamp(denom, min=1e-20)).to(q.dtype)


class RingFlash(torch.autograd.Function):
    """The ring on the flash kernels, q/k/v this rank's (B, H, T_local, D)
    blocks of the sequence split over `group`:
    ``RingFlash.apply(q, k, v, group, causal, sm_scale)`` -> out like q.
    ``RingFlash.launches`` counts its forward runs."""

    launches = 0

    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale):
        from ..ops.cuda_attention import flash_attention

        n, me = group.size, group.rank
        o_acc = lse = None
        kb, vb = k, v
        for step in range(n):
            owner = (me - step) % n
            if not (causal and owner > me):
                o_b, lse_b = flash_attention(q, kb, vb, None, None, sm_scale,
                                             causal and owner == me)
                if o_acc is None:
                    o_acc, lse = o_b.float(), lse_b
                else:
                    new = torch.logaddexp(lse, lse_b)
                    o_acc = (o_acc * torch.exp(lse - new)[..., None]
                             + o_b.float() * torch.exp(lse_b - new)[..., None])
                    lse = new
            if step < n - 1:
                kb, vb = ring_pass(group, kb, vb)
        out = o_acc.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.sm_scale = group, causal, sm_scale
        RingFlash.launches += 1
        return out

    @staticmethod
    def backward(ctx, dout):
        from ..ops.cuda_attention import (flash_attention_dkdv,
                                          flash_attention_dq)

        q, k, v, out, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n, me = group.size, group.rank
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kb, vb = k, v
        dkb = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvb = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step in range(n):
            owner = (me - step) % n
            if not (causal and owner > me):
                args = (q, kb, vb, None, None, dout, lse, delta, ctx.sm_scale,
                        causal and owner == me)
                dq += flash_attention_dq(*args).float()
                dk_b, dv_b, _ = flash_attention_dkdv(*args)
                dkb += dk_b.float()
                dvb += dv_b.float()
            # the accumulators travel with their block; the last pass
            # brings them home
            if step < n - 1:
                kb, vb, dkb, dvb = ring_pass(group, kb, vb, dkb, dvb)
            else:
                dkb, dvb = ring_pass(group, dkb, dvb)
        return (dq.to(q.dtype), dkb.to(k.dtype), dvb.to(v.dtype), None, None,
                None)


def ring_attention_sharded(q, k, v, mesh, axis="sp", causal=False):
    """q, k, v are GLOBAL (B, T, H, D) tensors, alike on every rank: each
    rank runs the ring on its sequence block over `mesh`'s `axis` and the
    blocks are gathered back (differentiably) into the global output."""
    group = mesh.axis_group(axis)
    blocks = [tpl.scatter(t, group, axis, 1) for t in (q, k, v)]
    if q.device.type == "cuda":
        qb, kb, vb = (t.transpose(1, 2).contiguous() for t in blocks)
        out = RingFlash.apply(qb, kb, vb, group, causal,
                              q.shape[-1] ** -0.5).transpose(1, 2)
    else:
        out = ring_attention(*blocks, group, causal=causal)
    return tpl.gather(out, group, axis, 1)
