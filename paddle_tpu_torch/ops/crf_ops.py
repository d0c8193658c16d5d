"""Linear-chain CRF and CTC decode op lowerings: linear_chain_crf,
crf_decoding, chunk_eval, ctc_greedy_decoder (ref: paddle/fluid/
operators/linear_chain_crf_op.h, crf_decoding_op.h, chunk_eval_op.h,
ctc_align_op). Port of the paddle_tpu/ops/crf_ops.py lowerings.

The reference runs the CRF forward as one log-domain scan over time for
the whole batch, Viterbi as a scan that keeps a (T, B, D) backpointer
table and a reverse scan that walks it, and chunk_eval's tag machine as
dense (L, L) lookup tables over (previous label, label) pairs and a
matching scan. Each scan is a Python loop of the same fixed length here,
on device tensors, steps past a row's length masked rather than skipped;
nothing is read back to the host. The forward's gradient comes from
autograd.

Transition layout as the reference's: row 0 start weights, row 1 end
weights, rows 2.. tag-to-tag scores, shape (D + 2, D). LogLikelihood is
the per-sequence negative log likelihood. Integer results the reference
gives as int64 (int32 under jax without x64) are int64: ViterbiPath,
chunk_eval's counts, ctc_greedy_decoder's Out and OutLength (ROADMAP.md
Queue 3).
"""
import numpy as np
import torch

from .detection_ops import table
from .registry import register_op
from .tensor_ops import stable_argsort


def _crf_inputs(ins):
    x, w = ins["Emission"][0], ins["Transition"][0]
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    b, t, _ = x.shape
    if ins.get("Length"):
        lens = ins["Length"][0].long().reshape(-1)
    else:
        lens = torch.full((b,), t, dtype=torch.long, device=x.device)
    return x, w, lens, squeeze


@register_op("linear_chain_crf")
def _linear_chain_crf(ctx, ins, attrs):
    """Negative log likelihood of each sequence under a linear-chain CRF:
    log Z from the batched forward recursion in the log domain (a row
    past its length keeps its alpha), minus the gold path's score;
    0 for an empty row. Alpha (B, T, D) is the recursion's history."""
    x, w, lens, _ = _crf_inputs(ins)
    b, t, d = x.shape
    label = ins["Label"][0].long().reshape(b, t)
    start_w, end_w, trans = w[0], w[1], w[2:]
    a = start_w[None, :] + x[:, 0, :]
    hist = [a]
    for k in range(1, t):
        nxt = torch.logsumexp(a[:, :, None] + trans[None, :, :], dim=1) \
            + x[:, k, :]
        a = torch.where((k < lens)[:, None], nxt, a)
        hist.append(a)
    log_z = torch.logsumexp(a + end_w[None, :], dim=-1)
    valid = torch.arange(t, device=x.device)[None, :] < lens[:, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    emit = x.gather(2, label[:, :, None])[:, :, 0]
    emit_sum = torch.where(valid, emit, zero).sum(dim=1)
    trans_sc = trans[label[:, :-1], label[:, 1:]]
    trans_sum = torch.where(valid[:, 1:], trans_sc, zero).sum(dim=1)
    last_lab = label.gather(1, (lens - 1).clamp(min=0)[:, None])[:, 0]
    gold = start_w[label[:, 0]] + emit_sum + trans_sum + end_w[last_lab]
    nll = torch.where(lens > 0, log_z - gold, zero)
    return {"LogLikelihood": [nll[:, None]],
            "Alpha": [torch.stack(hist, dim=1)],
            "EmissionExps": [torch.exp(x - x.amax(dim=-1, keepdim=True))],
            "TransitionExps": [torch.exp(w)]}


@register_op("crf_decoding")
def _crf_decoding(ctx, ins, attrs):
    """Viterbi decoding: ViterbiPath (B, T) int64, the best tags, 0 past
    each length (a padded step's backpointers are the identity, so the
    walk passes through it); with a Label input, 1 where the path equals
    the label instead. Ties go to the first tag, as ``jnp.argmax``."""
    x, w, lens, squeeze = _crf_inputs(ins)
    b, t, d = x.shape
    start_w, end_w, trans = w[0], w[1], w[2:]
    ident = torch.arange(d, device=x.device)[None, :].expand(b, d)
    a = start_w[None, :] + x[:, 0, :]
    tracks = []
    for k in range(1, t):
        scores = a[:, :, None] + trans[None, :, :]          # (B, Dprev, D)
        best = scores.amax(dim=1) + x[:, k, :]
        live = (k < lens)[:, None]
        a = torch.where(live, best, a)
        tracks.append(torch.where(live, torch.argmax(scores, dim=1), ident))
    tag = torch.argmax(a + end_w[None, :], dim=-1)
    path = [tag]
    for track in reversed(tracks):
        tag = track.gather(1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1)
    valid = torch.arange(t, device=x.device)[None, :] < lens[:, None]
    path = torch.where(valid, path, 0)
    if ins.get("Label"):
        label = ins["Label"][0].long().reshape(b, t)
        path = torch.where(valid, (label == path).long(), 0)
    return {"ViterbiPath": [path[0] if squeeze else path]}


_SCHEMES = {
    # scheme -> (tag types, begin, inside, end, single) tag roles
    "IOB": (2, 0, 1, -1, -1),
    "IOE": (2, -1, 0, 1, -1),
    "IOBES": (4, 0, 1, 2, 3),
    "plain": (1, -1, -1, -1, -1),
}


def _chunk_tables(scheme, num_chunk_types):
    """The reference's ChunkBegin/ChunkEnd predicates as dense (L, L)
    tables over (previous label, label); L counts the 'other' label,
    num_chunk_types · tag types."""
    ntag, t_beg, t_in, t_end, t_sin = _SCHEMES[scheme]
    other = num_chunk_types
    n_labels = num_chunk_types * ntag + 1

    def tag_type(lab):
        return lab % ntag, lab // ntag

    def chunk_begin(prev, cur):
        ptag, ptype = tag_type(prev)
        tag, typ = tag_type(cur)
        if ptype == other:
            return typ != other
        if typ == other:
            return False
        if typ != ptype:
            return True
        if tag == t_beg:
            return True
        if tag == t_in:
            return ptag in (t_end, t_sin)
        if tag == t_end:
            return ptag in (t_end, t_sin)
        if tag == t_sin:
            return True
        return False

    def chunk_end(prev, cur):
        ptag, ptype = tag_type(prev)
        tag, typ = tag_type(cur)
        if ptype == other:
            return False
        if typ == other:
            return True
        if typ != ptype:
            return True
        if ptag == t_beg or ptag == t_in:
            return tag in (t_beg, t_sin)
        if ptag in (t_end, t_sin):
            return True
        return False

    beg = np.zeros((n_labels, n_labels), np.bool_)
    end = np.zeros((n_labels, n_labels), np.bool_)
    for p in range(n_labels):
        for c in range(n_labels):
            beg[p, c] = chunk_begin(p, c)
            end[p, c] = chunk_end(p, c)
    return beg, end, ntag, n_labels


def _chunk_masks(labels, lens, beg_t, end_t, ntag, n_labels):
    """Per position (B, T): chunk begins, chunk ends, chunk type, in
    range. Labels outside [0, L) are clamped; padding acts as O."""
    b, t = labels.shape
    lab = labels.clamp(0, n_labels - 1)
    valid = torch.arange(t, device=labels.device)[None, :] < lens[:, None]
    lab = torch.where(valid, lab, n_labels - 1)
    o_col = torch.full((b, 1), n_labels - 1, dtype=lab.dtype,
                       device=lab.device)
    prev = torch.cat([o_col, lab[:, :-1]], dim=1)
    nxt = torch.cat([lab[:, 1:], o_col], dim=1)
    beg = beg_t[prev, lab] & valid
    end = end_t[lab, nxt] & valid
    return beg, end, lab // ntag


@register_op("chunk_eval")
def _chunk_eval(ctx, ins, attrs):
    """Chunk precision, recall and F1 of Inference against Label ((B, T)
    padded labels, SeqLength (B,)) under IOB, IOE, IOBES or plain; the
    counts are int64. A match runs from a shared begin of the same
    (not excluded) type to a shared end."""
    inf = ins["Inference"][0].long()
    lab = ins["Label"][0].long()
    if inf.dim() == 3:
        inf = inf[:, :, 0]
    if lab.dim() == 3:
        lab = lab[:, :, 0]
    if inf.dim() == 1:
        inf, lab = inf[None], lab[None]
    b, t = inf.shape
    dev = inf.device
    if ins.get("SeqLength"):
        lens = ins["SeqLength"][0].long().reshape(-1)
    else:
        lens = torch.full((b,), t, dtype=torch.long, device=dev)
    beg_t, end_t, ntag, n_labels = _chunk_tables(
        attrs.get("chunk_scheme", "IOB"), int(attrs["num_chunk_types"]))
    beg_t = table(beg_t, dev, torch.bool)
    end_t = table(end_t, dev, torch.bool)
    ib, ie, ityp = _chunk_masks(inf, lens, beg_t, end_t, ntag, n_labels)
    lb, le, ltyp = _chunk_masks(lab, lens, beg_t, end_t, ntag, n_labels)
    include_i = torch.ones_like(ib)
    include_l = torch.ones_like(lb)
    for e in attrs.get("excluded_chunk_types") or []:
        include_i = include_i & (ityp != e)
        include_l = include_l & (ltyp != e)
    n_infer = (ib & include_i).sum()
    n_label = (lb & include_l).sum()
    alive = torch.zeros((b,), dtype=torch.bool, device=dev)
    cnt = torch.zeros((b,), dtype=torch.long, device=dev)
    for k in range(t):
        start = lb[:, k] & ib[:, k] & (ltyp[:, k] == ityp[:, k]) \
            & include_l[:, k]
        alive = start | (alive & ~lb[:, k] & ~ib[:, k])
        cnt = cnt + (alive & le[:, k] & ie[:, k]).long()
        alive = alive & ~le[:, k] & ~ie[:, k]
    n_correct = cnt.sum()
    # the reference divides int64 counts in float32, as jax does without
    # x64 (int32 / int32 gives float32)
    ni, nl, nc = (v.to(torch.float32) for v in (n_infer, n_label, n_correct))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    prec = torch.where(n_infer > 0, nc / ni.clamp(min=1), zero)
    rec = torch.where(n_label > 0, nc / nl.clamp(min=1), zero)
    f1 = torch.where(n_correct > 0,
                     2 * prec * rec / (prec + rec).clamp(min=1e-12), zero)
    return {"Precision": [prec[None]], "Recall": [rec[None]],
            "F1-Score": [f1[None]], "NumInferChunks": [n_infer[None]],
            "NumLabelChunks": [n_label[None]],
            "NumCorrectChunks": [n_correct[None]]}


@register_op("ctc_greedy_decoder")
def _ctc_greedy_decoder(ctx, ins, attrs):
    """Greedy CTC decoding of Input (B, T, C) (optional InputLength):
    per-frame argmax, repeats merged, blanks dropped, the kept tokens
    moved left by a stable argsort; Out (B, T) padded with
    ``padding_value`` and OutLength (B, 1), both int64."""
    x = ins["Input"][0]
    blank = int(attrs["blank"])
    pad_val = attrs.get("padding_value", 0)
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    b, t, _ = x.shape
    if ins.get("InputLength"):
        lens = ins["InputLength"][0].long().reshape(-1)
    else:
        lens = torch.full((b,), t, dtype=torch.long, device=x.device)
    tok = torch.argmax(x, dim=-1)
    pos = torch.arange(t, device=x.device)[None, :]
    prev = torch.cat([torch.full((b, 1), -1, dtype=tok.dtype,
                                 device=x.device), tok[:, :-1]], dim=1)
    keep = (pos < lens[:, None]) & (tok != blank) & (tok != prev)
    order = stable_argsort(torch.where(keep, pos, t + pos), dim=1)
    n_keep = keep.long().sum(dim=1)
    out = torch.where(pos < n_keep[:, None], tok.gather(1, order), pad_val)
    return {"Out": [out[0] if squeeze else out],
            "OutLength": [n_keep[:, None]]}
