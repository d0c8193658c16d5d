"""Recurrent op lowerings: lstm, lstmp, gru, lstm_unit, gru_unit,
cudnn_lstm, beam_search, beam_search_decode.

Port of paddle_tpu/ops/rnn_ops.py (and ``gru_unit`` of its misc_ops.py).
The JAX package runs each recurrence as a lax.scan; here it is a Python
loop over the time axis whose step outputs are collected in a list and
stacked once, so autograd (``_run_training``'s tape) reaches through
every step and no buffer it saved is written. As in the reference, the
input projection x @ W_x (and its bias) is computed outside the loop
(``cudnn_lstm`` projects a whole layer with one product); only h @ W and
the gates run per step: ~10 kernel launches a step forward, ~50 with its
backward (a stacked-LSTM training step launched 9,284 kernels on the
card), so a long sequence is bound by the host's dispatch, not by the
card.

Sequences are dense-padded (B, T, 4D) with a (B,) ``SeqLen``: past a
row's length the state is held, so ``Hidden`` there repeats the row's
last state (it is not zero). ``is_reverse`` walks the whole padded axis
backward: the padding comes first, with the state held at H0. Gate
order is i, g (candidate), f, o for ``lstm``/``lstmp``. The ``lstm`` op
ignores the peephole columns of its (1, 7D) bias, as the reference's
does; ``lstmp`` applies them and its ``cell_clip``/``proj_clip``.
``cudnn_lstm`` returns LastH = LastC = Out[:, -1] whatever the lengths,
the reference's result kept for parity (ROADMAP.md Queue 3).
"""
import torch

from .registry import register_op
from .sequence_ops import _lens
from .tensor_ops import _jax_index

_ACTS = {"sigmoid": torch.sigmoid, "tanh": torch.tanh, "relu": torch.relu,
         "identity": lambda v: v}


def _steps(tsteps, is_reverse):
    return range(tsteps - 1, -1, -1) if is_reverse else range(tsteps)


def _stack(seq, is_reverse):
    """Step outputs in walk order -> (B, T, ...) in time order."""
    return torch.stack(seq[::-1] if is_reverse else seq, dim=1)


@register_op("lstm")
def _lstm(ctx, ins, attrs):
    """Single-layer LSTM over the (B, T, 4D) pre-projected input
    (ref lstm_op.cc): Weight is the recurrent (D, 4D); the bias's first 4D
    columns are added, the peephole columns are not read."""
    xproj = ins["Input"][0]
    w = ins["Weight"][0]
    d = w.shape[0]
    bsz, tsteps = xproj.shape[0], xproj.shape[1]
    lens = _lens(ins, xproj)
    h = ins["H0"][0] if ins.get("H0") else xproj.new_zeros((bsz, d))
    c = ins["C0"][0] if ins.get("C0") else xproj.new_zeros((bsz, d))
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACTS[attrs.get("cell_activation", "tanh")]
    cand_act = _ACTS[attrs.get("candidate_activation", "tanh")]
    is_reverse = attrs.get("is_reverse", False)
    if ins.get("Bias"):
        xproj = xproj + ins["Bias"][0].reshape(1, 1, -1)[:, :, :4 * d]
    hs, cs = [], []
    for t in _steps(tsteps, is_reverse):
        gates = xproj[:, t] + h @ w
        act = gate_act(gates)           # i, f and o of it are read
        c_new = act[:, 2 * d:3 * d] * c + act[:, :d] * cand_act(
            gates[:, d:2 * d])
        h_new = act[:, 3 * d:] * cell_act(c_new)
        live = (t < lens)[:, None]
        h = torch.where(live, h_new, h)
        c = torch.where(live, c_new, c)
        hs.append(h)
        cs.append(c)
    return {"Hidden": [_stack(hs, is_reverse)],
            "Cell": [_stack(cs, is_reverse)],
            "LastH": [h], "LastC": [c]}


@register_op("lstmp")
def _lstmp(ctx, ins, attrs):
    """Projected LSTM (ref lstmp_op.cc, Sak et al. 2014): the recurrent
    state is r = proj_act(h @ W_proj) (P wide), so the recurrent product
    is (P, 4D). Peephole weights are bias columns 4D:7D (i, f, o)."""
    xproj = ins["Input"][0]
    w = ins["Weight"][0]                # (P, 4D)
    w_proj = ins["ProjWeight"][0]       # (D, P)
    d, p = w_proj.shape
    bsz, tsteps = xproj.shape[0], xproj.shape[1]
    lens = _lens(ins, xproj)
    r = ins["H0"][0] if ins.get("H0") else xproj.new_zeros((bsz, p))
    c = ins["C0"][0] if ins.get("C0") else xproj.new_zeros((bsz, d))
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cell_act = _ACTS[attrs.get("cell_activation", "tanh")]
    cand_act = _ACTS[attrs.get("candidate_activation", "tanh")]
    proj_act = _ACTS[attrs.get("proj_activation", "tanh")]
    is_reverse = attrs.get("is_reverse", False)
    cell_clip = attrs.get("cell_clip")
    proj_clip = attrs.get("proj_clip")
    peep = None
    if ins.get("Bias"):
        b = ins["Bias"][0]
        xproj = xproj + b.reshape(1, 1, -1)[:, :, :4 * d]
        if attrs.get("use_peepholes", False) and b.shape[-1] >= 7 * d:
            peep = b.reshape(-1)[4 * d:7 * d]       # w_ic, w_fc, w_oc
    rs, cs = [], []
    for t in _steps(tsteps, is_reverse):
        gates = xproj[:, t] + r @ w
        gi, gf, go = gates[:, :d], gates[:, 2 * d:3 * d], gates[:, 3 * d:]
        if peep is not None:
            gi = gi + c * peep[:d]
            gf = gf + c * peep[d:2 * d]
        c_new = gate_act(gf) * c + gate_act(gi) * cand_act(
            gates[:, d:2 * d])
        if cell_clip is not None:
            c_new = c_new.clamp(-cell_clip, cell_clip)
        if peep is not None:
            go = go + c_new * peep[2 * d:]
        h_new = gate_act(go) * cell_act(c_new)
        r_new = proj_act(h_new @ w_proj)
        if proj_clip is not None:
            r_new = r_new.clamp(-proj_clip, proj_clip)
        live = (t < lens)[:, None]
        r = torch.where(live, r_new, r)
        c = torch.where(live, c_new, c)
        rs.append(r)
        cs.append(c)
    return {"Projection": [_stack(rs, is_reverse)],
            "Cell": [_stack(cs, is_reverse)]}


@register_op("gru")
def _gru(ctx, ins, attrs):
    """GRU over the (B, T, 3D) pre-projected input (ref gru_op.cc):
    u, r = act_g(x_ur + h @ W_ur); c = act(x_c + (r * h) @ W_c);
    h' = (1 - u) * h + u * c, or u * h + (1 - u) * c with origin_mode."""
    xproj = ins["Input"][0]
    w = ins["Weight"][0]                # (D, 3D)
    d = w.shape[0]
    bsz, tsteps = xproj.shape[0], xproj.shape[1]
    lens = _lens(ins, xproj)
    h = ins["H0"][0] if ins.get("H0") else xproj.new_zeros((bsz, d))
    gate_act = _ACTS[attrs.get("gate_activation", "sigmoid")]
    cand_act = _ACTS[attrs.get("activation", "tanh")]
    origin_mode = attrs.get("origin_mode", False)
    is_reverse = attrs.get("is_reverse", False)
    if ins.get("Bias"):
        xproj = xproj + ins["Bias"][0].reshape(1, 1, -1)
    w_ur, w_c = w[:, :2 * d], w[:, 2 * d:]
    hs = []
    for t in _steps(tsteps, is_reverse):
        xt = xproj[:, t]
        ru = gate_act(xt[:, :2 * d] + h @ w_ur)
        u, rr = ru[:, :d], ru[:, d:]
        c = cand_act(xt[:, 2 * d:] + (rr * h) @ w_c)
        h_new = u * h + (1 - u) * c if origin_mode else (1 - u) * h + u * c
        h = torch.where((t < lens)[:, None], h_new, h)
        hs.append(h)
    return {"Hidden": [_stack(hs, is_reverse)], "LastH": [h]}


@register_op("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    """One LSTM step (ref lstm_unit_op.cc) on X = [x, h] @ W + b, already
    projected to (B, 4D), gate order i, g, f, o."""
    gates = ins["X"][0]
    c_prev = ins["C_prev"][0]
    d = c_prev.shape[-1]
    i = torch.sigmoid(gates[:, :d])
    g = torch.tanh(gates[:, d:2 * d])
    f = torch.sigmoid(gates[:, 2 * d:3 * d] + attrs.get("forget_bias", 0.0))
    o = torch.sigmoid(gates[:, 3 * d:])
    c = f * c_prev + i * g
    return {"C": [c], "H": [o * torch.tanh(c)]}


@register_op("gru_unit")
def _gru_unit(ctx, ins, attrs):
    """One GRU step (ref gru_unit_op.cc). Input is the (B, 3D) projected
    input; Weight (D, 3D) holds the gates' weights in its first 2D
    columns and the candidate's in the last D. Gate is the gates' input
    before the activation, (B, 2D)."""
    x = ins["Input"][0]
    h_prev = ins["HiddenPrev"][0]
    w = ins["Weight"][0]
    d = h_prev.shape[-1]
    if ins.get("Bias"):
        x = x + ins["Bias"][0].reshape(1, 3 * d)
    gates = x[:, :2 * d] + h_prev @ w[:, :2 * d]
    gact = (torch.sigmoid if attrs.get("gate_activation", "sigmoid")
            == "sigmoid" else torch.tanh)
    cact = torch.tanh if attrs.get("activation", "tanh") == "tanh" \
        else torch.relu
    u = gact(gates[:, :d])
    r = gact(gates[:, d:2 * d])
    reset_h = r * h_prev
    c = cact(x[:, 2 * d:] + reset_h @ w[:, 2 * d:])
    if attrs.get("origin_mode", False):
        h = u * h_prev + (1 - u) * c
    else:
        h = (1 - u) * h_prev + u * c
    return {"Hidden": [h], "ResetHiddenPrev": [reset_h], "Gate": [gates]}


@register_op("cudnn_lstm")
def _cudnn_lstm(ctx, ins, attrs):
    """Multi-layer, optionally bidirectional LSTM (the role of the
    reference's cuDNN kernel): each layer's input projected by one
    product, then the ``lstm`` recurrence per direction, the directions'
    hidden states concatenated. LastH = LastC = Out[:, -1]."""
    x = ins["Input"][0]                 # (B, T, D_in)
    w_ih, w_hh = ins["WeightIh"], ins["WeightHh"]
    biases = ins.get("Bias", [])
    ndir = 2 if attrs.get("is_bidirec", False) else 1
    lens = _lens(ins, x)
    out = x
    for layer in range(attrs.get("num_layers", 1)):
        dir_outs = []
        for dr in range(ndir):
            idx = layer * ndir + dr
            proj = torch.matmul(out, w_ih[idx])
            if idx < len(biases):
                proj = proj + biases[idx].reshape(1, 1, -1)
            sub = _lstm(ctx, {"Input": [proj], "Weight": [w_hh[idx]],
                              "SeqLen": [lens]}, {"is_reverse": dr == 1})
            dir_outs.append(sub["Hidden"][0])
        out = torch.cat(dir_outs, dim=-1) if ndir == 2 else dir_outs[0]
    return {"Out": [out], "LastH": [out[:, -1]], "LastC": [out[:, -1]]}


@register_op("beam_search")
def _beam_search(ctx, ins, attrs):
    """One beam expansion (ref beam_search_op.cc) at static (B, beam):
    pre_ids/pre_scores (B*beam, 1), ids/scores (B*beam, K) candidates.
    A finished beam (pre_id == end_id) offers one candidate, (end_id,
    pre_score), and -1e30 elsewhere; the best beam of each row's
    beam*K candidates win, ties in index order. Ids and parent_idx are
    int64."""
    pre_ids = ins["pre_ids"][0].reshape(-1)
    pre_scores = ins["pre_scores"][0].reshape(-1)
    ids, scores = ins["ids"][0], ins["scores"][0]
    beam, end_id = attrs["beam_size"], attrs["end_id"]
    bb, k = scores.shape
    b = bb // beam
    finished = (pre_ids == end_id)[:, None]
    done = torch.cat([pre_scores[:, None],
                      scores.new_full((bb, k - 1), -1e30)], dim=1)
    scores = torch.where(finished, done, scores)
    ids = torch.where(finished, torch.full_like(ids, end_id), ids)
    flat = scores.reshape(b, beam * k)
    top, pos = torch.sort(flat, dim=-1, descending=True, stable=True)
    top, pos = top[:, :beam], pos[:, :beam]
    sel = torch.gather(ids.reshape(b, beam * k), 1, pos)
    parent = torch.div(pos, k, rounding_mode="floor") + torch.arange(
        b, device=pos.device)[:, None] * beam
    return {"selected_ids": [sel.reshape(-1, 1).to(torch.int64)],
            "selected_scores": [top.reshape(-1, 1)],
            "parent_idx": [parent.reshape(-1).to(torch.int64)]}


@register_op("beam_search_decode")
def _beam_search_decode(ctx, ins, attrs):
    """Backtrace beams into sequences (ref beam_search_decode_op.cc).
    Ids (T, B*beam, 1) per step; Parents (T, B*beam) global parent
    indices, the identity when absent. SentenceIds (B*beam, T) int64;
    SentenceScores the last step's scores."""
    ids = ins["Ids"][0]
    tsteps = ids.shape[0]
    ids2 = ids.reshape(tsteps, -1)
    bb = ids2.shape[1]
    cursor = torch.arange(bb, device=ids.device)
    parents = (ins["Parents"][0].reshape(tsteps, bb).long()
               if ins.get("Parents") else None)
    toks = []
    for t in range(tsteps - 1, -1, -1):
        toks.append(ids2[t][cursor])
        if parents is not None:
            cursor = _jax_index(parents[t][cursor], bb)
    seqs = torch.stack(toks[::-1], dim=1)
    return {"SentenceIds": [seqs.to(torch.int64)],
            "SentenceScores": [ins["Scores"][0].reshape(tsteps, -1)[-1]]}
