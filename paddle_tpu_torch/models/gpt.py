"""GPT-style decoder-only causal LM with KV-cache decode (port of
paddle_tpu/models/gpt.py: the training graph, the solo generator and the
continuous-batching decode programs).

Training and decoding share parameter names, so a trained scope drives
:func:`build_gpt_generate` and :class:`~paddle_tpu_torch.serving.DecodeEngine`
directly; the generator (``GPTDecodeCell`` under ``SamplingDecoder`` and
``dynamic_decode``) is the solo reference the engine's bit-exactness is
held to. :func:`build_gpt_decode_step_q` is the int8-resident step of
the disaggregated fleet's decode replicas. The delta prefill waits for
the prefix pool, the verify block for speculative decoding (ROADMAP.md
Queue 1 item 7.4), and ``tp_rules`` for the parallel slice (item 8).
"""
import numpy as np

from .. import fluid
from ..fluid import layers
from ..fluid.param_attr import ParamAttr

__all__ = ["GPTConfig", "gpt_tiny", "build_gpt_lm", "GPTDecodeCell",
           "SamplingDecoder", "build_gpt_generate", "build_gpt_prefill",
           "build_gpt_decode_step", "build_gpt_decode_step_q",
           "synthetic_lm_batch"]


class GPTConfig:
    def __init__(self, vocab=32000, hidden=768, num_layers=12, heads=12,
                 ffn=3072, max_len=1024, dropout=0.1):
        self.vocab = vocab
        self.hidden = hidden
        self.num_layers = num_layers
        self.heads = heads
        self.ffn = ffn
        self.max_len = max_len
        self.dropout = dropout


def gpt_tiny(vocab=211, max_len=64):
    return GPTConfig(vocab=vocab, hidden=32, num_layers=2, heads=2,
                     ffn=64, max_len=max_len, dropout=0.0)


def _p(name):
    return ParamAttr(name=name)


def _ln(x, name):
    return layers.layer_norm(x, begin_norm_axis=len(x.shape) - 1,
                             param_attr=_p(name + ".w"),
                             bias_attr=_p(name + ".b"))


def _proj(x, size, name, nfd=2):
    return layers.fc(x, size, num_flatten_dims=nfd,
                     param_attr=_p(name + ".w"), bias_attr=_p(name + ".b"))


def _attend(cfg, q, k, v, mask):
    from .decode_utils import attend

    return attend(q, k, v, mask, cfg.heads, cfg.hidden)


def _block_kv(x, cfg, i, mask, is_test):
    """One transformer block exposing its k/v projections — the prefill
    program captures them as the slot's KV cache. Op order matches
    :func:`_block` exactly (q, k, v projections in that order), so the
    factoring cannot perturb trained-weight numerics."""
    n = "gpt%d" % i
    q = _proj(x, cfg.hidden, n + ".self.q")
    k = _proj(x, cfg.hidden, n + ".self.k")
    v = _proj(x, cfg.hidden, n + ".self.v")
    attn = _proj(_attend(cfg, q, k, v, mask), cfg.hidden, n + ".self.o")
    if cfg.dropout and not is_test:
        attn = layers.dropout(attn, dropout_prob=cfg.dropout)
    x = _ln(layers.elementwise_add(x, attn), n + ".ln1")
    h = _proj(x, cfg.ffn, n + ".ffn.fc1")
    h = layers.gelu(h)
    h = _proj(h, cfg.hidden, n + ".ffn.fc2")
    if cfg.dropout and not is_test:
        h = layers.dropout(h, dropout_prob=cfg.dropout)
    return _ln(layers.elementwise_add(x, h), n + ".ln2"), k, v


def _block(x, cfg, i, mask, is_test):
    return _block_kv(x, cfg, i, mask, is_test)[0]


def _embed(ids, cfg, seq_len):
    """Token + learned position embeddings -> (B, T, H)."""
    tok = layers.embedding(ids, size=[cfg.vocab, cfg.hidden],
                           param_attr=_p("gpt_tok_emb"))
    tok = layers.reshape(tok, [-1, seq_len, cfg.hidden])
    pos_table = layers.create_parameter(
        shape=[cfg.max_len, cfg.hidden], dtype="float32",
        name="gpt_pos_emb")
    pos = layers.slice(pos_table, axes=[0], starts=[0], ends=[seq_len])
    return layers.elementwise_add(tok, layers.unsqueeze(pos, [0]))


def build_gpt_lm(cfg, seq_len, is_test=False):
    """Next-token LM training graph: feeds gpt_ids (B, T) and
    gpt_labels (B, T); loss is the mean causal cross-entropy."""
    ids = fluid.data("gpt_ids", shape=[None, seq_len], dtype="int64")
    labels = fluid.data("gpt_labels", shape=[None, seq_len],
                        dtype="int64")
    x = _embed(ids, cfg, seq_len)
    # causal visibility: position t sees <= t
    steps = layers.range(0, seq_len, 1, "int64")
    seen = layers.cast(
        layers.less_equal(layers.unsqueeze(steps, [0]),
                          layers.unsqueeze(steps, [1])), "float32")
    mask = layers.scale(seen, scale=1e9, bias=-1e9)      # (T, T)
    mask = layers.unsqueeze(mask, [0, 1])                # (1, 1, T, T)
    for i in range(cfg.num_layers):
        x = _block(x, cfg, i, mask, is_test)
    logits = _proj(x, cfg.vocab, "gpt_out")              # (B, T, V)
    flat = layers.reshape(logits, [-1, cfg.vocab])
    loss = layers.mean(layers.softmax_with_cross_entropy(
        flat, layers.reshape(labels, [-1, 1])))
    return {"ids": ids, "labels": labels, "logits": logits,
            "loss": loss}


class GPTDecodeCell:
    """One incremental decode step with per-layer KV caches (the
    decoder-only sibling of transformer_nmt.TransformerDecodeCell).

    States: ``[pos (B,1) int64, k0, v0, k1, v1, ...]`` with each cache
    (B, tmax, hidden). Parameter names match build_gpt_lm, so trained
    weights generate directly."""

    def __init__(self, cfg, tmax):
        self.cfg = cfg
        self.tmax = tmax

    def call(self, inputs, states):
        from .decode_utils import step_masks, update_cache

        cfg = self.cfg
        h = cfg.hidden
        pos, caches = states[0], states[1:]
        pos_table = layers.create_parameter(
            shape=[cfg.max_len, h], dtype="float32", name="gpt_pos_emb")
        x = layers.elementwise_add(
            inputs, layers.gather_nd(pos_table, pos))    # (B, H)
        x = layers.unsqueeze(x, [1])                      # (B, 1, H)

        # the write masks are unused on the pos fast path (the JAX package
        # builds them too, so the Programs stay the same)
        _w3, _k3, self_mask = step_masks(pos, self.tmax)

        new_caches = []
        for i in range(cfg.num_layers):
            n = "gpt%d" % i
            q = _proj(x, h, n + ".self.q")
            k_cache = update_cache(caches[2 * i],
                                   _proj(x, h, n + ".self.k"),
                                   pos=pos)
            v_cache = update_cache(caches[2 * i + 1],
                                   _proj(x, h, n + ".self.v"),
                                   pos=pos)
            new_caches += [k_cache, v_cache]
            attn = _proj(_attend(cfg, q, k_cache, v_cache, self_mask),
                         h, n + ".self.o")
            x = _ln(layers.elementwise_add(x, attn), n + ".ln1")
            f = _proj(x, cfg.ffn, n + ".ffn.fc1")
            f = layers.gelu(f)
            f = _proj(f, h, n + ".ffn.fc2")
            x = _ln(layers.elementwise_add(x, f), n + ".ln2")

        logits = _proj(layers.squeeze(x, [1]), cfg.vocab, "gpt_out",
                       nfd=1)
        one = layers.fill_constant([1], "int64", 1)
        return logits, [layers.elementwise_add(pos, one)] + new_caches

    def __call__(self, inputs, states, **kwargs):
        return self.call(inputs, states)


class SamplingDecoder(layers.Decoder):
    """Greedy / top-k sampling generation with prompt teacher-forcing.

    Step t consumes the token at position t and emits the token chosen
    for position t+1; while t+1 is still inside the prompt the choice
    is overridden by the prompt token, so caches are prefilled within
    the SAME scan that generates (no separate prefill program)."""

    def __init__(self, cell, prompt, prompt_len, mode="greedy",
                 topk=10, temperature=1.0):
        if mode not in ("greedy", "topk"):
            raise ValueError("mode must be 'greedy' or 'topk'")
        self.cell = cell
        self.prompt = prompt          # (B, prompt_len) int64
        self.prompt_len = int(prompt_len)
        self.mode = mode
        self.topk = int(topk)
        self.temperature = float(temperature)
        cfg = cell.cfg
        self._embed = lambda ids: layers.reshape(
            layers.embedding(ids, size=[cfg.vocab, cfg.hidden],
                             param_attr=_p("gpt_tok_emb")),
            [-1, cfg.hidden])
        # (plen, B): per-step gather of the forced token by time index
        self._prompt_t = layers.transpose(prompt, [1, 0])

    def _prompt_tok(self, idx):
        """Prompt column ``idx`` (clipped) as (B, 1) int64."""
        last = layers.fill_constant([1], "int64", self.prompt_len - 1)
        idx = layers.elementwise_min(idx, last)
        col = layers.gather(self._prompt_t, idx)          # (1, B)
        return layers.transpose(col, [1, 0])              # (B, 1)

    def initialize(self, inits):
        first = self._prompt_tok(layers.fill_constant([1], "int64", 0))
        finished = layers.cast(
            layers.zeros_like(layers.cast(first, "float32")), "bool")
        return self._embed(first), inits, finished

    def step(self, time, inputs, states, **kwargs):
        logits, next_states = self.cell(inputs, states)   # (B, V)
        if self.mode == "greedy":
            chosen = layers.unsqueeze(
                layers.argmax(logits, axis=-1), [1])      # (B, 1)
        else:
            vals, idx = layers.topk(logits, k=self.topk)
            probs = layers.softmax(
                layers.scale(vals, scale=1.0 / self.temperature))
            j = layers.sampling_id(probs)                 # (B,)
            j2 = layers.unsqueeze(layers.cast(j, "int64"), [1])
            chosen = layers.cast(_gather_rowwise(idx, j2), "int64")
        chosen = layers.cast(chosen, "int64")
        # teacher-force while t+1 is still a prompt position
        one = layers.fill_constant([1], "int64", 1)
        nxt = layers.elementwise_add(time, one)           # (1,)
        plen = layers.fill_constant([1], "int64", self.prompt_len)
        forced = layers.cast(layers.less_than(nxt, plen), "int64")
        tok = layers.elementwise_add(
            layers.elementwise_mul(self._prompt_tok(nxt), forced),
            layers.elementwise_mul(
                chosen, layers.elementwise_sub(one, forced)))
        finished = layers.cast(
            layers.zeros_like(layers.cast(tok, "float32")), "bool")
        return tok, next_states, self._embed(tok), finished


def _gather_rowwise(x, j):
    """x (B, K), j (B, 1) int64 -> x[b, j[b]] as (B, 1)."""
    ones = layers.fill_constant_batch_size_like(
        input=j, shape=[-1, 1], dtype="float32", value=1.0)
    rows = layers.cast(
        layers.cumsum(ones, axis=0, exclusive=True), "int64")
    coords = layers.concat([rows, j], axis=1)             # (B, 2)
    return layers.unsqueeze(layers.gather_nd(x, coords), [1])


def build_gpt_generate(cfg, prompt_len, max_new, mode="greedy",
                       topk=10, temperature=1.0):
    """Fixed-length generation graph. Feeds gpt_prompt (B, prompt_len);
    returns ids (B, prompt_len + max_new - 1): positions 1..plen-1 echo
    the prompt (teacher-forced), the rest are generated."""
    tmax = prompt_len + max_new
    if tmax > cfg.max_len:
        raise ValueError("prompt_len + max_new (%d) exceeds cfg.max_len "
                         "(%d)" % (tmax, cfg.max_len))
    prompt = fluid.data("gpt_prompt", shape=[None, prompt_len],
                        dtype="int64")
    cell = GPTDecodeCell(cfg, tmax)
    decoder = SamplingDecoder(cell, prompt, prompt_len, mode=mode,
                              topk=topk, temperature=temperature)
    pos0 = layers.fill_constant_batch_size_like(
        prompt, shape=[-1, 1], dtype="int64", value=0)
    inits = [pos0]
    for _ in range(cfg.num_layers):
        for _ in ("k", "v"):
            inits.append(layers.fill_constant_batch_size_like(
                prompt, shape=[-1, tmax, cfg.hidden], dtype="float32",
                value=0.0))
    ids, _ = layers.dynamic_decode(
        decoder, inits=inits, max_step_num=prompt_len + max_new - 2)
    ids = layers.squeeze(ids, [2])                        # (B, steps)
    return {"prompt": prompt, "ids": ids}


def _row_coords(col):
    """(B, 1) int64 column indices -> (B, 2) gather_nd coords
    ``[row, col]`` (row = 0..B-1 via the cumsum trick)."""
    ones = layers.fill_constant_batch_size_like(
        input=col, shape=[-1, 1], dtype="float32", value=1.0)
    rows = layers.cast(
        layers.cumsum(ones, axis=0, exclusive=True), "int64")
    return layers.concat([rows, col], axis=1)


def build_gpt_prefill(cfg, prompt_len, cache_len):
    """Slot-prefill program for continuous-batching decode: one parallel
    pass over a (right-padded) prompt bucket that writes a slot's KV
    cache and emits the first generated token.

    Feeds ``gpt_prefill_ids`` (B, prompt_len) int64 — prompts right-
    padded to the bucket with any token — and ``gpt_prefill_len``
    (B, 1) int64, the real lengths. The batch dim is a *slot* dim:
    every row is an independent sequence. Padded positions are causally
    invisible to real ones and their k/v rows are zeroed, so the cache
    leaving this program is bit-identical to feeding the prompt through
    the incremental decoder one token at a time (what
    the reference's ``build_gpt_generate`` teacher-forced scan does).

    Returns vars: ``ids``/``len`` feeds, ``next`` (B, 1) int64 — the
    greedy token for position ``len`` — plus ``k``/``v``
    (B, num_layers, cache_len, hidden) slot caches (positions >=
    ``len`` are zero; the decode step writes them one per step).
    """
    if not (1 <= prompt_len <= cache_len):
        raise ValueError(
            "need 1 <= prompt_len (%d) <= cache_len (%d)"
            % (prompt_len, cache_len))
    if cache_len > cfg.max_len:
        raise ValueError("cache_len (%d) exceeds cfg.max_len (%d)"
                         % (cache_len, cfg.max_len))
    ids = fluid.data("gpt_prefill_ids", shape=[None, prompt_len],
                     dtype="int64")
    plen = fluid.data("gpt_prefill_len", shape=[None, 1], dtype="int64")
    x = _embed(ids, cfg, prompt_len)
    steps = layers.range(0, prompt_len, 1, "int64")
    steps0 = layers.unsqueeze(steps, [0])                 # (1, P)
    seen = layers.cast(
        layers.less_equal(steps0,
                          layers.unsqueeze(steps, [1])), "float32")
    mask = layers.scale(seen, scale=1e9, bias=-1e9)       # (P, P)
    mask = layers.unsqueeze(mask, [0, 1])                 # (1, 1, P, P)
    # rows >= len are pad: zero their k/v so the cache handed to the
    # step program matches the incremental fill (zeros beyond pos)
    valid = layers.cast(layers.less_than(steps0, plen), "float32")
    valid3 = layers.unsqueeze(valid, [2])                 # (B, P, 1)
    ks, vs = [], []
    for i in range(cfg.num_layers):
        x, k, v = _block_kv(x, cfg, i, mask, is_test=True)
        ks.append(layers.elementwise_mul(k, valid3))
        vs.append(layers.elementwise_mul(v, valid3))
    if cache_len > prompt_len:
        pad = layers.fill_constant_batch_size_like(
            ids, shape=[-1, cache_len - prompt_len, cfg.hidden],
            dtype="float32", value=0.0)
        ks = [layers.concat([k, pad], axis=1) for k in ks]
        vs = [layers.concat([v, pad], axis=1) for v in vs]
    k_cache = layers.stack(ks, axis=1)   # (B, L, cache_len, H)
    v_cache = layers.stack(vs, axis=1)
    one = layers.fill_constant([1], "int64", 1)
    last = layers.elementwise_sub(plen, one)              # (B, 1)
    x_last = layers.gather_nd(x, _row_coords(last))       # (B, H)
    logits = _proj(x_last, cfg.vocab, "gpt_out", nfd=1)
    nxt = layers.cast(
        layers.unsqueeze(layers.argmax(logits, axis=-1), [1]), "int64")
    return {"ids": ids, "len": plen, "next": nxt, "logits": logits,
            "k": k_cache, "v": v_cache,
            "feed_names": ["gpt_prefill_ids", "gpt_prefill_len"],
            "fetch_vars": [nxt, k_cache, v_cache]}


def build_gpt_decode_step(cfg, cache_len):
    """One decode step for ALL slots of a continuous-batching engine:
    the reference's ``GPTDecodeCell`` math with the batch dim reinterpreted as
    a slot dim — every row carries its OWN position (a freshly
    prefilled slot at ``len`` sits beside one deep into generation), so
    cache writes use the per-row dynamic-update-slice path and the
    visibility mask is per-row.

    Feeds: ``gpt_step_tok`` (S, 1) int64 current token per slot,
    ``gpt_step_pos`` (S, 1) int64 write position per slot, and the
    stacked cache pair ``gpt_step_k`` / ``gpt_step_v``
    (S, num_layers, cache_len, hidden). Returns vars ``next`` (S, 1)
    int64 greedy tokens and the updated ``k``/``v`` pair (the engine
    round-trips them device-to-device; dead slots write harmlessly at
    position 0 and are ignored host-side).
    """
    from .decode_utils import step_masks, update_cache

    if cache_len > cfg.max_len:
        raise ValueError("cache_len (%d) exceeds cfg.max_len (%d)"
                         % (cache_len, cfg.max_len))
    h = cfg.hidden
    nl = cfg.num_layers
    tok = fluid.data("gpt_step_tok", shape=[None, 1], dtype="int64")
    pos = fluid.data("gpt_step_pos", shape=[None, 1], dtype="int64")
    k_all = fluid.data("gpt_step_k", shape=[None, nl, cache_len, h],
                       dtype="float32")
    v_all = fluid.data("gpt_step_v", shape=[None, nl, cache_len, h],
                       dtype="float32")
    emb = layers.reshape(
        layers.embedding(tok, size=[cfg.vocab, h],
                         param_attr=_p("gpt_tok_emb")), [-1, h])
    pos_table = layers.create_parameter(
        shape=[cfg.max_len, h], dtype="float32", name="gpt_pos_emb")
    x = layers.elementwise_add(emb, layers.gather_nd(pos_table, pos))
    x = layers.unsqueeze(x, [1])                          # (S, 1, H)
    _w3, _k3, self_mask = step_masks(pos, cache_len)      # per-row mask

    def layer_cache(t, i):
        return layers.squeeze(
            layers.slice(t, axes=[1], starts=[i], ends=[i + 1]), [1])

    new_ks, new_vs = [], []
    for i in range(nl):
        n = "gpt%d" % i
        q = _proj(x, h, n + ".self.q")
        k_cache = update_cache(layer_cache(k_all, i),
                               _proj(x, h, n + ".self.k"),
                               pos=pos, per_row=True)
        v_cache = update_cache(layer_cache(v_all, i),
                               _proj(x, h, n + ".self.v"),
                               pos=pos, per_row=True)
        new_ks.append(k_cache)
        new_vs.append(v_cache)
        attn = _proj(_attend(cfg, q, k_cache, v_cache, self_mask),
                     h, n + ".self.o")
        x = _ln(layers.elementwise_add(x, attn), n + ".ln1")
        f = _proj(x, cfg.ffn, n + ".ffn.fc1")
        f = layers.gelu(f)
        f = _proj(f, h, n + ".ffn.fc2")
        x = _ln(layers.elementwise_add(x, f), n + ".ln2")
    logits = _proj(layers.squeeze(x, [1]), cfg.vocab, "gpt_out", nfd=1)
    nxt = layers.cast(
        layers.unsqueeze(layers.argmax(logits, axis=-1), [1]), "int64")
    k_out = layers.stack(new_ks, axis=1)                  # (S, L, T, H)
    v_out = layers.stack(new_vs, axis=1)
    return {"tok": tok, "pos": pos, "k_in": k_all, "v_in": v_all,
            "next": nxt, "logits": logits, "k": k_out, "v": v_out,
            "feed_names": ["gpt_step_tok", "gpt_step_pos",
                           "gpt_step_k", "gpt_step_v"],
            "fetch_vars": [nxt, k_out, v_out]}


def _quantize_cache_rows(t):
    """In-graph per-(slot, layer, row) block-scaled int8 encode of a
    (S, L, T, H) fp32 cache: block = hidden width, matching
    serving.disagg.kv_wire. Returns (payload int8, scales fp32 with the
    hidden axis collapsed to 1). The 1e-30 clamp keeps all-zero rows
    (unwritten cache positions) at scale 1e-30 / payload 0, and rows
    decoded from an existing (payload, scale) re-encode identically
    (max |element| is exactly 127 * scale), so requantizing the whole
    cache every step does not compound error on unwritten rows."""
    amax = layers.reduce_max(layers.abs(t), dim=3, keep_dim=True)
    scale = layers.scale(layers.clip(amax, 1e-30, 3.0e38),
                         scale=1.0 / 127.0)
    q = layers.round(layers.elementwise_div(t, scale))
    payload = layers.cast(layers.clip(q, -127.0, 127.0), "int8")
    return payload, scale


def build_gpt_decode_step_q(cfg, cache_len):
    """:func:`build_gpt_decode_step` with an int8-**resident** KV
    cache: the engine keeps (payload int8, per-row fp32 scale) buffers
    instead of fp32 caches — ~4x more decode slots per card at equal
    device memory — and this program dequantizes on entry and requantizes the
    updated caches before returning them.

    Extra feeds beyond the fp32 step: ``gpt_step_kscale`` /
    ``gpt_step_vscale`` (S, num_layers, cache_len, 1) fp32, with
    ``gpt_step_k`` / ``gpt_step_v`` now int8. Fetches next tokens plus
    the requantized (k, v, k_scale, v_scale) quadruple. Compute after
    dequantize is identical op-for-op to the fp32 step, so the only
    numeric delta is the per-row int8 rounding (bounded by scale/2 per
    element — the round-trip tolerance the kv_wire tests pin).
    """
    from .decode_utils import step_masks, update_cache

    if cache_len > cfg.max_len:
        raise ValueError("cache_len (%d) exceeds cfg.max_len (%d)"
                         % (cache_len, cfg.max_len))
    h = cfg.hidden
    nl = cfg.num_layers
    tok = fluid.data("gpt_step_tok", shape=[None, 1], dtype="int64")
    pos = fluid.data("gpt_step_pos", shape=[None, 1], dtype="int64")
    k_all = fluid.data("gpt_step_k", shape=[None, nl, cache_len, h],
                       dtype="int8")
    v_all = fluid.data("gpt_step_v", shape=[None, nl, cache_len, h],
                       dtype="int8")
    k_sc = fluid.data("gpt_step_kscale", shape=[None, nl, cache_len, 1],
                      dtype="float32")
    v_sc = fluid.data("gpt_step_vscale", shape=[None, nl, cache_len, 1],
                      dtype="float32")
    k_f = layers.elementwise_mul(layers.cast(k_all, "float32"), k_sc)
    v_f = layers.elementwise_mul(layers.cast(v_all, "float32"), v_sc)
    emb = layers.reshape(
        layers.embedding(tok, size=[cfg.vocab, h],
                         param_attr=_p("gpt_tok_emb")), [-1, h])
    pos_table = layers.create_parameter(
        shape=[cfg.max_len, h], dtype="float32", name="gpt_pos_emb")
    x = layers.elementwise_add(emb, layers.gather_nd(pos_table, pos))
    x = layers.unsqueeze(x, [1])                          # (S, 1, H)
    _w3, _k3, self_mask = step_masks(pos, cache_len)      # per-row mask

    def layer_cache(t, i):
        return layers.squeeze(
            layers.slice(t, axes=[1], starts=[i], ends=[i + 1]), [1])

    new_ks, new_vs = [], []
    for i in range(nl):
        n = "gpt%d" % i
        q = _proj(x, h, n + ".self.q")
        k_cache = update_cache(layer_cache(k_f, i),
                               _proj(x, h, n + ".self.k"),
                               pos=pos, per_row=True)
        v_cache = update_cache(layer_cache(v_f, i),
                               _proj(x, h, n + ".self.v"),
                               pos=pos, per_row=True)
        new_ks.append(k_cache)
        new_vs.append(v_cache)
        attn = _proj(_attend(cfg, q, k_cache, v_cache, self_mask),
                     h, n + ".self.o")
        x = _ln(layers.elementwise_add(x, attn), n + ".ln1")
        f = _proj(x, cfg.ffn, n + ".ffn.fc1")
        f = layers.gelu(f)
        f = _proj(f, h, n + ".ffn.fc2")
        x = _ln(layers.elementwise_add(x, f), n + ".ln2")
    logits = _proj(layers.squeeze(x, [1]), cfg.vocab, "gpt_out", nfd=1)
    nxt = layers.cast(
        layers.unsqueeze(layers.argmax(logits, axis=-1), [1]), "int64")
    k_q, k_s = _quantize_cache_rows(layers.stack(new_ks, axis=1))
    v_q, v_s = _quantize_cache_rows(layers.stack(new_vs, axis=1))
    return {"tok": tok, "pos": pos, "k_in": k_all, "v_in": v_all,
            "k_scale_in": k_sc, "v_scale_in": v_sc,
            "next": nxt, "logits": logits, "k": k_q, "v": v_q,
            "k_scale": k_s, "v_scale": v_s,
            "feed_names": ["gpt_step_tok", "gpt_step_pos",
                           "gpt_step_k", "gpt_step_v",
                           "gpt_step_kscale", "gpt_step_vscale"],
            "fetch_vars": [nxt, k_q, v_q, k_s, v_s]}


def synthetic_lm_batch(cfg, batch, seq_len, seed=0):
    """Deterministic next-token task: x[t+1] = (x[t] * 3 + 1) % vocab —
    fully learnable by a causal LM, random start tokens."""
    rng = np.random.default_rng(seed)
    x = np.zeros((batch, seq_len + 1), np.int64)
    x[:, 0] = rng.integers(1, cfg.vocab, batch)
    for t in range(seq_len):
        x[:, t + 1] = (x[:, t] * 3 + 1) % cfg.vocab
    return x[:, :seq_len], x[:, 1:seq_len + 1]
