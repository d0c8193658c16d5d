"""Transformer NMT seq2seq (port of paddle_tpu/models/transformer_nmt.py;
parity target: BASELINE.json "Transformer NMT seq2seq (variable-length
LoDTensor, beam_search ops)"; structure per the reference's
machine-translation book example).

Dense-padded source/target + @SEQ_LEN lengths stand in for LoDTensors.
Beam-search translation runs ``dynamic_decode`` with
``BeamSearchDecoder`` over a KV-cache decoder cell: one static_rnn op
whose step block the port runs once per output position. Both programs
build the same Program JSON as the JAX package's.
"""
import numpy as np

from .. import fluid
from ..fluid import layers
from ..fluid.param_attr import ParamAttr

__all__ = ["NMTConfig", "build_transformer_nmt", "synthetic_pair_batch",
           "TransformerDecodeCell", "build_transformer_beam_decode"]


class NMTConfig:
    def __init__(self, src_vocab=10000, tgt_vocab=10000, hidden=256,
                 heads=8, ffn=1024, enc_layers=4, dec_layers=4,
                 max_len=64, dropout=0.1, bos_id=0, eos_id=1, pad_id=2):
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab
        self.hidden = hidden
        self.heads = heads
        self.ffn = ffn
        self.enc_layers = enc_layers
        self.dec_layers = dec_layers
        self.max_len = max_len
        self.dropout = dropout
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id  # loss masking target; distinct from eos so
        # the model IS trained to emit end-of-sequence


def _mha(q_in, kv_in, cfg, name, mask=None):
    h, nh = cfg.hidden, cfg.heads
    dh = h // nh
    q = layers.fc(q_in, h, num_flatten_dims=2,
                  param_attr=ParamAttr(name=name + ".q.w"),
                  bias_attr=ParamAttr(name=name + ".q.b"))
    k = layers.fc(kv_in, h, num_flatten_dims=2,
                  param_attr=ParamAttr(name=name + ".k.w"),
                  bias_attr=ParamAttr(name=name + ".k.b"))
    v = layers.fc(kv_in, h, num_flatten_dims=2,
                  param_attr=ParamAttr(name=name + ".v.w"),
                  bias_attr=ParamAttr(name=name + ".v.b"))

    def split_heads(t):
        t = layers.reshape(t, [0, 0, nh, dh])
        return layers.transpose(t, [0, 2, 1, 3])

    qh, kh, vh = split_heads(q), split_heads(k), split_heads(v)
    scores = layers.matmul(qh, kh, transpose_y=True, alpha=dh ** -0.5)
    if mask is not None:
        scores = layers.elementwise_add(scores, mask)
    probs = layers.softmax(scores)
    ctx = layers.matmul(probs, vh)
    ctx = layers.transpose(ctx, [0, 2, 1, 3])
    ctx = layers.reshape(ctx, [0, 0, h])
    return layers.fc(ctx, h, num_flatten_dims=2,
                     param_attr=ParamAttr(name=name + ".o.w"),
                     bias_attr=ParamAttr(name=name + ".o.b"))


def _ffn(x, cfg, name):
    f = layers.fc(x, cfg.ffn, num_flatten_dims=2, act="relu",
                  param_attr=ParamAttr(name=name + ".f1.w"),
                  bias_attr=ParamAttr(name=name + ".f1.b"))
    return layers.fc(f, cfg.hidden, num_flatten_dims=2,
                     param_attr=ParamAttr(name=name + ".f2.w"),
                     bias_attr=ParamAttr(name=name + ".f2.b"))


def _ln(x, name):
    return layers.layer_norm(x, begin_norm_axis=2,
                             param_attr=ParamAttr(name=name + ".w"),
                             bias_attr=ParamAttr(name=name + ".b"))


def _embed(ids, vocab, cfg, name, seq_len):
    emb = layers.embedding(ids, size=[vocab, cfg.hidden],
                           param_attr=ParamAttr(name=name))
    pos = layers.create_parameter(
        shape=[cfg.max_len, cfg.hidden], dtype="float32",
        name=name + ".pos",
    )
    pos_slice = layers.slice(pos, axes=[0], starts=[0], ends=[seq_len])
    return layers.elementwise_add(emb, layers.unsqueeze(pos_slice, [0]))


def _causal_mask(t):
    """(1, 1, t, t) additive causal mask built from ops."""
    ar = layers.range(0, t, 1, "float32")
    rows = layers.unsqueeze(ar, [1])
    cols = layers.unsqueeze(ar, [0])
    allow = layers.cast(
        layers.greater_equal(
            layers.expand(rows, [1, t]), layers.expand(cols, [t, 1])
        ),
        "float32",
    )
    neg = layers.scale(allow, scale=1e9, bias=-1e9)  # 0 where allowed, -1e9 else
    return layers.unsqueeze(neg, [0, 1])


def _encoder_stack(enc, cfg):
    for i in range(cfg.enc_layers):
        n = "enc%d" % i
        enc = _ln(layers.elementwise_add(
            enc, _mha(enc, enc, cfg, n + ".self")), n + ".ln1")
        enc = _ln(layers.elementwise_add(enc, _ffn(enc, cfg, n)), n + ".ln2")
    return enc


def build_transformer_nmt(cfg, src_len, tgt_len):
    src = fluid.data(name="src_ids", shape=[None, src_len], dtype="int64",
                     lod_level=1)
    tgt = fluid.data(name="tgt_ids", shape=[None, tgt_len], dtype="int64",
                     lod_level=1)
    labels = fluid.data(name="tgt_labels", shape=[None, tgt_len],
                        dtype="int64")

    enc = _encoder_stack(
        _embed(src, cfg.src_vocab, cfg, "src_emb", src_len), cfg)

    dec = _embed(tgt, cfg.tgt_vocab, cfg, "tgt_emb", tgt_len)
    cmask = _causal_mask(tgt_len)
    for i in range(cfg.dec_layers):
        n = "dec%d" % i
        dec = _ln(layers.elementwise_add(
            dec, _mha(dec, dec, cfg, n + ".self", mask=cmask)), n + ".ln1")
        dec = _ln(layers.elementwise_add(
            dec, _mha(dec, enc, cfg, n + ".cross")), n + ".ln2")
        dec = _ln(layers.elementwise_add(dec, _ffn(dec, cfg, n)), n + ".ln3")

    logits = layers.fc(dec, cfg.tgt_vocab, num_flatten_dims=2,
                       param_attr=ParamAttr(name="out_proj.w"),
                       bias_attr=ParamAttr(name="out_proj.b"))
    loss = layers.mean(
        layers.softmax_with_cross_entropy(
            logits, layers.unsqueeze(labels, [2]), ignore_index=cfg.pad_id
        )
    )
    return {
        "src_ids": src, "tgt_ids": tgt, "tgt_labels": labels,
        "logits": logits, "loss": loss, "enc_out": enc,
    }


class TransformerDecodeCell:
    """Incremental transformer decoder step with per-layer KV caches, in
    place of the reference's while_op `fast_decode` (ref: transformer book
    example / layers/rnn.py beam search ops).

    One step costs a 1-token QKV projection + attention over the cache
    (static `tmax` length, masked beyond `pos`) + FFN, instead of
    re-running the whole prefix. All shapes are static, so the decode
    loop is one static_rnn op; beam bookkeeping (top-k, state gather by
    parent beam) is BeamSearchDecoder's.

    States: ``[pos (B,1) int64, k0, v0, k1, v1, ...]`` with each cache
    (B, tmax, hidden). Parameter names match ``build_transformer_nmt``'s
    decoder so trained weights load directly.
    """

    def __init__(self, cfg, tmax):
        self.cfg = cfg
        self.tmax = tmax

    def _attend(self, q, k, v, mask):
        """q (B,1,H), k/v (B,T,H), additive mask broadcastable to
        (B,nh,1,T) -> context (B,1,H)."""
        from .decode_utils import attend

        return attend(q, k, v, mask, self.cfg.heads, self.cfg.hidden)

    def call(self, inputs, states, enc_kv=None):
        from .decode_utils import step_masks, update_cache

        cfg = self.cfg
        h = cfg.hidden
        pos, caches = states[0], states[1:]
        pos_table = layers.create_parameter(
            shape=[cfg.max_len, h], dtype="float32", name="tgt_emb.pos")
        x = layers.elementwise_add(
            inputs, layers.gather_nd(pos_table, pos))      # (B, H)
        x = layers.unsqueeze(x, [1])                        # (B, 1, H)

        # cache-write one-hot and <=pos visibility mask, shared by layers
        # the write masks are unused on the pos fast path (the JAX package
        # builds them too, so the Programs stay the same)
        _w3, _k3, self_mask = step_masks(pos, self.tmax)

        def proj(t, name):
            return layers.fc(t, h, num_flatten_dims=2,
                             param_attr=ParamAttr(name=name + ".w"),
                             bias_attr=ParamAttr(name=name + ".b"))

        new_caches = []
        for i in range(cfg.dec_layers):
            n = "dec%d" % i
            q = proj(x, n + ".self.q")
            k_cache = update_cache(caches[2 * i],
                                   proj(x, n + ".self.k"),
                                   pos=pos)
            v_cache = update_cache(caches[2 * i + 1],
                                   proj(x, n + ".self.v"),
                                   pos=pos)
            new_caches += [k_cache, v_cache]
            attn = proj(self._attend(q, k_cache, v_cache, self_mask),
                        n + ".self.o")
            x = _ln(layers.elementwise_add(x, attn), n + ".ln1")
            ek, ev = enc_kv[i]
            cross = proj(
                self._attend(proj(x, n + ".cross.q"), ek, ev, None),
                n + ".cross.o")
            x = _ln(layers.elementwise_add(x, cross), n + ".ln2")
            x = _ln(layers.elementwise_add(x, _ffn(x, cfg, n)), n + ".ln3")

        logits = layers.fc(layers.squeeze(x, [1]), cfg.tgt_vocab,
                           param_attr=ParamAttr(name="out_proj.w"),
                           bias_attr=ParamAttr(name="out_proj.b"))
        one = layers.fill_constant([1], "int64", 1)
        new_pos = layers.elementwise_add(pos, one)
        return logits, [new_pos] + new_caches

    def __call__(self, inputs, states, **kwargs):
        return self.call(inputs, states, **kwargs)


def build_transformer_beam_decode(cfg, src_len, max_out_len, beam_size):
    """Beam-search translation graph: encoder + KV-cache incremental
    decoder under dynamic_decode/BeamSearchDecoder (static beam, one
    static_rnn op). Returns predicted ids (B, T_out, beam) and beam
    scores."""
    src = fluid.data(name="src_ids", shape=[None, src_len], dtype="int64",
                     lod_level=1)
    enc = _encoder_stack(
        _embed(src, cfg.src_vocab, cfg, "src_emb", src_len), cfg)

    cell = TransformerDecodeCell(cfg, max_out_len)

    def embed_tokens(ids):
        e = layers.embedding(ids, size=[cfg.tgt_vocab, cfg.hidden],
                             param_attr=ParamAttr(name="tgt_emb"))
        # (B, beam) ids with beam==1 hit embedding's trailing-1 ids
        # convention and come back rank-2; restore (B, beam, H)
        return layers.reshape(e, [-1, beam_size, cfg.hidden])

    decoder = layers.BeamSearchDecoder(
        cell, start_token=cfg.bos_id, end_token=cfg.eos_id,
        beam_size=beam_size, embedding_fn=embed_tokens,
    )

    # per-layer cross-attention K/V from the encoder, computed ONCE and
    # beam-tiled (the pserver-era reference recomputes these per step
    # inside its While loop)
    enc_kv = []
    for i in range(cfg.dec_layers):
        n = "dec%d" % i

        def tiled(name):
            t = layers.fc(enc, cfg.hidden, num_flatten_dims=2,
                          param_attr=ParamAttr(name=name + ".w"),
                          bias_attr=ParamAttr(name=name + ".b"))
            return layers.BeamSearchDecoder.tile_beam_merge_with_batch(
                t, beam_size)

        enc_kv.append((tiled(n + ".cross.k"), tiled(n + ".cross.v")))

    pos0 = layers.fill_constant_batch_size_like(
        enc, shape=[-1, 1], dtype="int64", value=0)
    init_states = [pos0]
    for _ in range(cfg.dec_layers):
        for _ in ("k", "v"):
            init_states.append(layers.fill_constant_batch_size_like(
                enc, shape=[-1, max_out_len, cfg.hidden], dtype="float32",
                value=0.0))

    ids, final_states = layers.dynamic_decode(
        decoder, inits=init_states, max_step_num=max_out_len - 1,
        enc_kv=enc_kv)
    return {"src_ids": src, "ids": ids,
            "scores": final_states.log_probs}


def synthetic_pair_batch(cfg, batch, src_len, tgt_len, seed=0):
    """Copy-task pairs: target = source tokens shifted (teaches quickly)."""
    rng = np.random.default_rng(seed)
    # real tokens start above pad_id so padding never collides with content
    lo = cfg.pad_id + 1
    src = rng.integers(lo, cfg.src_vocab, size=(batch, src_len)).astype("int64")
    content = np.clip(src[:, : tgt_len - 1] % cfg.tgt_vocab, lo,
                      cfg.tgt_vocab - 1)
    tgt_full = np.concatenate(
        [np.full((batch, 1), cfg.bos_id, "int64"), content], axis=1
    )
    labels = np.concatenate(
        [content, np.full((batch, 1), cfg.eos_id, "int64")], axis=1
    )
    return src, tgt_full, labels
