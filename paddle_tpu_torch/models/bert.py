"""BERT-base pretraining model, built through the paddle_tpu_torch.fluid
layer API. Port of paddle_tpu/models/bert.py: the same layer calls build
the same Program, op for op and name for name, as the JAX package.
``tp_rules`` are the JAX package's tensor-parallel rules, run by
parallel/sharding.py's ``DistributedProgram`` and ``fleet``.
"""
import numpy as np

from .. import fluid
from ..fluid import layers
from ..fluid.param_attr import ParamAttr
from .decode_utils import split_heads

__all__ = ["BertConfig", "build_bert_pretrain", "tp_rules", "bert_base",
           "bert_tiny", "synthetic_batch"]


class BertConfig:
    def __init__(self, vocab_size=30522, hidden=768, num_layers=12, heads=12,
                 ffn=3072, max_seq=512, type_vocab=2, dropout=0.1,
                 use_fused_attention=True):
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.num_layers = num_layers
        self.heads = heads
        self.ffn = ffn
        self.max_seq = max_seq
        self.type_vocab = type_vocab
        self.dropout = dropout
        # fused_multihead_attention op (the flash-attention CUDA kernel on
        # the card); the unfused path keeps the matmul/softmax graph
        self.use_fused_attention = use_fused_attention


def bert_base():
    return BertConfig()


def bert_tiny(seq=64):
    return BertConfig(vocab_size=1024, hidden=64, num_layers=2, heads=4,
                      ffn=128, max_seq=seq, dropout=0.0)


def _attn_name(i, part):
    return "enc_l%d_%s" % (i, part)


def _encoder_layer(x, cfg, i, attn_mask, is_test):
    """One post-LN transformer encoder layer (B, T, H)."""
    h = cfg.hidden
    nh = cfg.heads
    dh = h // nh
    qkv = layers.fc(
        input=x,
        size=3 * h,
        num_flatten_dims=2,
        param_attr=ParamAttr(name=_attn_name(i, "qkv.w")),
        bias_attr=ParamAttr(name=_attn_name(i, "qkv.b")),
    )
    # (B, T, 3H): split by contiguous last-axis slices, then head-split
    # each (B, T, H) piece
    def _split(part, idx):
        p = layers.slice(part, axes=[2], starts=[idx * h],
                         ends=[(idx + 1) * h])            # (B, T, H)
        return split_heads(p, nh, dh)                     # (B,nh,T,dh)

    q = _split(qkv, 0)
    k = _split(qkv, 1)
    v = _split(qkv, 2)
    if getattr(cfg, "use_fused_attention", False) and attn_mask is None:
        ctxv = layers.fused_multihead_attention(
            q, k, v, dropout_rate=cfg.dropout if not is_test else 0.0,
        )                                                # (B,nh,T,dh)
    else:
        scores = layers.matmul(q, k, transpose_y=True, alpha=dh ** -0.5)
        if attn_mask is not None:
            scores = layers.elementwise_add(scores, attn_mask)
        probs = layers.softmax(scores)
        if cfg.dropout and not is_test:
            probs = layers.dropout(
                probs, cfg.dropout, dropout_implementation="upscale_in_train"
            )
        ctxv = layers.matmul(probs, v)                   # (B,nh,T,dh)
    ctxv = layers.transpose(ctxv, [0, 2, 1, 3])          # (B,T,nh,dh)
    ctxv = layers.reshape(ctxv, [0, 0, h])
    attn_out = layers.fc(
        input=ctxv,
        size=h,
        num_flatten_dims=2,
        param_attr=ParamAttr(name=_attn_name(i, "attnout.w")),
        bias_attr=ParamAttr(name=_attn_name(i, "attnout.b")),
    )
    if cfg.dropout and not is_test:
        attn_out = layers.dropout(
            attn_out, cfg.dropout,
            dropout_implementation="upscale_in_train",
        )
    x = layers.layer_norm(
        layers.elementwise_add(x, attn_out),
        begin_norm_axis=2,
        param_attr=ParamAttr(name=_attn_name(i, "ln1.w")),
        bias_attr=ParamAttr(name=_attn_name(i, "ln1.b")),
    )
    ff1 = layers.fc(
        input=x,
        size=cfg.ffn,
        num_flatten_dims=2,
        act="gelu",
        param_attr=ParamAttr(name=_attn_name(i, "ffn1.w")),
        bias_attr=ParamAttr(name=_attn_name(i, "ffn1.b")),
    )
    ff2 = layers.fc(
        input=ff1,
        size=h,
        num_flatten_dims=2,
        param_attr=ParamAttr(name=_attn_name(i, "ffn2.w")),
        bias_attr=ParamAttr(name=_attn_name(i, "ffn2.b")),
    )
    if cfg.dropout and not is_test:
        ff2 = layers.dropout(
            ff2, cfg.dropout, dropout_implementation="upscale_in_train"
        )
    return layers.layer_norm(
        layers.elementwise_add(x, ff2),
        begin_norm_axis=2,
        param_attr=ParamAttr(name=_attn_name(i, "ln2.w")),
        bias_attr=ParamAttr(name=_attn_name(i, "ln2.b")),
    )


def build_bert_pretrain(cfg, seq_len, is_test=False):
    """Build the MLM pretraining graph in the current default programs.
    Returns dict of the interface variables."""
    ids = fluid.data(name="input_ids", shape=[None, seq_len], dtype="int64")
    mlm_labels = fluid.data(name="mlm_labels", shape=[None, seq_len], dtype="int64")
    emb = layers.embedding(
        ids,
        size=[cfg.vocab_size, cfg.hidden],
        param_attr=ParamAttr(name="word_emb"),
    )
    # positions 0..T-1 added via a learned pos table, sliced to seq_len
    pos_table = layers.create_parameter(
        shape=[cfg.max_seq, cfg.hidden],
        dtype="float32",
        name="pos_emb",
    )
    pos_slice = layers.slice(pos_table, axes=[0], starts=[0], ends=[seq_len])
    x = layers.elementwise_add(emb, layers.unsqueeze(pos_slice, [0]))
    x = layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name="emb_ln.w"),
        bias_attr=ParamAttr(name="emb_ln.b"),
    )
    if cfg.dropout and not is_test:
        x = layers.dropout(
            x, cfg.dropout, dropout_implementation="upscale_in_train"
        )
    for i in range(cfg.num_layers):
        x = _encoder_layer(x, cfg, i, None, is_test)
    # MLM head: tied output embedding
    word_emb_var = fluid.default_main_program().global_block().var("word_emb")
    logits = layers.matmul(x, word_emb_var, transpose_y=True)
    loss = layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(mlm_labels, [2]), ignore_index=-1
    )
    mean_loss = layers.mean(loss)
    return {
        "input_ids": ids,
        "mlm_labels": mlm_labels,
        "encoder_out": x,
        "logits": logits,
        "loss": mean_loss,
    }


def tp_rules():
    """Tensor-parallel sharding rules for the BERT parameter naming above:
    column-shard qkv/ffn1 (+ their biases), row-shard attnout/ffn2,
    vocab-shard the embedding."""
    from ..parallel.mesh import P

    return [
        (r"enc_l\d+_qkv\.w", P(None, "tp")),
        (r"enc_l\d+_qkv\.b", P("tp")),
        (r"enc_l\d+_ffn1\.w", P(None, "tp")),
        (r"enc_l\d+_ffn1\.b", P("tp")),
        (r"enc_l\d+_attnout\.w", P("tp", None)),
        (r"enc_l\d+_ffn2\.w", P("tp", None)),
        (r"word_emb", P("tp", None)),
    ]


def synthetic_batch(cfg, batch, seq_len, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, size=(batch, seq_len), dtype=np.int64)
    labels = ids.copy()
    # mask 15%: label kept, input replaced by token 0 ("[MASK]")
    mask = rng.random((batch, seq_len)) < 0.15
    ids[mask] = 0
    labels[~mask] = -1
    return ids, labels
