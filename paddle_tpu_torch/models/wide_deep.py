"""Wide&Deep CTR model (the BASELINE.json configuration "Wide&Deep CTR
(lookup_table sparse embedding ...)"), built with the Fluid layer API.
Port of paddle_tpu/models/wide_deep.py: the same layer calls build the
same Program, op for op and name for name, as the JAX package.

``embedding(is_sparse=True)`` keeps a dense gradient, as the reference
does: the lookup is a gather whose gradient autograd scatters into a
dense (vocab, dim) table. ``wd_tp_rules`` shards the tables over a mesh
and waits for the parallel slice (ROADMAP.md Queue 1, item 8).
"""
import numpy as np

from .. import fluid
from ..fluid import layers
from ..fluid.param_attr import ParamAttr

__all__ = ["build_wide_deep", "synthetic_ctr_batch", "wd_tp_rules"]


def build_wide_deep(
    num_sparse_fields=26,
    sparse_vocab=100000,
    emb_dim=16,
    num_dense=13,
    hidden=[400, 400, 400],
):
    dense = fluid.data(name="dense", shape=[None, num_dense], dtype="float32")
    sparse = fluid.data(
        name="sparse", shape=[None, num_sparse_fields], dtype="int64"
    )
    label = fluid.data(name="ctr_label", shape=[None, 1], dtype="int64")

    # deep part: shared big embedding, one gather per field
    emb = layers.embedding(
        sparse,
        size=[sparse_vocab, emb_dim],
        param_attr=ParamAttr(name="ctr_emb"),
        is_sparse=True,
    )  # (B, F, D)
    deep = layers.reshape(emb, [0, num_sparse_fields * emb_dim])
    deep = layers.concat([deep, dense], axis=1)
    for i, h in enumerate(hidden):
        deep = layers.fc(
            deep, h, act="relu",
            param_attr=ParamAttr(name="deep_fc%d.w" % i),
            bias_attr=ParamAttr(name="deep_fc%d.b" % i),
        )
    # wide part: linear over dense + 1-d sparse embedding
    wide_emb = layers.embedding(
        sparse,
        size=[sparse_vocab, 1],
        param_attr=ParamAttr(name="ctr_wide_emb"),
        is_sparse=True,
    )
    wide = layers.reduce_sum(wide_emb, dim=[1, 2], keep_dim=False)
    wide = layers.elementwise_add(
        wide,
        layers.reduce_sum(
            layers.fc(dense, 1, bias_attr=False,
                      param_attr=ParamAttr(name="wide_fc.w")),
            dim=[1],
        ),
    )
    logit = layers.elementwise_add(
        layers.fc(deep, 1, param_attr=ParamAttr(name="head.w"),
                  bias_attr=ParamAttr(name="head.b")),
        layers.unsqueeze(wide, [1]),
    )
    prob = layers.sigmoid(logit)
    loss = layers.mean(
        layers.log_loss(
            layers.clip(prob, 1e-7, 1.0 - 1e-7),
            layers.cast(label, "float32"),
        )
    )
    auc_in = layers.concat(
        [layers.elementwise_sub(
            layers.fill_constant_batch_size_like(prob, [-1, 1], "float32", 1.0),
            prob,
        ), prob],
        axis=1,
    )
    auc_out, auc_states = layers.auc(auc_in, label)
    return {
        "dense": dense, "sparse": sparse, "label": label,
        "prob": prob, "loss": loss, "auc": auc_out,
    }


def wd_tp_rules():
    raise NotImplementedError(
        "wd_tp_rules shards the embedding tables over a device mesh: it "
        "comes with the parallel slice of paddle_tpu_torch (ROADMAP.md "
        "Queue 1, item 8)")


def synthetic_ctr_batch(batch, num_sparse_fields=26, sparse_vocab=100000,
                        num_dense=13, seed=0):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((batch, num_dense)).astype("float32")
    sparse = rng.integers(
        0, sparse_vocab, size=(batch, num_sparse_fields)
    ).astype("int64")
    # label correlated with a fixed direction for learnability
    w = np.random.default_rng(1).standard_normal(num_dense)
    label = ((dense @ w + 0.3 * rng.standard_normal(batch)) > 0).astype("int64")
    return dense, sparse, label[:, None]
