"""Mixture-of-Experts FFN with expert parallelism over an 'ep' mesh axis
(port of paddle_tpu/parallel/moe.py).

Not in the reference (Fluid 1.5 predates MoE): the JAX package adds it
because expert parallelism is a sharding dimension of its own, and the
port keeps it. The standard Switch-Transformer recipe (top-1 routing,
capacity-bounded dispatch; Fedus et al. 2021), built entirely from the
framework's layer ops, so the same Program runs replicated or split:

- router: fc -> softmax -> top-1 (argmax + one_hot), the output scaled
  by the winning probability;
- capacity C per expert; a token's slot comes from an exclusive cumsum
  over its expert's one-hot column; overflow tokens are DROPPED (their
  residual path carries them, the standard Switch behavior);
- dispatch and combine are batched matmuls over an explicit (S, E, C)
  dispatch tensor; the expert FFN weights are rank-3 (E, H, F) /
  (E, F, H) batched matmuls;
- aux load-balancing loss: E * sum(fraction_tokens_e * mean_prob_e).

The op graph is the JAX package's, op for op and name for name.
``moe_ep_rules(name)`` gives the ShardingRule patterns of the expert
dim. Under a :class:`.sharding.DistributedProgram` over a mesh with an
``ep`` axis, each rank holds E / ep experts, and the ops' layout rules
(parallel/tensor_parallel.py) carry the split: the dispatch product is
cut to the rank's experts, the expert products keep the split batch
dim, the (E, C, H) -> (E·C, H) reshape keeps it on the merged dim, and
the combine product contracts over the split E·C into a partial output
that one all-reduce over ``ep`` makes whole. On a mesh without ``ep``
the same program runs replicated.
"""
from .mesh import P

__all__ = ["switch_ffn", "moe_ep_rules"]


def switch_ffn(x, num_experts, d_ff, capacity_factor=1.25, act="gelu",
               name="moe"):
    """Switch-Transformer FFN over (B, T, H) input. Returns
    (y (B, T, H), aux_loss scalar)."""
    import math

    from ..fluid import layers
    from ..fluid.param_attr import ParamAttr

    if any(d is None or int(d) < 0 for d in x.shape):
        raise ValueError(
            "switch_ffn needs a fully static (B, T, H) input shape to "
            "compute expert capacity; got %r. Declare the batch dim "
            "explicitly (fluid.data(..., shape=[batch, T, H]) rather "
            "than the default None batch)." % (tuple(x.shape),))
    T, H = int(x.shape[1]), int(x.shape[2])
    E = int(num_experts)
    F = int(d_ff)

    xs = layers.reshape(x, [-1, H])                       # (S, H)
    gate_logits = layers.fc(
        xs, E, param_attr=ParamAttr(name=name + ".gate.w"),
        bias_attr=False)
    probs = layers.softmax(gate_logits)                   # (S, E)
    top_prob = layers.reduce_max(probs, dim=[-1])         # (S,)
    expert_idx = layers.argmax(probs, axis=-1)            # (S,)
    onehot = layers.one_hot(
        layers.unsqueeze(layers.cast(expert_idx, "int64"), [1]), E)

    # slot within the chosen expert, capacity-bounded
    position = layers.elementwise_mul(
        layers.cumsum(onehot, axis=0, exclusive=True), onehot)
    pos_tok = layers.reduce_sum(position, dim=[-1])       # (S,)
    # static capacity: tokens-per-expert x factor (the input shape is static)
    S_static = 1
    for d in x.shape[:-1]:
        S_static *= int(d)
    C = max(4, int(math.ceil(S_static / E * float(capacity_factor))))
    keep = layers.cast(
        layers.less_than(pos_tok,
                         layers.fill_constant([1], "float32", float(C))),
        "float32")                                        # (S,)
    pos_oh = layers.one_hot(
        layers.unsqueeze(layers.cast(pos_tok, "int64"), [1]), C)
    dispatch = layers.elementwise_mul(
        layers.elementwise_mul(
            layers.unsqueeze(onehot, [2]),                # (S, E, 1)
            layers.unsqueeze(pos_oh, [1])),               # (S, 1, C)
        layers.reshape(keep, [-1, 1, 1]))                 # (S, E, C)

    # dispatch: (E, C, S) @ (S, H) -> (E, C, H)
    expert_in = layers.matmul(
        layers.transpose(dispatch, [1, 2, 0]), xs)
    w1 = layers.create_parameter([E, H, F], "float32",
                                 name=name + ".w1")
    b1 = layers.create_parameter([E, 1, F], "float32",
                                 name=name + ".b1",
                                 is_bias=True)
    w2 = layers.create_parameter([E, F, H], "float32",
                                 name=name + ".w2")
    b2 = layers.create_parameter([E, 1, H], "float32",
                                 name=name + ".b2",
                                 is_bias=True)
    h1 = layers.elementwise_add(layers.matmul(expert_in, w1), b1)
    h1 = getattr(layers, act)(h1)
    out_e = layers.elementwise_add(layers.matmul(h1, w2), b2)  # (E,C,H)

    # combine: (S, E*C) @ (E*C, H), scaled by the winning gate prob
    combine = layers.elementwise_mul(
        dispatch, layers.reshape(top_prob, [-1, 1, 1]))
    y = layers.matmul(layers.reshape(combine, [-1, E * C]),
                      layers.reshape(out_e, [E * C, H]))
    y = layers.reshape(y, [-1, T, H])

    # Switch aux loss: E * sum_e mean(tokens routed to e) * mean(prob_e)
    frac = layers.reduce_mean(onehot, dim=[0])            # (E,)
    mprob = layers.reduce_mean(probs, dim=[0])            # (E,)
    aux = layers.scale(
        layers.reduce_sum(layers.elementwise_mul(frac, mprob)),
        scale=float(E))
    return y, aux


def moe_ep_rules(name="moe"):
    """Shard the expert dim of the FFN weights over 'ep'."""
    import re

    esc = re.escape(name)
    return [
        (esc + r"\.w1$", P("ep", None, None)),
        (esc + r"\.b1$", P("ep", None, None)),
        (esc + r"\.w2$", P("ep", None, None)),
        (esc + r"\.b2$", P("ep", None, None)),
    ]
