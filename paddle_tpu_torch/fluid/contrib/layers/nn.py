"""contrib.layers.nn (ref: python/paddle/fluid/contrib/layers/nn.py:27 —
the baidu text-matching / CTR op family).

Port of paddle_tpu/fluid/contrib/layers/nn.py. Dense-padded semantics,
as in the JAX package: the reference's 1-level LoD inputs become
(B, ...) padded tensors whose length info rides the ``@SEQ_LEN``
companions of the ``row``/``col`` template vars (exactly like
layers.sequence_*); padded positions are masked to zero. Everything is
composed from existing layer ops, so each function's program is the JAX
package's, op for op, and runs the port's lowerings (no kernel of its
own).
"""
from ...framework import Variable
from ...layer_helper import LayerHelper
from ...param_attr import ParamAttr
from ...initializer import Normal
from ...layers import nn as L
from ...layers import ops as OPS
from ...layers import tensor as T
from ...layers import control_flow as CF
from ...layers.sequence_lod import _seq_len_var

__all__ = [
    "fused_elemwise_activation", "var_conv_2d", "match_matrix_tensor",
    "sequence_topk_avg_pooling", "tree_conv", "fused_embedding_seq_pool",
    "multiclass_nms2", "search_pyramid_hash",
]

_UNARY = {
    "scale": lambda x, scale: L.scale(x, scale=scale),
    "relu": lambda x, scale: L.relu(x),
    "tanh": lambda x, scale: OPS.tanh(x),
}
_BINARY = {
    "elementwise_add": L.elementwise_add,
    "elementwise_mul": L.elementwise_mul,
}


def fused_elemwise_activation(x, y, functor_list, axis=-1, scale=0.0,
                              save_intermediate_out=True):
    """out = Unary(Binary(x, y)) or Binary(x, Unary(y))
    (ref contrib/layers/nn.py:39). This computes the same composition
    with ordinary ops."""
    if isinstance(functor_list, str):
        functor_list = functor_list.split(",")
    if not isinstance(functor_list, (list, tuple)) or \
            len(functor_list) != 2:
        raise ValueError(
            "functor_list should be a list of str of length 2")
    f1, f2 = functor_list
    if f1 in _UNARY and f2 in _BINARY:
        return _UNARY[f1](_BINARY[f2](x, y, axis=axis), scale)
    if f1 in _BINARY and f2 in _UNARY:
        return _BINARY[f1](x, _UNARY[f2](y, scale), axis=axis)
    raise ValueError(
        "functor_list must pair one of %s with one of %s, got %s"
        % (sorted(_BINARY), sorted(_UNARY), functor_list))


def _len_mask(template, maxlen, dtype="float32"):
    """(B, maxlen) 0/1 mask from a template var's @SEQ_LEN companion;
    None when the template carries no length info (treat as full)."""
    sl = _seq_len_var(template) if isinstance(template, Variable) else None
    if sl is None:
        return None
    from ...layers.sequence_lod import sequence_mask

    return T.cast(sequence_mask(sl, maxlen=maxlen), dtype)


def var_conv_2d(input, row, col, input_channel, output_channel,
                filter_size, stride=1, param_attr=None, act=None,
                dtype="float32", name=None):
    """Variable-size 2D conv (ref contrib/layers/nn.py:103). Dense
    form: ``input`` is (B, input_channel, Hmax, Wmax); ``row``/``col``
    carry per-sample heights/widths via @SEQ_LEN. Same-padding conv at
    the given stride, output masked beyond each sample's
    (ceil(h/stride), ceil(w/stride))."""
    if isinstance(filter_size, int):
        filter_size = [filter_size, filter_size]
    if isinstance(stride, int):
        stride = [stride, stride]
    helper = LayerHelper("var_conv_2d", **locals())
    fan_in = int(input_channel) * filter_size[0] * filter_size[1]
    out = L.conv2d(
        input, num_filters=output_channel, filter_size=filter_size,
        stride=stride, padding=[filter_size[0] // 2, filter_size[1] // 2],
        param_attr=helper.param_attr if param_attr is not None else
        ParamAttr(initializer=Normal(0.0, (2.0 / fan_in) ** 0.5)),
        bias_attr=False,
    )
    hmax, wmax = int(out.shape[2]), int(out.shape[3])
    rm = _len_mask(row, hmax * stride[0])
    cm = _len_mask(col, wmax * stride[1])

    def downsample(mask, s, n):
        # out position i covers input position i*s
        m = L.reshape(mask, [0, -1])
        idx = list(range(0, n * s, s))
        return T.concat(
            [L.slice(m, axes=[1], starts=[i], ends=[i + 1]) for i in idx],
            axis=1) if s > 1 else m

    if rm is not None:
        out = L.elementwise_mul(
            out, L.reshape(downsample(rm, stride[0], hmax),
                           [-1, 1, hmax, 1]))
    if cm is not None:
        out = L.elementwise_mul(
            out, L.reshape(downsample(cm, stride[1], wmax),
                           [-1, 1, 1, wmax]))
    return helper.append_activation(out) if act else out


def match_matrix_tensor(x, y, channel_num, act=None, param_attr=None,
                        dtype="float32", name=None):
    """Semantic match map out[b,c,i,j] = x[b,i] · W_c · y[b,j]
    (ref contrib/layers/nn.py:219). Dense form: x (B, Tx, H),
    y (B, Ty, H) -> out (B, channel_num, Tx, Ty); padded i/j masked 0.
    Returns (out, tmp) with tmp = x·W reshaped (B, Tx, channel, H)."""
    helper = LayerHelper("match_matrix_tensor", **locals())
    hx = int(x.shape[-1])
    hy = int(y.shape[-1])
    assert hx == hy, (hx, hy)
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[hx, channel_num, hy], dtype=dtype)
    tx = int(x.shape[1])
    ty = int(y.shape[1])
    xw = L.matmul(L.reshape(x, [-1, hx]),
                  L.reshape(w, [hx, channel_num * hy]))  # (B*Tx, C*H)
    tmp = L.reshape(xw, [-1, tx, channel_num, hy])
    # (B, C, Tx, H) @ (B, 1, H, Ty) -> (B, C, Tx, Ty)
    out = L.matmul(
        L.transpose(tmp, [0, 2, 1, 3]),
        L.unsqueeze(L.transpose(y, [0, 2, 1]), [1]))
    xm = _len_mask(x, tx)
    ym = _len_mask(y, ty)
    if xm is not None:
        out = L.elementwise_mul(out, L.reshape(xm, [-1, 1, tx, 1]))
    if ym is not None:
        out = L.elementwise_mul(out, L.reshape(ym, [-1, 1, 1, ty]))
    if act:
        out = helper.append_activation(out)
    return out, tmp


def sequence_topk_avg_pooling(input, row, col, topks, channel_num):
    """Top-k average pooling over the last dim of a match map
    (ref contrib/layers/nn.py:302). Dense form: ``input`` is
    (B, channel_num, Tx, Ty); for each (b, c, i) the j-values within
    the sample's col length are sorted descending and each
    k in ``topks`` contributes sum(top min(k, len) values) / k. Output
    (B, Tx, channel_num * len(topks)), rows beyond the row length
    zeroed. When a sample has fewer than k valid values the reference
    pads with zeros at the back and still averages over k (ref
    docstring: 'if feature size ... is less than topk, it will padding
    0 at the back'), so the denominator is the constant k, never the
    clamped valid length."""
    ks = [int(k) for k in topks]
    tx = int(input.shape[2])
    ty = int(input.shape[3])
    if int(channel_num) != int(input.shape[1]):
        raise ValueError(
            "sequence_topk_avg_pooling: channel_num=%d but input has "
            "%d channels" % (channel_num, int(input.shape[1])))
    cm = _len_mask(col, ty)
    x = input
    if cm is not None:
        # padded j positions must lose the sort: push them to -inf
        neg = L.scale(L.reshape(cm, [-1, 1, 1, ty]), scale=1e30,
                      bias=-1e30)
        x = L.elementwise_add(x, neg)
    sorted_vals = T.argsort(x, axis=-1, descending=True)[0]
    # zero the -inf tail so cumsum is over real values only
    if cm is not None:
        valid = T.cast(CF.greater_than(
            sorted_vals, T.fill_constant([1], input.dtype, -1e29)),
            "float32")
        sorted_vals = L.elementwise_mul(sorted_vals, valid)
    csum = OPS.cumsum(sorted_vals, axis=-1)          # (B, C, Tx, Ty)
    feats = []
    for k in ks:
        kk = min(k, ty)
        s = L.squeeze(L.slice(csum, axes=[3], starts=[kk - 1],
                              ends=[kk]), [3])       # (B, C, Tx)
        # top min(k, valid) values summed, zero-padded to k, mean over k
        feats.append(L.scale(s, scale=1.0 / float(k)))
    out = T.concat(feats, axis=1)                    # (B, C*K, Tx)
    out = L.transpose(out, [0, 2, 1])                # (B, Tx, C*K)
    rm = _len_mask(row, tx)
    if rm is not None:
        out = L.elementwise_mul(out, L.unsqueeze(rm, [2]))
    return out


# tree_conv is already a first-class layer (layers/nn.py); re-exported
# here because the reference also publishes it under contrib.layers
tree_conv = L.tree_conv


def fused_embedding_seq_pool(input, size, is_sparse=False,
                             padding_idx=None, combiner="sum",
                             param_attr=None, dtype="float32"):
    """Embedding lookup + sequence sum-pool in one call
    (ref contrib/layers/nn.py:435). Dense form: ids (B, T) or (B, T, 1)
    -> (B, emb_dim); padding_idx rows contribute zero, positions beyond
    the @SEQ_LEN companion are masked out: a lookup, a mask and a sum,
    where the reference has one fused CPU kernel."""
    if combiner != "sum":
        raise ValueError("fused_embedding_seq_pool supports combiner="
                         "'sum' only (like the reference)")
    ids = input
    if ids.shape is not None and len(ids.shape) == 3 and \
            ids.shape[-1] == 1:
        ids = L.squeeze(ids, [2])
    emb = L.embedding(ids, size=size, is_sparse=is_sparse,
                      padding_idx=padding_idx, param_attr=param_attr,
                      dtype=dtype)                   # (B, T, D)
    t = int(emb.shape[1])
    mask = _len_mask(input, t)
    if mask is not None:
        emb = L.elementwise_mul(emb, L.unsqueeze(mask, [2]))
    return L.reduce_sum(emb, dim=[1])


def multiclass_nms2(bboxes, scores, score_threshold, nms_top_k,
                    keep_top_k, nms_threshold=0.3, normalized=True,
                    nms_eta=1.0, background_label=0, return_index=False,
                    name=None):
    """multiclass_nms that can also return each kept box's index into
    the input (ref contrib/layers/nn.py:501). Static shapes: Out is
    (N, keep_top_k, 6) padded with label=-1, Index (N, keep_top_k, 1)
    padded with -1."""
    if return_index and nms_eta < 1.0:
        raise NotImplementedError(
            "multiclass_nms2 return_index with adaptive nms_eta<1: the "
            "adaptive path does not track source indices")
    helper = LayerHelper("multiclass_nms2", **locals())
    out = helper.create_variable_for_type_inference(bboxes.dtype)
    index = helper.create_variable_for_type_inference("int32")
    if bboxes.shape is not None:
        out.shape = (bboxes.shape[0], keep_top_k, 6)
        index.shape = (bboxes.shape[0], keep_top_k, 1)
    helper.append_op(
        type="multiclass_nms",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [out], "Index": [index]},
        attrs={
            "score_threshold": score_threshold,
            "nms_top_k": nms_top_k,
            "keep_top_k": keep_top_k,
            "nms_threshold": nms_threshold,
            "nms_eta": nms_eta,
            "normalized": normalized,
            "background_label": background_label,
        },
    )
    if return_index:
        return out, index
    return out


def search_pyramid_hash(input, num_emb, space_len, pyramid_layer,
                        rand_len, drop_out_percent, is_training,
                        use_filter, white_list_len, black_list_len,
                        seed, lr, param_attr=None, param_attr_wl=None,
                        param_attr_bl=None, name=None, dtype="float32"):
    """Pyramid hash embedding (ref contrib/layers/nn.py:631): for each
    n-gram length 2..pyramid_layer, the token-id n-grams hash into a
    [space_len + rand_len] weight vector and ``rand_len`` consecutive
    entries are summed per n-gram; n-gram embeddings average into
    (B, num_emb). Dense form: ids (B, T) or (B, T, 1) int; the hash is
    the reference's XXH-style mix replaced by a fixed multiplicative
    hash (any uniform hash yields the same model class). The white/
    black-list filters are brpc-side frequency filters; with
    use_filter=True the lists are carried as parameters for parity but
    filtering is a no-op (documented)."""
    if num_emb % rand_len:
        raise ValueError("num_emb must be a multiple of rand_len")
    helper = LayerHelper("search_pyramid_hash", **locals())
    w = helper.create_parameter(
        attr=param_attr, shape=[space_len + rand_len, 1], dtype=dtype)
    if white_list_len > 0:
        helper.create_parameter(
            attr=param_attr_wl, shape=[white_list_len, 1], dtype=dtype)
    if black_list_len > 0:
        helper.create_parameter(
            attr=param_attr_bl, shape=[black_list_len, 1], dtype=dtype)
    ids = input
    if ids.shape is not None and len(ids.shape) == 3 and \
            ids.shape[-1] == 1:
        ids = L.squeeze(ids, [2])
    t = int(ids.shape[1])
    chunks = num_emb // rand_len
    # modular polynomial hashing with every intermediate < 2^31 (ids
    # run as int32 where 64-bit integers are off; letting products overflow
    # would collapse the buckets)
    P = 1000003

    def _c(v):
        return T.fill_constant([1], "int64", int(v))

    grams = []
    for n in range(2, int(pyramid_layer) + 1):
        if n > t:
            break
        # combine n consecutive ids into one key in [0, P)
        key = None
        for j in range(n):
            part = L.slice(ids, axes=[1], starts=[j],
                           ends=[t - n + 1 + j])
            part = L.elementwise_mod(T.cast(part, "int64"), _c(P))
            key = part if key is None else L.elementwise_mod(
                L.elementwise_add(
                    L.elementwise_mul(key, _c(131)), part), _c(P))
        # one bucket per output chunk: hash -> [0, space_len)
        vecs = []
        for cidx in range(chunks):
            # key < P ~ 1e6, multiplier < 2^11 -> product < 2^31
            h = L.elementwise_mod(
                L.elementwise_add(
                    L.elementwise_mul(key, _c(1021 + 2 * cidx)),
                    _c(97 + cidx)),
                _c(int(space_len)))
            # gather rand_len consecutive weights per key
            rows = [L.gather_nd(
                w, L.unsqueeze(L.elementwise_add(
                    h, T.fill_constant([1], "int64", r)), [2]))
                for r in range(rand_len)]
            vecs.append(T.concat(rows, axis=2))  # (B, T-n+1, rand_len)
        gram = T.concat(vecs, axis=2)            # (B, T-n+1, num_emb)
        mask = _len_mask(input, t)
        if mask is not None:
            # an n-gram starting at i is real only if i+n <= sample len
            lens = L.reduce_sum(mask, dim=[1], keep_dim=True)  # (B,1)
            starts = L.unsqueeze(
                T.cast(T.range(0, t - n + 1, 1, "int64"), "float32"),
                [0])                               # (1, T-n+1)
            valid = T.cast(CF.less_equal(
                L.elementwise_add(
                    starts, T.fill_constant([1], "float32", float(n))),
                lens), "float32")
            gram = L.elementwise_mul(gram, L.unsqueeze(valid, [2]))
        if drop_out_percent and is_training:
            gram = L.dropout(gram, float(drop_out_percent),
                             dropout_implementation="upscale_in_train")
        grams.append(L.reduce_sum(gram, dim=[1]))
    if not grams:
        raise ValueError("pyramid_layer yields no n-grams for T=%d" % t)
    out = grams[0]
    for g in grams[1:]:
        out = L.elementwise_add(out, g)
    return L.scale(out, scale=1.0 / len(grams))
