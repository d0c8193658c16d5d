"""Recurrent layers (ref: python/paddle/fluid/layers/rnn.py + nn.py
dynamic_lstm/dynamic_gru/gru_unit/lstm_unit + beam search ops); port of
paddle_tpu/fluid/layers/rnn.py, which builds Programs without jax.

Dense-padded (B, T, D) sequences; the recurrences are the ops of
ops/rnn_ops.py; beam search is a static-beam top-k expansion.
"""
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from .sequence_lod import _seq_inputs, _alias_seq_len

__all__ = [
    "dynamic_lstm", "dynamic_gru", "gru_unit", "lstm_unit", "lstm",
    "beam_search", "beam_search_decode", "birnn_is_supported",
    "gather_tree",
]


def gather_tree(ids, parents):
    """Beam-search backtrace (ref operators/gather_tree_op.cc): ids and
    parents are (max_time, batch, beam); returns the full predicted
    sequences re-chained through the parent pointers."""
    helper = LayerHelper("gather_tree", **locals())
    out = helper.create_variable_for_type_inference(ids.dtype)
    out.shape = ids.shape
    helper.append_op(
        type="gather_tree",
        inputs={"Ids": [ids], "Parents": [parents]},
        outputs={"Out": [out]},
    )
    return out


def dynamic_lstm(
    input,
    size,
    h_0=None,
    c_0=None,
    param_attr=None,
    bias_attr=None,
    use_peepholes=True,
    is_reverse=False,
    gate_activation="sigmoid",
    cell_activation="tanh",
    candidate_activation="tanh",
    dtype="float32",
    name=None,
):
    """LSTM over a padded sequence batch (ref nn.py dynamic_lstm). `input`
    is the pre-projected (B, T, 4D) tensor, same contract as the reference
    (pair with an fc of size 4*hidden)."""
    helper = LayerHelper("lstm", **locals())
    d = size // 4
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[d, 4 * d], dtype=dtype
    )
    bias_size = 4 * d if not use_peepholes else 7 * d
    b = helper.create_parameter(
        attr=helper.bias_attr, shape=[1, bias_size], dtype=dtype, is_bias=True
    )
    hidden = helper.create_variable_for_type_inference(dtype)
    cell = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    if input.shape is not None:
        hidden.shape = tuple(input.shape[:-1]) + (d,)
        cell.shape = hidden.shape
    ins = _seq_inputs(input)
    ins["Input"] = ins.pop("X")
    ins["Weight"] = [w]
    ins["Bias"] = [b]
    if h_0 is not None:
        ins["H0"] = [h_0]
    if c_0 is not None:
        ins["C0"] = [c_0]
    helper.append_op(
        type="lstm",
        inputs=ins,
        outputs={
            "Hidden": [hidden],
            "Cell": [cell],
            "LastH": [last_h],
            "LastC": [last_c],
        },
        attrs={
            "use_peepholes": use_peepholes,
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
        },
    )
    _alias_seq_len(helper, input, hidden)
    return hidden, cell


def lstm(
    input,
    init_h,
    init_c,
    max_len,
    hidden_size,
    num_layers,
    dropout_prob=0.0,
    is_bidirec=False,
    is_test=False,
    name=None,
    default_initializer=None,
    seed=-1,
):
    """Multi-layer (cu)DNN-style LSTM (ref nn.py lstm). input (B, T, D)."""
    helper = LayerHelper("cudnn_lstm", **locals())
    dtype = input.dtype
    ndir = 2 if is_bidirec else 1
    in_dim = input.shape[-1]
    w_ih, w_hh, biases = [], [], []
    for layer in range(num_layers):
        for dr in range(ndir):
            d_in = in_dim if layer == 0 else hidden_size * ndir
            w_ih.append(
                helper.create_parameter(
                    attr=ParamAttr(), shape=[d_in, 4 * hidden_size],
                    dtype=dtype, default_initializer=default_initializer,
                )
            )
            w_hh.append(
                helper.create_parameter(
                    attr=ParamAttr(), shape=[hidden_size, 4 * hidden_size],
                    dtype=dtype, default_initializer=default_initializer,
                )
            )
            biases.append(
                helper.create_parameter(
                    attr=ParamAttr(), shape=[4 * hidden_size], dtype=dtype,
                    is_bias=True,
                )
            )
    out = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    last_c = helper.create_variable_for_type_inference(dtype)
    if input.shape is not None:
        out.shape = tuple(input.shape[:-1]) + (hidden_size * ndir,)
    ins = _seq_inputs(input)
    ins["Input"] = ins.pop("X")
    ins["WeightIh"] = w_ih
    ins["WeightHh"] = w_hh
    ins["Bias"] = biases
    helper.append_op(
        type="cudnn_lstm",
        inputs=ins,
        outputs={"Out": [out], "LastH": [last_h], "LastC": [last_c]},
        attrs={"num_layers": num_layers, "is_bidirec": is_bidirec},
    )
    _alias_seq_len(helper, input, out)
    return out, last_h, last_c


def dynamic_gru(
    input,
    size,
    param_attr=None,
    bias_attr=None,
    is_reverse=False,
    gate_activation="sigmoid",
    candidate_activation="tanh",
    h_0=None,
    origin_mode=False,
):
    """GRU over padded batch; input is pre-projected (B, T, 3D)
    (ref nn.py dynamic_gru)."""
    helper = LayerHelper("gru", **locals())
    dtype = input.dtype
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[size, 3 * size], dtype=dtype
    )
    b = helper.create_parameter(
        attr=helper.bias_attr, shape=[1, 3 * size], dtype=dtype, is_bias=True
    )
    hidden = helper.create_variable_for_type_inference(dtype)
    last_h = helper.create_variable_for_type_inference(dtype)
    if input.shape is not None:
        hidden.shape = tuple(input.shape[:-1]) + (size,)
    ins = _seq_inputs(input)
    ins["Input"] = ins.pop("X")
    ins["Weight"] = [w]
    ins["Bias"] = [b]
    if h_0 is not None:
        ins["H0"] = [h_0]
    helper.append_op(
        type="gru",
        inputs=ins,
        outputs={"Hidden": [hidden], "LastH": [last_h]},
        attrs={
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "activation": candidate_activation,
            "origin_mode": origin_mode,
        },
    )
    _alias_seq_len(helper, input, hidden)
    return hidden


def gru_unit(
    input,
    hidden,
    size,
    param_attr=None,
    bias_attr=None,
    activation="tanh",
    gate_activation="sigmoid",
    origin_mode=False,
):
    """One GRU step (ref nn.py gru_unit). input (B, 3D) pre-projected."""
    helper = LayerHelper("gru_unit", **locals())
    dtype = input.dtype
    d = size // 3
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[d, 3 * d], dtype=dtype
    )
    b = helper.create_parameter(
        attr=helper.bias_attr, shape=[1, 3 * d], dtype=dtype, is_bias=True
    )
    out_h = helper.create_variable_for_type_inference(dtype)
    reset_h = helper.create_variable_for_type_inference(dtype)
    gate = helper.create_variable_for_type_inference(dtype)
    out_h.shape = hidden.shape
    helper.append_op(
        type="gru_unit",
        inputs={
            "Input": [input],
            "HiddenPrev": [hidden],
            "Weight": [w],
            "Bias": [b],
        },
        outputs={
            "Hidden": [out_h],
            "ResetHiddenPrev": [reset_h],
            "Gate": [gate],
        },
        attrs={
            "activation": activation,
            "gate_activation": gate_activation,
            "origin_mode": origin_mode,
        },
    )
    return out_h, reset_h, gate


def lstm_unit(
    x_t,
    hidden_t_prev,
    cell_t_prev,
    forget_bias=0.0,
    param_attr=None,
    bias_attr=None,
    name=None,
):
    """One LSTM step (ref rnn.py lstm_unit): projects [x, h] then gates."""
    helper = LayerHelper("lstm_unit", **locals())
    from . import nn as nn_layers

    d = hidden_t_prev.shape[-1]
    concat_in = nn_layers.elementwise_add(
        nn_layers.fc(
            input=x_t, size=4 * d, param_attr=param_attr, bias_attr=bias_attr
        ),
        nn_layers.fc(input=hidden_t_prev, size=4 * d, bias_attr=False),
    )
    c = helper.create_variable_for_type_inference(x_t.dtype)
    h = helper.create_variable_for_type_inference(x_t.dtype)
    c.shape = cell_t_prev.shape
    h.shape = hidden_t_prev.shape
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [concat_in], "C_prev": [cell_t_prev]},
        outputs={"C": [c], "H": [h]},
        attrs={"forget_bias": forget_bias},
    )
    return h, c


def birnn_is_supported():
    return True


# ---------------------------------------------------------------------------
# beam search (ref: paddle/fluid/operators/beam_search_op.cc) — static beam
# ---------------------------------------------------------------------------
def beam_search(
    pre_ids,
    pre_scores,
    ids,
    scores,
    beam_size,
    end_id,
    level=0,
    is_accumulated=True,
    name=None,
    return_parent_idx=False,
):
    """One beam-search expansion step over (batch*beam, K) candidates →
    top beam_size per batch. Static shapes: (B, beam) in/out."""
    helper = LayerHelper("beam_search", **locals())
    sel_ids = helper.create_variable_for_type_inference(ids.dtype)
    sel_scores = helper.create_variable_for_type_inference(scores.dtype)
    parent = helper.create_variable_for_type_inference("int64")
    helper.append_op(
        type="beam_search",
        inputs={
            "pre_ids": [pre_ids],
            "pre_scores": [pre_scores],
            "ids": [ids],
            "scores": [scores],
        },
        outputs={
            "selected_ids": [sel_ids],
            "selected_scores": [sel_scores],
            "parent_idx": [parent],
        },
        attrs={
            "beam_size": beam_size,
            "end_id": end_id,
            "is_accumulated": is_accumulated,
        },
    )
    if return_parent_idx:
        return sel_ids, sel_scores, parent
    return sel_ids, sel_scores


def beam_search_decode(ids, scores, beam_size, end_id, name=None):
    """Backtrace beam parents into full sequences
    (ref beam_search_decode_op.cc). Expects stacked per-step tensors."""
    helper = LayerHelper("beam_search_decode", **locals())
    out_ids = helper.create_variable_for_type_inference(ids.dtype)
    out_scores = helper.create_variable_for_type_inference(scores.dtype)
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "Scores": [scores]},
        outputs={"SentenceIds": [out_ids], "SentenceScores": [out_scores]},
        attrs={"beam_size": beam_size, "end_id": end_id},
    )
    return out_ids, out_scores


# Cell-based RNN API (ref rnn.py:48-1700) — implemented in rnn_cells.py,
# re-exported here to mirror the reference module layout.
from .rnn_cells import (  # noqa: E402,F401
    RNNCell, GRUCell, LSTMCell, rnn, Decoder, BeamSearchDecoder,
    dynamic_decode, dynamic_lstmp,
)

__all__ += ["RNNCell", "GRUCell", "LSTMCell", "rnn", "Decoder",
            "BeamSearchDecoder", "dynamic_decode", "dynamic_lstmp"]
