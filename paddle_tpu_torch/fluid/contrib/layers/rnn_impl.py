"""Basic RNN units (ref: python/paddle/fluid/contrib/layers/rnn_impl.py
BasicGRUUnit/BasicLSTMUnit, backing layers.GRUCell/LSTMCell); a copy of
paddle_tpu/fluid/contrib/layers/rnn_impl.py, which builds Programs
without jax.

Graph-building step units: parameters are created lazily on the first
call (when the input width is known) under the unit's name scope, then
reused on every subsequent call — so one unit instance used inside a
StaticRNN step reads the SAME weights at every time step.
"""
import copy

from ...initializer import Constant
from ...layer_helper import LayerHelper
from ...param_attr import ParamAttr
from ... import unique_name

__all__ = ["BasicGRUUnit", "BasicLSTMUnit"]


def _role_attr(attr, suffix):
    """Per-role copy of a (possibly named) ParamAttr: a user-supplied
    name gets the role suffix so a unit's multiple weights never alias
    (ref rnn_impl.py renames per weight the same way)."""
    if attr is None or attr is False:
        return attr
    a = attr if isinstance(attr, ParamAttr) else ParamAttr._to_attr(attr)
    a = copy.deepcopy(a)
    if a.name:
        a.name = a.name + suffix
    return a


class _LazyUnit:
    """Shared lazy-parameter machinery."""

    def __init__(self, name_scope, hidden_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 dtype="float32"):
        self._name = unique_name.generate(name_scope)
        self._hidden_size = hidden_size
        self._param_attr = param_attr
        self._bias_attr = bias_attr
        self._gate_act_name = gate_activation
        self._act_name = activation
        self._dtype = dtype
        self._built = False

    def _helper(self):
        return LayerHelper(
            self._name,
            param_attr=self._param_attr,
            bias_attr=self._bias_attr,
        )

    def _acts(self):
        from ...layers import ops as activations

        gate = self._gate_act_name or activations.sigmoid
        act = self._act_name or activations.tanh
        return gate, act


class BasicGRUUnit(_LazyUnit):
    """One GRU step (ref rnn_impl.py BasicGRUUnit):
    u,r = act_g([x,h]·W_g + b_g); c = act_c([x, r⊙h]·W_c + b_c);
    h' = u⊙h + (1-u)⊙c."""

    def __call__(self, input, pre_hidden):
        from ...layers import nn as L
        from ...layers import tensor as T

        gate_act, act = self._acts()
        D = self._hidden_size
        helper = self._helper()
        in_width = input.shape[-1]
        if not self._built:
            self._gate_w = helper.create_parameter(
                attr=_role_attr(helper.param_attr, "_gate_weight"),
                shape=[in_width + D, 2 * D], dtype=self._dtype)
            self._gate_b = helper.create_parameter(
                attr=_role_attr(helper.bias_attr, "_gate_bias"),
                shape=[2 * D], dtype=self._dtype,
                is_bias=True, default_initializer=Constant(0.0))
            self._cand_w = helper.create_parameter(
                attr=_role_attr(helper.param_attr, "_candidate_weight"),
                shape=[in_width + D, D], dtype=self._dtype)
            self._cand_b = helper.create_parameter(
                attr=_role_attr(helper.bias_attr, "_candidate_bias"),
                shape=[D], dtype=self._dtype,
                is_bias=True, default_initializer=Constant(0.0))
            self._built = True

        concat = T.concat([input, pre_hidden], axis=-1)
        gates = L.elementwise_add(
            L.matmul(concat, self._gate_w), self._gate_b)
        gates = gate_act(gates)
        # ref rnn_impl.py:125 splits (r, u): reset gate first
        r = L.slice(gates, axes=[1], starts=[0], ends=[D])
        u = L.slice(gates, axes=[1], starts=[D], ends=[2 * D])
        r_hidden = L.elementwise_mul(r, pre_hidden)
        cand = L.elementwise_add(
            L.matmul(T.concat([input, r_hidden], axis=-1), self._cand_w),
            self._cand_b)
        c = act(cand)
        new_hidden = L.elementwise_add(
            L.elementwise_mul(u, pre_hidden),
            L.elementwise_mul(
                L.elementwise_sub(
                    T.fill_constant([1], self._dtype, 1.0), u), c))
        return new_hidden


class BasicLSTMUnit(_LazyUnit):
    """One LSTM step (ref rnn_impl.py BasicLSTMUnit), gate order i,j,f,o:
    c' = c⊙act_g(f + forget_bias) + act_g(i)⊙act_c(j);
    h' = act_c(c')⊙act_g(o)."""

    def __init__(self, name_scope, hidden_size, param_attr=None,
                 bias_attr=None, gate_activation=None, activation=None,
                 forget_bias=1.0, dtype="float32"):
        super().__init__(name_scope, hidden_size, param_attr, bias_attr,
                         gate_activation, activation, dtype)
        self._forget_bias = float(forget_bias)

    def __call__(self, input, pre_hidden, pre_cell):
        from ...layers import nn as L
        from ...layers import tensor as T

        gate_act, act = self._acts()
        D = self._hidden_size
        helper = self._helper()
        in_width = input.shape[-1]
        if not self._built:
            self._w = helper.create_parameter(
                attr=_role_attr(helper.param_attr, "_weight"),
                shape=[in_width + D, 4 * D], dtype=self._dtype)
            self._b = helper.create_parameter(
                attr=_role_attr(helper.bias_attr, "_bias"),
                shape=[4 * D], dtype=self._dtype,
                is_bias=True, default_initializer=Constant(0.0))
            self._built = True

        concat = T.concat([input, pre_hidden], axis=-1)
        gates = L.elementwise_add(L.matmul(concat, self._w), self._b)
        i = L.slice(gates, axes=[1], starts=[0], ends=[D])
        j = L.slice(gates, axes=[1], starts=[D], ends=[2 * D])
        f = L.slice(gates, axes=[1], starts=[2 * D], ends=[3 * D])
        o = L.slice(gates, axes=[1], starts=[3 * D], ends=[4 * D])
        forget = gate_act(
            L.elementwise_add(
                f, T.fill_constant([1], self._dtype, self._forget_bias)))
        new_cell = L.elementwise_add(
            L.elementwise_mul(pre_cell, forget),
            L.elementwise_mul(gate_act(i), act(j)))
        new_hidden = L.elementwise_mul(act(new_cell), gate_act(o))
        return new_hidden, new_cell


def _stacked_rnn(input, init_states, make_cell, hidden_size, num_layers,
                 sequence_length, dropout_prob, bidirectional, batch_first,
                 name):
    """The shared body of basic_gru/basic_lstm (ref rnn_impl.py:139,358).

    Mirrors the reference topology exactly: each direction is an
    INDEPENDENT num_layers-deep stack over the (reversed) input, and the
    two directions' final outputs are concatenated once at the end — so
    layer>0 weights have input width D, not 2D, and reference-shaped
    checkpoints port directly. Dropout follows the reference too: the
    default 'downgrade_in_infer' implementation, applied after every
    layer of a stack INCLUDING the last (the final rnn output is dropped
    out; recorded last-states are not — ref rnn_impl.py:305).

    init_states is a list of per-state stacked tensors shaped
    (L*ndir, B, D) (layer-major, direction-minor, like the reference's
    [num_layers, direc_num, -1, D] reshape) or Nones; a None entry
    zero-initialises that state.
    """
    from ...layers import nn as L
    from ...layers import tensor as T
    from ... import layers as lay

    ndir = 2 if bidirectional else 1
    time_major = not batch_first
    batch_dim = 1 if time_major else 0

    def _slice_init(stacked, idx):
        if stacked is None:
            # zero state batched like the input's batch dim
            return T.fill_constant_batch_size_like(
                input=input, shape=[-1, hidden_size], dtype="float32",
                value=0.0, input_dim_idx=batch_dim)
        s = L.slice(stacked, axes=[0], starts=[idx], ends=[idx + 1])
        return L.squeeze(s, [0])

    dir_outs = []
    # dir_layer_lasts[d][layer] = list of that cell's final states
    dir_layer_lasts = []
    for d in range(ndir):
        cur = input
        layer_lasts = []
        for layer in range(num_layers):
            cell = make_cell("%s_l%d_%s" % (name, layer,
                                            "fw" if d == 0 else "bw"))
            init = [_slice_init(st, layer * ndir + d) for st in init_states]
            init = init[0] if len(init) == 1 else init
            out, last = lay.rnn(
                cell, cur, initial_states=init,
                sequence_length=sequence_length,
                time_major=time_major, is_reverse=(d == 1))
            last = last if isinstance(last, (list, tuple)) else [last]
            layer_lasts.append(list(last))
            cur = out
            if dropout_prob:
                cur = L.dropout(cur, dropout_prob)
        dir_outs.append(cur)
        dir_layer_lasts.append(layer_lasts)
    out = dir_outs[0] if ndir == 1 else lay.concat(dir_outs, axis=-1)
    # stack last states layer-major, direction-minor (ref layout)
    last_per_state = [[] for _ in dir_layer_lasts[0][0]]
    for layer in range(num_layers):
        for d in range(ndir):
            for si, sv in enumerate(dir_layer_lasts[d][layer]):
                last_per_state[si].append(sv)
    lasts = [L.stack(vs, axis=0) for vs in last_per_state]
    return out, lasts


def basic_gru(input, init_hidden, hidden_size, num_layers=1,
              sequence_length=None, dropout_prob=0.0, bidirectional=False,
              batch_first=True, param_attr=None, bias_attr=None,
              gate_activation=None, activation=None, dtype="float32",
              name="basic_gru"):
    """Multi-layer (bi)GRU over BasicGRUUnit (ref rnn_impl.py:139).
    Returns (rnn_out, last_hidden) with last_hidden (L*ndir, B, D)."""
    from ...layers.rnn_cells import GRUCell

    def make_cell(nm):
        suffix = nm[len(name):]            # "_l0_fw" etc.
        return GRUCell(hidden_size, _role_attr(param_attr, suffix),
                       _role_attr(bias_attr, suffix),
                       gate_activation, activation, dtype, name=nm)

    out, lasts = _stacked_rnn(
        input, [init_hidden], make_cell, hidden_size, num_layers,
        sequence_length, dropout_prob, bidirectional, batch_first, name)
    return out, lasts[0]


def basic_lstm(input, init_hidden, init_cell, hidden_size, num_layers=1,
               sequence_length=None, dropout_prob=0.0, bidirectional=False,
               batch_first=True, param_attr=None, bias_attr=None,
               gate_activation=None, activation=None, forget_bias=1.0,
               dtype="float32", name="basic_lstm"):
    """Multi-layer (bi)LSTM over BasicLSTMUnit (ref rnn_impl.py:358).
    Returns (rnn_out, last_hidden, last_cell), each last (L*ndir, B, D)."""
    from ...layers.rnn_cells import LSTMCell

    def make_cell(nm):
        suffix = nm[len(name):]            # "_l0_fw" etc.
        return LSTMCell(hidden_size, _role_attr(param_attr, suffix),
                        _role_attr(bias_attr, suffix),
                        gate_activation, activation, forget_bias, dtype,
                        name=nm)

    out, lasts = _stacked_rnn(
        input, [init_hidden, init_cell], make_cell, hidden_size,
        num_layers, sequence_length, dropout_prob, bidirectional,
        batch_first, name)
    return out, lasts[0], lasts[1]


__all__ += ["basic_gru", "basic_lstm"]
