"""Cell-based decoding API (ref: python/paddle/fluid/layers/rnn.py:48-1700);
port of paddle_tpu/fluid/layers/rnn_cells.py: ``Decoder``,
``BeamSearchDecoder`` and ``dynamic_decode``.

``dynamic_decode`` runs ``max_step_num + 1`` decoder steps as one
StaticRNN (the static_rnn op), finished beams frozen by the decoder
itself, as the JAX package does with a fixed-length masked lax.scan: the
outputs match the reference's early-exit loop wherever it would have
stopped. When ``max_step_num`` is None the bound comes from
PADDLE_TPU_MAX_DECODE_LEN (default 256).

``RNNCell``, ``GRUCell``, ``LSTMCell``, ``rnn()`` and ``dynamic_lstmp``
need ``contrib.layers.rnn_impl`` and the ``lstmp`` op: they come with the
RNN slice of paddle_tpu_torch and raise until then.
"""
import collections
import os

import numpy as np

from . import utils
from .utils import flatten, map_structure

__all__ = [
    "RNNCell", "GRUCell", "LSTMCell", "rnn", "Decoder",
    "BeamSearchDecoder", "dynamic_decode", "dynamic_lstmp",
]


def _lay():
    """The fully-initialised layers package (deferred: rnn_cells is
    imported during the package's own __init__)."""
    from .. import layers

    return layers


def _rnn_slice(what):
    return NotImplementedError(
        "%s is not ported yet: it needs contrib.layers.rnn_impl and the "
        "rnn ops, and comes with the RNN slice of paddle_tpu_torch "
        "(ROADMAP.md Queue 1, item 6.4)" % what)


class RNNCell:
    """Base class mapping (inputs, states) -> (outputs, new_states)
    (ref rnn.py:48): waits for the RNN slice with its cells."""

    def __init__(self, *args, **kwargs):
        raise _rnn_slice("RNNCell")


class GRUCell(RNNCell):
    """GRU cell (ref rnn.py:178): waits for the RNN slice."""

    def __init__(self, *args, **kwargs):
        raise _rnn_slice("GRUCell")


class LSTMCell(RNNCell):
    """LSTM cell (ref rnn.py:267): waits for the RNN slice."""

    def __init__(self, *args, **kwargs):
        raise _rnn_slice("LSTMCell")


def _transpose_batch_time(x):
    L = _lay()
    return L.transpose(x, [1, 0] + list(range(2, len(x.shape))))


def rnn(cell, inputs, initial_states=None, sequence_length=None,
        time_major=False, is_reverse=False, **kwargs):
    """Unroll `cell` over time (ref rnn.py:363): waits for the RNN
    slice."""
    raise _rnn_slice("rnn()")


class Decoder:
    """Decoder interface for dynamic_decode (ref rnn.py:492)."""

    def initialize(self, inits):
        raise NotImplementedError

    def step(self, time, inputs, states, **kwargs):
        raise NotImplementedError

    def finalize(self, outputs, final_states, sequence_lengths):
        raise NotImplementedError


class BeamSearchDecoder(Decoder):
    """Beam-search decoding over a wrapped cell (ref rnn.py:588). Works
    on [batch, beam, ...] tensors; `tile_beam_merge_with_batch` prepares
    attention context the same way as the reference."""

    class OutputWrapper(collections.namedtuple(
            "OutputWrapper", ("scores", "predicted_ids", "parent_ids"))):
        """Per-step beam output structure (ref rnn.py:809)."""

    class StateWrapper(collections.namedtuple(
            "StateWrapper",
            ("cell_states", "log_probs", "finished", "lengths"))):
        """Beam decoding state structure (ref rnn.py:817)."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None, init_scores=None):
        """``start_token`` is an int like the reference — or a (B, 1)
        int64 Variable (e.g. the contrib decoder's fed ``init_ids``), in
        which case the beam seeds from its runtime values. Optional
        ``init_scores`` (B, 1) float Variable seeds beam 0's cumulative
        log-prob (ref contrib beam_search_decoder init_scores)."""
        self.cell = cell
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn
        self.start_token = start_token
        self.end_token = end_token
        self.beam_size = beam_size
        self.init_scores = init_scores
        self.kinf = 1e9

    @staticmethod
    def tile_beam_merge_with_batch(x, beam_size):
        """[B, ...] -> [B*beam, ...] with each batch entry repeated
        beam_size times (ref rnn.py:664)."""
        L = _lay()
        x = L.unsqueeze(x, [1])
        expand_times = [1] * len(x.shape)
        expand_times[1] = beam_size
        x = L.expand(x, expand_times)
        return L.reshape(x, shape=[-1] + list(x.shape[2:]))

    def _split_batch_beams(self, x):
        return _lay().reshape(
            x, shape=[-1, self.beam_size] + list(x.shape[1:]))

    def _merge_batch_beams(self, x):
        return _lay().reshape(x, shape=[-1] + list(x.shape[2:]))

    def _expand_to_beam_size(self, x):
        L = _lay()
        x = L.unsqueeze(x, [1])
        expand_times = [1] * len(x.shape)
        expand_times[1] = self.beam_size
        return L.expand(x, expand_times)

    def _batch_pos(self, like2d):
        """(B, beam) int64 tensor of row indices, batch-size agnostic:
        cumsum over a ones column (no shape op needed)."""
        L = T = _lay()
        ones = T.fill_constant_batch_size_like(
            input=like2d, shape=[-1, 1], dtype="float32", value=1.0)
        pos = L.cumsum(ones, axis=0, exclusive=True)     # 0,1,2,... (B,1)
        pos = T.cast(pos, "int64")
        return L.expand(pos, [1, self.beam_size])

    def _gather(self, x, indices):
        """Gather x[b, indices[b, k]] -> (B, beam, ...)."""
        L = _lay()
        coords = L.stack([self._batch_pos(indices), indices], axis=2)
        return L.gather_nd(x, coords)

    def initialize(self, initial_cell_states):
        L = T = _lay()
        state = flatten(initial_cell_states)[0]
        init_cell_states = map_structure(
            self._expand_to_beam_size, initial_cell_states)
        if hasattr(self.start_token, "name"):      # runtime (B, 1) ids
            init_ids = L.expand(T.cast(self.start_token, "int64"),
                                [1, self.beam_size])
        else:
            init_ids = T.fill_constant_batch_size_like(
                input=state, shape=[-1, self.beam_size], dtype="int64",
                value=self.start_token)
        # row [0, -inf, -inf, ...]: only beam 0 is live at t=0
        row = T.assign(np.array(
            [[0.0] + [-self.kinf] * (self.beam_size - 1)], dtype="float32"))
        if self.init_scores is not None:           # runtime (B, 1) base
            base = L.expand(T.cast(self.init_scores, "float32"),
                            [1, self.beam_size])
        else:
            base = T.fill_constant_batch_size_like(
                input=state, shape=[-1, self.beam_size], dtype="float32",
                value=0.0)
        log_probs = L.elementwise_add(base, row)
        init_finished = T.fill_constant_batch_size_like(
            input=state, shape=[-1, self.beam_size], dtype="bool",
            value=False)
        init_lengths = T.zeros_like(init_ids)
        init_inputs = (self.embedding_fn(init_ids) if self.embedding_fn
                       else init_ids)
        return init_inputs, self.StateWrapper(
            init_cell_states, log_probs, init_finished,
            init_lengths), init_finished

    def _mask_probs(self, probs, finished):
        """Finished beams put all mass on end_token (ref rnn.py:745)."""
        L = T = _lay()
        noend = [-self.kinf] * self.vocab_size
        noend[self.end_token] = 0.0
        noend_row = T.assign(np.array([[noend]], dtype="float32"))
        fin = T.cast(finished, "float32")
        fin = L.unsqueeze(fin, [2])                     # (B, beam, 1)
        one = T.fill_constant([1], "float32", 1.0)
        keep = L.elementwise_sub(one, fin)
        return L.elementwise_add(
            L.elementwise_mul(fin, noend_row),
            L.elementwise_mul(keep, probs))

    def _beam_search_step(self, time, logits, next_cell_states, beam_state):
        L = T = _lay()
        self.vocab_size = int(logits.shape[-1])
        step_log_probs = L.log(L.softmax(logits))
        step_log_probs = self._mask_probs(
            step_log_probs, beam_state.finished)
        log_probs = L.elementwise_add(
            step_log_probs, L.unsqueeze(beam_state.log_probs, [2]))
        scores = L.reshape(
            log_probs, [-1, self.beam_size * self.vocab_size])
        topk_scores, topk_indices = L.topk(input=scores, k=self.beam_size)
        vocab_c = T.fill_constant([1], "int64", self.vocab_size)
        beam_indices = L.elementwise_floordiv(topk_indices, vocab_c)
        token_indices = L.elementwise_mod(topk_indices, vocab_c)
        next_log_probs = self._gather(scores, topk_indices)
        next_cell_states = map_structure(
            lambda x: self._gather(x, beam_indices), next_cell_states)
        next_finished = self._gather(beam_state.finished, beam_indices)
        next_lengths = self._gather(beam_state.lengths, beam_indices)
        not_fin = T.cast(L.logical_not(next_finished), "int64")
        next_lengths = L.elementwise_add(next_lengths, not_fin)
        end_c = T.fill_constant([1], "int64", self.end_token)
        next_finished = L.logical_or(
            next_finished, L.equal(token_indices, end_c))
        return (self.OutputWrapper(topk_scores, token_indices,
                                   beam_indices),
                self.StateWrapper(next_cell_states, next_log_probs,
                                  next_finished, next_lengths))

    def step(self, time, inputs, states, **kwargs):
        inputs = map_structure(self._merge_batch_beams, inputs)
        cell_states = map_structure(
            self._merge_batch_beams, states.cell_states)
        cell_outputs, next_cell_states = self.cell(
            inputs, cell_states, **kwargs)
        cell_outputs = map_structure(self._split_batch_beams, cell_outputs)
        next_cell_states = map_structure(
            self._split_batch_beams, next_cell_states)
        if self.output_fn is not None:
            cell_outputs = self.output_fn(cell_outputs)
        beam_search_output, beam_search_state = self._beam_search_step(
            time=time, logits=cell_outputs,
            next_cell_states=next_cell_states, beam_state=states)
        finished = beam_search_state.finished
        sample_ids = beam_search_output.predicted_ids
        next_inputs = (self.embedding_fn(sample_ids) if self.embedding_fn
                       else sample_ids)
        return beam_search_output, beam_search_state, next_inputs, finished

    def finalize(self, outputs, final_states, sequence_lengths):
        from .rnn import gather_tree

        predicted_ids = gather_tree(
            outputs.predicted_ids, outputs.parent_ids)
        return predicted_ids, final_states

    @property
    def output_dtype(self):
        return self.OutputWrapper(
            scores="float32", predicted_ids="int64", parent_ids="int64")


def dynamic_decode(decoder, inits=None, max_step_num=None,
                   output_time_major=False, **kwargs):
    """Run `decoder.step` max_step_num + 1 times (ref rnn.py:1040) as
    one StaticRNN instead of a While/TensorArray loop: finished beams are
    frozen by the decoder itself, so the outputs match the reference's
    early-exit loop wherever it would have stopped. With max_step_num
    None the bound is PADDLE_TPU_MAX_DECODE_LEN (default 256)."""
    from . import control_flow

    L = T = _lay()

    if max_step_num is None:
        tmax = int(os.environ.get("PADDLE_TPU_MAX_DECODE_LEN", 256))
    else:
        tmax = int(max_step_num) + 1

    initial_inputs, initial_states, initial_finished = decoder.initialize(
        inits)
    flat_init_states = flatten(initial_states)
    flat_init_inputs = flatten(initial_inputs)

    times = L.reshape(
        T.range(0, tmax, 1, dtype="int64"), [tmax, 1])
    seq_len_init = T.cast(T.zeros_like(initial_finished), "int64")

    srnn = control_flow.StaticRNN()
    with srnn.step():
        time_t = srnn.step_input(times)
        in_mems = [srnn.memory(v) for v in flat_init_inputs]
        st_mems = [srnn.memory(v) for v in flat_init_states]
        fin_mem = srnn.memory(initial_finished)
        len_mem = srnn.memory(seq_len_init)

        inputs_t = utils.pack_sequence_as(initial_inputs, in_mems)
        states_t = utils.pack_sequence_as(initial_states, st_mems)
        outputs, next_states, next_inputs, next_finished = decoder.step(
            time_t, inputs_t, states_t, **kwargs)
        # lengths count one step for every not-yet-finished sequence
        next_seq_lens = L.elementwise_add(
            len_mem, T.cast(L.logical_not(fin_mem), "int64"))
        next_finished = L.logical_or(next_finished, fin_mem)

        for m, v in zip(in_mems, flatten(next_inputs)):
            srnn.update_memory(m, v)
        for m, v in zip(st_mems, flatten(next_states)):
            srnn.update_memory(m, v)
        srnn.update_memory(fin_mem, next_finished)
        srnn.update_memory(len_mem, next_seq_lens)

        flat_outputs = flatten(outputs)
        flat_next_states = flatten(next_states)
        for o in flat_outputs:
            srnn.step_output(o)
        srnn.step_output(next_seq_lens)
        for s in flat_next_states:
            srnn.step_output(s)

    rnn_out = srnn()
    if not isinstance(rnn_out, (list, tuple)):
        rnn_out = [rnn_out]
    n_out = len(flat_outputs)
    final_outputs = utils.pack_sequence_as(outputs, rnn_out[:n_out])

    def _last_step(x):
        last = L.slice(x, axes=[0], starts=[tmax - 1], ends=[tmax])
        return L.squeeze(last, [0])

    sequence_lengths = _last_step(rnn_out[n_out])
    final_states = utils.pack_sequence_as(
        next_states, [_last_step(s) for s in rnn_out[n_out + 1:]])

    if type(decoder).finalize is not Decoder.finalize:
        final_outputs, final_states = decoder.finalize(
            final_outputs, final_states, sequence_lengths)

    if not output_time_major:
        final_outputs = map_structure(_transpose_batch_time, final_outputs)
    return final_outputs, final_states


def dynamic_lstmp(input, size, proj_size, *args, **kwargs):
    """Projected LSTM (ref rnn.py:1512): waits for the RNN slice."""
    raise _rnn_slice("dynamic_lstmp")
