"""StateCell / TrainingDecoder / BeamSearchDecoder python decoder API
(ref: python/paddle/fluid/contrib/decoder/beam_search_decoder.py); a copy
of paddle_tpu/fluid/contrib/decoder/beam_search_decoder.py, which builds
Programs without jax.

User contract preserved: describe one RNN step as a ``StateCell`` with a
``@state_cell.state_updater`` function built from ordinary layers, train
with ``TrainingDecoder`` (teacher forcing over target sequences), decode
with ``BeamSearchDecoder``.

Mapping:
- TrainingDecoder drives DynamicRNN (the ``dynamic_rnn`` op): the
  StateCell's states become its memories.
- BeamSearchDecoder.decode() adapts the StateCell into an RNNCell and
  runs it through layers.BeamSearchDecoder + dynamic_decode (fixed-length
  masked steps with a static beam), instead of the reference's
  While/TensorArray/LoD machinery. ``topk_size`` is unnecessary (the top
  k over beam*vocab is one op) and accepted for parity.
- Custom step graphs inside ``BeamSearchDecoder.block()`` (read_array /
  update_array / early_stop) are While-loop idioms with no masked-step
  analogue; they raise with guidance to the layers-level decoder API.
"""
import collections

from ... import unique_name
from ...framework import Variable
from ...layer_helper import LayerHelper

__all__ = ["InitState", "StateCell", "TrainingDecoder", "BeamSearchDecoder"]


class _DecoderType:
    TRAINING = 1
    BEAM_SEARCH = 2


class InitState:
    """Initial hidden state (ref beam_search_decoder.py:43): either an
    explicit variable or a constant tensor batched like ``init_boot``."""

    def __init__(self, init=None, shape=None, value=0.0, init_boot=None,
                 need_reorder=False, dtype="float32"):
        from ... import layers

        if init is not None:
            self._init = init
        elif init_boot is None:
            raise ValueError(
                "InitState: provide init or init_boot (to infer shape)"
            )
        else:
            self._init = layers.fill_constant_batch_size_like(
                input=init_boot, value=value,
                shape=shape or [-1] + list(init_boot.shape[1:]),
                dtype=dtype)
        self._shape = shape
        self._value = value
        # need_reorder sorts by LoD rank in the reference; dense-padded
        # batches have no rank table, rows already align
        self._need_reorder = need_reorder
        self._dtype = dtype

    @property
    def value(self):
        return self._init

    @property
    def need_reorder(self):
        return self._need_reorder


class _MemoryState:
    """TrainingDecoder state backing: a DynamicRNN memory."""

    def __init__(self, state_name, rnn_obj, init_state):
        self._state_name = state_name
        self._rnn_obj = rnn_obj
        self._state_mem = self._rnn_obj.memory(init=init_state.value)

    def get_state(self):
        return self._state_mem

    def update_state(self, state):
        self._rnn_obj.update_memory(self._state_mem, state)


class StateCell:
    """Named states + named step inputs + a user updater
    (ref beam_search_decoder.py:159). The same cell instance drives both
    a TrainingDecoder and a BeamSearchDecoder (sequentially)."""

    def __init__(self, inputs, states, out_state, name=None):
        self._helper = LayerHelper("state_cell", name=name)
        self._cur_states = {}
        self._state_names = []
        for state_name, state in states.items():
            if not isinstance(state, InitState):
                raise ValueError(
                    "StateCell states must be InitState objects"
                )
            self._cur_states[state_name] = state
            self._state_names.append(state_name)
        self._inputs = dict(inputs)
        self._cur_decoder_obj = None
        self._in_decoder = False
        self._states_holder = {}
        self._switched_decoder = False
        self._state_updater = None
        self._out_state = out_state
        if out_state not in self._cur_states:
            raise ValueError("out_state must be one of the states")

    # -- decoder attachment --------------------------------------------
    def _enter_decoder(self, decoder_obj):
        if self._in_decoder or self._cur_decoder_obj is not None:
            raise ValueError("StateCell has already entered a decoder")
        self._in_decoder = True
        self._cur_decoder_obj = decoder_obj
        self._switched_decoder = False

    def _leave_decoder(self, decoder_obj):
        if not self._in_decoder:
            raise ValueError("StateCell not in a decoder")
        if self._cur_decoder_obj is not decoder_obj:
            raise ValueError("inconsistent decoder object in StateCell")
        self._in_decoder = False
        self._cur_decoder_obj = None
        self._switched_decoder = False
        # restore InitState bindings so the cell can enter another decoder
        for name, holder in self._states_holder.items():
            if "init" in holder:
                self._cur_states[name] = holder["init"]
        self._states_holder = {}

    def _switch_decoder(self):
        if not self._in_decoder:
            raise ValueError("StateCell must enter a decoder first")
        if self._switched_decoder:
            raise ValueError("StateCell already switched decoder")
        for name in self._state_names:
            state = self._cur_states[name]
            if not isinstance(state, InitState):
                raise ValueError(
                    "state %r should be an InitState, got %s"
                    % (name, type(state))
                )
            holder = self._states_holder.setdefault(name, {})
            holder["init"] = state
            if self._cur_decoder_obj.type == _DecoderType.TRAINING:
                mem = _MemoryState(
                    name, self._cur_decoder_obj.dynamic_rnn, state)
                holder[id(self._cur_decoder_obj)] = mem
                self._cur_states[name] = mem.get_state()
            elif self._cur_decoder_obj.type == _DecoderType.BEAM_SEARCH:
                # beam decoder binds states itself (set_state per step)
                self._cur_states[name] = state.value
        self._switched_decoder = True

    # -- user API -------------------------------------------------------
    def get_state(self, state_name):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        if state_name not in self._cur_states:
            raise ValueError("unknown state %r" % state_name)
        s = self._cur_states[state_name]
        return s.value if isinstance(s, InitState) else s

    def get_input(self, input_name):
        if input_name not in self._inputs or self._inputs[input_name] is None:
            raise ValueError("invalid input %r" % input_name)
        return self._inputs[input_name]

    def set_state(self, state_name, state_value):
        self._cur_states[state_name] = state_value

    def state_updater(self, updater):
        self._state_updater = updater

        def _decorator(state_cell):
            if state_cell is self:
                raise TypeError(
                    "updater should accept a StateCell argument"
                )
            updater(state_cell)

        return _decorator

    def compute_state(self, inputs):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        for input_name, input_value in inputs.items():
            if input_name not in self._inputs:
                raise ValueError(
                    "unknown input %r (declared: %s)"
                    % (input_name, sorted(self._inputs))
                )
            self._inputs[input_name] = input_value
        if self._state_updater is None:
            raise ValueError(
                "no state updater: decorate one with "
                "@state_cell.state_updater"
            )
        self._state_updater(self)

    def update_states(self):
        if self._in_decoder and not self._switched_decoder:
            self._switch_decoder()
        for name, holder in self._states_holder.items():
            backer = holder.get(id(self._cur_decoder_obj))
            if backer is not None:
                backer.update_state(self._cur_states[name])

    def out_state(self):
        return self._cur_states[self._out_state]


class TrainingDecoder:
    """Teacher-forced decoder over DynamicRNN
    (ref beam_search_decoder.py:384)."""

    BEFORE_DECODER = 0
    IN_DECODER = 1
    AFTER_DECODER = 2

    def __init__(self, state_cell, name=None):
        from ... import layers

        self._helper = LayerHelper("training_decoder", name=name)
        self._status = TrainingDecoder.BEFORE_DECODER
        self._dynamic_rnn = layers.DynamicRNN()
        self._type = _DecoderType.TRAINING
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)

    def block(self):
        import contextlib

        @contextlib.contextmanager
        def _block():
            if self._status != TrainingDecoder.BEFORE_DECODER:
                raise ValueError("decoder.block() can only be invoked once")
            self._status = TrainingDecoder.IN_DECODER
            with self._dynamic_rnn.block():
                yield
            self._status = TrainingDecoder.AFTER_DECODER
            self._state_cell._leave_decoder(self)

        return _block()

    @property
    def state_cell(self):
        self._assert_in_decoder_block("state_cell")
        return self._state_cell

    @property
    def dynamic_rnn(self):
        return self._dynamic_rnn

    @property
    def type(self):
        return self._type

    def step_input(self, x):
        self._assert_in_decoder_block("step_input")
        return self._dynamic_rnn.step_input(x)

    def static_input(self, x):
        self._assert_in_decoder_block("static_input")
        return self._dynamic_rnn.static_input(x)

    def __call__(self, *args, **kwargs):
        if self._status != TrainingDecoder.AFTER_DECODER:
            raise ValueError(
                "TrainingDecoder output is only available after the block"
            )
        return self._dynamic_rnn(*args, **kwargs)

    def output(self, *outputs):
        self._assert_in_decoder_block("output")
        self._dynamic_rnn.output(*outputs)

    def _assert_in_decoder_block(self, method):
        if self._status != TrainingDecoder.IN_DECODER:
            raise ValueError(
                "%s must be invoked inside TrainingDecoder.block()" % method
            )


class _StateCellRNNCell:
    """Adapts a StateCell to the layers.RNNCell protocol so the beam
    machinery (expand/topk/gather over [batch, beam]) can drive it."""

    def __init__(self, state_cell, input_name, static_inputs):
        self._sc = state_cell
        self._input_name = input_name
        self._static_inputs = static_inputs  # {name: merged (B*beam, ...)}

    def __call__(self, inputs, states):
        sc = self._sc
        if not isinstance(states, (list, tuple)):
            states = [states]
        for name, s in zip(sc._state_names, states):
            sc.set_state(name, s)
        feed = dict(self._static_inputs)
        feed[self._input_name] = inputs
        sc.compute_state(feed)
        out = sc.out_state()
        new_states = [sc._cur_states[n] for n in sc._state_names]
        return out, new_states


class BeamSearchDecoder:
    """Beam-search inference decoder (ref beam_search_decoder.py:523).

    ``decode()`` builds the canonical flow — embed previous ids, advance
    the StateCell, project to vocab, beam-select — on the masked-step
    beam machinery. ``__call__`` returns (ids, scores) shaped
    (batch, beam, steps): dense-padded (end_id padding after finish)
    rather than the reference's ragged LoD arrays.
    """

    BEFORE_BEAM_SEARCH_DECODER = 0
    IN_BEAM_SEARCH_DECODER = 1
    AFTER_BEAM_SEARCH_DECODER = 2

    def __init__(self, state_cell, init_ids, init_scores, target_dict_dim,
                 word_dim, input_var_dict=None, topk_size=50,
                 sparse_emb=True, max_len=100, beam_size=1, end_id=1,
                 name=None):
        self._helper = LayerHelper("beam_search_decoder", name=name)
        self._type = _DecoderType.BEAM_SEARCH
        self._status = BeamSearchDecoder.BEFORE_BEAM_SEARCH_DECODER
        self._state_cell = state_cell
        self._state_cell._enter_decoder(self)
        self._init_ids = init_ids
        self._init_scores = init_scores
        self._target_dict_dim = target_dict_dim
        self._word_dim = word_dim
        self._input_var_dict = dict(input_var_dict or {})
        self._topk_size = topk_size  # parity: fused topk needs no cap
        self._sparse_emb = sparse_emb
        self._max_len = int(max_len)
        self._beam_size = int(beam_size)
        self._end_id = int(end_id)
        self._outputs = None

    @property
    def type(self):
        return self._type

    @property
    def state_cell(self):
        return self._state_cell

    def decode(self):
        from ... import layers

        if self._status != BeamSearchDecoder.BEFORE_BEAM_SEARCH_DECODER:
            raise ValueError("decode() can only be invoked once")
        self._status = BeamSearchDecoder.IN_BEAM_SEARCH_DECODER
        sc = self._state_cell
        # force state binding so InitState values are live variables
        sc._switch_decoder()

        emb_name = unique_name.generate(
            (self._helper.name or "beam_search_decoder") + "_emb")
        proj_name = unique_name.generate(
            (self._helper.name or "beam_search_decoder") + "_proj")
        # exposed so callers can tie these weights elsewhere (e.g. share
        # the target embedding with the training graph)
        self._emb_param_name = emb_name
        self._proj_param_name = proj_name

        def proj_attr(n):
            from ...param_attr import ParamAttr

            return ParamAttr(name=n)

        def embedding_fn(ids):
            return layers.embedding(
                ids, size=[self._target_dict_dim, self._word_dim],
                dtype="float32", is_sparse=self._sparse_emb,
                param_attr=proj_attr(emb_name))

        def output_fn(x):
            # raw logits: the beam step applies log-softmax itself
            return layers.fc(
                x, size=self._target_dict_dim,
                num_flatten_dims=len(x.shape) - 1,
                param_attr=proj_attr(proj_name), bias_attr=False)

        # static inputs (e.g. the encoded source) tile to the beam once
        static = {}
        for name, var in self._input_var_dict.items():
            if name not in sc._inputs:
                raise ValueError(
                    "input_var_dict key %r not declared in StateCell"
                    % name
                )
            static[name] = layers.BeamSearchDecoder.tile_beam_merge_with_batch(
                var, self._beam_size)
        dyn_inputs = [
            n for n in sc._inputs if n not in self._input_var_dict
        ]
        if len(dyn_inputs) != 1:
            raise ValueError(
                "exactly one StateCell input must remain for the "
                "previous-token embedding, got %s" % (dyn_inputs,)
            )
        cell = _StateCellRNNCell(sc, dyn_inputs[0], static)
        # the beam seeds from the CALLER's init_ids/init_scores variables
        # at runtime (ref decode() reads them in its While loop) — a
        # nonzero start token decodes from that token, not from 0
        decoder = layers.BeamSearchDecoder(
            cell,
            start_token=(self._init_ids if self._init_ids is not None
                         else 0),
            end_token=self._end_id,
            beam_size=self._beam_size, embedding_fn=embedding_fn,
            output_fn=output_fn, init_scores=self._init_scores)
        inits = [sc.get_state(n) for n in sc._state_names]
        outputs, final_states = layers.dynamic_decode(
            decoder, inits=inits if len(inits) > 1 else inits[0],
            max_step_num=self._max_len - 1)
        self._outputs = outputs
        self._final_states = final_states
        self._status = BeamSearchDecoder.AFTER_BEAM_SEARCH_DECODER
        sc._leave_decoder(self)

    def __call__(self):
        if self._status != BeamSearchDecoder.AFTER_BEAM_SEARCH_DECODER:
            raise ValueError("call decode() before reading the outputs")
        ids = self._outputs
        scores = getattr(self._final_states, "log_probs", None)
        return ids, scores

    # -- While-loop idioms without a masked-step analogue ---------------
    def block(self):
        raise NotImplementedError(
            "contrib BeamSearchDecoder.block(): custom per-step beam "
            "graphs are a While/TensorArray idiom; build on "
            "layers.BeamSearchDecoder + layers.dynamic_decode instead "
            "(same expand/topk/gather primitives, fixed-step compatible)"
        )

    early_stop = block
    read_array = block
    update_array = block

    def _parent_block(self):
        program = self._helper.main_program
        return program.current_block()
