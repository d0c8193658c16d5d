"""The recurrent book chapters in the port against the JAX package, on the
CPU.

Each chapter (tests/test_book.py's sentiment LSTM, rnn_encoder_decoder
and contrib-decoder machine translation, and the book's
``06.understand_sentiment`` stacked-LSTM net at a small width, fed
through ``DataFeeder`` from ``dataset.imdb``) is built by the same layer
calls in both packages and must give the same Program JSON, startup
program included. It is then trained 5 steps in each package from the
JAX startup's values, carried into the port by ``params_from_numpy``:
every step's loss within LOSS_TOL (1e-5) relative of the JAX package's,
and the first step's gradient of every parameter within GRAD_TOL (1e-4)
of that parameter's largest JAX gradient (the same f32 ops, summed in
other orders). The contrib chapter then beam-decodes with
``BeamSearchDecoder`` on JAX-initialised parameters: ids equal, scores
within 1e-5 of the largest.
"""
import json

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import unique_name as jax_unique_name
import paddle_tpu_torch as paddle
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.io import params_from_numpy

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
SCORE_TOL = 1e-5
STEPS = 5


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, name generator and scope of the port."""
    old_main = pt_framework.switch_main_program(pt_framework.Program())
    old_startup = pt_framework.switch_startup_program(pt_framework.Program())
    old_gen = pt_unique_name.switch()
    old_scopes = pt_executor._scope_stack[:]
    pt_executor._scope_stack[:] = [pt_executor.Scope()]
    yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)
    pt_executor._scope_stack[:] = old_scopes


def _build(fl, un, fn, seed=3):
    un.switch()
    main, start = fl.Program(), fl.Program()
    start.random_seed = seed
    with fl.program_guard(main, start):
        vs = fn(fl)
    return main, start, vs


def _both(fn):
    """fn(fluid) built in each package: ((main, start, vs) JAX, port)."""
    j = _build(jfluid, jax_unique_name, fn)
    p = _build(fluid, pt_unique_name, fn)
    assert json.loads(p[0].to_json()) == json.loads(j[0].to_json())
    assert json.loads(p[1].to_json()) == json.loads(j[1].to_json())
    return j, p


def _jax_init(start):
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    exe.run(start, scope=scope)
    persist = [v.name for v in start.global_block().vars.values()
               if v.persistable]
    return exe, scope, {n: np.array(scope[n]) for n in persist}


def _port_scope(values):
    scope = fluid.Scope()
    for n, t in params_from_numpy(values, torch.device("cpu")).items():
        scope.set(n, t)
    return scope


def _train_both(fn, feeds, steps=STEPS):
    """`steps` training steps of fn's program in both packages from the
    JAX startup's values; losses and step-1 gradients compared. Returns
    the port's losses."""
    (jmain, jstart, jvs), (pmain, _, pvs) = _both(fn)
    jexe, jscope, init = _jax_init(jstart)
    scope = _port_scope(init)
    exe = fluid.Executor(fluid.CPUPlace())
    params = sorted(p.name for p in pmain.all_parameters())
    grads = [p + "@GRAD" for p in params]
    losses = []
    for step in range(steps):
        feed = feeds(step)
        jout = jexe.run(jmain, feed=feed, scope=jscope,
                        fetch_list=[jvs["loss"]] + grads)
        pout = exe.run(pmain, feed=feed, scope=scope,
                       fetch_list=[pvs["loss"]] + grads)
        jl, pl = float(np.asarray(jout[0])), float(pout[0])
        assert np.isfinite(pl) and abs(pl - jl) <= LOSS_TOL * abs(jl), (
            step, pl, jl)
        losses.append(pl)
        if step:
            continue
        for name, a, w in zip(params, pout[1:], jout[1:]):
            w = np.asarray(w)
            assert a.shape == w.shape and np.isfinite(a).all(), name
            assert float(np.abs(a - w).max()) <= GRAD_TOL * max(
                float(np.abs(w).max()), 1e-30), name
    return losses


# ---------------------------------------------------------------------------
# ch6: sentiment
# ---------------------------------------------------------------------------
SEQ, DICT, EMB, HID = 24, 300, 24, 32


def _sentiment_lstm(fl):
    """tests/test_book.py's understand_sentiment_lstm."""
    data = fl.layers.data(name="words", shape=[SEQ], dtype="int64",
                          lod_level=1)
    label = fl.layers.data(name="label", shape=[1], dtype="int64")
    emb = fl.layers.embedding(input=data, size=[DICT, EMB])
    fc1 = fl.layers.fc(input=emb, size=HID * 4, num_flatten_dims=2)
    lstm1, _ = fl.layers.dynamic_lstm(input=fc1, size=HID * 4)
    last = fl.layers.sequence_last_step(lstm1)
    prediction = fl.layers.fc(input=last, size=2, act="softmax")
    loss = fl.layers.mean(fl.layers.cross_entropy(input=prediction,
                                                  label=label))
    fl.optimizer.Adam(learning_rate=0.02).minimize(loss)
    return {"loss": loss}


def test_book_sentiment_lstm_trains_like_jax():
    rng = np.random.RandomState(1)
    n = 32
    xs = rng.randint(1, DICT, size=(n, SEQ)).astype("int64")
    lens = rng.randint(5, SEQ + 1, size=n).astype("int32")
    ys = (xs[:, 0] > DICT // 2).astype("int64").reshape(-1, 1)
    losses = _train_both(_sentiment_lstm, lambda i: {
        "words": xs, "words@SEQ_LEN": lens, "label": ys})
    assert losses[-1] < losses[0], losses


def stacked_lstm_net(fl, dict_dim, emb_dim, hid_dim, stacked_num,
                     class_dim=2, lr=0.002):
    """The book's 06.understand_sentiment stacked_lstm_net (its
    train_stacked_lstm.py settings by default elsewhere): the per-token
    fcs take num_flatten_dims=2, as padded (B, T, D) input needs."""
    assert stacked_num % 2 == 1
    data = fl.data(name="words", shape=[None, None], dtype="int64",
                   lod_level=1)
    label = fl.data(name="label", shape=[None, 1], dtype="int64")
    emb = fl.layers.embedding(input=data, size=[dict_dim, emb_dim],
                              is_sparse=True)
    fc1 = fl.layers.fc(input=emb, size=hid_dim, num_flatten_dims=2)
    lstm1, _ = fl.layers.dynamic_lstm(input=fc1, size=hid_dim)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = fl.layers.fc(input=inputs, size=hid_dim, num_flatten_dims=2)
        lstm, _ = fl.layers.dynamic_lstm(input=fc, size=hid_dim,
                                         is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = fl.layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = fl.layers.sequence_pool(input=inputs[1], pool_type="max")
    prediction = fl.layers.fc(input=[fc_last, lstm_last], size=class_dim,
                              act="softmax")
    loss = fl.layers.mean(fl.layers.cross_entropy(input=prediction,
                                                  label=label))
    acc = fl.layers.accuracy(input=prediction, label=label)
    fl.optimizer.Adagrad(learning_rate=lr).minimize(loss)
    return {"words": data, "label": label, "loss": loss, "acc": acc,
            "prediction": prediction}


def test_book_stacked_lstm_net_through_data_feeder_trains_like_jax():
    """The stacked net at EMB 16 / HID 32 / 3 layers (the middle one
    reverse) on dataset.imdb batches of 16 fed through each package's
    DataFeeder: the feeds are ragged, padded per batch."""
    word_dict = paddle.dataset.imdb.word_dict()
    batches = []
    for b in paddle.batch(paddle.dataset.imdb.train(word_dict), 16)():
        batches.append(b)
        if len(batches) == STEPS:
            break
    fn = lambda fl: stacked_lstm_net(fl, len(word_dict), 16, 32, 3,
                                     lr=0.05)
    (jmain, _, jvs), (pmain, _, pvs) = _both(fn)
    jfeeder = jfluid.DataFeeder(feed_list=[jvs["words"], jvs["label"]],
                                place=jfluid.CPUPlace())
    pfeeder = fluid.DataFeeder(feed_list=[pvs["words"], pvs["label"]],
                               place=fluid.CPUPlace())
    for b in batches:
        jf, pf = jfeeder.feed(b), pfeeder.feed(b)
        np.testing.assert_array_equal(np.asarray(pf["words"]),
                                      np.asarray(jf["words"]))
        np.testing.assert_array_equal(pf["words"].seq_lens,
                                      jf["words"].seq_lens)
        np.testing.assert_array_equal(pf["label"], jf["label"])
    lens = [pfeeder.feed(b)["words"].seq_lens for b in batches]
    assert len({int(l.max()) for l in lens}) > 1    # padded per batch
    losses = _train_both(fn, lambda i: pfeeder.feed(batches[i]))
    assert all(np.isfinite(losses))


# ---------------------------------------------------------------------------
# the recurrent seq2seq chapters
# ---------------------------------------------------------------------------
V_SRC, V_TGT, ENC, DEC, T = 60, 60, 8, 8, 10


def _lstm_step(fl, x_t, hidden_t_prev, cell_t_prev, size):
    def linear(inputs):
        return fl.layers.fc(input=inputs, size=size, bias_attr=True)

    forget_gate = fl.layers.sigmoid(x=linear([hidden_t_prev, x_t]))
    input_gate = fl.layers.sigmoid(x=linear([hidden_t_prev, x_t]))
    output_gate = fl.layers.sigmoid(x=linear([hidden_t_prev, x_t]))
    cell_tilde = fl.layers.tanh(x=linear([hidden_t_prev, x_t]))
    cell_t = fl.layers.sums(input=[
        fl.layers.elementwise_mul(x=forget_gate, y=cell_t_prev),
        fl.layers.elementwise_mul(x=input_gate, y=cell_tilde)])
    hidden_t = fl.layers.elementwise_mul(
        x=output_gate, y=fl.layers.tanh(x=cell_t))
    return hidden_t, cell_t


def rnn_encoder_decoder(fl, v_src=V_SRC, v_tgt=V_TGT, emb=12, enc=ENC,
                        dec=DEC, t=T, lr=0.02):
    """tests/test_book.py's rnn_encoder_decoder (ref book/
    test_rnn_encoder_decoder.py): a forward and a reverse dynamic_lstm
    encoder, pooled by sequence_last_step / sequence_first_step, feeding
    a hand-built LSTM decoder written with DynamicRNN."""
    src = fl.data("re_src", shape=[None, t], dtype="int64", lod_level=1)
    trg = fl.data("re_trg", shape=[None, t], dtype="int64", lod_level=1)
    lbl = fl.data("re_lbl", shape=[None, t, 1], dtype="int64", lod_level=1)
    src_emb = fl.layers.embedding(input=src, size=[v_src, emb],
                                  dtype="float32")
    fwd_proj = fl.layers.fc(input=src_emb, size=enc * 4, bias_attr=True,
                            num_flatten_dims=2)
    forward, _ = fl.layers.dynamic_lstm(input=fwd_proj, size=enc * 4,
                                        use_peepholes=False)
    bwd_proj = fl.layers.fc(input=src_emb, size=enc * 4, bias_attr=True,
                            num_flatten_dims=2)
    backward, _ = fl.layers.dynamic_lstm(input=bwd_proj, size=enc * 4,
                                         is_reverse=True,
                                         use_peepholes=False)
    src_forward_last = fl.layers.sequence_last_step(input=forward)
    src_backward_first = fl.layers.sequence_first_step(input=backward)
    encoded = fl.layers.concat(input=[src_forward_last, src_backward_first],
                               axis=1)
    decoder_boot = fl.layers.fc(input=src_backward_first, size=dec,
                                bias_attr=False, act="tanh")
    trg_emb = fl.layers.embedding(input=trg, size=[v_tgt, emb],
                                  dtype="float32")
    rnn = fl.layers.DynamicRNN()
    cell_init = fl.layers.fill_constant_batch_size_like(
        input=decoder_boot, value=0.0, shape=[-1, dec], dtype="float32")
    cell_init.stop_gradient = False
    with rnn.block():
        current_word = rnn.step_input(trg_emb)
        context = rnn.static_input(encoded)
        hidden_mem = rnn.memory(init=decoder_boot, need_reorder=True)
        cell_mem = rnn.memory(init=cell_init)
        decoder_inputs = fl.layers.concat(input=[context, current_word],
                                          axis=1)
        h, c = _lstm_step(fl, decoder_inputs, hidden_mem, cell_mem, dec)
        rnn.update_memory(hidden_mem, h)
        rnn.update_memory(cell_mem, c)
        out = fl.layers.fc(input=h, size=v_tgt, bias_attr=True,
                           act="softmax")
        rnn.output(out)
    prediction = rnn()
    loss = fl.layers.mean(x=fl.layers.cross_entropy(input=prediction,
                                                    label=lbl))
    fl.optimizer.Adam(learning_rate=lr).minimize(loss)
    return {"loss": loss, "prediction": prediction}


def rnn_encoder_decoder_feed(batch, t=T, v=V_SRC, seed=0):
    rng = np.random.default_rng(seed)
    srcs = rng.integers(1, v, (batch, t)).astype("int64")
    trgs = np.roll(srcs, 1, axis=1)
    lbls = np.roll(trgs, -1, axis=1)[:, :, None]
    lens = rng.integers(4, t + 1, batch).astype("int32")
    return {"re_src": srcs, "re_src@SEQ_LEN": lens,
            "re_trg": trgs, "re_trg@SEQ_LEN": lens,
            "re_lbl": lbls, "re_lbl@SEQ_LEN": lens}


def test_book_rnn_encoder_decoder_trains_like_jax():
    """Autograd through DynamicRNN's step block (each step's memories and
    outputs masked by the lengths) and both encoder directions."""
    feed = rnn_encoder_decoder_feed(8)
    losses = _train_both(rnn_encoder_decoder, lambda i: feed)
    assert losses[-1] < losses[0], losses


MT_V, MT_EMB, MT_HID, MT_T = 40, 12, 16, 6


def _mt_updater(fl, hid):
    def updater(sc):
        xt = sc.get_input("x")
        h = sc.get_state("h")
        sc.set_state("h", fl.layers.fc(
            fl.layers.concat([xt, h], axis=-1), hid, act="tanh",
            num_flatten_dims=len(xt.shape) - 1,
            param_attr=fl.ParamAttr("mtc_step.w"),
            bias_attr=fl.ParamAttr("mtc_step.b")))

    return updater


def mt_contrib_train(fl, v=MT_V, emb=MT_EMB, hid=MT_HID, t=MT_T, lr=5e-3):
    """tests/test_book.py's machine_translation_contrib_decoder, training
    side: StateCell + TrainingDecoder (teacher forcing over DynamicRNN)."""
    from importlib import import_module

    dec = import_module(fl.__name__ + ".contrib.decoder")
    src = fl.data("mtc_src", shape=[None, t], dtype="int64")
    trg = fl.data("mtc_trg", shape=[None, t], dtype="int64")
    lab = fl.data("mtc_lab", shape=[None, t], dtype="int64")
    src_emb = fl.layers.embedding(src, size=[v, emb],
                                  param_attr=fl.ParamAttr("mtc_semb"))
    enc = fl.layers.fc(fl.layers.reduce_mean(src_emb, dim=[1]), hid,
                       act="tanh")
    trg_emb = fl.layers.embedding(trg, size=[v, emb],
                                  param_attr=fl.ParamAttr("mtc_temb"))
    state_cell = dec.StateCell(inputs={"x": None},
                               states={"h": dec.InitState(init=enc)},
                               out_state="h")
    state_cell.state_updater(_mt_updater(fl, hid))
    decoder = dec.TrainingDecoder(state_cell)
    with decoder.block():
        cur = decoder.step_input(trg_emb)
        state_cell.compute_state(inputs={"x": cur})
        out = fl.layers.fc(state_cell.get_state("h"), v,
                           param_attr=fl.ParamAttr("mtc_out.w"),
                           bias_attr=False)
        state_cell.update_states()
        decoder.output(out)
    logits = decoder()
    loss = fl.layers.mean(fl.layers.softmax_with_cross_entropy(
        logits, fl.layers.unsqueeze(lab, [2])))
    fl.optimizer.Adam(learning_rate=lr).minimize(loss)
    return {"loss": loss}


def mt_contrib_beam(fl, v=MT_V, emb=MT_EMB, hid=MT_HID, t=MT_T, beam=3):
    """The chapter's inference side: BeamSearchDecoder over the same
    StateCell updater, seeded from fed init_ids/init_scores."""
    from importlib import import_module

    dec = import_module(fl.__name__ + ".contrib.decoder")
    src = fl.data("mtc_src", shape=[None, t], dtype="int64")
    init_ids = fl.data("mtc_iid", shape=[None, 1], dtype="int64")
    init_scores = fl.data("mtc_isc", shape=[None, 1], dtype="float32")
    semb = fl.layers.embedding(src, size=[v, emb],
                               param_attr=fl.ParamAttr("mtc_semb"))
    enc = fl.layers.fc(fl.layers.reduce_mean(semb, dim=[1]), hid,
                       act="tanh")
    sc = dec.StateCell(inputs={"x": None},
                       states={"h": dec.InitState(init=enc)},
                       out_state="h")
    sc.state_updater(_mt_updater(fl, hid))
    bsd = dec.BeamSearchDecoder(
        sc, init_ids=init_ids, init_scores=init_scores, target_dict_dim=v,
        word_dim=emb, beam_size=beam, max_len=t, end_id=1)
    bsd.decode()
    ids, scores = bsd()
    return {"ids": ids, "scores": scores}


def mt_feed(batch, v=MT_V, t=MT_T, seed=9):
    rng = np.random.default_rng(seed)
    srcv = rng.integers(2, v, (batch, t)).astype("int64")
    trgv = np.roll(srcv, 1, axis=1)
    return {"mtc_src": srcv, "mtc_trg": trgv, "mtc_lab": (trgv * 3 + 1) % v}


def test_book_contrib_decoder_trains_and_beam_decodes_like_jax():
    feed = mt_feed(16)
    losses = _train_both(mt_contrib_train, lambda i: feed)
    assert losses[-1] < losses[0], losses
    (jmain, jstart, jvs), (pmain, _, pvs) = _both(mt_contrib_beam)
    jexe, jscope, init = _jax_init(jstart)
    b = 4
    infer = {"mtc_src": feed["mtc_src"][:b],
             "mtc_iid": np.zeros((b, 1), "int64"),
             "mtc_isc": np.zeros((b, 1), "float32")}
    want = jexe.run(jmain, feed=infer, scope=jscope,
                    fetch_list=[jvs["ids"], jvs["scores"]])
    got = fluid.Executor(fluid.CPUPlace()).run(
        pmain, feed=infer, scope=_port_scope(init),
        fetch_list=[pvs["ids"], pvs["scores"]])
    ids, scores = got
    w_ids, w_scores = (np.asarray(x) for x in want)
    assert ids.shape == w_ids.shape and ids.shape[-1] == 3
    assert ids.dtype == np.int64
    np.testing.assert_array_equal(ids, w_ids)
    assert float(np.abs(scores - w_scores).max()) <= SCORE_TOL * float(
        np.abs(w_scores).max())


def test_book_nets_read_no_lengths_past_embedding_and_fc():
    """The JAX package's ``embedding`` and ``fc`` do not pass a feed's
    ``@SEQ_LEN`` companion on (ROADMAP.md Queue 3), so in the stacked net
    every ``lstm`` and max pool reads the whole padded axis, in both
    packages alike: the lengths change nothing downstream of the
    embedding."""
    (jmain, _, _), (pmain, _, _) = _both(
        lambda fl: stacked_lstm_net(fl, 50, 8, 16, 3))
    for main in (jmain, pmain):
        ops = [op for op in main.global_block().ops
               if op.type in ("lstm", "sequence_pool")]
        assert len(ops) == 5
        assert not any(op.inputs.get("SeqLen") for op in ops)
