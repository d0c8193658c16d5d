"""The Paddle book's semantic-role-labelling chapter (07.label_semantic_roles,
a stacked bidirectional LSTM under a linear-chain CRF) in the port against
the JAX package, on the CPU.

``db_lstm`` is the chapter's net as tests/test_book.py:238 builds it (the
padded (B, T, D) input needs ``num_flatten_dims=2`` in the fcs), with the
chapter's tanh fcs and the ``crfw`` transition at learning rate 1e-3, at
a small width: word_dim 32 (the width of ``conll05.get_embedding()``,
loaded into the frozen ``emb``), mark_dim 5, hidden 16 (a dynamic_lstm of
4 x 4), depth 4, over ``dataset.conll05``'s dictionaries, trained by SGD
under ``exponential_decay(0.01, 100000, 0.5, staircase=True)`` on
``conll05.test()`` batches of 4 fed through each package's DataFeeder
(nine ``lod_level=1`` slots). Both packages build the same Program JSON;
STEPS steps from the JAX startup's values give losses within LOSS_TOL
(1e-5) relative and first-step gradients within GRAD_TOL (1e-4) of each
parameter's largest; ``crf_decoding`` then gives the same paths, and
``chunk_eval`` of them the same counts.

The feeds' ``@SEQ_LEN`` companions stop at ``embedding`` and ``fc`` in
both packages, so the LSTMs and the CRF run over the whole padded axis
(ROADMAP.md Queue 3).
"""
import json
import math

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
STEPS = 4
BATCH = 4
FEATS = ["word_data", "ctx_n2_data", "ctx_n1_data", "ctx_0_data",
         "ctx_p1_data", "ctx_p2_data", "verb_data", "mark_data"]


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


def db_lstm(fl, word_dict_len, pred_dict_len, label_dict_len, word_dim=32,
            mark_dim=5, hidden_dim=16, depth=4, mark_dict_len=2):
    """The chapter's net, loss, decoding and chunk evaluation; returns its
    feed vars (in the reader's slot order), loss, decoded paths and the
    chunk counts."""
    L = fl.layers
    ins = {n: fl.data(name=n, shape=[None, None], dtype="int64",
                      lod_level=1) for n in FEATS}
    target = fl.data(name="target", shape=[None, None], dtype="int64",
                     lod_level=1)
    pred_emb = L.embedding(input=ins["verb_data"],
                           size=[pred_dict_len, word_dim], dtype="float32",
                           param_attr="vemb")
    mark_emb = L.embedding(input=ins["mark_data"],
                           size=[mark_dict_len, mark_dim], dtype="float32")
    emb_layers = [L.embedding(input=ins[n], size=[word_dict_len, word_dim],
                              param_attr=fl.ParamAttr(name="emb",
                                                      trainable=False))
                  for n in FEATS[:6]]
    emb_layers += [pred_emb, mark_emb]
    hidden_0 = L.sums(input=[L.fc(input=e, size=hidden_dim, act="tanh",
                                  num_flatten_dims=2) for e in emb_layers])
    lstm_0, _ = L.dynamic_lstm(input=hidden_0, size=hidden_dim,
                               candidate_activation="relu",
                               gate_activation="sigmoid",
                               cell_activation="sigmoid")
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = L.sums(input=[
            L.fc(input=input_tmp[0], size=hidden_dim, act="tanh",
                 num_flatten_dims=2),
            L.fc(input=input_tmp[1], size=hidden_dim, act="tanh",
                 num_flatten_dims=2)])
        lstm, _ = L.dynamic_lstm(input=mix_hidden, size=hidden_dim,
                                 candidate_activation="relu",
                                 gate_activation="sigmoid",
                                 cell_activation="sigmoid",
                                 is_reverse=((i % 2) == 1))
        input_tmp = [mix_hidden, lstm]
    feature_out = L.sums(input=[
        L.fc(input=input_tmp[0], size=label_dict_len, act="tanh",
             num_flatten_dims=2),
        L.fc(input=input_tmp[1], size=label_dict_len, act="tanh",
             num_flatten_dims=2)])
    crf_cost = L.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=fl.ParamAttr(name="crfw", learning_rate=1e-3))
    loss = L.mean(crf_cost)
    fl.optimizer.SGD(learning_rate=L.exponential_decay(
        learning_rate=0.01, decay_steps=100000, decay_rate=0.5,
        staircase=True)).minimize(loss)
    decoded = L.crf_decoding(input=feature_out,
                             param_attr=fl.ParamAttr(name="crfw"))
    counts = L.chunk_eval(input=decoded, label=target, chunk_scheme="IOB",
                          num_chunk_types=int(math.ceil(
                              (label_dict_len - 1) / 2.0)))[3:]
    return ([ins[n] for n in FEATS] + [target], loss, decoded, counts)


def _build(fl, un, dicts):
    un.switch()
    main, start = fl.Program(), fl.Program()
    start.random_seed = 7
    with fl.program_guard(main, start):
        out = db_lstm(fl, *dicts)
    return main, start, out


def test_book_srl_trains_and_decodes_like_jax():
    word_dict, verb_dict, label_dict = paddle.dataset.conll05.get_dict()
    dicts = (len(word_dict), len(verb_dict), len(label_dict))
    jmain, jstart, (jfeeds, jloss, jdec, jcounts) = _build(
        jfluid, jax_unique_name, dicts)
    pmain, pstart, (pfeeds, ploss, pdec, pcounts) = _build(
        fluid, pt_unique_name, dicts)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert json.loads(pstart.to_json()) == json.loads(jstart.to_json())

    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    jscope.set("emb", paddle.dataset.conll05.get_embedding())
    persist = [v.name for v in jstart.global_block().vars.values()
               if v.persistable]
    scope = fluid.Scope()
    for n, t in params_from_numpy({n: np.array(jscope[n]) for n in persist},
                                  torch.device("cpu")).items():
        scope.set(n, t)
    jfeeder = jfluid.DataFeeder(feed_list=jfeeds, place=jfluid.CPUPlace())
    pfeeder = fluid.DataFeeder(feed_list=pfeeds, place=fluid.CPUPlace())
    batches = []
    for b in paddle.batch(paddle.dataset.conll05.test(), BATCH)():
        batches.append(b)
        if len(batches) == STEPS + 1:
            break
    exe = fluid.Executor(fluid.CPUPlace())
    params = sorted(p.name for p in pmain.all_parameters())
    grads = [p + "@GRAD" for p in params if p != "emb"]
    for step in range(STEPS):
        fetch = [ploss] + (grads if step == 0 else [])
        jout = jexe.run(jmain, feed=jfeeder.feed(batches[step]),
                        scope=jscope,
                        fetch_list=[jloss] + fetch[1:])
        pout = exe.run(pmain, feed=pfeeder.feed(batches[step]), scope=scope,
                       fetch_list=fetch)
        jl, pl = float(np.asarray(jout[0])), float(pout[0])
        assert np.isfinite(pl) and abs(pl - jl) <= LOSS_TOL * abs(jl), (
            step, pl, jl)
        if step:
            continue
        for name, a, w in zip(grads, pout[1:], jout[1:]):
            w = np.asarray(w)
            assert a.shape == w.shape and np.isfinite(a).all(), name
            assert float(np.abs(a - w).max()) <= GRAD_TOL * max(
                float(np.abs(w).max()), 1e-30), name

    # decode a held-out batch with the trained weights; count chunks
    feed_j, feed_p = jfeeder.feed(batches[-1]), pfeeder.feed(batches[-1])
    want = jexe.run(jmain, feed=feed_j, scope=jscope,
                    fetch_list=[jdec] + list(jcounts))
    got = exe.run(pmain, feed=feed_p, scope=scope,
                  fetch_list=[pdec] + list(pcounts))
    lens = feed_p["word_data"].seq_lens
    assert got[0].shape == np.asarray(want[0]).shape == (BATCH, max(lens))
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    for a, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, np.asarray(w))
    assert int(got[2][0]) > 0                   # the batch has label chunks
