"""The recurrent slice of the port against the JAX package, on the CPU.

- The 8 recurrent op types (``lstm``, ``lstmp``, ``gru``, ``lstm_unit``,
  ``gru_unit``, ``cudnn_lstm``, ``beam_search``, ``beam_search_decode``):
  each lowering against the JAX lowering on the same seeded numpy inputs,
  forward within FWD_TOL (1e-6) of the largest value and bit for bit for
  ids, gradients (torch.autograd against jax.vjp, one random cotangent)
  within GRAD_TOL (1e-5) of the largest JAX gradient. The cases hold the
  reference's choices: ``lstm`` ignores the peephole columns of its
  (1, 7D) bias, ``lstmp`` applies them and its clips, ``is_reverse`` with
  lengths consumes the padding first with the state held at H0, a padded
  step repeats the row's last state, ``origin_mode`` swaps the GRU's
  blend, ``cudnn_lstm`` gives LastH = LastC = Out[:, -1] whatever the
  lengths, a finished beam offers (end_id, pre_score) and ties come out in
  index order, absent ``Parents`` mean the identity.
- The layers, as the JAX package's tests/test_rnn_cells.py,
  test_sequence_and_rnn.py, test_contrib_decoder.py and the three
  DynamicRNN tests of test_dynamic_rnn_io.py drive them: each program
  built by the same calls in both packages (the same Program JSON), run
  on the JAX startup's values, every fetch within PROGRAM_TOL (1e-5) of
  its largest value (recurrences carry the packages' rounding over the
  steps) and ids equal; training programs 5 steps, losses within 1e-5
  relative and step-1 gradients within 1e-4 of each parameter's largest
  (test_torch_book_rnn.py's harness). The reference tests' own checks
  (frozen states, clip bounds, lengths) hold on the port's values.
- Liveness: ``LivePlan`` keeps a ``dynamic_rnn``'s fetched outputs and
  every memory a live op reads, and drops the rest.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import lowering as pt_lowering_mod
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering
from test_torch_book_rnn import _both, _jax_init, _port_scope, _train_both
from test_torch_sequence_ops import (GRAD_TOL, _assert_same, _grads_both,
                                     _rand, _run_both)

PROGRAM_TOL = 1e-5

RNN_OPS = ("lstm", "lstmp", "gru", "lstm_unit", "gru_unit", "cudnn_lstm",
           "beam_search", "beam_search_decode")


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


def test_every_new_op_has_a_port_lowering():
    for op in RNN_OPS:
        pt_lowering(op)


B, T, D = 3, 5, 4
LENS = np.array([5, 2, 3], np.int32)


def _case(name):
    """(op, ins, attrs, differentiable input slots, output slot)."""
    x4 = _rand(B, T, 4 * D, seed=1)
    w4 = _rand(D, 4 * D, seed=2) * 0.5
    h0, c0 = _rand(B, D, seed=3), _rand(B, D, seed=4)
    lstm_ins = {"Input": [x4], "Weight": [w4],
                "Bias": [_rand(1, 7 * D, seed=5)], "SeqLen": [LENS],
                "H0": [h0], "C0": [c0]}
    gru_ins = {"Input": [_rand(B, T, 3 * D, seed=6)],
               "Weight": [_rand(D, 3 * D, seed=7) * 0.5],
               "Bias": [_rand(1, 3 * D, seed=8)], "SeqLen": [LENS],
               "H0": [h0]}
    p = 3
    lstmp_ins = {"Input": [x4], "Weight": [_rand(p, 4 * D, seed=9) * 0.5],
                 "ProjWeight": [_rand(D, p, seed=10)],
                 "Bias": [_rand(1, 7 * D, seed=11)], "SeqLen": [LENS]}
    cudnn_ins = {"Input": [_rand(B, T, 6, seed=12)],
                 "WeightIh": [_rand(6, 4 * D, seed=13),
                              _rand(6, 4 * D, seed=14),
                              _rand(2 * D, 4 * D, seed=15),
                              _rand(2 * D, 4 * D, seed=16)],
                 "WeightHh": [_rand(D, 4 * D, seed=17 + i) * 0.5
                              for i in range(4)],
                 "Bias": [_rand(4 * D, seed=21 + i) for i in range(4)],
                 "SeqLen": [LENS]}
    lstm_attrs = {"use_peepholes": True, "gate_activation": "sigmoid",
                  "cell_activation": "tanh",
                  "candidate_activation": "tanh"}
    return {
        "lstm": ("lstm", lstm_ins, dict(lstm_attrs),
                 ["Input", "Weight", "Bias", "H0", "C0"], "Hidden"),
        "lstm_reverse": ("lstm", lstm_ins, dict(lstm_attrs, is_reverse=True),
                         ["Input", "Weight", "Bias", "H0", "C0"], "Hidden"),
        "lstm_last_cell": ("lstm", lstm_ins, dict(lstm_attrs), ["Input"],
                           "LastC"),
        "lstm_plain": ("lstm", {"Input": [x4], "Weight": [w4]},
                       {"candidate_activation": "relu"}, ["Input", "Weight"],
                       "Cell"),
        "lstmp": ("lstmp", lstmp_ins,
                  {"use_peepholes": True, "cell_clip": 1.5, "proj_clip": 0.4},
                  ["Input", "Weight", "ProjWeight", "Bias"], "Projection"),
        "lstmp_reverse": ("lstmp", lstmp_ins,
                          {"use_peepholes": False, "is_reverse": True,
                           "proj_activation": "identity"},
                          ["Input", "Weight", "ProjWeight", "Bias"], "Cell"),
        "gru": ("gru", gru_ins, {}, ["Input", "Weight", "Bias", "H0"],
                "Hidden"),
        "gru_origin_reverse": ("gru", gru_ins,
                               {"origin_mode": True, "is_reverse": True},
                               ["Input", "Weight", "Bias", "H0"], "Hidden"),
        "lstm_unit": ("lstm_unit", {"X": [_rand(B, 4 * D, seed=30)],
                                    "C_prev": [c0]},
                      {"forget_bias": 1.0}, ["X", "C_prev"], "H"),
        "gru_unit": ("gru_unit", {"Input": [_rand(B, 3 * D, seed=31)],
                                  "HiddenPrev": [h0],
                                  "Weight": [_rand(D, 3 * D, seed=32)],
                                  "Bias": [_rand(1, 3 * D, seed=33)]},
                     {}, ["Input", "HiddenPrev", "Weight", "Bias"],
                     "Hidden"),
        "gru_unit_origin_relu": ("gru_unit",
                                 {"Input": [_rand(B, 3 * D, seed=34)],
                                  "HiddenPrev": [h0],
                                  "Weight": [_rand(D, 3 * D, seed=35)]},
                                 {"origin_mode": True,
                                  "gate_activation": "tanh",
                                  "activation": "relu"},
                                 ["Input", "HiddenPrev", "Weight"],
                                 "ResetHiddenPrev"),
        "cudnn_lstm": ("cudnn_lstm", cudnn_ins,
                       {"num_layers": 2, "is_bidirec": True},
                       ["Input", "WeightIh", "WeightHh", "Bias"], "Out"),
    }[name]


CASES = ("lstm", "lstm_reverse", "lstm_last_cell", "lstm_plain", "lstmp",
         "lstmp_reverse", "gru", "gru_origin_reverse", "lstm_unit",
         "gru_unit", "gru_unit_origin_relu", "cudnn_lstm")


def _match(got, want, what):
    for slot in want:
        assert len(got[slot]) == len(want[slot]), (what, slot)
        for a, w in zip(got[slot], want[slot]):
            _assert_same(a, w, "%s.%s" % (what, slot))


@pytest.mark.parametrize("case", CASES)
def test_lowering_matches_jax(case):
    op, ins, attrs, wrt, out = _case(case)
    got, want = _run_both(op, ins, attrs)
    _match(got, want, case)
    gots, wants = _grads_both(op, ins, attrs, wrt, out)
    assert len(gots) == len(wants) == sum(len(ins[s]) for s in wrt)
    for i, (a, w) in enumerate(zip(gots, wants)):
        assert a.shape == w.shape, (case, i)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(a - w).max()) <= GRAD_TOL * scale, (case, i)


def test_padded_steps_hold_the_state_and_reverse_starts_at_h0():
    _, ins, attrs, _, _ = _case("lstm")
    fwd, _ = _run_both("lstm", ins, attrs)
    h = fwd["Hidden"][0]
    for b, n in enumerate(LENS):
        for t in range(n, T):                 # past the length: held
            np.testing.assert_array_equal(h[b, t], h[b, n - 1])
        np.testing.assert_array_equal(fwd["LastH"][0][b], h[b, n - 1])
    rev, _ = _run_both("lstm", ins, dict(attrs, is_reverse=True))
    h0 = ins["H0"][0]
    for b, n in enumerate(LENS):
        for t in range(n, T):                 # the padding comes first
            np.testing.assert_array_equal(rev["Hidden"][0][b, t], h0[b])
        np.testing.assert_array_equal(rev["LastH"][0][b],
                                      rev["Hidden"][0][b, 0])


def test_lstm_ignores_the_peephole_columns():
    _, ins, attrs, _, _ = _case("lstm")
    other = dict(ins, Bias=[ins["Bias"][0].copy()])
    other["Bias"][0][:, 4 * D:] = 9.0
    a, _ = _run_both("lstm", ins, attrs)
    b, _ = _run_both("lstm", other, attrs)
    np.testing.assert_array_equal(a["Hidden"][0], b["Hidden"][0])
    # lstmp reads them
    _, pins, pattrs, _, _ = _case("lstmp")
    pother = dict(pins, Bias=[pins["Bias"][0].copy()])
    pother["Bias"][0][:, 4 * D:] = 9.0
    a, _ = _run_both("lstmp", pins, pattrs)
    b, _ = _run_both("lstmp", pother, pattrs)
    assert not np.array_equal(a["Cell"][0], b["Cell"][0])
    assert np.abs(a["Projection"][0]).max() <= 0.4
    assert np.abs(a["Cell"][0]).max() <= 1.5


def test_cudnn_lstm_last_state_is_the_last_column():
    """The reference's LastH = LastC = Out[:, -1], ndir·D wide, whatever
    the lengths (ROADMAP.md Queue 3): kept for parity."""
    _, ins, attrs, _, _ = _case("cudnn_lstm")
    got, want = _run_both("cudnn_lstm", ins, attrs)
    out = got["Out"][0]
    assert out.shape == (B, T, 2 * D)
    for slot in ("LastH", "LastC"):
        np.testing.assert_array_equal(got[slot][0], out[:, -1])
        np.testing.assert_array_equal(want[slot][0], want["Out"][0][:, -1])


def test_beam_search_finished_beams_and_ties():
    beam, k = 2, 3
    ins = {"pre_ids": [np.array([[5], [0], [7], [3]], np.int64)],
           "pre_scores": [np.array([[-1.0], [-0.5], [-2.0], [-2.0]],
                                   np.float32)],
           "ids": [np.array([[1, 2, 3], [4, 5, 6], [8, 9, 2], [4, 4, 1]],
                            np.int64)],
           "scores": [np.array([[-0.7, -0.9, -1.2], [-0.1, -0.2, -0.3],
                                [-2.5, -2.5, -3.0], [-2.5, -2.6, -2.5]],
                               np.float32)]}
    attrs = {"beam_size": beam, "end_id": 0}
    got, want = _run_both("beam_search", ins, attrs)
    _match(got, want, "beam_search")
    # row 0: beam 1 is finished and offers (end_id 0, -0.5) only
    assert got["selected_ids"][0][:2, 0].tolist() == [0, 1]
    np.testing.assert_array_equal(got["selected_scores"][0][:2, 0],
                                  np.float32([-0.5, -0.7]))
    assert got["parent_idx"][0][:2].tolist() == [1, 0]
    # row 1: four candidates tie at -2.5: index order
    assert got["selected_ids"][0][2:, 0].tolist() == [8, 9]
    assert got["parent_idx"][0][2:].tolist() == [2, 2]
    for slot in ("selected_ids", "parent_idx"):
        assert got[slot][0].dtype == np.int64


@pytest.mark.parametrize("parents", [True, False])
def test_beam_search_decode_matches_jax(parents):
    rng = np.random.default_rng(8)
    steps, bb = 4, 6
    ins = {"Ids": [rng.integers(0, 9, (steps, bb, 1)).astype(np.int64)],
           "Scores": [_rand(steps, bb, 1, seed=9)]}
    if parents:
        ins["Parents"] = [rng.integers(0, bb, (steps, bb)).astype(np.int64)]
    got, want = _run_both("beam_search_decode", ins, {"beam_size": 2,
                                                      "end_id": 1})
    _match(got, want, "beam_search_decode")
    if not parents:
        np.testing.assert_array_equal(got["SentenceIds"][0],
                                      ins["Ids"][0][:, :, 0].T)
    np.testing.assert_array_equal(got["SentenceScores"][0],
                                  ins["Scores"][0][-1, :, 0])


# ---------------------------------------------------------------------------
# layers: programs run by both packages
# ---------------------------------------------------------------------------
def _close(a, w, what=""):
    w = np.asarray(w)
    assert a.shape == w.shape, (what, a.shape, w.shape)
    if not np.issubdtype(w.dtype, np.floating):
        np.testing.assert_array_equal(a, w.astype(a.dtype), err_msg=what)
        return
    assert np.isfinite(a).all(), what
    scale = max(float(np.abs(w).max()), 1e-30)
    assert float(np.abs(a - w).max()) <= PROGRAM_TOL * scale, what


def _run_programs(fn, feeds):
    """fn(fluid) -> fetch vars, built in both packages (same Program
    JSON) and run on the JAX startup's values for each feed. Returns the
    port's fetches per feed and the parameter values."""
    (jmain, jstart, jouts), (pmain, _, pouts) = _both(fn)
    jexe, jscope, init = _jax_init(jstart)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = _port_scope(init)
    runs = []
    for feed in feeds:
        want = jexe.run(jmain, feed=feed, fetch_list=jouts, scope=jscope)
        got = exe.run(pmain, feed=feed, fetch_list=pouts, scope=scope)
        for o, a, w in zip(pouts, got, want):
            _close(a, w, o.name)
        runs.append(got)
    return runs, init, pmain


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        "float32")


def test_rnn_gru_cell_time_major_and_reverse():
    """rnn(GRUCell) batch-major, reversed and time-major (ref
    test_rnn_gru_cell_matches_numpy, test_rnn_is_reverse,
    test_rnn_time_major); the GRU oracle on the port's output."""
    def fn(fl):
        L = fl.layers
        x = fl.data("x", (None, 5, 4), "float32")
        xtm = L.data("xtm", (5, -1, 4), append_batch_size=False,
                     dtype="float32")
        outs, final = L.rnn(L.GRUCell(hidden_size=6, name="g"), x)
        rev, _ = L.rnn(L.GRUCell(hidden_size=6, name="revgru"), x,
                       is_reverse=True)
        tm, tm_final = L.rnn(L.GRUCell(hidden_size=6, name="tmgru"), xtm,
                             time_major=True)
        return [outs, final, rev, tm, tm_final]

    xv = _x(3, 5, 4)
    (out, fin, rev, tm, tm_fin), = _run_programs(
        fn, [{"x": xv, "xtm": xv.transpose(1, 0, 2).copy()}])[0]
    assert tm.shape == (5, 3, 6) and tm_fin.shape == (3, 6)
    np.testing.assert_array_equal(tm[-1], tm_fin)
    np.testing.assert_array_equal(out[:, -1], fin)
    assert rev.shape == out.shape


def test_rnn_lstm_cell_seq_len_masks_the_state_by_arithmetic():
    """rnn(LSTMCell, sequence_length) (ref
    test_rnn_lstm_cell_seq_len_and_reverse): past a row's length the
    state is held, new·m + old·(1 − m), and the step output is the raw
    cell output."""
    def fn(fl):
        x = fl.data("x", (None, 4, 3), "float32")
        sl = fl.data("sl", (None,), "int64")
        cell = fl.layers.LSTMCell(hidden_size=5)
        outs, final = fl.layers.rnn(cell, x, sequence_length=sl)
        rev, rfin = fl.layers.rnn(fl.layers.LSTMCell(hidden_size=5,
                                                     name="rl"), x,
                                  sequence_length=sl, is_reverse=True)
        return [outs, final[0], final[1], rev, rfin[0]]

    xv = _x(2, 4, 3, seed=1)
    slv = np.array([4, 2], "int64")
    runs, init, pmain = _run_programs(fn, [{"x": xv, "sl": slv}])
    outs, h_fin, c_fin, rev, _ = runs[0]
    names = [p.name for p in pmain.global_block().all_parameters()]
    w, b = init[names[0]], init[names[1]]
    h = np.zeros((2, 5), "float32")
    c = np.zeros((2, 5), "float32")
    for t in range(4):
        gates = np.concatenate([xv[:, t], h], axis=1) @ w + b
        i, j, f, o = np.split(gates, 4, axis=1)
        c_new = c * _sigmoid(f + 1.0) + _sigmoid(i) * np.tanh(j)
        h_new = np.tanh(c_new) * _sigmoid(o)
        np.testing.assert_allclose(outs[:, t], h_new, rtol=2e-5, atol=2e-5)
        live = (t < slv)[:, None]
        h = np.where(live, h_new, h)
        c = np.where(live, c_new, c)
    np.testing.assert_allclose(h_fin, h, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(c_fin, c, rtol=2e-5, atol=2e-5)


def _mse(fl, pred, y):
    L = fl.layers
    return L.reduce_mean(L.square(L.elementwise_sub(pred, y)))


def test_rnn_lstm_cell_trains_like_jax():
    """ref test_rnn_trains: autograd through rnn()'s StaticRNN."""
    def fn(fl):
        L = fl.layers
        x = fl.data("x", (None, 6, 3), "float32")
        y = fl.data("y", (None, 1), "float32")
        _, final = L.rnn(L.LSTMCell(hidden_size=8), x)
        loss = _mse(fl, L.fc(final[0], 1), y)
        fl.optimizer.Adam(0.02).minimize(loss)
        return {"loss": loss}

    xv = _x(4, 6, 3, seed=5)
    feed = {"x": xv, "y": xv.sum(axis=(1, 2))[:, None]}
    losses = _train_both(fn, lambda i: feed)
    assert losses[-1] < losses[0], losses


def _decoder(fl, beam=3, V=7, Dh=5, steps=5, name="decgru"):
    L = fl.layers
    enc = fl.data("enc", (None, Dh), "float32")
    cell = L.GRUCell(hidden_size=Dh, name=name)
    decoder = L.BeamSearchDecoder(
        cell, start_token=0, end_token=1, beam_size=beam,
        embedding_fn=lambda ids: L.embedding(
            ids, size=[V, Dh], param_attr=fl.ParamAttr(name="trg_emb")),
        output_fn=lambda x: L.fc(x, size=V, num_flatten_dims=len(x.shape)
                                 - 1, param_attr=fl.ParamAttr(name="out_w"),
                                 bias_attr=False))
    return L.dynamic_decode(decoder, inits=enc, max_step_num=steps - 1)


def test_beam_search_decoder_and_final_states():
    """ref test_beam_search_decoder_matches_numpy and
    test_dynamic_decode_final_states_are_final: ids equal to the JAX
    package's (batch-major (B, T, beam)), lengths past 0 and at most the
    step count, a bool ``finished``."""
    def fn(fl):
        outputs, final = _decoder(fl)
        return [outputs, final.lengths, final.finished, final.log_probs]

    (ids, lens, fin, lp), = _run_programs(fn, [{"enc": _x(2, 5, seed=7)}])[0]
    assert ids.shape == (2, 5, 3) and ids.dtype == np.int64
    assert 1 <= lens.max() <= 5
    assert fin.dtype == bool and lp.shape == (2, 3)


def test_dynamic_lstmp_and_shared_param_attr():
    """ref test_dynamic_lstmp_matches_numpy, the peephole/clip run and
    test_shared_param_attr_not_aliased."""
    def fn(fl):
        L = fl.layers
        xp = fl.data("xp", (None, 4, 24), "float32")
        proj, cell = L.dynamic_lstmp(xp, size=24, proj_size=3,
                                     use_peepholes=False)
        cproj, ccell = L.dynamic_lstmp(xp, size=24, proj_size=3,
                                       use_peepholes=True, cell_clip=1.0,
                                       proj_clip=0.5)
        aproj, _ = L.dynamic_lstmp(xp, size=24, proj_size=3,
                                   param_attr=fl.ParamAttr(),
                                   use_peepholes=False)
        gout, _ = L.rnn(L.GRUCell(hidden_size=6, param_attr=fl.ParamAttr()),
                        xp)
        return [proj, cell, cproj, ccell, aproj, gout]

    (proj, cell, cproj, ccell, aproj, gout), = _run_programs(
        fn, [{"xp": _x(2, 4, 24, seed=9)}])[0]
    assert proj.shape == (2, 4, 3) and cell.shape == (2, 4, 6)
    assert np.abs(cproj).max() <= 0.5 + 1e-6
    assert np.abs(ccell).max() <= 1.0 + 1e-6
    assert gout.shape == (2, 4, 6)


def test_get_initial_states_structure():
    def fn(fl):
        x = fl.data("gis_x", (None, 4), "float32")
        states = fl.layers.LSTMCell(hidden_size=6).get_initial_states(
            batch_ref=x)
        assert isinstance(states, list) and len(states) == 2
        return list(states)

    a, b = _run_programs(fn, [{"gis_x": np.zeros((3, 4), "float32")}])[0][0]
    assert a.shape == (3, 6) and b.shape == (3, 6)


def test_basic_gru_and_lstm():
    """ref test_basic_gru_single_layer_matches_rnn_oracle,
    test_basic_lstm_bidirectional_stacked, test_basic_gru_init_hidden_
    consumed and test_basic_lstm_partial_init_and_named_attr."""
    def fn(fl):
        from importlib import import_module

        cl = import_module(fl.__name__ + ".contrib.layers")
        L = fl.layers
        x = fl.data("bgx", (None, 5, 4), "float32")
        h0 = L.data("bgh0", (1, -1, 6), append_batch_size=False,
                    dtype="float32")
        h2 = L.data("plh0", (2, -1, 6), append_batch_size=False,
                    dtype="float32")
        gout, glast = cl.basic_gru(x, None, 6, num_layers=1, name="bg1")
        hout, _ = cl.basic_gru(x, h0, 6, num_layers=1, name="bgh")
        lout, lh, lc = cl.basic_lstm(x, None, None, 6, num_layers=2,
                                     bidirectional=True, name="bl2")
        pout, _, _ = cl.basic_lstm(
            x, h2, None, 6, num_layers=2,
            param_attr=fl.ParamAttr(name="bl_named"), name="blpi")
        return [gout, glast, hout, lout, lh, lc, pout]

    xv = _x(2, 5, 4, seed=21)
    feeds = [{"bgx": xv, "bgh0": _x(1, 2, 6, seed=1),
              "plh0": _x(2, 2, 6, seed=2)},
             {"bgx": xv, "bgh0": np.zeros((1, 2, 6), "float32"),
              "plh0": np.zeros((2, 2, 6), "float32")}]
    (a, b), _, pmain = _run_programs(fn, feeds)
    gout, glast, hout, lout, lh, lc, pout = a
    assert glast.shape == (1, 2, 6)
    np.testing.assert_array_equal(glast[0], gout[:, -1])
    assert lout.shape == (2, 5, 12)
    assert lh.shape == lc.shape == (4, 2, 6)
    assert not np.allclose(hout, b[2])      # init hidden flows in
    assert not np.allclose(pout, b[6])
    names = [p.name for p in pmain.global_block().all_parameters()]
    assert len(names) == len(set(names))
    assert len([n for n in names if n.startswith("bl_named")]) == 2


def test_basic_lstm_trains_like_jax():
    def fn(fl):
        from importlib import import_module

        cl = import_module(fl.__name__ + ".contrib.layers")
        L = fl.layers
        x = fl.data("blx", (None, 5, 4), "float32")
        y = fl.data("bly", (None, 1), "float32")
        out, _, _ = cl.basic_lstm(x, None, None, 6, num_layers=2,
                                  bidirectional=True, name="bl2")
        loss = _mse(fl, L.fc(L.reduce_mean(out, dim=1), 1), y)
        fl.optimizer.Adam(0.02).minimize(loss)
        return {"loss": loss}

    xv = _x(2, 5, 4, seed=23)
    feed = {"blx": xv, "bly": xv.sum((1, 2))[:, None]}
    losses = _train_both(fn, lambda i: feed)
    assert losses[-1] < losses[0], losses


def test_dynamic_lstm_gru_and_cudnn_lstm_layers():
    """ref test_dynamic_lstm_and_gru_shapes_and_masking, fed a LoDTensor;
    layers.lstm (cudnn_lstm, 2 layers, bidirectional) and dynamic_gru."""
    def fn(fl):
        L = fl.layers
        x = fl.data("x", (None, 6, 32), "float32", lod_level=1)
        h, c = L.dynamic_lstm(x, size=32, use_peepholes=False)
        hp, _ = L.dynamic_lstm(x, size=32, is_reverse=True)
        g = L.dynamic_gru(L.fc(x, 12, num_flatten_dims=2), size=4,
                          origin_mode=True)
        init = L.fill_constant_batch_size_like(x, [2, -1, 4], "float32",
                                               0.0, output_dim_idx=1)
        out, lh, lc = L.lstm(x, init, init, 6, 4, 2, is_bidirec=True)
        return [h, c, hp, g, out, lh]

    lod = fluid.LoDTensor.from_sequences([_x(3, 32, seed=1),
                                          _x(6, 32, seed=2)])
    (h, c, hp, g, out, lh), = _run_programs(fn, [{"x": lod}])[0]
    assert h.shape == (2, 6, 8)
    np.testing.assert_array_equal(h[0, 2], h[0, 5])   # frozen
    assert out.shape == (2, 6, 8)
    np.testing.assert_array_equal(lh, out[:, -1])


def test_beam_search_step_layer():
    def fn(fl):
        pre_ids = fl.data("pi", [2, 1], "int64")
        pre_scores = fl.data("ps", [2, 1], "float32")
        ids = fl.data("ids", [2, 3], "int64")
        scores = fl.data("sc", [2, 3], "float32")
        return list(fl.layers.beam_search(pre_ids, pre_scores, ids, scores,
                                          beam_size=2, end_id=0,
                                          return_parent_idx=True))

    out_ids, out_sc, parent = _run_programs(fn, [{
        "pi": np.array([[5], [6]], "int64"),
        "ps": np.array([[0.0], [0.0]], "float32"),
        "ids": np.array([[1, 2, 3], [4, 5, 6]], "int64"),
        "sc": np.array([[0.5, 0.1, 0.2], [0.9, 0.3, 0.1]], "float32"),
    }])[0][0]
    np.testing.assert_allclose(out_sc.reshape(-1), [0.9, 0.5], rtol=1e-6)
    assert out_ids.reshape(-1).tolist() == [4, 1]
    assert parent.tolist() == [1, 0]


# ---------------------------------------------------------------------------
# DynamicRNN (ref tests/test_dynamic_rnn_io.py)
# ---------------------------------------------------------------------------
def _accumulator(fl, shape):
    x = fl.data(name="x", shape=shape, dtype="float32", lod_level=1)
    drnn = fl.layers.DynamicRNN()
    with drnn.block():
        xt = drnn.step_input(x)
        mem = drnn.memory(shape=[2], value=0.0)
        acc = fl.layers.elementwise_add(mem, xt)
        drnn.update_memory(mem, acc)
        drnn.output(acc)
    return [drnn()]


def test_dynamic_rnn_masked_accumulator():
    b, t, d = 3, 4, 2
    xv = np.arange(b * t * d, dtype="float32").reshape(b, t, d)
    lens = np.array([4, 2, 3], "int32")
    (o,), = _run_programs(lambda fl: _accumulator(fl, [b, t, d]),
                          [{"x": xv, "x@SEQ_LEN": lens}])[0]
    for i in range(b):
        run = np.zeros(d, "float32")
        for step in range(t):
            if step < lens[i]:
                run = run + xv[i, step]
                np.testing.assert_array_equal(o[i, step], run)
            else:
                np.testing.assert_array_equal(o[i, step], 0.0)


def test_dynamic_rnn_dynamic_batch_memory():
    (o,), = _run_programs(lambda fl: _accumulator(fl, [None, 3, 2]), [
        {"x": np.ones((2, 3, 2), "float32"),
         "x@SEQ_LEN": np.array([3, 1], "int32")}])[0]
    np.testing.assert_array_equal(o[0, :, 0], [1, 2, 3])
    np.testing.assert_array_equal(o[1, :, 0], [1, 0, 0])


def test_dynamic_rnn_with_fc_trains_like_jax():
    def fn(fl):
        L = fl.layers
        x = fl.data(name="x", shape=[4, 5, 3], dtype="float32", lod_level=1)
        y = fl.data(name="y", shape=[4, 6], dtype="float32")
        drnn = L.DynamicRNN()
        with drnn.block():
            xt = drnn.step_input(x)
            mem = drnn.memory(shape=[6], value=0.0)
            nh = L.fc(input=[xt, mem], size=6, act="tanh")
            drnn.update_memory(mem, nh)
            drnn.output(nh)
        loss = _mse(fl, L.sequence_last_step(drnn()), y)
        fl.optimizer.Adam(learning_rate=0.05).minimize(loss)
        return {"loss": loss}

    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(4, 5, 3).astype("float32"),
            "x@SEQ_LEN": np.array([5, 3, 2, 4], "int32"),
            "y": rng.rand(4, 6).astype("float32")}
    losses = _train_both(fn, lambda i: feed)
    assert losses[-1] < losses[0], losses


def _two_output_drnn(fl):
    x = fl.data(name="x", shape=[None, 4, 2], dtype="float32", lod_level=1)
    drnn = fl.layers.DynamicRNN()
    with drnn.block():
        xt = drnn.step_input(x)
        a = drnn.memory(shape=[2], value=0.0)
        b = drnn.memory(shape=[2], value=1.0)
        unread = drnn.memory(shape=[2], value=0.0)
        na = fl.layers.elementwise_add(a, fl.layers.elementwise_mul(b, xt))
        nb = fl.layers.scale(b, scale=2.0)
        drnn.update_memory(a, na)
        drnn.update_memory(b, nb)
        drnn.update_memory(unread, fl.layers.exp(xt))
        drnn.output(na, nb, fl.layers.tanh(na))
    return drnn()


def test_live_plan_keeps_the_fetched_outputs_and_read_memories():
    main, start = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, start):
        na, nb, tna = _two_output_drnn(fluid)
    op = [o for o in main.global_block().ops if o.type == "dynamic_rnn"][0]
    plan = pt_lowering_mod.live_plan(main, [na.name])
    outs, mems = plan.rnn[id(op)]
    # only the fetched output; memory b is read through na's update
    assert outs == {0} and mems == {0, 1}
    step_types = [o.type for o in plan.ops[op.attrs["sub_block"]]]
    assert "exp" not in step_types and "tanh" not in step_types
    feed = {"x": _x(2, 4, 2), "x@SEQ_LEN": np.array([4, 2], "int32")}
    exe = fluid.Executor(fluid.CPUPlace())
    got, = exe.run(main, feed=feed, fetch_list=[na])
    full = exe.run(main, feed=feed, fetch_list=[na, nb, tna])
    np.testing.assert_array_equal(got, full[0])
    np.testing.assert_allclose(full[2], np.tanh(full[0]), rtol=1e-6,
                               atol=1e-7)
    jmain = jfluid.Program()
    with jfluid.program_guard(jmain, jfluid.Program()):
        jouts = _two_output_drnn(jfluid)
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed=feed, fetch_list=list(jouts), scope=jfluid.Scope())
    for a, w in zip(full, want):
        _close(a, w)


# ---------------------------------------------------------------------------
# contrib.decoder (ref tests/test_contrib_decoder.py)
# ---------------------------------------------------------------------------
Dc, Vc, EMBc = 6, 9, 5


def _cell_updater(fl):
    def updater(state_cell):
        x = state_cell.get_input("x")
        h = state_cell.get_state("h")
        state_cell.set_state("h", fl.layers.fc(
            fl.layers.concat([x, h], axis=-1), Dc, act="tanh",
            num_flatten_dims=len(x.shape) - 1,
            param_attr=fl.ParamAttr(name="dec_step.w"),
            bias_attr=fl.ParamAttr(name="dec_step.b")))

    return updater


def _contrib(fl):
    from importlib import import_module

    return import_module(fl.__name__ + ".contrib.decoder")


def test_training_decoder_teacher_forcing_trains_like_jax():
    def fn(fl):
        dec, L = _contrib(fl), fl.layers
        enc = fl.data("enc_h", shape=[None, Dc], dtype="float32")
        trg = fl.data("trg", shape=[None, 4], dtype="int64", lod_level=1)
        lab = fl.data("lab", shape=[None, 4, 1], dtype="int64")
        sc = dec.StateCell(inputs={"x": None},
                           states={"h": dec.InitState(init=enc)},
                           out_state="h")
        sc.state_updater(_cell_updater(fl))
        trg_emb = L.embedding(trg, size=[Vc, EMBc])
        decoder = dec.TrainingDecoder(sc)
        with decoder.block():
            cur = decoder.step_input(trg_emb)
            sc.compute_state(inputs={"x": cur})
            decoder.output(L.fc(sc.get_state("h"), Vc, act="softmax"))
            sc.update_states()
        loss = L.mean(L.cross_entropy(decoder(), lab))
        fl.optimizer.Adam(0.05).minimize(loss)
        return {"loss": loss}

    rng = np.random.default_rng(3)
    trg = rng.integers(0, Vc, (4, 4)).astype("int64")
    feed = {"enc_h": _x(4, Dc, seed=4), "trg": trg,
            "trg@SEQ_LEN": np.array([4, 3, 2, 4], "int32"),
            "lab": ((trg + 1) % Vc)[:, :, None]}
    losses = _train_both(fn, lambda i: feed)
    assert losses[-1] < losses[0], losses


def test_contrib_beam_decoder_matches_layers_decoder():
    beam, max_len = 3, 6

    def fn(fl):
        dec, L = _contrib(fl), fl.layers
        enc = fl.data("enc_h", shape=[None, Dc], dtype="float32")
        init_ids = fl.data("bs_init_ids", shape=[None, 1], dtype="int64")
        init_scores = fl.data("bs_init_scores", shape=[None, 1],
                              dtype="float32")
        sc = dec.StateCell(inputs={"x": None},
                           states={"h": dec.InitState(init=enc)},
                           out_state="h")
        sc.state_updater(_cell_updater(fl))
        decoder = dec.BeamSearchDecoder(
            sc, init_ids=init_ids, init_scores=init_scores,
            target_dict_dim=Vc, word_dim=EMBc, beam_size=beam,
            max_len=max_len, end_id=1)
        decoder.decode()
        ids, scores = decoder()

        class StepCell(L.RNNCell):
            def call(self, inputs, states):
                nh = L.fc(L.concat([inputs, states], axis=-1), Dc,
                          act="tanh", num_flatten_dims=len(inputs.shape) - 1,
                          param_attr=fl.ParamAttr(name="dec_step.w"),
                          bias_attr=fl.ParamAttr(name="dec_step.b"))
                return nh, nh

        ref_dec = L.BeamSearchDecoder(
            StepCell(), start_token=0, end_token=1, beam_size=beam,
            embedding_fn=lambda x: L.embedding(
                x, size=[Vc, EMBc],
                param_attr=fl.ParamAttr(decoder._emb_param_name)),
            output_fn=lambda x: L.fc(
                x, size=Vc, num_flatten_dims=len(x.shape) - 1,
                param_attr=fl.ParamAttr(decoder._proj_param_name),
                bias_attr=False))
        ref_out, _ = L.dynamic_decode(ref_dec, inits=enc,
                                      max_step_num=max_len - 1)
        return [ids, scores, ref_out]

    (ids, scores, ref), = _run_programs(fn, [{
        "enc_h": _x(2, Dc, seed=5),
        "bs_init_ids": np.zeros((2, 1), "int64"),
        "bs_init_scores": np.zeros((2, 1), "float32")}])[0]
    np.testing.assert_array_equal(ids, ref)
    assert scores.shape[:2] == (2, beam)


def test_state_cell_validation_and_beam_block_guidance():
    dec = _contrib(fluid)
    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.data("scv", shape=[None, Dc], dtype="float32")
        with pytest.raises(ValueError):
            dec.StateCell(inputs={}, states={"h": dec.InitState(init=x)},
                          out_state="nope")
        with pytest.raises(ValueError):
            dec.StateCell(inputs={}, states={"h": "not-an-initstate"},
                          out_state="h")
        sc = dec.StateCell(inputs={"x": None},
                           states={"h": dec.InitState(init=x)},
                           out_state="h")
        with pytest.raises(ValueError):
            sc.get_input("x")
        with pytest.raises(ValueError):
            sc.compute_state(inputs={"y": x})
        ii = fluid.data("bsi", shape=[None, 1], dtype="int64")
        s0 = fluid.data("bss", shape=[None, 1], dtype="float32")
        bsd = dec.BeamSearchDecoder(dec.StateCell(
            inputs={"x": None}, states={"h": dec.InitState(init=x)},
            out_state="h"), ii, s0, Vc, EMBc)
        with pytest.raises(NotImplementedError, match="dynamic_decode"):
            bsd.block()
    with pytest.raises(NotImplementedError, match="rank"):
        fluid.layers.reorder_lod_tensor_by_rank(x, None)
