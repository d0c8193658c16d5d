"""Ragged sequence feeds in the port against the JAX package, on the CPU.

- ``fluid.lod`` (a copy of the JAX package's numpy module): LoDTensor,
  create_lod_tensor and create_random_int_lodtensor give the same padded
  arrays, lengths and offsets as the JAX package's.
- ``DataFeeder`` turns a ``lod_level`` = 1 slot into a LoDTensor padded to
  the batch's longest sequence, equal to the JAX package's feeder's.
- ``Executor.run`` takes a LoDTensor feed: its array, and its lengths as
  the var's ``@SEQ_LEN`` companion (full lengths for a LoDTensor without
  any; a companion the caller feeds wins); results equal the JAX
  package's on the same feeds within 1e-5 of the largest value.
  ``run_pipelined`` and a program-attached ``py_reader`` fed through
  ``decorate_paddle_reader`` take the same feeds, bit-identical to a
  ``run`` loop.
- ``Predictor.from_model`` on a saved sentiment net takes
  ``create_lod_tensor`` and ``DataFeeder`` feeds, bit-identical to each
  other and within 1e-5 of the JAX package's Executor on the same
  parameters.
"""
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

TOL = 1e-5


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


def _seqs(n=4, width=None, seed=0):
    rng = np.random.default_rng(seed)
    shape = lambda k: (k,) if width is None else (k, width)  # noqa: E731
    return [rng.integers(0, 50, shape(int(k))).astype("int64")
            for k in rng.integers(1, 7, n)]


def test_lod_module_matches_jax():
    for width in (None, 3):
        seqs = _seqs(width=width)
        got = fluid.LoDTensor.from_sequences(seqs)
        want = jfluid.LoDTensor.from_sequences(seqs)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        np.testing.assert_array_equal(got.seq_lens, want.seq_lens)
        assert got.seq_lens.dtype == np.int32
        assert got.lod() == want.lod()
        assert got.shape() == want.shape()
    lens = [3, 1, 4]
    flat = np.arange(8 * 2, dtype="float32").reshape(8, 2)
    got = fluid.create_lod_tensor(flat, [lens], fluid.CPUPlace())
    want = jfluid.create_lod_tensor(flat, [lens], jfluid.CPUPlace())
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got)[2], flat[4:8])
    assert got.recursive_sequence_lengths() == [lens]
    got.set_lod([[0, 2, 3, 8]])
    assert got.recursive_sequence_lengths() == [[2, 1, 5]]
    np.random.seed(7)
    got = fluid.create_random_int_lodtensor([lens], [2], fluid.CPUPlace(),
                                            0, 9)
    np.random.seed(7)
    want = jfluid.create_random_int_lodtensor([lens], [2], None, 0, 9)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert fluid.lod_tensor.create_lod_tensor is fluid.create_lod_tensor


def _feeder_vars(fl):
    words = fl.data("words", shape=[None, None], dtype="int64", lod_level=1)
    feats = fl.data("feats", shape=[None, None, 3], dtype="float32",
                    lod_level=1)
    label = fl.data("label", shape=[None, 1], dtype="int64")
    return [words, feats, label]


def test_data_feeder_pads_each_batch_like_jax():
    rng = np.random.default_rng(2)
    batches = []
    for n in (3, 5):
        batches.append([(s.tolist(), rng.random((len(s), 3)).tolist(),
                         [int(rng.integers(0, 2))])
                        for s in _seqs(n, seed=n)])
    feeders = []
    for fl in (fluid, jfluid):
        main = fl.Program()
        with fl.program_guard(main, fl.Program()):
            vs = _feeder_vars(fl)
        feeders.append(fl.DataFeeder(vs, fl.CPUPlace()))
    for b in batches:
        got, want = (f.feed(b) for f in feeders)
        assert set(got) == {"words", "feats", "label"}
        for name in ("words", "feats"):
            assert isinstance(got[name], fluid.LoDTensor)
            np.testing.assert_array_equal(np.asarray(got[name]),
                                          np.asarray(want[name]))
            np.testing.assert_array_equal(got[name].seq_lens,
                                          want[name].seq_lens)
            assert np.asarray(got[name]).shape[1] == max(
                len(s[0]) for s in b)
        assert np.asarray(got["feats"]).dtype == np.float32
        np.testing.assert_array_equal(got["label"], want["label"])


def _pool_net(fl):
    """Ops that read the feed's lengths: the ``@SEQ_LEN`` companion reaches
    an op fed by the data var or by a sequence or recurrent layer (the
    JAX package's ``embedding`` and ``fc`` do not pass it on)."""
    x = fl.data("x", shape=[None, None, 8], dtype="float32", lod_level=1)
    h, _ = fl.layers.dynamic_lstm(x, size=8)
    return [fl.layers.sequence_pool(h, "max"), fl.layers.sequence_last_step(x),
            x.block.var("x@SEQ_LEN")]


def _floats(n=5, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(k), 8)).astype("float32")
            for k in rng.integers(1, 7, n)]


def _both(fn):
    progs = []
    for fl, un in ((jfluid, jax_unique_name), (fluid, pt_unique_name)):
        un.switch()
        main, start = fl.Program(), fl.Program()
        start.random_seed = 4
        with fl.program_guard(main, start):
            outs = fn(fl)
        progs.append((main, start, outs))
    (jmain, jstart, jouts), (pmain, _, pouts) = progs
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    values = {n: np.array(jscope[n]) for n in jscope.keys()}
    scope = fluid.Scope()
    for n, t in params_from_numpy(values, torch.device("cpu")).items():
        scope.set(n, t)
    return (jexe, jmain, jouts, jscope), (pmain, pouts, scope), values


def _close(a, w):
    w = np.asarray(w)
    assert a.shape == w.shape and np.isfinite(a).all()
    assert float(np.abs(a - w).max()) <= TOL * float(np.abs(w).max())


def test_executor_takes_lod_tensor_feeds_like_jax():
    (jexe, jmain, jouts, jscope), (pmain, pouts, scope), _ = _both(
        _pool_net)
    exe = fluid.Executor(fluid.CPUPlace())
    lod = fluid.LoDTensor.from_sequences(_floats())
    got = exe.run(pmain, feed={"x": lod}, fetch_list=pouts, scope=scope)
    want = jexe.run(jmain, feed={"x": jfluid.LoDTensor.from_sequences(
        _floats())}, fetch_list=jouts, scope=jscope)
    for a, w in zip(got, want):
        _close(a, w)
    np.testing.assert_array_equal(got[2], lod.seq_lens)
    assert len(set(lod.seq_lens.tolist())) > 1
    # the same as the padded array with its lengths fed explicitly
    explicit = exe.run(pmain, feed={"x": np.asarray(lod),
                                    "x@SEQ_LEN": lod.seq_lens},
                       fetch_list=pouts, scope=scope)
    for a, b in zip(got, explicit):
        np.testing.assert_array_equal(a, b)
    # a fed companion wins; a LoDTensor without lengths gets full ones
    full = np.full(5, np.asarray(lod).shape[1], "int32")
    over = exe.run(pmain, feed={"x": lod, "x@SEQ_LEN": full},
                   fetch_list=pouts, scope=scope)
    bare = exe.run(pmain, feed={"x": fluid.LoDTensor(np.asarray(lod))},
                   fetch_list=pouts, scope=scope)
    for a, b in zip(over, bare):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(bare[2], full)
    assert not np.array_equal(over[1], got[1])


def test_pipelined_and_py_reader_take_lod_feeds():
    main, start = fluid.Program(), fluid.Program()
    start.random_seed = 4
    with fluid.program_guard(main, start):
        words = fluid.data("words", shape=[None, None], dtype="int64",
                           lod_level=1)
        label = fluid.data("label", shape=[None, 1], dtype="int64")
        emb = fluid.layers.embedding(words, size=[50, 8])
        pred = fluid.layers.fc(fluid.layers.sequence_pool(emb, "average"),
                               2, act="softmax")
        loss = fluid.layers.mean(fluid.layers.cross_entropy(pred, label))
        fluid.optimizer.SGD(0.5).minimize(loss)
        reader = fluid.layers.create_py_reader_by_data(
            capacity=2, feed_list=[words, label], name="lodr")
    rng = np.random.default_rng(6)
    samples = [[(s.tolist(), [int(rng.integers(0, 2))])
                for s in _seqs(4, seed=10 + i)] for i in range(4)]
    feeder = fluid.DataFeeder([words, label], fluid.CPUPlace())
    feeds = [feeder.feed(b) for b in samples]

    def fresh():
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        exe.run(start, scope=scope)
        return exe, scope

    exe, scope = fresh()
    loop = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
            for f in feeds]
    exe, scope = fresh()
    piped = [o[0] for o in exe.run_pipelined(main, feeds=feeds,
                                             fetch_list=[loss],
                                             scope=scope)]
    exe, scope = fresh()
    reader.decorate_paddle_reader(lambda: iter(samples))
    reader.start()
    popped = []
    while True:
        try:
            popped.append(exe.run(main, fetch_list=[loss], scope=scope)[0])
        except fluid.core.EOFException:
            reader.reset()
            break
    assert len(loop) == len(piped) == len(popped) == 4
    for a, b, c in zip(loop, piped, popped):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_predictor_takes_lod_tensors(tmp_path):
    """A saved stacked-LSTM sentiment net (tests/test_torch_book_rnn.py's,
    at a small width) served by ``Predictor.from_model`` on the CPU."""
    from test_torch_book_rnn import stacked_lstm_net

    word_dict = paddle.dataset.imdb.word_dict()
    fn = lambda fl: stacked_lstm_net(fl, len(word_dict), 8, 16, 3)  # noqa
    (jexe, jmain, jvs, jscope), (pmain, pvs, scope), _ = _both(fn)
    exe = fluid.Executor(fluid.CPUPlace())
    fluid.io.save_inference_model(str(tmp_path), ["words"],
                                  [pvs["prediction"]], exe,
                                  main_program=pmain, scope=scope)
    pred = fluid.Predictor.from_model(str(tmp_path), place=fluid.CPUPlace())
    assert pred.feed_names == ["words"]
    batch = next(paddle.batch(paddle.dataset.imdb.test(word_dict), 6)())
    seqs = [np.asarray(w, "int64") for w, _ in batch]
    lens = [len(s) for s in seqs]
    flat = np.concatenate(seqs)
    by_lod, = pred.run({"words": fluid.create_lod_tensor(
        flat, [lens], fluid.CPUPlace())})
    feeder = fluid.DataFeeder([pvs["words"]], fluid.CPUPlace(),
                              program=pmain)
    by_feeder, = pred.run(feeder.feed([(s,) for s in seqs]))
    np.testing.assert_array_equal(by_lod, by_feeder)
    lod = jfluid.LoDTensor.from_sequences(seqs)
    want, = jexe.run(jmain, feed={"words": lod,
                                  "label": np.zeros((6, 1), "int64")},
                     fetch_list=[jvs["prediction"]], scope=jscope)
    _close(by_lod, want)
    assert by_lod.shape == (6, 2)
