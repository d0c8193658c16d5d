"""The book's fit_a_line, word2vec, recommender and image-classification
(VGG-16-BN-drop) chapters in the port against the JAX package, on the CPU.

- Each chapter as tests/test_book.py builds it (its widths), built by the
  same layer calls in both packages: the same Program JSON, startup
  program included. Then 5 training steps in each package from the JAX
  startup's values, carried into the port by ``params_from_numpy``:
  every step's loss within LOSS_TOL (1e-5) relative of the JAX package's
  and the first step's gradient of every parameter within GRAD_TOL
  (1e-4) of that parameter's largest JAX gradient. VGG's dropout masks
  cannot match across packages (each draws from its own generator), so
  the compared VGG program has every ``dropout_prob`` at 0; the
  published rates are held by their keep rates in a port run.
- The chapters at their published widths: the recommender
  (``test_recommender_system.py``: user and movie towers of embeddings
  and fcs, the title's ``sequence_conv_pool``, ``cos_sim``, ``scale(5)``,
  ``square_error_cost``, SGD(0.2)) fed through each package's
  ``DataFeeder`` from ``dataset.movielens``, word2vec (N 5, embedding 32,
  hidden 256, the synthetic imikolov dictionary) and fit_a_line
  (uci_housing, SGD(0.001), batch 20) train as above; VGG-16-BN-drop
  (CIFAR-10's 3x32x32, fc 4096) builds the same Program JSON, and its
  test program (``clone(for_test=True)``) too. The full-width VGG
  trains on the card (chip_smoke.py phase 18).
- tests/test_book.py's four chapter tests run as they are with their
  ``fluid`` and ``paddle`` bound to the port's.
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
from test_torch_rcnn import reference_tests

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
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


def _biases_under_batch_norm(main):
    """The bias parameters whose sum goes straight into a batch norm: their
    exact gradient is 0 (the norm subtracts the batch mean), so each
    package's is rounding noise."""
    ops = main.global_block().ops
    normed = {op.input("X")[0] for op in ops if op.type == "batch_norm"}
    params = {p.name for p in main.all_parameters()}
    return {op.input("Y")[0] for op in ops if op.type == "elementwise_add"
            and op.input("Y")[0] in params and op.output("Out")[0] in normed}


def _train_both(fn, feeds, steps=STEPS):
    """`steps` training steps of fn's program in both packages from the
    JAX startup's values; losses and step-1 gradients compared (a bias
    under a batch norm, whose exact gradient is 0: both packages' within
    GRAD_TOL of the largest gradient of any parameter). Returns the
    port's losses."""
    (jmain, jstart, jvs), (pmain, _, pvs) = _both(fn)
    jexe, jscope = jfluid.Executor(jfluid.CPUPlace()), jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    persist = [v.name for v in jstart.global_block().vars.values()
               if v.persistable]
    scope = fluid.Scope()
    for n, t in params_from_numpy({n: np.array(jscope[n]) for n in persist},
                                  torch.device("cpu")).items():
        scope.set(n, t)
    exe = fluid.Executor(fluid.CPUPlace())
    params = sorted(p.name for p in pmain.all_parameters() if p.trainable)
    grads = [p + "@GRAD" for p in params]
    losses = []
    for step in range(steps):
        feed = feeds(step)
        fetch = grads if step == 0 else []
        jout = jexe.run(jmain, feed=feed, scope=jscope,
                        fetch_list=[jvs["loss"]] + fetch)
        pout = exe.run(pmain, feed=feed, scope=scope,
                       fetch_list=[pvs["loss"]] + fetch)
        jl, pl = float(np.asarray(jout[0])), float(pout[0])
        assert np.isfinite(pl) and abs(pl - jl) <= LOSS_TOL * abs(jl), (
            step, pl, jl)
        losses.append(pl)
        if not fetch:
            continue
        zero = _biases_under_batch_norm(pmain)
        largest = max(float(np.abs(np.asarray(w)).max()) for w in jout[1:])
        for name, a, w in zip(params, pout[1:], jout[1:]):
            w = np.asarray(w)
            assert a.shape == w.shape and np.isfinite(a).all(), name
            if name in zero:
                assert max(float(np.abs(a).max()), float(np.abs(w).max())) \
                    <= GRAD_TOL * largest, name
                continue
            assert float(np.abs(a - w).max()) <= GRAD_TOL * max(
                float(np.abs(w).max()), 1e-30), name
    return losses


# ---------------------------------------------------------------------------
# the chapters at tests/test_book.py's widths
# ---------------------------------------------------------------------------
def fit_a_line(fl, lr=0.01):
    """ch1, tests/test_book.py:39 (published: SGD(0.001), batch 20)."""
    L = fl.layers
    x = L.data(name="x", shape=[13], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    y_predict = L.fc(input=x, size=1, act=None)
    loss = L.mean(L.square_error_cost(input=y_predict, label=y))
    fl.optimizer.SGD(learning_rate=lr).minimize(loss)
    return {"loss": loss, "feeds": [x, y], "predict": y_predict}


def word2vec(fl, dict_size=200, emb=16, hidden=64, lr=0.02, adam=True):
    """ch4, tests/test_book.py:78 (published: embedding 32, hidden 256,
    SGD(0.001))."""
    L = fl.layers
    words = [L.data(name=n, shape=[1], dtype="int64")
             for n in ("firstw", "secondw", "thirdw", "forthw", "nextw")]
    embeds = [L.embedding(input=w, size=[dict_size, emb],
                          param_attr=fl.ParamAttr(name="shared_w"))
              for w in words[:4]]
    concat = L.reshape(L.concat(input=embeds, axis=-1), [-1, 4 * emb])
    hidden1 = L.fc(input=concat, size=hidden, act="sigmoid")
    predict = L.fc(input=hidden1, size=dict_size, act="softmax")
    loss = L.mean(L.cross_entropy(input=predict, label=words[4]))
    (fl.optimizer.Adam(learning_rate=lr) if adam
     else fl.optimizer.SGD(learning_rate=lr)).minimize(loss)
    return {"loss": loss, "feeds": words, "predict": predict}


def recommender_small(fl):
    """ch5 as tests/test_book.py:144 simplifies it."""
    L = fl.layers
    n_users, n_items, emb = 100, 80, 16
    uid = L.data(name="uid", shape=[1], dtype="int64")
    iid = L.data(name="iid", shape=[1], dtype="int64")
    score = L.data(name="score", shape=[1], dtype="float32")
    u = L.reshape(L.embedding(input=uid, size=[n_users, emb]), [-1, emb])
    it = L.reshape(L.embedding(input=iid, size=[n_items, emb]), [-1, emb])
    sim = L.cos_sim(X=L.fc(input=u, size=emb), Y=L.fc(input=it, size=emb))
    pred = L.scale(sim, scale=5.0)
    loss = L.mean(L.square_error_cost(input=pred, label=score))
    fl.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return {"loss": loss}


def vgg_bn_drop(fl, blocks, fc_size, drop=1.0, image=16, lr=0.02):
    """The book's vgg16_bn_drop (ref book/test_image_classification.py)
    with the conv blocks `blocks` ((filters, groups, dropouts), ...) and
    the fcs `fc_size` wide; every dropout rate times `drop`."""
    L = fl.layers

    def conv_block(ipt, num_filter, groups, dropouts):
        return fl.nets.img_conv_group(
            input=ipt, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=[r * drop for r in dropouts],
            pool_type="max")

    images = fl.data(name="pixel", shape=[None, 3, image, image],
                     dtype="float32")
    label = fl.data(name="label", shape=[None, 1], dtype="int64")
    net = images
    for num_filter, groups, dropouts in blocks:
        net = conv_block(net, num_filter, groups, dropouts)
    net = L.dropout(x=net, dropout_prob=0.5 * drop)
    fc1 = L.fc(input=net, size=fc_size, act=None)
    bn = L.batch_norm(input=fc1, act="relu")
    drop2 = L.dropout(x=bn, dropout_prob=0.5 * drop)
    fc2 = L.fc(input=drop2, size=fc_size, act=None)
    predict = L.fc(input=fc2, size=10, act="softmax")
    loss = L.mean(L.cross_entropy(input=predict, label=label))
    acc = L.accuracy(input=predict, label=label)
    test_program = fl.default_main_program().clone(for_test=True)
    fl.optimizer.Adam(learning_rate=lr).minimize(loss)
    return {"loss": loss, "predict": predict, "acc": acc,
            "test_program": test_program}


SMALL_VGG = ((8, 2, (0.3, 0.0)), (16, 2, (0.4, 0.0)))
VGG16 = ((64, 2, (0.3, 0.0)), (128, 2, (0.4, 0.0)),
         (256, 3, (0.4, 0.4, 0.0)), (512, 3, (0.4, 0.4, 0.0)),
         (512, 3, (0.4, 0.4, 0.0)))


def test_fit_a_line_trains_like_jax():
    data = list(paddle.dataset.uci_housing.train()())[:64]
    xs = np.asarray([d[0] for d in data], "float32")
    ys = np.asarray([d[1] for d in data], "float32").reshape(-1, 1)
    losses = _train_both(fit_a_line, lambda i: {"x": xs, "y": ys})
    assert losses[-1] < losses[0]


def _ngram_feeds(seq_len=512, dict_size=200, batch=32):
    rng = np.random.RandomState(0)
    seq = rng.randint(0, dict_size, size=seq_len)

    def feeds(i):
        starts = np.random.RandomState(i).randint(0, len(seq) - 5,
                                                  size=batch)
        grams = np.stack([seq[s:s + 5] for s in starts])
        return {n: grams[:, k:k + 1].astype("int64") for k, n in enumerate(
            ("firstw", "secondw", "thirdw", "forthw", "nextw"))}

    return feeds


def test_word2vec_trains_like_jax():
    _train_both(word2vec, _ngram_feeds())


def test_recommender_small_trains_like_jax():
    rng = np.random.RandomState(2)
    us = rng.randint(0, 100, size=(64, 1)).astype("int64")
    its = rng.randint(0, 80, size=(64, 1)).astype("int64")
    sc = ((us * 7 + its * 3) % 5 + 1).astype("float32")
    _train_both(recommender_small,
                lambda i: {"uid": us, "iid": its, "score": sc})


def _cifar_like(n, image, seed):
    rng = np.random.default_rng(seed)
    return {"pixel": rng.standard_normal((n, 3, image, image)).astype(
                "float32"),
            "label": rng.integers(0, 10, (n, 1)).astype("int64")}


def test_vgg_without_dropout_trains_like_jax():
    """tests/test_book.py's VGG (blocks 8x2 and 16x2 at 16x16, fc 32) with
    every dropout_prob at 0, batch 16 (batch norm over 4x4 maps at batch
    8 leaves too few values a channel for 1e-4 gradients)."""
    feeds = [_cifar_like(16, 16, s) for s in range(STEPS)]
    losses = _train_both(
        lambda fl: vgg_bn_drop(fl, SMALL_VGG, 32, drop=0.0),
        lambda i: feeds[i])
    assert all(np.isfinite(losses))


def test_vgg_dropout_keeps_its_published_rates():
    """The published rates (0.3, 0.4 and twice 0.5) in a port run: each
    dropout's mask keeps 1 - p of its elements, within 5 sigma."""
    main, start, vs = _build(fluid, pt_unique_name,
                             lambda fl: vgg_bn_drop(fl, SMALL_VGG, 32))
    drops = [op for op in main.global_block().ops if op.type == "dropout"]
    assert sorted(op.attrs["dropout_prob"] for op in drops) == [
        0.3, 0.4, 0.5, 0.5]
    exe, scope = fluid.Executor(fluid.CPUPlace()), fluid.Scope()
    exe.run(start, scope=scope)
    masks = exe.run(main, feed=_cifar_like(32, 16, 9), scope=scope,
                    fetch_list=[op.output("Mask")[0] for op in drops])
    for op, m in zip(drops, masks):
        p = op.attrs["dropout_prob"]
        keep = float(np.asarray(m).mean())
        sigma = np.sqrt(p * (1 - p) / np.asarray(m).size)
        assert abs(keep - (1 - p)) < 5 * sigma, (p, keep)


# ---------------------------------------------------------------------------
# the chapters at their published widths
# ---------------------------------------------------------------------------
def recommender(fl, lr=0.2):
    """ch5 as the book's test_recommender_system.py builds it; returns the
    feeds in the reader's slot order, the scaled cosine and the loss."""
    L, ml = fl.layers, paddle.dataset.movielens
    uid = L.data(name="user_id", shape=[1], dtype="int64")
    usr_fc = L.fc(input=L.embedding(input=uid, dtype="float32",
                                    size=[ml.max_user_id() + 1, 32],
                                    param_attr="user_table"), size=32)
    gender = L.data(name="gender_id", shape=[1], dtype="int64")
    gender_fc = L.fc(input=L.embedding(input=gender, size=[2, 16],
                                       param_attr="gender_table"), size=16)
    age = L.data(name="age_id", shape=[1], dtype="int64")
    age_fc = L.fc(input=L.embedding(input=age, size=[len(ml.age_table), 16],
                                    param_attr="age_table"), size=16)
    job = L.data(name="job_id", shape=[1], dtype="int64")
    job_fc = L.fc(input=L.embedding(input=job,
                                    size=[ml.max_job_id() + 1, 16],
                                    param_attr="job_table"), size=16)
    usr = L.fc(input=L.concat(input=[usr_fc, gender_fc, age_fc, job_fc],
                              axis=1), size=200, act="tanh")
    mov_id = L.data(name="movie_id", shape=[1], dtype="int64")
    mov_fc = L.fc(input=L.embedding(input=mov_id, dtype="float32",
                                    size=[ml.max_movie_id() + 1, 32],
                                    param_attr="movie_table"), size=32)
    # the LoD slots as the repo's padded (batch, length) ids: the book's
    # layers.data(shape=[1], lod_level=1) declares (-1, 1), and the
    # reference's shape inference then loses the sequence axis
    category = fl.data(name="category_id", shape=[None, None],
                       dtype="int64", lod_level=1)
    cat_hidden = L.sequence_pool(input=L.embedding(
        input=category, size=[len(ml.movie_categories()), 32]),
        pool_type="sum")
    title = fl.data(name="movie_title", shape=[None, None], dtype="int64",
                    lod_level=1)
    title_conv = fl.nets.sequence_conv_pool(
        input=L.embedding(input=title,
                          size=[len(ml.get_movie_title_dict()), 32]),
        num_filters=32, filter_size=3, act="tanh", pool_type="sum")
    mov = L.fc(input=L.concat(input=[mov_fc, cat_hidden, title_conv],
                              axis=1), size=200, act="tanh")
    scale_infer = L.scale(x=L.cos_sim(X=usr, Y=mov), scale=5.0)
    score = L.data(name="score", shape=[1], dtype="float32")
    loss = L.mean(L.square_error_cost(input=scale_infer, label=score))
    fl.optimizer.SGD(learning_rate=lr).minimize(loss)
    return {"loss": loss, "infer": scale_infer,
            "feeds": [uid, gender, age, job, mov_id, category, title,
                      score]}


def test_recommender_at_published_width_through_data_feeder():
    batches = []
    for b in paddle.batch(paddle.dataset.movielens.train(), 64)():
        batches.append(b)
        if len(batches) == STEPS:
            break
    (_, _, jvs), (_, _, pvs) = _both(recommender)
    jfeeder = jfluid.DataFeeder(feed_list=jvs["feeds"],
                                place=jfluid.CPUPlace())
    pfeeder = fluid.DataFeeder(feed_list=pvs["feeds"],
                               place=fluid.CPUPlace())
    for b in batches:
        jf, pf = jfeeder.feed(b), pfeeder.feed(b)
        for n in ("category_id", "movie_title"):
            np.testing.assert_array_equal(np.asarray(pf[n]),
                                          np.asarray(jf[n]))
            np.testing.assert_array_equal(pf[n].seq_lens, jf[n].seq_lens)
    losses = _train_both(recommender, lambda i: pfeeder.feed(batches[i]))
    assert all(np.isfinite(losses))


def test_word2vec_at_published_width():
    word_dict = paddle.dataset.imikolov.build_dict()
    grams = np.array(list(paddle.dataset.imikolov.train(word_dict, 5)()),
                     np.int64)

    def feeds(i):
        g = grams[32 * i:32 * (i + 1)]
        return {n: g[:, k:k + 1] for k, n in enumerate(
            ("firstw", "secondw", "thirdw", "forthw", "nextw"))}

    _train_both(lambda fl: word2vec(fl, len(word_dict), 32, 256, 0.001,
                                    adam=False), feeds)


def test_fit_a_line_at_published_settings():
    data = list(paddle.dataset.uci_housing.train()())

    def feeds(i):
        d = data[20 * i:20 * (i + 1)]
        return {"x": np.asarray([r[0] for r in d], "float32"),
                "y": np.asarray([r[1] for r in d], "float32").reshape(-1, 1)}

    _train_both(lambda fl: fit_a_line(fl, lr=0.001), feeds)


def test_vgg16_at_published_width_builds_the_reference_s_programs():
    (jm, js, jvs), (pm, ps, pvs) = _both(
        lambda fl: vgg_bn_drop(fl, VGG16, 4096, image=32, lr=0.001))
    assert json.loads(pvs["test_program"].to_json()) == json.loads(
        jvs["test_program"].to_json())
    types = [op.type for op in pm.global_block().ops]
    assert types.count("conv2d") == 13 and types.count("batch_norm") == 14
    assert types.count("pool2d") == 5
    assert sorted(op.attrs["dropout_prob"] for op in pm.global_block().ops
                  if op.type == "dropout") == [0.3, 0.4, 0.4, 0.4, 0.4, 0.4,
                                               0.4, 0.4, 0.5, 0.5]
    shapes = {p.name: tuple(p.shape) for p in pm.all_parameters()}
    assert sorted(s for s in shapes.values() if len(s) == 2) == [
        (512, 4096), (4096, 10), (4096, 4096)]


# ---------------------------------------------------------------------------
# tests/test_book.py's own chapter tests on the port
# ---------------------------------------------------------------------------
BOOK_TESTS = ("test_book_fit_a_line", "test_book_word2vec_ngram",
              "test_book_recommender_system",
              "test_book_image_classification_vgg")


@pytest.mark.parametrize("test", BOOK_TESTS)
def test_reference_book_test_passes_on_the_port(test):
    mod = reference_tests("test_book")
    mod.paddle = paddle
    # the module's autouse fixture, on the port
    fluid.default_startup_program().random_seed = 3
    getattr(mod, test)()
