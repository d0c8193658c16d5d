"""fluid.contrib.layers' nn and metric families in the port, against the
JAX package, on the CPU.

- The nine functions (``fused_elemwise_activation``, ``var_conv_2d``,
  ``match_matrix_tensor``, ``sequence_topk_avg_pooling``, ``tree_conv``,
  ``fused_embedding_seq_pool``, ``multiclass_nms2``,
  ``search_pyramid_hash``, ``ctr_metric_bundle``) built in both packages
  (the same Program JSON), run on the same seeded inputs from the JAX
  package's initial parameters, lengths riding the ``@SEQ_LEN``
  companions: outputs within 1e-5 of the largest (integers equal), and,
  where the function has a parameter, the gradient of a loss on its
  output within 1e-5 of the largest.
- ``ctr_metric_bundle``'s accumulators are persistable writes: three
  batches run without fetching them advance them as in the JAX package.
- The JAX package's own tests/test_contrib_layers_nn.py runs on the port
  (``test_torch_slim.on_port``).
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
from test_torch_slim import (  # noqa: F401
    _fresh_state, copy_scope, host, on_port, pjson, port_contrib,
    run_reference_test)

TOL = 1e-5
B = 3


def _rng(seed):
    return np.random.default_rng(seed)


def _lens(*vals):
    return np.array(vals, np.int32)


def _run_both(build, feed, grads=True):
    """build(fl) -> output vars, in each package (the same Program JSON),
    run on `feed`, the port from the JAX package's startup values; with
    `grads`, the parameters' gradients of mean(out[0]^2) too. Each value
    within TOL of the JAX package's largest (integers equal)."""
    res = []
    for fl in (jfluid, fluid):
        main, startup = fl.Program(), fl.Program()
        main.random_seed = startup.random_seed = 3
        with fl.program_guard(main, startup), fl.unique_name.guard():
            outs = build(fl)
            params = sorted(p.name for p in main.all_parameters())
            if grads:
                assert params
                loss = fl.layers.mean(fl.layers.square(outs[0]))
                fl.optimizer.SGD(0.0).minimize(loss)
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup)
        if fl is jfluid:
            init = {n: np.array(v) for n, v in fl.global_scope().items()}
        else:
            copy_scope(init, fl.global_scope())
        names = [o.name for o in outs] + (
            [p + "@GRAD" for p in params] if grads else [])
        vals = exe.run(main, feed=feed, fetch_list=names)
        res.append((main, dict(zip(names, (np.asarray(v) for v in vals)))))
    (jm, want), (pm, got) = res
    assert pjson(pm) == pjson(jm)
    assert got.keys() == want.keys()
    for n, w in want.items():
        g = got[n]
        assert g.shape == w.shape, n
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=n)
        else:
            np.testing.assert_allclose(
                g, w, rtol=0, atol=TOL * max(np.abs(w).max(), 1e-30),
                err_msg=n)


FUNCTORS = [(["elementwise_add", "relu"], 0.0),
            (["relu", "elementwise_add"], 0.0),
            (["scale", "elementwise_add"], 2.0),
            (["elementwise_mul", "tanh"], 0.0),
            ("tanh,elementwise_mul", 0.0)]


@pytest.mark.parametrize("functors,scale", FUNCTORS)
def test_fused_elemwise_activation(functors, scale):
    def build(fl):
        x = fl.data("x", [None, 4], "float32")
        y = fl.data("y", [None, 4], "float32")
        return [fl.contrib.fused_elemwise_activation(x, y, functors,
                                                     scale=scale)]

    r = _rng(0)
    _run_both(build, {"x": r.standard_normal((B, 4)).astype(np.float32),
                      "y": r.standard_normal((B, 4)).astype(np.float32)},
              grads=False)


@pytest.mark.parametrize("stride", [1, 2])
def test_var_conv_2d(stride):
    def build(fl):
        x = fl.data("vx", [None, 3, 6, 8], "float32")
        row = fl.data("row", [None, 6], "float32", lod_level=1)
        col = fl.data("col", [None, 8], "float32", lod_level=1)
        return [fl.contrib.var_conv_2d(x, row, col, 3, 4, [3, 3],
                                       stride=stride, act="relu")]

    r = _rng(1)
    _run_both(build, {
        "vx": r.standard_normal((B, 3, 6, 8)).astype(np.float32),
        "row": np.zeros((B, 6), np.float32), "row@SEQ_LEN": _lens(6, 3, 4),
        "col": np.zeros((B, 8), np.float32), "col@SEQ_LEN": _lens(8, 5, 2)})


def _mm_feed(seed):
    r = _rng(seed)
    return {"mx": r.standard_normal((B, 4, 5)).astype(np.float32),
            "mx@SEQ_LEN": _lens(4, 2, 3),
            "my": r.standard_normal((B, 6, 5)).astype(np.float32),
            "my@SEQ_LEN": _lens(6, 1, 4)}


def _mm(fl, act=None):
    x = fl.data("mx", [None, 4, 5], "float32", lod_level=1)
    y = fl.data("my", [None, 6, 5], "float32", lod_level=1)
    return x, y, fl.contrib.match_matrix_tensor(x, y, 3, act=act)


@pytest.mark.parametrize("act", [None, "tanh"])
def test_match_matrix_tensor(act):
    def build(fl):
        out, tmp = _mm(fl, act)[2]
        return [out, tmp]

    _run_both(build, _mm_feed(2))


@pytest.mark.parametrize("topks", [[1, 3], [2, 5, 7]])
def test_sequence_topk_avg_pooling_after_match_matrix(topks):
    """The pooling over a match map, the way the reference's text
    matching nets chain them; the gradient reaches the match weight."""
    def build(fl):
        x, y, (out, _) = _mm(fl)
        return [fl.contrib.sequence_topk_avg_pooling(out, x, y, topks, 3)]

    _run_both(build, _mm_feed(3))


def test_sequence_topk_avg_pooling_without_lengths():
    def build(fl):
        inp = fl.data("tk", [None, 2, 3, 5], "float32")
        return [fl.contrib.sequence_topk_avg_pooling(inp, None, None,
                                                     [1, 3, 6], 2)]

    _run_both(build, {"tk": _rng(4).standard_normal((B, 2, 3, 5)).astype(
        np.float32)}, grads=False)


def test_tree_conv():
    def build(fl):
        nodes = fl.data("nodes", [None, 6, 4], "float32")
        edges = fl.data("edges", [None, 5, 2], "int32")
        return [fl.contrib.tree_conv(nodes, edges, output_size=5,
                                     num_filters=2, max_depth=2)]

    edges = np.array([[[1, 2], [1, 3], [2, 4], [2, 5], [3, 6]]] * B,
                     np.int32)
    edges[1, 3:] = 0
    _run_both(build, {"nodes": _rng(5).standard_normal((B, 6, 4)).astype(
        np.float32), "edges": edges})


@pytest.mark.parametrize("padding_idx", [None, 0])
def test_fused_embedding_seq_pool(padding_idx):
    def build(fl):
        ids = fl.data("fids", [None, 5], "int64", lod_level=1)
        return [fl.contrib.fused_embedding_seq_pool(
            ids, [11, 6], padding_idx=padding_idx)]

    ids = _rng(6).integers(0, 11, (B, 5)).astype(np.int64)
    ids[0, 1] = 0
    _run_both(build, {"fids": ids, "fids@SEQ_LEN": _lens(5, 2, 4)})


@pytest.mark.parametrize("return_index", [True, False])
def test_multiclass_nms2(return_index):
    def build(fl):
        boxes = fl.data("nb", [None, 6, 4], "float32")
        scores = fl.data("ns", [None, 3, 6], "float32")
        out = fl.contrib.multiclass_nms2(
            boxes, scores, score_threshold=0.1, nms_top_k=5, keep_top_k=4,
            nms_threshold=0.4, background_label=0,
            return_index=return_index)
        return list(out) if return_index else [out]

    r = _rng(7)
    xy = r.uniform(0, 8, (2, 6, 2)).astype(np.float32)
    wh = r.uniform(1, 4, (2, 6, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=2)
    boxes[0, 1] = boxes[0, 0] + 0.1          # overlaps box 0
    scores = r.uniform(0, 1, (2, 3, 6)).astype(np.float32)
    _run_both(build, {"nb": boxes, "ns": scores}, grads=False)


@pytest.mark.parametrize("pyramid,lists", [(3, 0), (4, 4)])
def test_search_pyramid_hash(pyramid, lists):
    def build(fl):
        ids = fl.data("pids", [None, 6], "int64", lod_level=1)
        return [fl.contrib.search_pyramid_hash(
            ids, num_emb=8, space_len=64, pyramid_layer=pyramid,
            rand_len=4, drop_out_percent=0.0, is_training=True,
            use_filter=bool(lists), white_list_len=lists,
            black_list_len=lists, seed=1, lr=0.1)]

    ids = _rng(8).integers(0, 1000, (B, 6)).astype(np.int64)
    _run_both(build, {"pids": ids, "pids@SEQ_LEN": _lens(6, 2, 4)})


def _ctr(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        p = fl.data("cp", [None, 1], "float32")
        y = fl.data("cy", [None, 1], "int64")
        other = fl.layers.scale(p, 2.0)
        states = fl.contrib.ctr_metric_bundle(p, y)
    return main, startup, other, states


def test_ctr_metric_bundle_advances_unfetched():
    """Three batches that fetch another var (and one that fetches
    nothing): the four accumulators advance in the scope as the JAX
    package's do, and a fetch then reads them."""
    r = _rng(9)
    batches = [{"cp": r.uniform(0.05, 0.95, (8, 1)).astype(np.float32),
                "cy": r.integers(0, 2, (8, 1)).astype(np.int64)}
               for _ in range(4)]
    res = {}
    for fl in (jfluid, fluid):
        main, startup, other, states = _ctr(fl)
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup)
        for feed in batches[:3]:
            exe.run(main, feed=feed, fetch_list=[other])
        exe.run(main, feed=batches[3], fetch_list=[])
        scope = [host(fl.global_scope()[s.name]) for s in states]
        fetched = exe.run(main, feed=batches[0], fetch_list=list(states))
        res[fl] = (pjson(main), scope, [np.asarray(v) for v in fetched])
    (jj, js, jf), (pj, ps, pf) = res[jfluid], res[fluid]
    assert pj == jj
    for a, b in zip(ps + pf, js + jf):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    # (sqrerr, abserr, prob, q) over the four batches
    p, y = (np.concatenate([b[k] for b in batches]) for k in ("cp", "cy"))
    want = [((p - y) ** 2).sum(), np.abs(p - y).sum(), p.sum(),
            (p / (1 - p)).sum()]
    np.testing.assert_allclose([float(v) for v in ps], want, rtol=1e-5)


@pytest.mark.parametrize("test", [
    "test_fused_elemwise_activation", "test_match_matrix_tensor_oracle",
    "test_sequence_topk_avg_pooling_oracle", "test_fused_embedding_seq_pool",
    "test_multiclass_nms2_returns_indices",
    "test_search_pyramid_hash_runs_and_trains",
    "test_ctr_metric_bundle_accumulates", "test_var_conv_2d_shapes"])
def test_reference_contrib_layers_test_passes_on_the_port(
        test, port_contrib, tmp_path, monkeypatch):
    mod = on_port("test_contrib_layers_nn")
    assert mod.contrib is fluid.contrib
    run_reference_test(mod, test, tmp_path, monkeypatch)
