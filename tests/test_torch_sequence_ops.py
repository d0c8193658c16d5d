"""The sequence slice's op lowerings and layers against the JAX package, on
the CPU.

- The 17 sequence op types (``sequence_pool`` .. ``edit_distance``) and
  the three ops the recurrent chapters need beside them (``tanh``,
  ``cross_entropy``, ``reverse``): each lowering against the JAX
  lowering on the same seeded numpy inputs and attrs. Integer and
  data-movement results are equal bit for bit (int64 in the port where
  jax without x64 gives int32, ROADMAP.md Queue 3); float results within
  FWD_TOL (1e-6) of the largest value (softmax, matmul and log sum in
  other orders). Gradients through torch.autograd against jax.vjp under
  one random cotangent, within GRAD_TOL (1e-5) of the largest JAX
  gradient.
- ``sequence_pool`` MAX with tied maxima: the gradient is split equally
  among the ties, as jax's max reduction splits it; a length-0 row gives
  -inf; FIRST ignores the lengths; LAST reads index 0 of a length-0 row.
- Scatter-adds: ``sequence_concat``'s masked-out rows add zeros at
  total_t - 1; ``sequence_scatter`` adds duplicate ids.
- The reference's refusals raise in both packages: ``sequence_expand`` of
  a 3-D X, ``sequence_erase``, and ``sequence_mask`` with a
  ``MaxLenTensor`` or without ``maxlen``, run through each Executor.
- The sequence layers build the same Program JSON in both packages, their
  ``@SEQ_LEN`` companions included, and run to the same values.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.fluid import unique_name as jax_unique_name
from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
from paddle_tpu.ops.registry import get_lowering as jax_lowering
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.ops.registry import LowerContext
from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering

FWD_TOL = 1e-6
GRAD_TOL = 1e-5

SEQUENCE_OPS = (
    "sequence_pool", "sequence_softmax", "sequence_reverse",
    "sequence_expand", "sequence_expand_as", "sequence_concat",
    "sequence_conv", "sequence_mask", "sequence_pad", "sequence_unpad",
    "sequence_enumerate", "sequence_slice", "sequence_erase", "lod_reset",
    "sequence_reshape", "sequence_scatter", "edit_distance")
SUPPORT_OPS = ("tanh", "cross_entropy", "reverse")


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


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ints(*shape, lo=0, hi=9, seed=0):
    return np.random.default_rng(seed).integers(
        lo, hi, size=shape).astype(np.int64)


def _ctx():
    return LowerContext(torch.device("cpu"), generator=torch.Generator())


def _jctx():
    return JaxLowerContext(rng=jax.random.PRNGKey(0), platform="cpu")


def _run_both(op_type, ins, attrs):
    """({slot: [np]}, {slot: [np]}) of the port's and the JAX package's
    lowering on the same numpy inputs."""
    got = pt_lowering(op_type)(
        _ctx(), {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
                 for k, v in ins.items()}, dict(attrs))
    want = jax_lowering(op_type)(
        _jctx(), {k: [jnp.asarray(a) for a in v] for k, v in ins.items()},
        dict(attrs))
    return ({k: [t.detach().numpy() for t in v] for k, v in got.items()},
            {k: [np.asarray(x) for x in v] for k, v in want.items()})


def _assert_same(a, w, what=""):
    """Same shape; the same dtype (int64 where jax gives int32); equal
    integers and bools, floats within FWD_TOL of the largest."""
    assert a.shape == w.shape, (what, a.shape, w.shape)
    assert a.dtype == w.dtype or (
        w.dtype == np.int32 and a.dtype == np.int64), (what, a.dtype, w.dtype)
    if np.issubdtype(w.dtype, np.floating):
        fin = np.isfinite(w)
        np.testing.assert_array_equal(fin, np.isfinite(a), err_msg=what)
        np.testing.assert_array_equal(a[~fin], w[~fin], err_msg=what)
        if fin.any():
            scale = max(float(np.abs(w[fin]).max()), 1e-30)
            assert float(np.abs(a[fin] - w[fin]).max()) <= FWD_TOL * scale, (
                what, float(np.abs(a[fin] - w[fin]).max()), scale)
    else:
        np.testing.assert_array_equal(a, w.astype(a.dtype), err_msg=what)


def _grads_both(op_type, ins, attrs, wrt, out_slot, seed=5):
    """d out_slot / d (every input of the wrt slots) under one random
    cotangent: torch.autograd on the port's lowering, jax.vjp on the JAX
    package's."""
    pt = {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
          for k, v in ins.items()}
    for s in wrt:
        pt[s] = [t.requires_grad_() for t in pt[s]]
    out = pt_lowering(op_type)(_ctx(), pt, dict(attrs))[out_slot][0]
    cot = _rand(*out.shape, seed=seed)
    got = torch.autograd.grad(out, [t for s in wrt for t in pt[s]],
                              torch.from_numpy(cot))
    jx = {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}
    counts = [len(jx[s]) for s in wrt]

    def f(*vals):
        args = dict(jx)
        it = iter(vals)
        for s, n in zip(wrt, counts):
            args[s] = [next(it) for _ in range(n)]
        return jax_lowering(op_type)(_jctx(), args, dict(attrs))[out_slot][0]

    _, vjp = jax.vjp(f, *[v for s in wrt for v in jx[s]])
    want = vjp(jnp.asarray(cot))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def test_every_new_op_has_a_port_lowering():
    for op in SEQUENCE_OPS + SUPPORT_OPS:
        pt_lowering(op)


LENS = np.array([5, 2, 0, 3], np.int32)


def _case(name):
    """(op, ins, attrs, differentiable input slots, output slot)."""
    x = _rand(4, 5, 3)
    return {
        "pool_sum": ("sequence_pool", {"X": [x], "SeqLen": [LENS]},
                     {"pooltype": "SUM"}, ["X"], "Out"),
        "pool_average": ("sequence_pool", {"X": [x], "SeqLen": [LENS]},
                         {"pooltype": "AVERAGE"}, ["X"], "Out"),
        "pool_sqrt": ("sequence_pool", {"X": [x], "SeqLen": [LENS]},
                      {"pooltype": "SQRT"}, ["X"], "Out"),
        "pool_max": ("sequence_pool", {"X": [x], "SeqLen": [LENS + 1]},
                     {"pooltype": "MAX"}, ["X"], "Out"),
        "pool_last": ("sequence_pool", {"X": [x], "SeqLen": [LENS]},
                      {"pooltype": "LAST"}, ["X"], "Out"),
        "pool_first": ("sequence_pool", {"X": [x], "SeqLen": [LENS]},
                       {"pooltype": "FIRST"}, ["X"], "Out"),
        "pool_no_lens": ("sequence_pool", {"X": [x]},
                         {"pooltype": "AVERAGE"}, ["X"], "Out"),
        "softmax": ("sequence_softmax",
                    {"X": [_rand(4, 5)], "SeqLen": [LENS + 1]}, {}, ["X"],
                    "Out"),
        "softmax_3d": ("sequence_softmax",
                       {"X": [_rand(4, 5, 1)], "SeqLen": [LENS + 1]}, {},
                       ["X"], "Out"),
        "reverse": ("sequence_reverse", {"X": [x], "SeqLen": [LENS]}, {},
                    ["X"], "Y"),
        "expand": ("sequence_expand", {"X": [_rand(4, 3)], "Y": [x]}, {},
                   ["X"], "Out"),
        "expand_as": ("sequence_expand_as", {"X": [_rand(4, 3)], "Y": [x]},
                      {}, ["X"], "Out"),
        "expand_as_same_rank": ("sequence_expand_as",
                                {"X": [_rand(4, 1, 3)], "Y": [x]}, {},
                                ["X"], "Out"),
        "concat": ("sequence_concat",
                   {"X": [x, _rand(4, 3, 3, seed=1)],
                    "SeqLen": [LENS, np.array([1, 3, 2, 0], np.int32)]},
                   {}, ["X"], "Out"),
        "concat_plain": ("sequence_concat", {"X": [x, _rand(4, 3, 3)]}, {},
                         ["X"], "Out"),
        "conv": ("sequence_conv",
                 {"X": [x], "SeqLen": [LENS], "Filter": [_rand(9, 4, seed=2)]},
                 {"contextLength": 3, "contextStart": -1}, ["X", "Filter"],
                 "Out"),
        "conv_shifted": ("sequence_conv",
                         {"X": [x], "SeqLen": [LENS],
                          "Filter": [_rand(12, 2, seed=3)],
                          "Bias": [_rand(2, seed=4)]},
                         {"contextLength": 4, "contextStart": 0},
                         ["X", "Filter", "Bias"], "Out"),
        "mask": ("sequence_mask", {"X": [LENS.astype(np.int64)]},
                 {"maxlen": 6, "out_dtype": "int64"}, [], "Y"),
        "mask_float": ("sequence_mask", {"X": [LENS.reshape(4, 1)]},
                       {"maxlen": 4, "out_dtype": "float32"}, [], "Y"),
        "pad_longer": ("sequence_pad",
                       {"X": [x], "SeqLen": [LENS],
                        "PadValue": [np.array([-1.5], np.float32)]},
                       {"padded_length": 7}, ["X"], "Out"),
        "pad_shorter": ("sequence_pad", {"X": [x], "SeqLen": [LENS]},
                        {"padded_length": 3}, ["X"], "Out"),
        "unpad": ("sequence_unpad",
                  {"X": [x], "Length": [LENS.astype(np.int64)]}, {}, ["X"],
                  "Out"),
        "enumerate": ("sequence_enumerate", {"X": [_ints(3, 6)]},
                      {"win_size": 3, "pad_value": 7}, [], "Out"),
        "slice": ("sequence_slice",
                  {"X": [x], "Offset": [np.array([[1], [0], [3], [2]],
                                                 np.int64)],
                   "Length": [np.array([[3], [2], [2], [1]], np.int64)]},
                  {}, ["X"], "Out"),
        "lod_reset": ("lod_reset", {"X": [x]}, {}, ["X"], "Out"),
        "reshape": ("sequence_reshape", {"X": [_rand(4, 6, 2)]},
                    {"new_dim": 4}, ["X"], "Out"),
        "scatter": ("sequence_scatter",
                    {"X": [_rand(3, 6)],
                     "Ids": [np.array([[0, 2, 2], [5, 5, 5], [1, 0, 4]],
                                      np.int64)],
                     "Updates": [_rand(3, 3, seed=1)]}, {},
                    ["X", "Updates"], "Out"),
        "tanh": ("tanh", {"X": [x]}, {}, ["X"], "Out"),
        "cross_entropy": ("cross_entropy",
                          {"X": [np.abs(_rand(6, 4)) + 0.1],
                           "Label": [np.array([[0], [3], [1], [-100], [2],
                                               [3]], np.int64)]},
                          {"ignore_index": -100}, ["X"], "Y"),
        "cross_entropy_3d": ("cross_entropy",
                             {"X": [np.abs(_rand(2, 3, 4)) + 0.1],
                              "Label": [_ints(2, 3, 1, hi=4)]}, {}, ["X"],
                             "Y"),
        "cross_entropy_soft": ("cross_entropy",
                               {"X": [np.abs(_rand(3, 4)) + 0.1],
                                "Label": [np.abs(_rand(3, 4, seed=1))]},
                               {"soft_label": True}, ["X"], "Y"),
        "flip": ("reverse", {"X": [x]}, {"axis": [0, 2]}, ["X"], "Out"),
    }[name]


CASES = ("pool_sum", "pool_average", "pool_sqrt", "pool_max", "pool_last",
         "pool_first", "pool_no_lens", "softmax", "softmax_3d", "reverse",
         "expand", "expand_as", "expand_as_same_rank", "concat",
         "concat_plain", "conv", "conv_shifted", "mask", "mask_float",
         "pad_longer", "pad_shorter", "unpad", "enumerate", "slice",
         "lod_reset", "reshape", "scatter", "tanh", "cross_entropy",
         "cross_entropy_3d", "cross_entropy_soft", "flip")


@pytest.mark.parametrize("case", CASES)
def test_lowering_matches_jax(case):
    op, ins, attrs, wrt, out = _case(case)
    got, want = _run_both(op, ins, attrs)
    for slot in want:
        assert len(got[slot]) == len(want[slot]), slot
        for a, w in zip(got[slot], want[slot]):
            _assert_same(a, w, "%s.%s" % (case, slot))
    if not wrt:
        return
    gots, wants = _grads_both(op, ins, attrs, wrt, out)
    assert len(gots) == len(wants) == sum(len(ins[s]) for s in wrt)
    for i, (a, w) in enumerate(zip(gots, wants)):
        assert a.shape == w.shape, (case, i)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(a - w).max()) <= GRAD_TOL * scale, (case, i)


def test_max_pool_splits_the_gradient_among_ties():
    x = np.array([[[1.0], [3.0], [3.0], [9.0]],
                  [[2.0], [2.0], [2.0], [0.0]]], np.float32)
    ins = {"X": [x], "SeqLen": [np.array([3, 3], np.int32)]}
    attrs = {"pooltype": "MAX"}
    got, want = _grads_both("sequence_pool", ins, attrs, ["X"], "Out")
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-7)
    cot = _rand(2, 1, seed=5)
    np.testing.assert_allclose(got[0][0, 1:3, 0], cot[0, 0] / 2, rtol=1e-6)
    np.testing.assert_allclose(got[0][1, :3, 0], cot[1, 0] / 3, rtol=1e-6)
    assert got[0][0, 3, 0] == 0.0             # past the length


def test_pool_edges_of_empty_rows():
    x = _rand(2, 3, 2)
    lens = np.array([0, 2], np.int32)
    for ptype, row0 in (("MAX", np.full(2, -np.inf, np.float32)),
                        ("FIRST", x[0, 0]), ("LAST", x[0, 0]),
                        ("SUM", np.zeros(2, np.float32)),
                        ("AVERAGE", np.zeros(2, np.float32))):
        got, want = _run_both("sequence_pool", {"X": [x], "SeqLen": [lens]},
                              {"pooltype": ptype})
        _assert_same(got["Out"][0], want["Out"][0], ptype)
        np.testing.assert_array_equal(got["Out"][0][0], row0)
        assert got["MaxIndex"][0].dtype == np.int32
        assert not got["MaxIndex"][0].any()


def test_concat_adds_masked_rows_at_the_last_position():
    a = np.ones((1, 2, 1), np.float32)
    b = np.full((1, 2, 1), 5.0, np.float32)
    ins = {"X": [a, b], "SeqLen": [np.array([1], np.int32),
                                   np.array([1], np.int32)]}
    got, want = _run_both("sequence_concat", ins, {})
    np.testing.assert_array_equal(got["Out"][0][0, :, 0], [1, 5, 0, 0])
    np.testing.assert_array_equal(got["Out"][0], want["Out"][0])


def test_edit_distance_matches_jax():
    rng = np.random.default_rng(4)
    hyp = rng.integers(0, 4, (5, 7)).astype(np.int64)
    ref = rng.integers(0, 4, (5, 6)).astype(np.int64)
    hl = np.array([7, 3, 0, 5, 1], np.int64)
    rl = np.array([6, 6, 2, 0, 1], np.int64)
    for normalized in (False, True):
        for lens in ({}, {"HypsLength": [hl], "RefsLength": [rl]}):
            ins = {"Hyps": [hyp], "Refs": [ref], **lens}
            got, want = _run_both("edit_distance", ins,
                                  {"normalized": normalized})
            _assert_same(got["Out"][0], want["Out"][0], "Out")
            assert got["SequenceNum"][0].dtype == np.int64
            assert int(got["SequenceNum"][0]) == int(want["SequenceNum"][0])
    got, _ = _run_both("edit_distance",
                       {"Hyps": [np.array([[1, 2, 3, 0]], np.int64)],
                        "Refs": [np.array([[1, 3, 3]], np.int64)],
                        "HypsLength": [np.array([3], np.int64)]}, {})
    assert float(got["Out"][0][0, 0]) == 1.0      # one substitution


def test_unpad_reads_a_column_of_lengths_as_a_vector():
    """A (B, 1) Length: the JAX lowering broadcasts its mask to a 4-D
    (B, B, T, D) result; the port reads the lengths as (B,) (ROADMAP.md
    Queue 3). A (B,) Length, as ``sequence_pad`` gives it, agrees."""
    x = _rand(3, 4, 2)
    col = np.array([[2], [4], [1]], np.int64)
    got, want = _run_both("sequence_unpad", {"X": [x], "Length": [col]}, {})
    assert want["Out"][0].shape == (3, 3, 4, 2)
    vec, want_vec = _run_both("sequence_unpad",
                              {"X": [x], "Length": [col.reshape(-1)]}, {})
    _assert_same(vec["Out"][0], want_vec["Out"][0])
    np.testing.assert_array_equal(got["Out"][0], vec["Out"][0])


def test_refusals_raise_in_both_packages():
    x3 = _rand(2, 3, 4)
    for op, ins in (("sequence_expand", {"X": [x3], "Y": [x3]}),
                    ("sequence_erase", {"X": [_ints(2, 3)]})):
        with pytest.raises(NotImplementedError):
            pt_lowering(op)(_ctx(), {k: [torch.from_numpy(a) for a in v]
                                     for k, v in ins.items()}, {})
        with pytest.raises(NotImplementedError):
            jax_lowering(op)(_jctx(), {k: [jnp.asarray(a) for a in v]
                                       for k, v in ins.items()}, {})


@pytest.mark.parametrize("tensor_maxlen", [True, False])
def test_sequence_mask_needs_a_static_maxlen_in_both(tensor_maxlen):
    feed = {"lens": np.array([1, 3], "int64"),
            "maxlen": np.array([4], "int64")}
    for fl in (jfluid, fluid):
        main, start = fl.Program(), fl.Program()
        with fl.program_guard(main, start):
            lens = fl.data("lens", shape=[None], dtype="int64")
            maxlen = fl.data("maxlen", shape=[1], dtype="int64")
            y = fl.layers.sequence_mask(
                lens, maxlen=maxlen if tensor_maxlen else None)
        with pytest.raises(NotImplementedError, match="static"):
            fl.Executor(fl.CPUPlace()).run(main, feed=feed, fetch_list=[y],
                                           scope=fl.Scope())


def _sequence_layers(fl):
    """Every sequence layer, in one program, from two lod_level=1 feeds."""
    L = fl.layers
    x = fl.data("x", shape=[None, 5, 3], dtype="float32", lod_level=1)
    y = fl.data("y", shape=[None, 4, 3], dtype="float32", lod_level=1)
    ids = fl.data("ids", shape=[None, 5], dtype="int64", lod_level=1)
    v = fl.data("v", shape=[None, 3], dtype="float32")
    off = fl.data("off", shape=[None, 1], dtype="int64")
    ln = fl.data("ln", shape=[None, 1], dtype="int64")
    sc = fl.data("sc", shape=[None, 5], dtype="float32", lod_level=1)
    padded, length = L.sequence_pad(
        x, pad_value=L.fill_constant([1], "float32", 0.5), maxlen=6)
    outs = [
        L.sequence_pool(x, "sum"), L.sequence_pool(x, "max"),
        L.sequence_first_step(x), L.sequence_last_step(x),
        L.sequence_softmax(sc), L.sequence_reverse(x),
        L.sequence_expand(v, x), L.sequence_expand_as(v, x),
        L.sequence_concat([x, y]),
        L.sequence_conv(x, num_filters=4, filter_size=3, act="tanh"),
        padded, length, L.sequence_unpad(padded, length),
        L.sequence_enumerate(ids, 2),
        L.sequence_slice(x, off, ln), L.sequence_reshape(x, 5),
        L.sequence_mask(ln, maxlen=5, dtype="float32"),
        L.lod_reset(x, y), L.lod_append(x, [1, 2, 3, 4]),
        fl.nets.sequence_conv_pool(x, num_filters=2, filter_size=3),
    ]
    return outs


def test_sequence_layers_build_and_run_as_in_jax():
    progs = []
    for fl, un in ((jfluid, jax_unique_name), (fluid, pt_unique_name)):
        un.switch()
        main, start = fl.Program(), fl.Program()
        start.random_seed = 11
        with fl.program_guard(main, start):
            outs = _sequence_layers(fl)
        progs.append((main, start, outs))
    (jmain, jstart, jouts), (pmain, pstart, pouts) = progs
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert json.loads(pstart.to_json()) == json.loads(jstart.to_json())
    names = set(pmain.global_block().vars)
    for o in pouts[4:9]:
        assert o.name + "@SEQ_LEN" in names, o.name
    feed = {"x": _rand(4, 5, 3), "x@SEQ_LEN": np.array([5, 3, 1, 4],
                                                       np.int32),
            "y": _rand(4, 4, 3, seed=1),
            "y@SEQ_LEN": np.array([4, 1, 2, 3], np.int32),
            "ids": _ints(4, 5), "v": _rand(4, 3, seed=2),
            "off": np.array([[0], [1], [2], [0]], np.int64),
            "ln": np.array([[2], [1], [3], [4]], np.int64),
            "sc": _rand(4, 5, seed=3)}
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    want = jexe.run(jmain, feed=feed, fetch_list=jouts, scope=jscope)
    scope = fluid.Scope()
    for n in jscope.keys():
        scope.set(n, np.array(jscope[n]))
    got = fluid.Executor(fluid.CPUPlace()).run(pmain, feed=feed,
                                               fetch_list=pouts, scope=scope)
    for o, a, w in zip(pouts, got, want):
        _assert_same(a, np.asarray(w), o.name)
