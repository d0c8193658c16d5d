"""The training slice of the port against the JAX package, on the CPU.

- Each new op lowering (mean, softmax_with_cross_entropy, adam, dropout)
  gets the same numpy inputs and attrs as the JAX lowering. Tolerances:
  1e-6 for the loss and optimizer arithmetic (f32, exact in practice up to
  the last bit); dropout cannot match bit for bit (the JAX package draws
  from jax.random), so it is compared by keep rate, scaling and the eval
  path.
- The ``backward`` op: targets the loss does not reach, intermediate
  targets, ``InitGrad`` seeds, and scopes that hold no autograd state.
- The slice as a whole: bert_tiny (f32, dropout 0) + Adam built in both
  packages, the JAX startup values (fixed seed) copied by name, 5 steps on
  one batch. Losses within 1e-4 relative and gradients within
  1e-4·max|grad| of each parameter's at every step, and each parameter's
  5-step update (after − before) within 1e-3·max|update| of what Adam
  makes of the port's own gradients and of the JAX package's update (but
  where Adam passes the gradients' rounding differences through, see the
  test), so a wrong step size or bias correction fails.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
from paddle_tpu.ops.registry import get_lowering as jax_lowering
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops.registry import LowerContext
from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering

SEQ = 16
STEPS = 5
LR = 1e-4
BETA1, BETA2, EPS = 0.9, 0.999, 1e-8     # fluid.optimizer.Adam's defaults
INIT_SEED = 1234


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


def _run_both(op_type, ins, attrs, seed=0):
    """The port's and the JAX package's lowering of `op_type` on the same
    numpy inputs; returns ({slot: [np]}, {slot: [np]})."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    got = pt_lowering(op_type)(
        LowerContext(torch.device("cpu"), generator=gen),
        {k: [torch.from_numpy(np.ascontiguousarray(a)) for a in v]
         for k, v in ins.items()}, dict(attrs))
    want = jax_lowering(op_type)(
        JaxLowerContext(rng=jax.random.PRNGKey(seed), platform="cpu"),
        {k: [jnp.asarray(a) for a in v] for k, v in ins.items()}, dict(attrs))
    return ({k: [t.numpy() for t in v] for k, v in got.items()},
            {k: [np.asarray(x) for x in v] for k, v in want.items()})


def _assert_close(got, want, slots, tol=1e-6):
    for slot in slots:
        for a, w in zip(got[slot], want[slot]):
            assert a.shape == w.shape, (slot, a.shape, w.shape)
            assert a.dtype == w.dtype, (slot, a.dtype, w.dtype)
            np.testing.assert_allclose(a, w, rtol=0, atol=tol, err_msg=slot)


# ---------------------------------------------------------------------------
# op lowerings
# ---------------------------------------------------------------------------
def test_mean():
    got, want = _run_both("mean", {"X": [_rand(4, 7, 3)]}, {})
    _assert_close(got, want, ("Out",))


@pytest.mark.parametrize("label_shape", [(3, 5, 1), (3, 5)])
def test_softmax_with_cross_entropy_hard_labels(label_shape):
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 11, size=label_shape).astype(np.int64)
    labels.reshape(-1)[::3] = -1            # ignored rows give loss 0
    got, want = _run_both("softmax_with_cross_entropy",
                          {"Logits": [_rand(3, 5, 11) * 4],
                           "Label": [labels]},
                          {"soft_label": False, "ignore_index": -1,
                           "axis": -1})
    _assert_close(got, want, ("Softmax", "Loss"))
    assert got["Loss"][0].shape == (3, 5, 1)
    assert (got["Loss"][0].reshape(-1)[::3] == 0).all()


def test_softmax_with_cross_entropy_soft_labels():
    soft = np.random.default_rng(2).random((4, 9)).astype(np.float32)
    soft /= soft.sum(axis=-1, keepdims=True)
    got, want = _run_both("softmax_with_cross_entropy",
                          {"Logits": [_rand(4, 9)], "Label": [soft]},
                          {"soft_label": True, "axis": -1})
    _assert_close(got, want, ("Softmax", "Loss"))


@pytest.mark.parametrize("axis", [1, 0])
def test_softmax_with_cross_entropy_soft_labels_other_axis(axis):
    # logits (2, 5, 3), soft labels normalised over `axis`; tolerance 1e-6
    # as for the last axis (f32 on both sides)
    soft = np.random.default_rng(3).random((2, 5, 3)).astype(np.float32)
    soft /= soft.sum(axis=axis, keepdims=True)
    got, want = _run_both("softmax_with_cross_entropy",
                          {"Logits": [_rand(2, 5, 3) * 3], "Label": [soft]},
                          {"soft_label": True, "axis": axis})
    _assert_close(got, want, ("Softmax", "Loss"))
    assert got["Loss"][0].shape == tuple(1 if i == axis else n
                                         for i, n in enumerate((2, 5, 3)))


def test_softmax_with_cross_entropy_hard_labels_other_axis_raises():
    # the reference's gather is wrong over a non-last axis: the port raises
    # and names it instead of copying it
    lowering = pt_lowering("softmax_with_cross_entropy")
    with pytest.raises(NotImplementedError, match="reference's lowering"):
        lowering(LowerContext(torch.device("cpu")),
                 {"Logits": [torch.zeros(2, 5, 3)],
                  "Label": [torch.zeros(2, 1, 3, dtype=torch.int64)]},
                 {"soft_label": False, "axis": 1})


@pytest.mark.parametrize("step", [1, 7])
def test_adam(step):
    b1, b2 = 0.9, 0.999
    rng = np.random.default_rng(step)
    ins = {"Param": [_rand(6, 5)], "Grad": [_rand(6, 5, seed=1)],
           "Moment1": [_rand(6, 5, seed=2) * 0.1],
           "Moment2": [np.abs(_rand(6, 5, seed=3)) * 0.01],
           "Beta1Pow": [np.array([b1 ** step], np.float32)],
           "Beta2Pow": [np.array([b2 ** step], np.float32)],
           "LearningRate": [np.array([rng.uniform(1e-4, 1e-2)], np.float32)]}
    got, want = _run_both("adam", ins, {"beta1": b1, "beta2": b2,
                                        "epsilon": 1e-8})
    _assert_close(got, want, ("ParamOut", "Moment1Out", "Moment2Out",
                              "Beta1PowOut", "Beta2PowOut"))


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_train_keep_rate_and_scaling(impl):
    p = 0.3
    x = np.abs(_rand(64, 128)) + 0.5        # nonzero, so a zero is a drop
    attrs = {"dropout_prob": p, "dropout_implementation": impl,
             "is_test": False}
    got, want = _run_both("dropout", {"X": [x]}, attrs)
    scale = 1.0 / (1.0 - p) if impl == "upscale_in_train" else 1.0
    for res in (got, want):
        out, mask = res["Out"][0], res["Mask"][0]
        assert out.shape == mask.shape == x.shape
        assert out.dtype == mask.dtype == np.float32
        kept = mask.astype(bool)
        # 8192 draws: the keep rate's standard error is ~0.005
        assert abs(kept.mean() - (1.0 - p)) < 0.02, kept.mean()
        np.testing.assert_allclose(out[kept], x[kept] * scale, rtol=1e-6)
        assert (out[~kept] == 0).all()
    # each package draws a new mask per generator state
    again, _ = _run_both("dropout", {"X": [x]}, attrs, seed=1)
    assert not np.array_equal(again["Mask"][0], got["Mask"][0])


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_eval_path(impl):
    got, want = _run_both("dropout", {"X": [_rand(5, 6)]},
                          {"dropout_prob": 0.25, "is_test": True,
                           "dropout_implementation": impl})
    _assert_close(got, want, ("Out", "Mask"))


def test_unported_optimizer_op_names_the_gap():
    with pytest.raises(NotImplementedError, match="no torch lowering yet"):
        pt_lowering("lars_momentum")


# ---------------------------------------------------------------------------
# the backward op
# ---------------------------------------------------------------------------
def _build_grad_program(pkg, with_seed):
    """x -> fc(h1) -> fc(out); a third fc the loss never reads. Returns
    (main, startup, loss, names of the gradient vars) after gradients()
    for [h1's weight, the unused weight, the intermediate h1]."""
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        x = pkg.data("x", [None, 6])
        h1 = pkg.layers.fc(x, 5, param_attr=pkg.ParamAttr(name="w1"))
        out = pkg.layers.fc(h1, 3, param_attr=pkg.ParamAttr(name="w2"))
        pkg.layers.fc(x, 2, param_attr=pkg.ParamAttr(name="w_unused"))
        loss = pkg.layers.mean(out)
        seed = None
        if with_seed:
            seed = main.global_block().create_var(
                name="seed", dtype="float32", shape=())
            main.global_block().append_op(
                type="fill_constant", outputs={"Out": [seed]},
                attrs={"shape": [], "dtype": "float32", "value": 3.0})
        block = main.global_block()
        grads = pkg.gradients(
            [loss], [block.var("w1"), block.var("w_unused"), h1],
            target_gradients=[seed] if with_seed else None)
    return main, startup, loss, [g.name for g in grads]


@pytest.mark.parametrize("with_seed", [False, True])
def test_gradients_match_jax(with_seed):
    """gradients() w.r.t. a used weight, an unused one (zeros) and an
    intermediate, with and without an InitGrad seed, against the JAX
    package on the same parameters."""
    jmain, jstart, jloss, jgrads = _build_grad_program(jfluid, with_seed)
    pmain, pstart, ploss, pgrads = _build_grad_program(fluid, with_seed)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    scope = fluid.Scope()
    for n, t in params_from_numpy(
            {p.name: np.asarray(jscope[p.name])
             for p in pmain.all_parameters()}, torch.device("cpu")).items():
        scope.set(n, t)
    feed = {"x": _rand(4, 6, seed=9)}
    want = jexe.run(jmain, feed=feed, fetch_list=[jloss] + jgrads,
                    scope=jscope)
    got = fluid.Executor(fluid.CPUPlace()).run(
        pmain, feed=feed, fetch_list=[ploss] + pgrads, scope=scope)
    for name, a, w in zip(["loss"] + pgrads, got, want):
        assert a.shape == np.asarray(w).shape, name
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=1e-6, err_msg=name)
    assert not got[2].any()                      # w_unused@GRAD
    assert got[1].any() and got[3].any()
    assert all(not t.requires_grad for _, t in scope.items())


def test_target_rewritten_in_region_matches_jax():
    """A target bound at program start is differentiated at its start
    value even when an op of the region writes the var again (w = w + w
    before the fc reads it), as jax.vjp's primals are."""
    results = []
    for pkg in (jfluid, fluid):
        main, startup = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, startup):
            x = pkg.data("x", [None, 3])
            loss = pkg.layers.mean(pkg.layers.fc(
                x, 2, param_attr=pkg.ParamAttr(name="w"), bias_attr=False))
            block = main.global_block()
            block.ops.insert(0, pkg.Operator(
                block, "elementwise_add", {"X": ["w"], "Y": ["w"]},
                {"Out": ["w"]}, {"axis": -1}))
            grads = pkg.gradients([loss], [block.var("w")])
        scope = pkg.Scope()
        scope.set("w", np.arange(6, dtype=np.float32).reshape(3, 2)
                  if pkg is jfluid else torch.arange(6.0).reshape(3, 2))
        exe = pkg.Executor(pkg.CPUPlace())
        results.append(exe.run(main, feed={"x": _rand(4, 3, seed=5)},
                               fetch_list=[loss, grads[0]], scope=scope))
    (jl, jg), (pl, pg) = results
    np.testing.assert_allclose(pl, jl, rtol=1e-6)
    np.testing.assert_allclose(pg, jg, rtol=1e-6)
    x = _rand(4, 3, seed=5)        # d mean(x @ 2w) / dw = 2 x^T 1 / 8
    np.testing.assert_allclose(pg, np.repeat(x.sum(0)[:, None], 2, 1) / 4,
                               rtol=1e-5)


def test_init_grad_scales_the_gradient():
    main, startup, loss, grads = _build_grad_program(fluid, True)
    pt_unique_name.switch()          # the same names for the second build
    main1, _, _, grads1 = _build_grad_program(fluid, False)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": _rand(3, 6, seed=4)}
    seeded = exe.run(main, feed=feed, fetch_list=grads, scope=scope)
    plain = exe.run(main1, feed=feed, fetch_list=grads1, scope=scope)
    for a, b in zip(seeded, plain):
        np.testing.assert_allclose(a, 3.0 * b, rtol=1e-6, atol=1e-7)


def test_training_run_leaves_no_autograd_state():
    """After Executor.run of a minimized program the scope's tensors are
    plain values (no requires_grad, no grad_fn), and the tensors that were
    in the scope before the run were never marked."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [None, 4])
        loss = fluid.layers.mean(fluid.layers.fc(x, 3))
        fluid.optimizer.Adam(learning_rate=0.1).minimize(loss)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    before = {n: t for n, t in scope.items()}
    w0 = {n: t.clone() for n, t in before.items()}
    exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
            fetch_list=[loss], scope=scope)
    assert all(not t.requires_grad and t.grad_fn is None
               for _, t in scope.items())
    assert all(not t.requires_grad and t.grad is None
               for t in before.values())
    moved = [n for n, t in scope.items() if not torch.equal(t, w0[n])]
    assert any(n.endswith(".w_0") for n in moved), moved


def test_backward_forms_left_for_later():
    """A second backward op in a block and recompute raise, naming the
    later training slice."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [None, 4])
        loss = fluid.layers.mean(fluid.layers.fc(x, 3))
    w = main.all_parameters()[0].name
    for _ in range(2):     # a second backward op in the block
        main.global_block().append_op(
            type="backward", inputs={"Loss": [loss]},
            outputs={"Grads": [w + "@GRAD"]},
            attrs={"targets": [w], "checkpoints": []})
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(NotImplementedError, match="second 'backward' op"):
        exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                fetch_list=[loss], scope=scope)
    main.global_block().ops.pop()
    main.global_block().ops[-1].attrs["checkpoints"] = [loss.name]
    with pytest.raises(NotImplementedError, match="training slice"):
        exe.run(main, feed={"x": np.ones((2, 4), np.float32)},
                fetch_list=[loss], scope=scope)


@pytest.mark.parametrize("kind", ["global_norm_clip", "l2_decay",
                                  "l1_decay"])
def test_clip_and_regularizer_ops_name_the_gap(kind):
    """A real clip or regularizer appends its ops as the JAX package does.
    Global-norm clipping (squared_l2_norm, ...) and L1Decay (sign) have no
    torch lowering yet and raise when the program runs; L2Decay's scale
    and elementwise_add are lowered since the mixed-precision slice, so
    its program trains, each regularized gradient being grad + coeff·param
    (the param before the update)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.data("x", [None, 4])
        loss = fluid.layers.mean(fluid.layers.fc(x, 3))
        reg = None
        if kind == "global_norm_clip":
            fluid.clip.set_gradient_clip(
                fluid.clip.GradientClipByGlobalNorm(1.0), program=main)
        elif kind == "l2_decay":
            reg = fluid.regularizer.L2Decay(1e-2)
        else:
            reg = fluid.regularizer.L1Decay(1e-2)
        fluid.optimizer.Adam(0.1, regularization=reg).minimize(loss)
    ops = [op.type for op in main.global_block().ops]
    assert {"global_norm_clip": "squared_l2_norm", "l2_decay": "scale",
            "l1_decay": "sign"}[kind] in ops
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((2, 4), np.float32)}
    if kind != "l2_decay":
        with pytest.raises(NotImplementedError, match="no torch lowering yet"):
            exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        return
    params = [p.name for p in main.all_parameters()]
    before = {n: scope[n].clone() for n in params}
    got = exe.run(main, feed=feed, scope=scope, fetch_list=[
        n + "@GRAD" for n in params] + [n + "@GRAD@REGULARIZED"
                                         for n in params])
    for n, g, r in zip(params, got[:len(params)], got[len(params):]):
        np.testing.assert_allclose(r, g + 1e-2 * before[n].numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=n)
        assert not torch.equal(scope[n], before[n]), n


def test_grad_comm_hook_waits_for_the_parallel_slice():
    from paddle_tpu_torch.fluid.lowering import build_step_fn

    with pytest.raises(NotImplementedError, match="grad_comm"):
        build_step_fn(fluid.Program(), [], [], "cpu",
                      grad_comm=lambda grads: grads)


# ---------------------------------------------------------------------------
# the slice: bert_tiny + Adam, 5 steps, both packages
# ---------------------------------------------------------------------------
def _build_train(pkg, bert_mod):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        io = bert_mod.build_bert_pretrain(bert_mod.bert_tiny(SEQ), SEQ)
        pkg.optimizer.Adam(learning_rate=LR).minimize(io["loss"])
    return main, startup, io


def test_train_program_parity():
    jmain, jstart, _ = _build_train(jfluid, jbert)
    pmain, pstart, _ = _build_train(fluid, bert)
    assert json.loads(pmain.to_json()) == json.loads(jmain.to_json())
    assert json.loads(pstart.to_json()) == json.loads(jstart.to_json())
    ops = {op.type for op in pmain.global_block().ops}
    assert {"backward", "adam", "softmax_with_cross_entropy", "mean",
            "fused_multihead_attention", "layer_norm"} <= ops
    assert pmain._appending_grad_times == 1
    assert pmain._loss_name == pmain.global_block().ops[
        [op.type for op in pmain.global_block().ops].index("backward")
    ].input("Loss")[0]


def _adam_update(grads):
    """The update Adam makes from a parameter's gradients of successive
    steps, in float64: what either package's Adam should make of them."""
    m = v = 0.0
    update = 0.0
    for t, g in enumerate(grads, 1):
        g = np.asarray(g, np.float64)
        m = BETA1 * m + (1 - BETA1) * g
        v = BETA2 * v + (1 - BETA2) * g * g
        lr_t = LR * np.sqrt(1 - BETA2 ** t) / (1 - BETA1 ** t)
        update = update - lr_t * m / (np.sqrt(v) + EPS)
    return update


def test_bert_tiny_adam_matches_jax():
    jmain, jstart, jio = _build_train(jfluid, jbert)
    pmain, pstart, pio = _build_train(fluid, bert)
    # a fixed seed: with random_seed 0 the JAX startup seeds from Python's
    # string hash, which differs from process to process, so every run
    # would start from other parameters
    jstart.random_seed = INIT_SEED
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    persist = [v.name for v in pstart.global_block().vars.values()
               if v.persistable]
    init = {n: np.array(jscope[n]) for n in persist}
    scope = fluid.Scope()
    for n, t in params_from_numpy(init, torch.device("cpu")).items():
        scope.set(n, t)
    exe = fluid.Executor(fluid.CPUPlace())
    cfg = bert.bert_tiny(SEQ)
    ids, labels = bert.synthetic_batch(cfg, 2, SEQ, seed=3)
    feed = {"input_ids": ids, "mlm_labels": labels}
    params = sorted(p.name for p in pmain.all_parameters())
    grads = [p + "@GRAD" for p in params]
    seen = {p: ([], []) for p in params}    # each step's gradient: port, JAX
    for step in range(STEPS):
        jout = jexe.run(jmain, feed=feed, fetch_list=[jio["loss"]] + grads,
                        scope=jscope)
        pout = exe.run(pmain, feed=feed, fetch_list=[pio["loss"]] + grads,
                       scope=scope)
        jl, pl = float(np.asarray(jout[0])), float(pout[0])
        assert np.isfinite(pl)
        assert abs(pl - jl) <= 1e-4 * abs(jl), (step, pl, jl)
        for name, a, w in zip(params, pout[1:], jout[1:]):
            w = np.asarray(w)
            assert a.shape == w.shape, name
            assert np.isfinite(a).all(), name
            bound = 1e-4 * float(np.abs(w).max())
            assert float(np.abs(a - w).max()) <= bound, (step, name)
            seen[name][0].append(a)
            seen[name][1].append(w)
    # the 5 steps' update itself, against the whole of the JAX update
    for n in params:
        a, w = scope[n].numpy(), np.asarray(jscope[n])
        moved, want = a - init[n], w - init[n]
        scale = float(np.abs(want).max())
        assert scale > 0, n                           # Adam moved it
        # the port's Adam on the port's gradients, every element
        own = _adam_update(seen[n][0])
        assert float(np.abs(moved - own).max()) <= 1e-3 * scale, n
        # Where a gradient stays near Adam's eps (a GELU unit off for the
        # whole batch), m/sqrt(v) passes the two packages' rounding
        # differences in the gradients (held to 1e-4 above) into the step
        # nearly undamped, so their updates differ by what their gradients
        # make them differ. Such elements are held to the line above; the
        # rest, nearly all, to the JAX update.
        held = np.abs(own - _adam_update(seen[n][1])) <= 1e-4 * scale
        if n.endswith("qkv.b"):
            # the key bias adds q·b_k to every score of a row, which softmax
            # cancels: its exact gradient is 0, so each package moves it by
            # its own rounding noise (Adam scales that up to ~1e-3 of lr)
            h = want.size // 3
            for upd in (moved[h:2 * h], want[h:2 * h]):
                assert float(np.abs(upd).max()) <= 1e-2 * scale, n
            moved, want, held = (np.concatenate([u[:h], u[2 * h:]])
                                 for u in (moved, want, held))
        assert held.mean() >= 0.99, (n, held.mean())
        assert float(np.abs(moved - want)[held].max()) <= 1e-3 * scale, n
