"""The ResNet and MNIST slice of the port against the JAX package, on the
CPU: Program parity, training from the same state, and saved models served
both ways.

- Program JSON: ``build_resnet_train`` at every depth of ``_DEPTH_CFG``
  with ``Momentum``, depth 50 also under ``decorate(use_bf16=True)`` (the
  bench's program: 104 casts, 161 momentum ops, 429 persistables holding
  51.2 M values), and both MNIST models with SGD, op for op and name for
  name, main and startup.
- Training (here the helpers and bf16 AMP; f32 in
  tests/test_torch_resnet_train.py): before every step the JAX package's
  scope (parameters, velocities, moving statistics) is copied by name into
  a port scope (``params_from_numpy``), both packages run the step, and
  the port is held to the JAX package (test_f32_training_matches_jax says
  how and why). Each step starts from the same state because two runs that start
  apart by f32 rounding drift apart within a few steps whatever the code
  does: from their random initialization these ResNets' steps are that
  sensitive (``JAX_PLATFORMS=cpu PYTHONPATH=. python
  tests/test_torch_resnet_train.py conditioning`` measures the JAX package
  against itself).
- bf16 AMP: each op of the decorated ResNet-18's forward on the JAX
  package's own values (one bfloat16 ulp), and a whole step against the
  undecorated f32 control (test_resnet18_bf16_amp_matches_jax).
- Every bound is at least 2x the worst of startup seeds 0-7, measured on
  the CPU by ``JAX_PLATFORMS=cpu PYTHONPATH=. python
  tests/test_torch_resnet_train.py sweep`` (each metric per seed).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid.contrib import mixed_precision as jmp
from paddle_tpu.fluid.inference import Predictor as JaxPredictor
from paddle_tpu.models import mnist as jmnist
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.ops.registry import LowerContext as JaxLowerContext
from paddle_tpu.ops.registry import get_lowering as jax_lowering_fn
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import lowering as pt_lowering
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from paddle_tpu_torch.fluid.contrib import mixed_precision as mp
from paddle_tpu_torch.fluid.inference import Predictor
from paddle_tpu_torch.fluid.io import params_from_numpy
from paddle_tpu_torch.models import mnist, resnet
from paddle_tpu_torch.ops.registry import LowerContext
from paddle_tpu_torch.ops.registry import get_lowering as pt_lowering_fn

SEED = 5                         # the JAX startup seed the tests run
LR = 1e-3                        # Momentum(LR, 0.9) in the training tests
SGD_LR = 1e-2                    # SGD(SGD_LR) in the MNIST tests
# bf16 AMP, re-synced steps
AMP_LOSS_RTOL = 1e-1
AMP_DIST = 0.6


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


# ---------------------------------------------------------------------------
# builders: the same calls in either package
# ---------------------------------------------------------------------------
def _resnet_io(depth, image, classes):
    def build(pkg):
        mod = jresnet if pkg is jfluid else resnet
        return mod.build_resnet_train(depth=depth, class_num=classes,
                                      image_size=image)
    return build


def _mnist_io(kind):
    def build(pkg):
        mod = jmnist if pkg is jfluid else mnist
        shape = [None, 784] if kind == "mlp" else [None, 1, 28, 28]
        img = pkg.data(name="img", shape=shape, dtype="float32")
        label = pkg.data(name="label", shape=[None, 1], dtype="int64")
        loss, acc, logits = getattr(mod, kind)(img, label)
        return {"loss": loss, "acc": acc, "logits": logits}
    return build


def _momentum(lr=LR):
    return lambda pkg: pkg.optimizer.Momentum(lr, 0.9)


def _sgd(lr=SGD_LR):
    return lambda pkg: pkg.optimizer.SGD(lr)


def _build(pkg, io_fn, opt_fn, amp=False):
    main, startup = pkg.Program(), pkg.Program()
    with pkg.program_guard(main, startup):
        io = io_fn(pkg)
        opt = opt_fn(pkg)
        if amp:
            opt = (jmp if pkg is jfluid else mp).decorate(opt, use_bf16=True)
        opt.minimize(io["loss"])
    return main, startup, io


def _json(program):
    return json.loads(program.to_json())


# ---------------------------------------------------------------------------
# Program parity
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("depth", sorted(resnet._DEPTH_CFG))
def test_resnet_program_parity(depth):
    io_fn = _resnet_io(depth, 224, 1000)
    jmain, jstart, _ = _build(jfluid, io_fn, _momentum(0.1))
    pmain, pstart, _ = _build(fluid, io_fn, _momentum(0.1))
    assert _json(pmain) == _json(jmain)
    assert _json(pstart) == _json(jstart)


def test_resnet50_bf16_momentum_program_is_the_benchs():
    """bench.py's program: ResNet-50, 1000 classes, 224x224, under
    decorate(Momentum(0.1, 0.9), use_bf16=True)."""
    io_fn = _resnet_io(50, 224, 1000)
    jmain, jstart, _ = _build(jfluid, io_fn, _momentum(0.1), amp=True)
    pmain, pstart, _ = _build(fluid, io_fn, _momentum(0.1), amp=True)
    assert _json(pmain) == _json(jmain)
    assert _json(pstart) == _json(jstart)
    ops = pmain.global_block().ops
    count = {}
    for op in ops:
        count[op.type] = count.get(op.type, 0) + 1
    assert count == {"conv2d": 53, "batch_norm": 53, "relu": 49,
                     "elementwise_add": 17, "pool2d": 2, "flatten2": 1,
                     "mul": 1, "softmax_with_cross_entropy": 1, "mean": 1,
                     "softmax": 1, "top_k": 1, "accuracy": 1, "cast": 104,
                     "momentum": 161, "backward": 1}
    start = {}
    for op in pstart.global_block().ops:
        start[op.type] = start.get(op.type, 0) + 1
    assert start == {"fill_constant": 375, "gaussian_random": 53,
                     "uniform_random": 1}
    persist = [v for v in pmain.global_block().vars.values()
               if v.persistable]
    assert len(persist) == 429
    assert sum(int(np.prod(v.shape)) for v in persist) == 51_167_185
    # batch_norm takes the bf16 conv output as it comes, and its f32
    # Scale, Bias, Mean and Variance through no cast
    forward = ops[:[op.type for op in ops].index("backward")]
    out_of = {n: op for op in forward for n in op.output_arg_names}
    for op in forward:
        if op.type != "batch_norm":
            continue
        assert out_of[op.input("X")[0]].type == "conv2d"
        for slot in ("Scale", "Bias", "Mean", "Variance"):
            name = op.input(slot)[0]
            assert name not in out_of or out_of[name] is op
            assert pmain.global_block().var(name).dtype == "float32"
        assert op.output("MeanOut") == op.input("Mean")


@pytest.mark.parametrize("kind", ["mlp", "conv_net"])
def test_mnist_program_parity(kind):
    jmain, jstart, _ = _build(jfluid, _mnist_io(kind), _sgd())
    pmain, pstart, _ = _build(fluid, _mnist_io(kind), _sgd())
    assert _json(pmain) == _json(jmain)
    assert _json(pstart) == _json(jstart)
    assert "sgd" in {op.type for op in pmain.global_block().ops}


# ---------------------------------------------------------------------------
# training from the same state
# ---------------------------------------------------------------------------
def _feed(batch, image, classes, seed=0):
    rng = np.random.default_rng(seed)
    if image == "mlp":
        return {"img": rng.standard_normal((batch, 784), dtype=np.float32),
                "label": rng.integers(0, 10, (batch, 1), dtype=np.int64)}
    if image == "conv_net":
        return {"img": rng.standard_normal((batch, 1, 28, 28),
                                           dtype=np.float32),
                "label": rng.integers(0, 10, (batch, 1), dtype=np.int64)}
    return {"image": rng.standard_normal((batch, 3, image, image),
                                         dtype=np.float32),
            "label": rng.integers(0, classes, (batch, 1), dtype=np.int64)}


def _port_scope(jscope, names):
    scope = fluid.Scope()
    for n, t in params_from_numpy({n: np.array(jscope[n]) for n in names},
                                  torch.device("cpu")).items():
        scope.set(n, t)
    return scope


def _rel(a, w):
    w = np.asarray(w, dtype=np.float64)
    return float(np.abs(np.asarray(a, np.float64) - w).max()) / max(
        float(np.abs(w).max()), 1e-30)


def _bf16_share(a):
    """Share of the nonzero f32 elements of `a` that a bfloat16 holds
    exactly: all of a gradient that came out of a bfloat16 product through
    a cast. Exact zeros say nothing (a 3x3 filter's off-centre taps over
    1x1 maps get none)."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    bits = bits[(bits & 0x7FFFFFFF) != 0]
    return float(((bits & 0xFFFF) == 0).mean()) if bits.size else 1.0


def _parity(io_fn, opt_fn, feed, steps, seed=SEED, amp=False):
    """`steps` steps of the JAX package from its startup values (seed
    `seed`); before each, a port scope re-synced to the JAX state runs the
    same step. Returns, worst over the steps: the loss error; the
    gradients' errors as the largest and the median over parameters of
    max|d|/max|grad|, and all gradients together, sqrt(sum d^2) /
    sqrt(sum grad^2) ("dist"); each moving statistic after the step,
    max|d|/max|stat|; and each parameter and velocity after the step
    against the update made of the port's own gradients from the same
    state ("update"). With ``amp`` the undecorated f32 program of the port
    also runs each step from the same state (the control): its gradients'
    distance and loss error, and the least share of bfloat16 values in the
    gradients of the weights read only through casts (port and JAX) and
    the largest in the control."""
    jmain, jstart, jio = _build(jfluid, io_fn, opt_fn, amp)
    pmain, _, pio = _build(fluid, io_fn, opt_fn, amp)
    if amp:
        pt_unique_name.switch()      # the control: the same var names
        fmain, _, fio = _build(fluid, io_fn, opt_fn)
    jstart.random_seed = seed
    jexe, exe = jfluid.Executor(jfluid.CPUPlace()), fluid.Executor(
        fluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    block = pmain.global_block()
    persist = [v.name for v in block.vars.values() if v.persistable]
    params = sorted(p.name for p in pmain.all_parameters() if p.trainable)
    stats = sorted(p.name for p in pmain.all_parameters()
                   if not p.trainable)
    grads = [p + "@GRAD" for p in params]
    ops = block.ops
    readers = {}
    for op in ops[:[op.type for op in ops].index("backward")]:
        for n in op.input_arg_names:
            readers.setdefault(n, set()).add(op.type)
    cast_only = {p + "@GRAD" for p in params if readers.get(p) == {"cast"}}
    lr = float(next(op.attr("value") for op in jstart.global_block().ops
                    if op.output("Out")[0].startswith("learning_rate")))
    res = dict(loss=(0.0, 0), grad=(0.0, ""), median=0.0, dist=0.0,
               stat=(0.0, ""), update=(0.0, ""), loss_f32=0.0, dist_f32=0.0,
               bf16={"port": 1.0, "jax": 1.0, "f32": 0.0})
    for step in range(steps):
        before = {n: np.array(jscope[n]) for n in persist}
        synced = _port_scope(jscope, persist)
        jout = jexe.run(jmain, feed=feed, fetch_list=[jio["loss"]] + grads,
                        scope=jscope)
        pout = exe.run(pmain, feed=feed, fetch_list=[pio["loss"]] + grads,
                       scope=synced)
        jl = float(np.asarray(jout[0]).astype(np.float32))
        assert np.isfinite(float(pout[0]))
        res["loss"] = max(res["loss"],
                          (abs(float(pout[0]) - jl) / abs(jl), step))
        jgrads = [np.asarray(w) for w in jout[1:]]
        rels = []
        for name, a, w in zip(grads, pout[1:], jgrads):
            assert a.shape == w.shape, name
            assert a.dtype == np.float32 and np.isfinite(a).all(), name
            rels.append(_rel(a, w))
            res["grad"] = max(res["grad"], (rels[-1], name))
            if name in cast_only:
                res["bf16"]["port"] = min(res["bf16"]["port"], _bf16_share(a))
                res["bf16"]["jax"] = min(res["bf16"]["jax"], _bf16_share(w))
        res["median"] = max(res["median"], float(np.median(rels)))
        res["dist"] = max(res["dist"], _dist(pout[1:], jgrads))
        for n in stats:
            res["stat"] = max(res["stat"], (_rel(synced[n].numpy(),
                                                 jscope[n]), n))
        # the update, from the same state and the port's own gradients
        for n, g in zip(params, pout[1:]):
            vel = n + "_velocity_0"
            if vel in before:
                v = np.float32(0.9) * before[vel] + g
                res["update"] = max(res["update"],
                                    (_rel(synced[vel].numpy(), v), vel))
                g = v
            want = before[n] - np.float32(lr) * g
            res["update"] = max(res["update"],
                                (_rel(synced[n].numpy(), want), n))
        if not amp:
            continue
        cout = exe.run(fmain, feed=feed, fetch_list=[fio["loss"]] + grads,
                       scope=_port_scope(jscope, persist))
        res["loss_f32"] = max(res["loss_f32"],
                              abs(float(cout[0]) - jl) / abs(jl))
        res["dist_f32"] = max(res["dist_f32"], _dist(cout[1:], jgrads))
        for name, c in zip(grads, cout[1:]):
            if name in cast_only:
                res["bf16"]["f32"] = max(res["bf16"]["f32"], _bf16_share(c))
    return res


def _dist(got, want):
    """All of `got` against all of `want`: sqrt(sum d^2) / sqrt(sum w^2)."""
    num = sum(float(((np.asarray(a, np.float64) - w) ** 2).sum())
              for a, w in zip(got, want))
    den = sum(float((np.asarray(w, np.float64) ** 2).sum()) for w in want)
    return float(np.sqrt(num / den))


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def test_resnet18_bf16_amp_forward_op_by_op():
    """Every op of the decorated ResNet-18's forward (casts, bf16 convs,
    batch norm on bf16 x with f32 statistics, relu, adds, pools, the fc,
    the loss, softmax, top_k, accuracy), given the values its inputs take
    in one step of the JAX package, gives what the JAX package's lowering
    of that op gives on the same inputs: float dtypes equal, bfloat16
    values within one bfloat16 ulp (a product or a normalization rounded
    from an f32 sum taken in another order) plus 1e-4·max (near zero, the
    f32 sum's own rounding error exceeds a bfloat16 ulp), f32 values
    within 1e-5·max, integers equal (the JAX package keeps int32 where the port
    has int64, ops/promotion.py). Each op runs alone on both sides: in
    the JAX package's compiled step XLA may skip a rounding to bfloat16
    where an f32 op reads it (its default, excess precision allowed), so
    the batch norms there read some conv outputs unrounded, which the
    port, running the program's casts as written, does not. End to end
    the two runs cannot agree in bfloat16: see
    test_resnet18_bf16_amp_matches_jax."""
    io_fn = _resnet_io(18, 32, 10)
    jmain, jstart, _ = _build(jfluid, io_fn, _momentum(), amp=True)
    pmain, _, _ = _build(fluid, io_fn, _momentum(), amp=True)
    jstart.random_seed = SEED
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jscope = jfluid.Scope()
    jexe.run(jstart, scope=jscope)
    block = pmain.global_block()
    ops = block.ops[:[op.type for op in block.ops].index("backward")]
    persist = {v.name for v in block.vars.values() if v.persistable}
    inputs = {n: np.array(jscope[n]) for n in persist}
    feed = _feed(4, 32, 10)
    made = sorted({n for op in ops for n in op.output_arg_names
                   if n not in persist})
    inputs.update(zip(made, jexe.run(jmain, feed=feed, fetch_list=made,
                                     scope=jscope)))
    inputs.update(feed)
    ctx = LowerContext(torch.device("cpu"), generator=torch.Generator())
    jctx = JaxLowerContext(rng=jax.random.PRNGKey(0), platform="cpu")
    checked = {}
    for op in ops:
        got = pt_lowering_fn(op.type)(ctx, {
            slot: [_to_torch(inputs[n]) for n in names]
            for slot, names in op.inputs.items()}, dict(op.attrs))
        want = jax_lowering_fn(op.type)(jctx, {
            slot: [jnp.asarray(inputs[n]) for n in names]
            for slot, names in op.inputs.items()}, dict(op.attrs))
        for slot, names in op.outputs.items():
            for n, t, w in zip(names, got.get(slot, []), want.get(slot, [])):
                what = (op.type, slot, n)
                w = np.asarray(w)
                assert tuple(t.shape) == w.shape, what
                if not t.is_floating_point():
                    np.testing.assert_array_equal(t.numpy(), w,
                                                  err_msg=str(what))
                    continue
                assert str(t.dtype)[6:] == w.dtype.name, (what, t.dtype,
                                                          w.dtype)
                a, w = t.detach().double().numpy(), w.astype(np.float64)
                if not w.size:
                    continue
                if t.dtype == torch.bfloat16:
                    ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                        np.abs(w), 2.0 ** -126))) - 7)
                    near0 = 1e-4 * np.abs(w).max()
                    assert (np.abs(a - w) <= ulp + near0).all(), what
                else:
                    assert float(np.abs(a - w).max()) <= 1e-5 * float(
                        np.abs(w).max()), what
        checked[op.type] = checked.get(op.type, 0) + 1
    assert checked["cast"] == 39 and checked["conv2d"] == 20
    assert checked["batch_norm"] == 20 and checked["accuracy"] == 1


def _amp_case():
    return (_resnet_io(18, 32, 10), _momentum(), _feed(16, 32, 10), 3)


def test_resnet18_bf16_amp_matches_jax():
    """ResNet-18 at 32x32, batch 16, in decorate(Momentum(1e-3, 0.9),
    use_bf16=True), 3 steps, each from the JAX state, with the
    undecorated f32 program from the same state as the control.

    Why the bounds are what they are: in bfloat16 the two packages round
    some conv outputs to neighbouring values (their f32 sums are taken in
    other orders, and XLA skips some roundings, see
    test_resnet18_bf16_amp_forward_op_by_op), and ResNet's batch norms
    carry each such flip into more flips layer by layer. Over startup
    seeds 0-7 (``python tests/test_torch_resnet_train.py sweep amp``, CPU) the
    port's AMP gradients lie 0.39-0.43 (all together, relative) from the
    JAX package's and the f32 control's 1.00, its losses within 4.5e-2
    (the losses fall to a few hundredths in 3 steps), and no per-parameter
    bound or share of elements more than an ulp off (which tells AMP from
    f32 for BERT, tests/test_torch_amp.py) tells them apart here. So the
    test holds: the losses within AMP_LOSS_RTOL; all gradients together
    within AMP_DIST of the JAX package's, a bound between the sound runs'
    worst (0.43) and the f32 control's reading (1.00), which must fail it
    (an all-zero gradient reads 1.0, a negated one 2.0); the bf16
    signature (the gradients of the weights read only through casts are
    bfloat16 values in the port, and next to none of
    their nonzero elements are in the control; the JAX package's are not,
    XLA having kept them in f32); and every parameter and velocity after
    the step equal (1e-6) to the momentum step of the port's own
    gradients. Each op of the forward is held to one ulp by
    test_resnet18_bf16_amp_forward_op_by_op."""
    res = _parity(*_amp_case(), amp=True)
    assert res["loss"][0] <= AMP_LOSS_RTOL, res["loss"]
    assert res["dist"] <= AMP_DIST < res["dist_f32"], res
    assert res["bf16"]["port"] == 1.0, res["bf16"]
    assert res["bf16"]["f32"] < 0.1, res["bf16"]
    assert res["update"][0] <= 1e-6, res["update"]


# ---------------------------------------------------------------------------
# saved models, both ways
# ---------------------------------------------------------------------------
def _save(pkg, dirname, seed):
    """ResNet-18 (32x32, 10 classes) initialised from `seed`, its moving
    statistics set away from (0, 1) so that is_test matters, saved pruned
    to the logits."""
    main, startup, io = _build(pkg, _resnet_io(18, 32, 10), _momentum())
    startup.random_seed = seed
    exe = pkg.Executor(pkg.CPUPlace())
    scope = pkg.Scope()
    exe.run(startup, scope=scope)
    rng = np.random.default_rng(seed)
    for p in main.all_parameters():
        if not p.trainable:
            v = rng.uniform(0.5, 1.5, p.shape) if p.name.endswith(".var") \
                else rng.normal(0, 0.1, p.shape)
            value = v.astype(np.float32)
            scope.set(p.name, value if pkg is jfluid
                      else torch.from_numpy(value))
    with pkg.scope_guard(scope):
        pkg.io.save_inference_model(dirname, ["image"], [io["logits"]], exe,
                                    main_program=main)


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_saved_resnet_served_both_ways(tmp_path, saved_by):
    """A ResNet saved by one package is served by the other through
    Predictor.from_model: the same logits (f32, 1e-4·max|logit|), every
    batch_norm op of the loaded program in is_test mode (the moving
    statistics normalize), and the moving statistics among the saved
    parameters."""
    _save(jfluid if saved_by == "jax" else fluid, str(tmp_path), seed=3)
    image = _feed(3, 32, 10, seed=4)["image"]
    pred = Predictor.from_model(str(tmp_path), place=fluid.CPUPlace())
    got, = pred.run({"image": image})
    want, = JaxPredictor.from_model(str(tmp_path)).run({"image": image})
    want = np.asarray(want)
    assert got.shape == want.shape == (3, 10) and got.dtype == np.float32
    assert float(np.abs(got - want).max()) <= 1e-4 * float(
        np.abs(want).max())
    bns = [op for op in pred.program.global_block().ops
           if op.type == "batch_norm"]
    assert len(bns) == 20 and all(op.attr("is_test") for op in bns)
    saved = np.load(str(tmp_path / "__params__.npz"))
    assert {"stem.bn.mean", "stem.bn.var"} <= set(saved.files)
    # the moving statistics, not the batch's, normalize: one request alone
    # gives its row of the batch
    one, = pred.run({"image": image[1:2]})
    assert float(np.abs(one[0] - got[1]).max()) <= 1e-5 * float(
        np.abs(got).max())


# ---------------------------------------------------------------------------
# the run's precision switches
# ---------------------------------------------------------------------------
def _conv_tf32():
    """Whether cuDNN may run an f32 convolution in TF32, by the switch
    f32_precision sets."""
    ns, attr, _ = pt_lowering.precision_switches()[3]
    return getattr(ns, attr) != "ieee"


def test_run_on_the_card_turns_cudnn_tf32_off_and_restores_it():
    """f32_precision (the context every run on the card enters) turns
    cuDNN's TF32 convolutions off, with torch's default (allow_tf32 True)
    or a caller's own setting before it, and gives the caller's setting
    back when the last concurrent run leaves. The matmul switches come
    back as well."""
    cudnn = torch.backends.cudnn
    switches = pt_lowering.precision_switches()
    before = [getattr(ns, attr) for ns, attr, _ in switches]
    try:
        cudnn.allow_tf32 = True          # torch's default
        assert _conv_tf32()
        with pt_lowering.f32_precision():
            assert not _conv_tf32()
            with pt_lowering.f32_precision():
                assert not _conv_tf32()
            assert not _conv_tf32()      # an inner run leaving keeps it
        assert _conv_tf32() and cudnn.allow_tf32
        cudnn.allow_tf32 = False
        with pt_lowering.f32_precision():
            assert not _conv_tf32()
        assert not cudnn.allow_tf32
        assert [getattr(ns, attr) for ns, attr, _ in switches] \
            == [getattr(ns, attr) for ns, attr, _ in
                pt_lowering.precision_switches()]
    finally:
        for (ns, attr, _), value in zip(switches, before):
            setattr(ns, attr, value)
    names = [attr for _, attr, _ in switches]
    assert names[:2] == ["allow_bf16_reduced_precision_reduction",
                         "allow_fp16_reduced_precision_reduction"]
