"""fluid.contrib.slim's Compressor, GraphWrapper, pruning, distillation
and searcher in the port, against the JAX package, on the CPU.

- GraphWrapper's queries (parameters, producers and consumers, the
  parameters of each op), ``flops`` and ``numel_params`` equal the JAX
  package's on ResNet-18, ResNet-50 and BERT at depth 2; the optimize
  graph's Program JSON too.
- The pruner picks the JAX package's groups from the same values (numpy
  or a tensor), ties and groups that are zero already included, and
  gives the same pruned parameters; ``prune_program`` zeroes a tensor's
  groups in place (the same tensor object and storage). The masks hold after every batch of
  a Momentum run, each re-assert writes into the tensor the scope holds,
  and no batch copies a pruned parameter to the host.
- The yaml prune + quant Compressor and the distillation Compressor,
  from the JAX package's initial parameters: the same Program JSON,
  losses within 1e-5 relative, parameters within 1e-5 of the largest.
- A Compressor checkpoint resumes to the same epoch, eval results and
  persistables in both packages. The prune masks do not survive a resume
  in either: the resumed strategy holds no mask, and the next epoch's
  updates move the pruned groups again (ROADMAP.md Queue 3).
- The teacher in one program with its student: every teacher parameter
  is a backward target with an update op in both packages, its
  gradient is 0 (the teacher's output stops the gradient), so Adam
  leaves it bit for bit as it was, while the teacher's batch norm runs
  in training mode and its moving statistics move (ROADMAP.md Queue 3).
- SAController gives the same tokens and rewards under one seed.
- The JAX package's own slim tests (tests/test_slim_framework.py's
  graph, compressor, distillation and SA cases, tests/test_slim.py's
  prune and distillation cases) run on the port: each module is loaded
  afresh with its ``fluid`` and the names it imported from the JAX
  package bound to the port's (``on_port``), the modules its tests
  import in their bodies patched to the port's for the call
  (``port_contrib``), and an entry point without a place on the CPU.
"""
import importlib
import json
import random
import sys
import types

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.fluid import executor as jax_executor
from paddle_tpu.fluid import framework as jax_framework
from paddle_tpu.fluid import unique_name as jax_unique_name
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.fluid import core as pt_core
from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from test_torch_rcnn import reference_tests

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_state():
    """Fresh default programs (random seed 5), name generators and scopes
    of both packages."""
    old = (pt_framework.switch_main_program(pt_framework.Program()),
           pt_framework.switch_startup_program(pt_framework.Program()),
           pt_unique_name.switch(), pt_executor._scope_stack[:],
           jax_framework.switch_main_program(jax_framework.Program()),
           jax_framework.switch_startup_program(jax_framework.Program()),
           jax_unique_name.switch(), jax_executor._scope_stack[:])
    pt_executor._scope_stack[:] = [pt_executor.Scope()]
    jax_executor._scope_stack[:] = [jax_executor.Scope()]
    for fw in (pt_framework, jax_framework):
        fw.default_main_program().random_seed = 5
        fw.default_startup_program().random_seed = 5
    yield
    pt_framework.switch_main_program(old[0])
    pt_framework.switch_startup_program(old[1])
    pt_unique_name.switch(old[2])
    pt_executor._scope_stack[:] = old[3]
    jax_framework.switch_main_program(old[4])
    jax_framework.switch_startup_program(old[5])
    jax_unique_name.switch(old[6])
    jax_executor._scope_stack[:] = old[7]


# ---------------------------------------------------------------------------
# shared helpers (the other test_torch_* files of this slice import them)
# ---------------------------------------------------------------------------
def port_twin(value):
    """The port's counterpart of a JAX-package module, class or function,
    else None."""
    if isinstance(value, types.ModuleType):
        name = value.__name__
        if name.startswith("paddle_tpu."):
            return importlib.import_module(
                "paddle_tpu_torch." + name[len("paddle_tpu."):])
        return None
    mod = getattr(value, "__module__", None)
    if isinstance(mod, str) and mod.startswith("paddle_tpu.") and hasattr(
            value, "__name__"):
        return getattr(importlib.import_module(
            "paddle_tpu_torch." + mod[len("paddle_tpu."):]), value.__name__)
    return None


def on_port(name):
    """tests/<name>.py loaded afresh, its fluid and every name it imported
    from the JAX package bound to the port's."""
    mod = reference_tests(name)
    for key, value in list(vars(mod).items()):
        twin = port_twin(value)
        if twin is not None:
            setattr(mod, key, twin)
    return mod


PORT_MODULES = ("contrib", "contrib.slim", "contrib.slim.core",
                "contrib.slim.graph", "contrib.slim.prune",
                "contrib.slim.distillation", "contrib.slim.searcher",
                "contrib.slim.nas", "contrib.slim.quantization",
                "contrib.quantize", "contrib.quant")


@pytest.fixture
def port_contrib(monkeypatch):
    """For the call: the contrib modules the reference tests import in
    their bodies are the port's, the JAX package's global_scope is the
    port's, and an entry point given no place runs on the CPU."""
    for m in PORT_MODULES:
        monkeypatch.setitem(
            sys.modules, "paddle_tpu.fluid." + m,
            importlib.import_module("paddle_tpu_torch.fluid." + m))
    monkeypatch.setattr(jax_executor, "global_scope",
                        pt_executor.global_scope)
    monkeypatch.setattr(pt_core, "default_place", lambda: pt_core.CPUPlace())


def run_reference_test(mod, test, tmp_path, monkeypatch):
    fn = getattr(mod, test)
    names = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    args = {"tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(*[args[n] for n in names])


def pjson(prog):
    return json.loads(prog.to_json())


def host(value):
    if isinstance(value, torch.Tensor):
        return pt_executor.to_numpy(value)
    return np.array(value)


def copy_scope(jscope, pscope, names=None, tensors=False):
    """The JAX scope's values (all, or `names`; a scope or a dict) set in
    the port's scope, as host arrays or CPU tensors."""
    for n in (names if names is not None else list(jscope.keys())):
        v = np.array(jscope[n])
        pscope.set(n, torch.from_numpy(v) if tensors else v)


def assert_scopes_close(pscope, jscope, names, tol=TOL):
    for n in names:
        want = np.asarray(jscope[n])
        got = host(pscope[n])
        assert got.shape == want.shape, n
        np.testing.assert_allclose(
            got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30),
            err_msg=n)


_RUN = {jfluid: jfluid.Executor.run, fluid: fluid.Executor.run}


def record_losses(monkeypatch, fl, loss_names):
    """Every fetched value of `loss_names` (first fetch) that `fl`'s
    Executor.run returns, in order, from now on."""
    log = []
    orig = _RUN[fl]

    def run(self, program=None, feed=None, fetch_list=None, *a, **k):
        out = orig(self, program, feed, fetch_list, *a, **k)
        first = [getattr(f, "name", f) for f in (fetch_list or [])][:1]
        if first and first[0] in loss_names:
            log.append(float(np.mean(np.asarray(out[0]))))
        return out

    monkeypatch.setattr(fl.Executor, "run", run)
    return log


def assert_losses_close(got, want):
    assert len(got) == len(want) and got
    np.testing.assert_allclose(got, want, rtol=TOL, atol=0)


# ---------------------------------------------------------------------------
# GraphWrapper
# ---------------------------------------------------------------------------
def _resnet(fl, depth):
    from paddle_tpu.models import resnet as jres
    from paddle_tpu_torch.models import resnet as pres

    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        vs = (jres if fl is jfluid else pres).build_resnet_train(
            depth=depth, class_num=10, image_size=32)
    return main, [("image", "image"), ("label", "label")], [
        ("loss", vs["loss"].name), ("acc", vs["acc"].name)]


def _bert(fl):
    from paddle_tpu.models import bert as jbert
    from paddle_tpu_torch.models import bert as pbert

    b = jbert if fl is jfluid else pbert
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        vs = b.build_bert_pretrain(b.BertConfig(
            vocab_size=500, hidden=64, num_layers=2, heads=2, ffn=128,
            max_seq=32), 32)
    return main, [("input_ids", "input_ids"),
                  ("mlm_labels", "mlm_labels")], [("loss", vs["loss"].name)]


GRAPHS = {"resnet18": lambda fl: _resnet(fl, 18),
          "resnet50": lambda fl: _resnet(fl, 50), "bert_depth2": _bert}


def _queries(fl, build, deep):
    main, ins, outs = build(fl)
    g = fl.contrib.slim.GraphWrapper(main, in_nodes=ins, out_nodes=outs)
    ops = g.ops()
    q = {"params": [p.name() for p in g.all_parameters()],
         "shapes": [tuple(p.shape()) for p in g.all_parameters()],
         "numel": g.numel_params(), "flops": g.flops(),
         "conv_flops": g.flops(only_conv=True),
         "ops": [(o.idx(), o.type(), o.is_bwd_op(), o.is_opt_op())
                 for o in ops],
         "persistables": sorted(g.persistables),
         "param_by_op": [[v.name() for v in g.get_param_by_op(o)]
                         for o in ops]}
    if deep:
        q["pre"] = [[p.idx() for p in g.pre_ops(o)] for o in ops]
        q["next"] = [[p.idx() for p in g.next_ops(o)] for o in ops]
        q["producers"] = {v.name(): [o.idx() for o in v.inputs()]
                          for v in g.vars()[:40]}
        q["consumers"] = {v.name(): [o.idx() for o in v.outputs()]
                          for v in g.vars()[:40]}
    opt = g.get_optimize_graph(fl.optimizer.Momentum(0.1, 0.9),
                               fl.CPUPlace(), fl.Scope())
    q["optimize_json"] = pjson(opt.program)
    q["optimize_ops"] = [(o.type(), o.is_bwd_op(), o.is_opt_op())
                         for o in opt.ops()]
    c = g.clone(for_test=True)
    q["clone_json"] = pjson(c.program)
    assert c.program is not main and c.in_nodes == g.in_nodes
    return q


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_graph_wrapper_queries_match_the_jax_package(graph):
    deep = graph != "resnet50"
    got = _queries(fluid, GRAPHS[graph], deep)
    want = _queries(jfluid, GRAPHS[graph], deep)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    assert got["flops"] > 0 and got["numel"] > 0


def test_graph_wrapper_unported_paths_raise_naming_their_items():
    main, ins, outs = _resnet(fluid, 18)
    g = fluid.contrib.slim.GraphWrapper(main, ins, outs)
    with pytest.raises(NotImplementedError, match="item 11"):
        g.infer_shape()
    # compile() wraps the program in a CompiledProgram (item 8.1 brought
    # it), as the JAX package's does
    assert isinstance(g.compile(), fluid.CompiledProgram)
    assert g.compile()._program is main
    assert g.compile(for_parallel=False) is main
    assert pjson(g.compile(for_parallel=False, for_test=True)) == pjson(
        main.clone(for_test=True))
    # merge appends the other graph's ops and shares vars by name
    other = fluid.contrib.slim.GraphWrapper(main.clone())
    n = len(g.ops())
    g.merge(other)
    assert len(g.ops()) == 2 * n


# ---------------------------------------------------------------------------
# the pruner
# ---------------------------------------------------------------------------
def _prune_values():
    rng = np.random.default_rng(7)
    ties = np.repeat(np.array([[1.0], [2.0], [1.0], [0.5], [1.0], [2.0]],
                              np.float32), 3, axis=1)
    zeros = rng.standard_normal((8, 5)).astype(np.float32)
    zeros[[1, 6]] = 0
    conv = rng.standard_normal((10, 3, 3, 3)).astype(np.float32)
    conv[4] = 0
    return {"random": (rng.standard_normal((9, 4)).astype(np.float32), 0),
            "ties": (ties, 0), "already_zero": (zeros, 0),
            "axis1": (rng.standard_normal((4, 7)).astype(np.float32), 1),
            "conv": (conv, 0)}


@pytest.mark.parametrize("case", sorted(_prune_values()))
@pytest.mark.parametrize("ratio", [0.25, 0.5])
def test_pruner_picks_the_jax_package_s_groups(case, ratio):
    from paddle_tpu.fluid.contrib.slim.prune import StructurePruner as J
    from paddle_tpu_torch.fluid.contrib.slim.prune import StructurePruner

    w, axis = _prune_values()[case]
    jp, pp = J(pruning_axis={"*": axis}), StructurePruner(
        pruning_axis={"*": axis})
    want = jp.cal_pruned_idx("w", w, ratio)
    for value in (w, torch.from_numpy(w.copy())):
        got = pp.cal_pruned_idx("w", value, ratio)
        np.testing.assert_array_equal(got, want)
    for lazy in (True, False):
        np.testing.assert_array_equal(
            pp.prune_tensor(w, want, axis, lazy=lazy),
            jp.prune_tensor(w, want, axis, lazy=lazy))


def _fc_net(fl, with_opt=True):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 3
    with fl.program_guard(main, startup), fl.unique_name.guard():
        x = fl.data("sx", (None, 8), "float32")
        y = fl.data("sy", (None, 1), "float32")
        h = fl.layers.fc(x, 16, act="relu",
                         param_attr=fl.ParamAttr(name="fc_w1"))
        h = fl.layers.fc(h, 12, act="relu",
                         param_attr=fl.ParamAttr(name="fc_w2"))
        loss = fl.layers.reduce_mean(fl.layers.square_error_cost(
            fl.layers.fc(h, 1), y))
        if with_opt:
            fl.optimizer.Momentum(0.05, 0.9).minimize(loss)
    return main, startup, loss


def test_prune_program_zeroes_the_scope_tensor_in_place():
    from paddle_tpu.fluid.contrib.slim.prune import prune_program as jprune
    from paddle_tpu_torch.fluid.contrib.slim.prune import prune_program

    jm, js, _ = _fc_net(jfluid, False)
    pm, ps, _ = _fc_net(fluid, False)
    jfluid.Executor(jfluid.CPUPlace()).run(js)
    jscope, pscope = jfluid.global_scope(), fluid.global_scope()
    copy_scope(jscope, pscope, tensors=True)
    w2 = np.array(jscope["fc_w2"])
    w2[:, 0] = 0
    jscope.set("fc_w2", w2)
    pscope.set("fc_w2", torch.from_numpy(w2.copy()))
    before = {n: (pscope[n], pscope[n].data_ptr()) for n in ("fc_w1",
                                                             "fc_w2")}
    for axis in (0, 1):
        pruner = fluid.contrib.slim.prune.StructurePruner(
            pruning_axis={"*": axis})
        jpruner = jfluid.contrib.slim.prune.StructurePruner(
            pruning_axis={"*": axis})
        got = prune_program(pm, 0.25, patterns=["fc_w*"], pruner=pruner)
        want = jprune(jm, 0.25, patterns=["fc_w*"], pruner=jpruner)
        assert got == want
    for n, (t, ptr) in before.items():
        assert pscope[n] is t and t.data_ptr() == ptr
        np.testing.assert_array_equal(t.numpy(), np.asarray(jscope[n]))


class _Probe(fluid.contrib.slim.Strategy):
    """Records, after every batch, the pruned parameters' tensor objects
    and storage (before the prune strategy's re-assert when `first`, after
    it otherwise)."""

    def __init__(self, names, log, end_epoch):
        super().__init__(0, end_epoch)
        self.names, self.log = names, log

    def on_batch_end(self, context):
        self.log.append({n: (context.scope[n], context.scope[n].data_ptr())
                         for n in self.names})


def test_masks_hold_on_the_device_in_place_after_every_batch(monkeypatch):
    """UniformPruneStrategy inside a Compressor with Momentum: after each
    batch's re-assert the pruned groups are zero, in the tensor object the
    run left in the scope (its storage unchanged), and no batch reads a
    pruned parameter back to the host; the values track the JAX
    package's."""
    from paddle_tpu_torch.fluid.contrib.slim.prune import (
        prune_strategy, pruner)

    rng = np.random.default_rng(0)
    xs = rng.standard_normal((64, 8)).astype(np.float32)
    ys = rng.standard_normal((64, 1)).astype(np.float32)

    def reader():
        for i in range(0, 64, 16):
            yield [(xs[j], ys[j]) for j in range(i, i + 16)]

    ctxs, logs = {}, {}
    for fl in (jfluid, fluid):
        main, startup, loss = _fc_net(fl, False)
        exe = fl.Executor(fl.CPUPlace())
        if fl is jfluid:
            exe.run(startup)
            init = {n: np.array(v) for n, v in fl.global_scope().items()}
        else:
            copy_scope(init, fluid.global_scope(), tensors=True)
        comp = fl.contrib.slim.Compressor(
            place=fl.CPUPlace(), scope=fl.global_scope(), train_program=main,
            train_reader=reader,
            train_feed_list=[("sx", "sx"), ("sy", "sy")],
            train_fetch_list=[("loss", loss.name)],
            train_optimizer=fl.optimizer.Momentum(0.05, 0.9), log_period=4)
        strat = fl.contrib.slim.prune.UniformPruneStrategy(
            pruner=fl.contrib.slim.prune.StructurePruner(), start_epoch=0,
            end_epoch=1, target_ratio=0.25, pruned_params="fc_w*")
        if fl is fluid:
            logs["pre"], logs["post"] = [], []
            comp._add_strategy(_Probe(["fc_w1", "fc_w2"], logs["pre"], 1))
            comp._add_strategy(strat)
            comp._add_strategy(_Probe(["fc_w1", "fc_w2"], logs["post"], 1))
            reads = []
            orig = prune_strategy.as_host

            def counted(v):
                if isinstance(v, torch.Tensor):
                    reads.append(v.shape)
                return orig(v)

            monkeypatch.setattr(prune_strategy, "as_host", counted)
            monkeypatch.setattr(pruner, "as_host", counted)
        else:
            comp._add_strategy(strat)
        comp.epoch = 2
        ctxs[fl] = (comp.run(), strat)
    # one read a pruned parameter at the prune event (the pruner's group
    # choice and the mask), none in the 8 batches
    assert len(reads) == 4
    assert len(logs["pre"]) == len(logs["post"]) == 8
    for pre, post in zip(logs["pre"], logs["post"]):
        for n in ("fc_w1", "fc_w2"):
            assert pre[n][0] is post[n][0] and pre[n][1] == post[n][1]
            mask, axis = ctxs[fluid][1]._masks[n]
            assert post[n][0].numpy()[mask].sum() == 0 and mask.sum() > 0
    (pctx, pstrat), (jctx, jstrat) = ctxs[fluid], ctxs[jfluid]
    for n in ("fc_w1", "fc_w2"):
        np.testing.assert_array_equal(pstrat._masks[n][0],
                                      jstrat._masks[n][0])
        assert pstrat._masks[n][1] == jstrat._masks[n][1]
    assert pstrat.sparsity(pctx) == jstrat.sparsity(jctx)
    assert_scopes_close(fluid.global_scope(), jfluid.global_scope(),
                        ["fc_w1", "fc_w2", "fc_0.w_0"])


def test_sensitive_prune_restores_each_probe_on_its_device(monkeypatch):
    """SensitivePruneStrategy probes each parameter and puts it back from
    a clone on its device: the same ratios and masks as the JAX
    package's, and the unpruned values untouched by the probes."""
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((32, 8)).astype(np.float32)
    ys = rng.standard_normal((32, 1)).astype(np.float32)

    def reader():
        yield [(xs[j], ys[j]) for j in range(32)]

    out = {}
    for fl in (jfluid, fluid):
        main, startup, loss = _fc_net(fl, False)
        if fl is jfluid:
            fl.Executor(fl.CPUPlace()).run(startup)
        else:
            copy_scope(jfluid.global_scope(), fluid.global_scope(),
                       tensors=True)
        ctx = fl.contrib.slim.Context(
            fl.CPUPlace(), fl.global_scope(),
            train_graph=fl.contrib.slim.GraphWrapper(main),
            eval_graph=fl.contrib.slim.GraphWrapper(
                main.clone(for_test=True), [("sx", "sx"), ("sy", "sy")],
                [("loss", loss.name)]), eval_reader=reader)
        ctx.optimize_graph = ctx.train_graph
        s = fl.contrib.slim.prune.SensitivePruneStrategy(
            start_epoch=0, target_ratio=0.4, pruned_params="fc_w*")
        s.on_epoch_begin(ctx)
        out[fl] = {n: (m.copy(), a) for n, (m, a) in s._masks.items()}
    assert out[fluid].keys() == out[jfluid].keys()
    for n in out[fluid]:
        np.testing.assert_array_equal(out[fluid][n][0], out[jfluid][n][0])
    assert_scopes_close(fluid.global_scope(), jfluid.global_scope(),
                        ["fc_w1", "fc_w2"], tol=1e-7)


# ---------------------------------------------------------------------------
# the Compressor: yaml prune + quant, distillation, checkpoints
# ---------------------------------------------------------------------------
V_IN, HID, NCLS = 12, 24, 4

PRUNE_QUANT_YAML = """
version: 1.0
pruners:
  pruner_1:
    class: StructurePruner
    pruning_axis:
      '*': 0
    criterions:
      '*': l1_norm
strategies:
  prune_strategy:
    class: UniformPruneStrategy
    pruner: pruner_1
    start_epoch: 0
    end_epoch: 2
    target_ratio: 0.25
    pruned_params: 'fc_*.w_0'
  quant_strategy:
    class: QuantizationStrategy
    start_epoch: 1
    end_epoch: 2
    weight_bits: 8
    activation_bits: 8
    int8_model_save_path: %s
compressor:
  epoch: %d
  eval_epoch: 1
  %s
  strategies:
%s
"""


def _mlp(fl):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 5
    with fl.program_guard(main, startup), fl.unique_name.guard():
        x = fl.data("qx", shape=[None, V_IN], dtype="float32")
        y = fl.data("qy", shape=[None, 1], dtype="int64")
        h = fl.layers.fc(x, HID, act="relu")
        logits = fl.layers.fc(h, NCLS)
        loss = fl.layers.mean(
            fl.layers.softmax_with_cross_entropy(logits, y))
        acc = fl.layers.accuracy(fl.layers.softmax(logits), y)
    return main, startup, loss, acc


def _mlp_reader():
    rng = np.random.default_rng(2)
    xs = rng.standard_normal((128, V_IN)).astype("float32")
    ys = np.argmax(xs[:, :NCLS], axis=1).astype("int64")[:, None]

    def reader():
        for i in range(0, 128, 32):
            yield [(xs[j], ys[j]) for j in range(i, i + 32)]
    return reader


def _prune_quant_run(fl, tmp_path, epochs, monkeypatch, ckpt=None,
                     init=None, quant=True):
    """The yaml prune (+ quant) Compressor over the MLP in `fl`, from
    `init` when given (the JAX package's startup values). Returns the
    context, the Compressor, the losses and the values it started from."""
    tag = "jax" if fl is jfluid else "port"
    cfg = tmp_path / ("compress_%s_%d.yaml" % (tag, epochs))
    cfg.write_text(PRUNE_QUANT_YAML % (
        tmp_path / ("int8_" + tag), epochs,
        ("checkpoint_path: %s" % ckpt) if ckpt else "",
        "    - prune_strategy" + ("\n    - quant_strategy" if quant else "")))
    main, startup, loss, acc = _mlp(fl)
    exe = fl.Executor(fl.CPUPlace())
    exe.run(startup)
    if init is not None:
        copy_scope(init, fl.global_scope())
    start = {n: host(v) for n, v in fl.global_scope().items()}
    losses = record_losses(monkeypatch, fl, [loss.name])
    reader = _mlp_reader()
    comp = fl.contrib.slim.Compressor(
        place=fl.CPUPlace(), scope=fl.global_scope(), train_program=main,
        train_reader=reader, train_feed_list=[("image", "qx"),
                                              ("label", "qy")],
        train_fetch_list=[("loss", loss.name)],
        eval_program=main.clone(for_test=True), eval_reader=reader,
        eval_feed_list=[("image", "qx"), ("label", "qy")],
        eval_fetch_list=[("acc", acc.name)],
        train_optimizer=fl.optimizer.Adam(5e-3), log_period=4)
    comp.config(str(cfg))
    ctx = comp.run()
    return ctx, comp, losses, start


def _scales(prog):
    """The quantized ops' act_scale and weight_scale attrs, taken out of
    `prog`: float states of the trained values, which the two packages'
    sums round differently."""
    out = []
    for op in prog.global_block().ops:
        for k in ("act_scale", "weight_scale"):
            if k in op.attrs:
                out.extend(np.ravel(op.attrs.pop(k)).tolist())
    return out


def test_yaml_prune_and_quant_compressor_matches_the_jax_package(
        tmp_path, monkeypatch):
    jctx, jcomp, jl, init = _prune_quant_run(jfluid, tmp_path, 3,
                                             monkeypatch)
    pctx, pcomp, pl, _ = _prune_quant_run(fluid, tmp_path, 3, monkeypatch,
                                          init=init)
    assert pjson(pctx.optimize_graph.program) == pjson(
        jctx.optimize_graph.program)
    assert pjson(pctx.eval_graph.program) == pjson(jctx.eval_graph.program)
    pscales = _scales(pctx.get("int8_program"))
    jscales = _scales(jctx.get("int8_program"))
    assert pjson(pctx.get("int8_program")) == pjson(jctx.get("int8_program"))
    assert len(pscales) == len(jscales) > 0
    np.testing.assert_allclose(pscales, jscales, rtol=TOL)
    assert_losses_close(pl, jl)
    np.testing.assert_allclose(pctx.eval_results["acc"],
                               jctx.eval_results["acc"], rtol=TOL)
    assert_scopes_close(fluid.global_scope(), jfluid.global_scope(),
                        list(jfluid.global_scope().keys()))
    for fl in (fluid, jfluid):
        w = host(fl.global_scope()["fc_0.w_0"])
        assert int((np.abs(w).sum(axis=1) == 0).sum()) == round(V_IN * 0.25)
        prog, _, _ = fl.io.load_inference_model(
            str(tmp_path / ("int8_" + ("jax" if fl is jfluid else "port"))),
            fl.Executor(fl.CPUPlace()))
        assert "quantized_mul" in [op.type for op in
                                   prog.global_block().ops]


def test_compressor_checkpoint_resumes_like_the_jax_package(
        tmp_path, monkeypatch):
    """Two epochs of the yaml prune Compressor with a checkpoint_path,
    then a new Compressor of three epochs over the same path: it resumes
    at epoch 2 with the saved eval results and persistables, in both
    packages alike. The resumed UniformPruneStrategy holds no mask (it
    prunes only at its start_epoch), so epoch 2's updates move the pruned
    rows again in both."""
    out, init = {}, None
    for fl in (jfluid, fluid):
        ckpt = tmp_path / ("ckpt_" + ("jax" if fl is jfluid else "port"))
        with fl.scope_guard(fl.Scope()):
            ctx2, _, l2, start = _prune_quant_run(
                fl, tmp_path, 2, monkeypatch, ckpt=ckpt, init=init,
                quant=False)
            init = start
            saved = {n: host(v) for n, v in fl.global_scope().items()}
        with fl.scope_guard(fl.Scope()):
            ctx3, comp3, l3, _ = _prune_quant_run(
                fl, tmp_path, 3, monkeypatch, ckpt=ckpt, init=init,
                quant=False)
            out[fl] = dict(
                epoch=ctx3.epoch_id, evals=ctx3.eval_results,
                evals2=ctx2.eval_results, masks=dict(comp3.strategies[0]
                                                     ._masks),
                saved=saved, losses2=list(l2), losses3=list(l3),
                scope={n: host(v) for n, v in fl.global_scope().items()},
                dirs=sorted(p.name for p in ckpt.iterdir()))
    j, p = out[jfluid], out[fluid]
    assert p["epoch"] == j["epoch"] == 2
    assert p["dirs"] == j["dirs"] == ["0", "1", "2"]
    assert len(j["evals"]["acc"]) == 3
    assert j["evals"]["acc"][:2] == j["evals2"]["acc"]
    np.testing.assert_allclose(p["evals"]["acc"], j["evals"]["acc"],
                               rtol=TOL)
    assert p["masks"] == j["masks"] == {}
    assert len(j["losses3"]) == 4          # one epoch of 4 batches
    assert_losses_close(p["losses2"], j["losses2"])
    assert_losses_close(p["losses3"], j["losses3"])
    for n in j["saved"]:
        np.testing.assert_array_equal(p["saved"][n].shape,
                                      j["saved"][n].shape)
    for n in j["scope"]:
        np.testing.assert_allclose(
            p["scope"][n], j["scope"][n], rtol=0,
            atol=TOL * max(np.abs(j["scope"][n]).max(), 1e-30), err_msg=n)
    for d in (j, p):
        pruned = np.abs(d["saved"]["fc_0.w_0"]).sum(axis=1) == 0
        assert pruned.sum() == round(V_IN * 0.25)
        assert (np.abs(d["scope"]["fc_0.w_0"][pruned]).sum(axis=1) > 0).all()


def _teacher_student(fl):
    from paddle_tpu.models import mnist as jm
    from paddle_tpu_torch.models import mnist as pm

    mn = jm if fl is jfluid else pm
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 11
    with fl.program_guard(main, startup), fl.unique_name.guard():
        img = fl.data("img", [None, 1, 28, 28], "float32")
        label = fl.data("label", [None, 1], "int64")
        t_loss, t_acc, t_logits = mn.conv_net(img, label)
        s_loss, s_acc, s_logits = mn.mlp(img, label)
    return main, startup, s_loss, s_logits, t_logits


TEACHER = ("conv2d_0.w_0", "conv2d_0.w_1", "conv2d_1.w_0", "conv2d_1.w_1",
           "batch_norm_0.w_0", "batch_norm_0.w_1", "fc_0.w_0", "fc_0.w_1")
TEACHER_STATS = ("batch_norm_0.w_2", "batch_norm_0.w_3")
STUDENT = ("fc_1.w_0", "fc_1.w_1", "fc_2.w_0", "fc_2.w_1", "fc_3.w_0",
           "fc_3.w_1")


def _distill_run(fl, init, monkeypatch, batches=3, batch=8):
    main, startup, s_loss, s_logits, t_logits = _teacher_student(fl)
    exe = fl.Executor(fl.CPUPlace())
    exe.run(startup)
    if init is not None:
        copy_scope(init, fl.global_scope())
    start = {n: host(v) for n, v in fl.global_scope().items()}
    rng = np.random.default_rng(4)
    imgs = rng.standard_normal((batches * batch, 1, 28, 28)).astype(
        np.float32)
    labels = rng.integers(0, 10, (batches * batch, 1)).astype(np.int64)

    def reader():
        for i in range(0, batches * batch, batch):
            yield [(imgs[j], labels[j]) for j in range(i, i + batch)]

    d = fl.contrib.slim.distillation
    strat = d.DistillationStrategy(
        distillers=[d.SoftLabelDistiller(s_logits.name, t_logits.name),
                    d.L2Distiller(s_logits.name, t_logits.name)],
        start_epoch=0, end_epoch=0)
    comp = fl.contrib.slim.Compressor(
        place=fl.CPUPlace(), scope=fl.global_scope(), train_program=main,
        train_reader=reader,
        train_feed_list=[("img", "img"), ("label", "label")],
        train_fetch_list=[("loss", s_loss.name)],
        train_optimizer=fl.optimizer.Momentum(0.01, 0.9),
        distiller_optimizer=fl.optimizer.Momentum(0.01, 0.9), log_period=1)
    comp._add_strategy(strat)
    comp.epoch = 2
    losses = record_losses(monkeypatch, fl, [s_loss.name])
    ctx = comp.run()
    return ctx, strat, start, losses


def test_distillation_compressor_matches_the_jax_package(monkeypatch):
    """conv_net (teacher) and mlp (student) in one program; the distill
    graph (soft label + l2 on the logits, Momentum) for epoch 0, the
    student's own loss for epoch 1. (Momentum: Adam's first steps pass the
    packages' rounding differences in gradients near its eps into the
    update undamped, as tests/test_torch_train.py shows; the teacher
    under Adam is held by the next test.)"""
    jctx, jstrat, start, jl = _distill_run(jfluid, None, monkeypatch)
    pctx, pstrat, _, pl = _distill_run(fluid, start, monkeypatch)
    assert pjson(pstrat._distill_graph.program) == pjson(
        jstrat._distill_graph.program)
    assert pjson(pctx.optimize_graph.program) == pjson(
        jctx.optimize_graph.program)
    assert len(jl) == 6
    assert_losses_close(pl, jl)
    assert_scopes_close(fluid.global_scope(), jfluid.global_scope(),
                        list(jfluid.global_scope().keys()))
    # the teacher finding: every teacher parameter has an update op in the
    # distill program, its gradient is 0 and the update leaves it as it
    # was; the teacher's batch-norm statistics move; the student's move
    for strat in (pstrat, jstrat):
        ops = strat._distill_graph.program.global_block().ops
        updated = {op.input("Param")[0] for op in ops
                   if op.type == "momentum"}
        assert set(TEACHER) | set(STUDENT) == updated
        (bw,) = [op for op in ops if op.type == "backward"]
        assert set(TEACHER) <= set(bw.attrs["targets"])
    for fl in (fluid, jfluid):
        scope = fl.global_scope()
        for n in TEACHER:
            np.testing.assert_array_equal(host(scope[n]), start[n],
                                          err_msg=n)
        for n in TEACHER_STATS + STUDENT:
            assert not np.array_equal(host(scope[n]), start[n]), n


def test_teacher_gradients_are_zero_in_both_packages():
    """Two Adam steps of a distill program: the teacher's gradients
    (fetched @GRAD vars) are all zero in both packages, so Adam leaves the
    teacher's parameters bit for bit as they were; the student's
    gradients agree."""
    grads = {}
    for fl in (jfluid, fluid):
        main, startup, s_loss, s_logits, t_logits = _teacher_student(fl)
        d = fl.contrib.slim.distillation
        with fl.program_guard(main, startup):
            loss = fl.layers.elementwise_add(
                d.L2Distiller(s_logits.name, t_logits.name).distiller_loss(
                    main), s_loss)
            fl.optimizer.Adam(0.001).minimize(loss)
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup)
        if fl is fluid:
            copy_scope(init, fluid.global_scope())
        else:
            init = {n: np.array(v) for n, v in fl.global_scope().items()}
        rng = np.random.default_rng(6)
        feed = {"img": rng.standard_normal((4, 1, 28, 28)).astype(
            np.float32), "label": rng.integers(0, 10, (4, 1))}
        names = [n + "@GRAD" for n in TEACHER + STUDENT]
        for _ in range(2):
            vals = exe.run(main, feed=feed, fetch_list=names)
        grads[fl] = dict(zip(names, vals))
        for n in TEACHER:
            np.testing.assert_array_equal(host(fl.global_scope()[n]),
                                          init[n], err_msg=n)
    for n in TEACHER:
        for fl in (jfluid, fluid):
            assert not np.asarray(grads[fl][n + "@GRAD"]).any(), n
    for n in STUDENT:
        g = np.asarray(grads[jfluid][n + "@GRAD"])
        assert g.any()
        np.testing.assert_allclose(grads[fluid][n + "@GRAD"], g, rtol=0,
                                   atol=TOL * np.abs(g).max())


# ---------------------------------------------------------------------------
# the searcher
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 3])
def test_sa_controller_matches_the_jax_package(seed):
    from paddle_tpu.fluid.contrib.slim.searcher import SAController as J
    from paddle_tpu_torch.fluid.contrib.slim.searcher import SAController

    target = [3, 1, 4, 1, 5]

    def reward(tokens):
        return -sum(abs(a - b) for a, b in zip(tokens, target))

    runs = []
    for cls in (J, SAController):
        random.seed(seed)
        ctl = cls(reduce_rate=0.9, init_temperature=10.0)
        ctl.reset([8] * 5, [0] * 5,
                  constrain_func=lambda t: sum(t) < 20)
        seq = []
        for _ in range(200):
            cand = ctl.next_tokens()
            ctl.update(cand, reward(cand))
            seq.append((cand, ctl._tokens, ctl._temperature))
        runs.append((seq, ctl.best_tokens, ctl.max_reward, ctl._iter))
    assert runs[0] == runs[1]
    assert runs[1][2] >= -3


# ---------------------------------------------------------------------------
# the JAX package's own slim tests on the port
# ---------------------------------------------------------------------------
REFERENCE = [("test_slim_framework", t) for t in (
    "test_graph_wrapper_queries", "test_compressor_yaml_prune_plus_quant",
    "test_distillation_strategy_runs", "test_sa_controller_improves")] + [
    ("test_slim", t) for t in (
        "test_structure_pruner_l1_groups",
        "test_prune_program_masks_and_training_continues",
        "test_l2_distiller_loss_decreases",
        "test_soft_label_distiller_loss_decreases",
        "test_prune_program_skips_low_rank_params_for_axis1")]


@pytest.mark.parametrize("module,test", REFERENCE)
def test_reference_slim_test_passes_on_the_port(module, test, port_contrib,
                                                tmp_path, monkeypatch):
    mod = on_port(module)
    if module == "test_slim":
        assert mod.StructurePruner is \
            fluid.contrib.slim.prune.StructurePruner
    run_reference_test(mod, test, tmp_path, monkeypatch)
