"""The high-level Trainer/Inferencer API and the utilities of
fluid.contrib in the port, against the JAX package, on the CPU.

- Trainer and Inferencer (the book's recognize_digits MLP, Adam): each
  package trains from the same saved parameters (``param_path``, a file
  the JAX package wrote): the same events, losses within 1e-5 relative,
  the same checkpoints kept (``CheckpointConfig``), ``test()`` and the
  Inferencer's predictions within 1e-5; ``stop()``; ``fetch_metrics =
  False`` fetches nothing; a resume from a checkpoint; ``parallel=True``
  raises, naming item 8.
- The JAX package's own tests/test_trainer_api.py on the port, an entry
  point without a place on the CPU.
- ``extend_with_decoupled_weight_decay`` (AdamW): the same Program JSON,
  and 3 steps from the same parameters within 1e-6 of the largest; one
  AdamW step equals one Adam step minus ``coeff * p_before``.
- ``memory_usage`` (a bf16 AMP program counts 2 bytes a bfloat16
  element), ``op_freq_statistic`` and ``summary`` equal the JAX
  package's; ``distributed_batch_reader`` shards alike under
  PADDLE_TRAINERS_NUM / PADDLE_TRAINER_ID; the HDFS and lookup-table
  utilities.
- The tombstones (``fluid.inferencer``, ``paddle_tpu_torch.libs``,
  ``paddle_tpu_torch.proto``), and ``fluid.contrib`` exports everything
  the JAX package's does. Importing every module of the port leaves
  PyYAML out (the card's host need not have it); a ConfigFactory parse
  brings it in.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
from test_torch_slim import (  # noqa: F401
    _fresh_state, assert_scopes_close, copy_scope, host, on_port, pjson,
    port_contrib, run_reference_test)

BATCH = 16


def _digits(n_batches=5, seed=3):
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((n_batches * BATCH, 1, 28, 28)).astype(
        np.float32)
    labels = rng.integers(0, 10, (n_batches * BATCH, 1)).astype(np.int64)

    def reader():
        for i in range(0, n_batches * BATCH, BATCH):
            yield [(imgs[j], labels[j]) for j in range(i, i + BATCH)]
    return reader, imgs


def _funcs(fl):
    from paddle_tpu.models import mnist as jm
    from paddle_tpu_torch.models import mnist as pm

    mn = jm if fl is jfluid else pm

    def train_func():
        img = fl.data("img", [None, 1, 28, 28], "float32")
        label = fl.data("label", [None, 1], "int64")
        loss, acc, _ = mn.mlp(img, label)
        return [loss, acc]

    def infer_func():
        # mlp's layers up to its logits (the same parameter names)
        img = fl.data("img", [None, 1, 28, 28], "float32")
        h = fl.layers.fc(input=img, size=200, act="relu")
        h = fl.layers.fc(input=h, size=200, act="relu")
        return fl.layers.fc(input=h, size=10)

    def optimizer_func():
        return fl.optimizer.Adam(0.001)

    return train_func, infer_func, optimizer_func


class _Events:
    def __init__(self, fl, trainer=None, stop_after=None):
        self.fl, self.trainer, self.stop_after = fl, trainer, stop_after
        self.kinds, self.losses = [], []

    def __call__(self, event):
        c = self.fl.contrib
        kind = [k for k in ("BeginEpochEvent", "EndEpochEvent",
                            "BeginStepEvent", "EndStepEvent")
                if isinstance(event, getattr(c, k))]
        self.kinds.append((kind[0], event.epoch, getattr(event, "step",
                                                         None)))
        if kind[0] == "EndStepEvent":
            assert all(isinstance(m, np.ndarray) for m in event.metrics)
            self.losses.append(float(event.metrics[0]))
            if self.stop_after and len(self.losses) == self.stop_after:
                self.trainer.stop()


def _trainer_run(fl, param_path, ckpt_dir):
    train_func, infer_func, optimizer_func = _funcs(fl)
    cfg = fl.contrib.CheckpointConfig(checkpoint_dir=str(ckpt_dir),
                                      max_num_checkpoints=2, step_interval=5)
    trainer = fl.contrib.Trainer(train_func, optimizer_func,
                                 param_path=param_path,
                                 place=fl.CPUPlace(), checkpoint_config=cfg)
    events = _Events(fl)
    reader, imgs = _digits()
    trainer.train(num_epochs=2, event_handler=events, reader=reader,
                  feed_order=["img", "label"])
    test = trainer.test(reader=reader, feed_order=["img", "label"])
    stopper = _Events(fl, trainer, stop_after=3)
    trainer.train(num_epochs=2, event_handler=stopper, reader=reader,
                  feed_order=["img", "label"])
    kept = sorted(os.listdir(ckpt_dir))
    saved = str(ckpt_dir) + "_params"
    trainer.save_params(saved)
    inferencer = fl.contrib.Inferencer(infer_func, param_path=saved,
                                       place=fl.CPUPlace())
    (pred,) = inferencer.infer({"img": imgs[:8]})
    return dict(events=events, test=test, stopper=stopper, kept=kept,
                pred=np.asarray(pred), trainer=trainer)


def test_trainer_and_inferencer_match_the_jax_package(tmp_path):
    train_func, _, optimizer_func = _funcs(jfluid)
    init = str(tmp_path / "init")
    jfluid.contrib.Trainer(train_func, optimizer_func,
                           place=jfluid.CPUPlace()).save_params(init)
    want = _trainer_run(jfluid, init, tmp_path / "jax_ckpt")
    got = _trainer_run(fluid, init, tmp_path / "port_ckpt")
    n = 2 * (1 + 5 * 2 + 1)
    assert got["events"].kinds == want["events"].kinds and len(
        got["events"].kinds) == n
    np.testing.assert_allclose(got["events"].losses, want["events"].losses,
                               rtol=1e-5)
    np.testing.assert_allclose(got["test"], want["test"], rtol=1e-5)
    assert got["stopper"].kinds == want["stopper"].kinds
    assert len(got["stopper"].losses) == 3
    np.testing.assert_allclose(got["stopper"].losses,
                               want["stopper"].losses, rtol=1e-5)
    # 2 epochs of 5 steps at step_interval 5 and an end-of-epoch save
    # each, then the stopped run's: exactly the last 2 kept
    assert got["kept"] == want["kept"] and len(got["kept"]) == 2
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=0,
                               atol=1e-5 * np.abs(want["pred"]).max())
    assert pjson(got["trainer"].train_program) == pjson(
        want["trainer"].train_program)
    assert pjson(got["trainer"].test_program) == pjson(
        want["trainer"].test_program)


def test_trainer_resumes_from_a_checkpoint_and_fetches_nothing_when_told(
        tmp_path):
    """A Trainer built on a kept checkpoint (``param_path``) starts from
    its values; a step with ``fetch_metrics = False`` returns no metric
    (nothing fetched, nothing read back)."""
    train_func, _, optimizer_func = _funcs(fluid)
    cfg = fluid.contrib.CheckpointConfig(
        checkpoint_dir=str(tmp_path / "ckpt"), max_num_checkpoints=1,
        step_interval=100)
    first = fluid.contrib.Trainer(train_func, optimizer_func,
                                  place=fluid.CPUPlace(),
                                  checkpoint_config=cfg)
    reader, _ = _digits(2)
    first.train(1, None, reader=reader, feed_order=["img", "label"])
    (kept,) = os.listdir(tmp_path / "ckpt")
    resumed = fluid.contrib.Trainer(
        train_func, optimizer_func,
        param_path=str(tmp_path / "ckpt" / kept), place=fluid.CPUPlace())
    names = [v.name for v in first.train_program.list_vars()
             if v.persistable]
    assert_scopes_close(resumed.scope, first.scope, names, tol=0)
    seen = []

    def handler(event):
        if isinstance(event, fluid.contrib.BeginStepEvent):
            event.fetch_metrics = False
        elif isinstance(event, fluid.contrib.EndStepEvent):
            seen.append(event.metrics)

    resumed.train(1, handler, reader=reader, feed_order=["img", "label"])
    assert seen == [[], []]


def test_parallel_raises_naming_item_8(tmp_path):
    train_func, infer_func, optimizer_func = _funcs(fluid)
    with pytest.raises(NotImplementedError, match="item 8"):
        fluid.contrib.Trainer(train_func, optimizer_func,
                              place=fluid.CPUPlace(), parallel=True)
    with pytest.raises(NotImplementedError, match="item 8"):
        fluid.contrib.Inferencer(infer_func, str(tmp_path),
                                 place=fluid.CPUPlace(), parallel=True)


@pytest.mark.parametrize("test", [
    "test_trainer_event_loop_and_inferencer_roundtrip",
    "test_trainer_stop_mid_training", "test_trainer_fetch_metrics_off"])
def test_reference_trainer_test_passes_on_the_port(test, port_contrib,
                                                   tmp_path, monkeypatch):
    mod = on_port("test_trainer_api")
    assert mod.Trainer is fluid.contrib.Trainer
    run_reference_test(mod, test, tmp_path, monkeypatch)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def _adamw_net(fl, coeff, decay_fun=None, adam=False):
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = 5
    with fl.program_guard(main, startup), fl.unique_name.guard():
        x = fl.data("x", [None, 12], "float32")
        y = fl.data("y", [None, 1], "float32")
        h = fl.layers.fc(x, 24, act="relu")
        loss = fl.layers.reduce_mean(fl.layers.square_error_cost(
            fl.layers.fc(h, 1), y))
        if adam:
            fl.optimizer.Adam(learning_rate=0.01).minimize(loss)
        else:
            opt = fl.contrib.extend_with_decoupled_weight_decay(
                fl.optimizer.Adam)
            opt(learning_rate=0.01, coeff=coeff,
                apply_decay_param_fun=decay_fun).minimize(loss)
    return main, startup, loss


@pytest.mark.parametrize("case", ["all", "weights_only"])
def test_adamw_matches_the_jax_package(case):
    fun = None if case == "all" else (lambda n: n.endswith("w_0"))
    (jm, js, jl), (pm, ps, pl) = (_adamw_net(fl, 0.01, fun)
                                  for fl in (jfluid, fluid))
    assert pjson(pm) == pjson(jm)
    jexe, pexe = (fl.Executor(fl.CPUPlace()) for fl in (jfluid, fluid))
    jexe.run(js)
    copy_scope(jfluid.global_scope(), fluid.global_scope())
    rng = np.random.default_rng(1)
    for _ in range(3):
        feed = {"x": rng.standard_normal((16, 12)).astype(np.float32),
                "y": rng.standard_normal((16, 1)).astype(np.float32)}
        want = jexe.run(jm, feed=feed, fetch_list=[jl])[0]
        got = pexe.run(pm, feed=feed, fetch_list=[pl])[0]
        np.testing.assert_allclose(got, want, rtol=1e-6)
    params = [p.name for p in pm.all_parameters()]
    assert_scopes_close(fluid.global_scope(), jfluid.global_scope(), params,
                        tol=1e-6)


def test_one_adamw_step_is_one_adam_step_minus_the_decay():
    """From one state and one batch, AdamW's parameters equal, bit for
    bit, Adam's minus ``coeff * p_before``: the snapshot is no gradient
    path, and the decay is written after the update."""
    out = {}
    for adam in (False, True):
        with fluid.scope_guard(fluid.Scope()):
            main, startup, loss = _adamw_net(fluid, 0.01, adam=adam)
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            before = {p.name: host(fluid.global_scope()[p.name])
                      for p in main.all_parameters()}
            rng = np.random.default_rng(2)
            exe.run(main, feed={
                "x": rng.standard_normal((16, 12)).astype(np.float32),
                "y": rng.standard_normal((16, 1)).astype(np.float32)},
                fetch_list=[loss])
            out[adam] = (before, {n: host(fluid.global_scope()[n])
                                  for n in before})
    (b_w, a_w), (b_a, a_a) = out[False], out[True]
    for n in b_w:
        np.testing.assert_array_equal(b_w[n], b_a[n])
        want = a_a[n] - b_a[n] * np.float32(0.01)
        np.testing.assert_array_equal(a_w[n], want, err_msg=n)


# ---------------------------------------------------------------------------
# utils_stat, the reader, the utilities
# ---------------------------------------------------------------------------
def _amp_bert(fl):
    from paddle_tpu.models import bert as jbert
    from paddle_tpu_torch.models import bert as pbert

    b = jbert if fl is jfluid else pbert
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        vs = b.build_bert_pretrain(b.BertConfig(
            vocab_size=300, hidden=32, num_layers=2, heads=2, ffn=64,
            max_seq=16), 16)
        fl.contrib.mixed_precision.decorate(
            fl.optimizer.Adam(1e-4), use_bf16=True).minimize(vs["loss"])
    return main


def test_utils_stat_match_the_jax_package(capsys):
    jm, pm = _amp_bert(jfluid), _amp_bert(fluid)
    bf16 = [v for v in pm.list_vars() if str(v.dtype) == "bfloat16"]
    assert bf16                       # the AMP program holds bf16 vars
    for batch in (1, 8):
        got = fluid.contrib.memory_usage(pm, batch)
        assert got == jfluid.contrib.memory_usage(jm, batch)
        # each bf16 var at 2 bytes an element
        from paddle_tpu_torch.fluid.contrib import utils_stat
        v = bf16[0]
        n = int(np.prod([batch if s in (None, -1) and i == 0 else
                         (1 if s in (None, -1) else s)
                         for i, s in enumerate(v.shape)]))
        assert utils_stat._var_bytes(v, batch) == 2 * n
    assert fluid.contrib.op_freq_statistic(pm) == \
        jfluid.contrib.op_freq_statistic(jm)
    got = fluid.contrib.summary(pm)
    want = jfluid.contrib.summary(jm)
    assert got == want and got["total_params"] > 0
    out = capsys.readouterr().out.split("total params")
    assert out[0] == out[1].split("\n", 1)[1]


@pytest.mark.parametrize("trainers,tid", [(1, 0), (3, 0), (3, 2)])
def test_distributed_batch_reader_shards_alike(trainers, tid, monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", str(trainers))
    monkeypatch.setenv("PADDLE_TRAINER_ID", str(tid))

    def batches():
        for i in range(10):
            yield [i]

    got = list(fluid.contrib.distributed_batch_reader(batches)())
    want = list(jfluid.contrib.distributed_batch_reader(batches)())
    assert got == want and got
    monkeypatch.setenv("PADDLE_TRAINER_ID", str(trainers))
    with pytest.raises(ValueError, match="out of range"):
        fluid.contrib.distributed_batch_reader(batches)


def test_hdfs_and_lookup_table_utils(tmp_path):
    from paddle_tpu_torch.fluid.contrib.utils import (
        hdfs_utils, lookup_table_utils as lt)

    client = hdfs_utils.HDFSClient("/hadoop", {})
    with pytest.raises(NotImplementedError, match="no Hadoop runtime"):
        client.ls("/x")
    with pytest.raises(NotImplementedError):
        hdfs_utils.multi_download(client, "a", "b", 0, 1)
    assert lt.create_kvs_content({3: [1.0, 2.5]}) == \
        jfluid.contrib.utils.lookup_table_utils.create_kvs_content(
            {3: [1.0, 2.5]})
    main, startup, loss = _adamw_net(fluid, 0.0, adam=True)
    assert lt.convert_dist_to_sparse_program(main) is main
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup)
    fluid.io.save_persistables(exe, str(tmp_path), main)
    values = {n: host(v) for n, v in fluid.global_scope().items()}
    with fluid.scope_guard(fluid.Scope()):
        lt.load_persistables_for_increment(str(tmp_path), exe, main)
        for n, v in values.items():
            np.testing.assert_array_equal(host(fluid.global_scope()[n]), v)


def test_tombstones_and_exports():
    import paddle_tpu.fluid.contrib as jc
    import paddle_tpu_torch
    import paddle_tpu_torch.fluid.contrib as c
    import paddle_tpu_torch.libs as libs
    import paddle_tpu_torch.proto as proto

    assert fluid.inferencer.__all__ == [] and libs.__all__ == []
    with pytest.raises(NotImplementedError, match="to_json"):
        proto.framework_pb2
    assert not hasattr(paddle_tpu_torch, "__no_such__")
    assert c.__all__ == jc.__all__
    assert {n for n in dir(jc) if not n.startswith("_")} <= set(dir(c))
    for name in jc.__all__:
        assert getattr(c, name) is not None
    for mod in ("layers", "utils", "reader"):
        assert getattr(c, mod).__all__ == getattr(jc, mod).__all__


def test_the_port_imports_yaml_only_when_a_config_parses(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("version: 1.0\ncompressor:\n  epoch: 2\n")
    code = r"""
import importlib, pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
print(sorted(k for k in sys.modules if k.split(".")[0] == "yaml"))
from paddle_tpu_torch.fluid.contrib.slim import ConfigFactory
print(ConfigFactory(sys.argv[1]).compressor["epoch"], "yaml" in sys.modules)
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code, str(cfg)], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split("\n")[:2] == ["[]", "2 True"]
