"""fluid.contrib.slim.nas (LightNAS) in the port, against the JAX package,
on the CPU.

- A LightNAS search through a yaml Compressor in each package, each from a
  temporary working directory of its own (the strategy writes its
  flock'd server file there, and a shared directory would let one
  package's agent reach the other's server): one token picks the hidden
  width of a classifier whose parameters start from the same seeded
  numpy values in both packages, a FLOPs budget excludes the widest
  choices, the initial token is over it. Under one ``random.seed`` both
  packages propose and train the same tokens, give the same rewards,
  keep the same best, and evaluate alike (1e-5 relative). Each server
  thread is joined and its socket file removed.
- The JAX package's own tests/test_light_nas.py runs on the port
  (``test_torch_slim.on_port``).
"""
import os
import random

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
from test_torch_slim import (  # noqa: F401
    _fresh_state, on_port, port_contrib, run_reference_test)

V_IN, NCLS = 8, 3
WIDTHS = [4, 8, 16, 64]


def _data(n=96, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n, V_IN)).astype("float32")
    ys = np.argmax(xs[:, :NCLS], axis=1).astype("int64")[:, None]
    return xs, ys


class WidthSpace:
    """One token choosing the hidden width; the parameters start from
    seeded numpy values, the same in both packages."""

    def __init__(self, fl):
        self.fl = fl
        self.created = []

    def init_tokens(self):
        return [3]            # over the budget on purpose

    def range_table(self):
        return [len(WIDTHS)]

    def create_net(self, tokens=None):
        fl = self.fl
        width = WIDTHS[tokens[0]]
        self.created.append(list(tokens))
        init = (jfluid if fl is jfluid else fluid).initializer

        def attr(shape, seed):
            return fl.ParamAttr(initializer=init.NumpyArrayInitializer(
                np.random.default_rng(seed).uniform(
                    -0.5, 0.5, shape).astype(np.float32)))

        train_p, startup_p = fl.Program(), fl.Program()
        with fl.program_guard(train_p, startup_p), fl.unique_name.guard():
            x = fl.data("nx", shape=[None, V_IN], dtype="float32")
            y = fl.data("ny", shape=[None, 1], dtype="int64")
            h = fl.layers.fc(x, width, act="relu",
                             param_attr=attr((V_IN, width), width),
                             bias_attr=attr((width,), width + 1))
            logits = fl.layers.fc(h, NCLS,
                                  param_attr=attr((width, NCLS), width + 2),
                                  bias_attr=attr((NCLS,), width + 3))
            loss = fl.layers.mean(
                fl.layers.softmax_with_cross_entropy(logits, y))
            acc = fl.layers.accuracy(fl.layers.softmax(logits), y)
        test_p = train_p.clone(for_test=True)
        with fl.program_guard(train_p, startup_p):
            fl.optimizer.Adam(5e-2).minimize(loss)
        xs, ys = _data()

        def reader():
            for i in range(0, len(xs), 32):
                yield [(xs[j], ys[j]) for j in range(i, i + 32)]

        return (startup_p, train_p, test_p, [("loss", loss.name)],
                [("acc_top1", acc.name), ("loss", loss.name)], reader,
                reader)


YAML = """
version: 1.0
controllers:
    sa_controller:
        class: 'SAController'
        reduce_rate: 0.9
        init_temperature: 1024
        max_iter_number: 300
strategies:
    light_nas_strategy:
        class: 'LightNASStrategy'
        controller: 'sa_controller'
        target_flops: %d
        target_latency: 0
        end_epoch: 3
        retrain_epoch: 1
        metric_name: 'acc_top1'
        is_server: 1
        server_ip: '127.0.0.1'
        max_client_num: 10
        search_steps: 50
compressor:
    epoch: 4
    strategies:
        - light_nas_strategy
"""


def _search(fl, workdir, monkeypatch):
    workdir.mkdir()
    monkeypatch.chdir(workdir)
    (workdir / "compress.yaml").write_text(YAML % (11 * 16))
    random.seed(0)
    space = WidthSpace(fl)
    comp = fl.contrib.slim.Compressor(
        place=fl.CPUPlace(), scope=fl.global_scope(),
        train_program=fl.Program(), train_reader=None,
        train_feed_list=[("nx", "nx"), ("ny", "ny")],
        train_fetch_list=[("loss", "unused")],
        eval_program=fl.Program(), eval_reader=None,
        eval_feed_list=[("nx", "nx"), ("ny", "ny")],
        eval_fetch_list=[("acc_top1", "unused")],
        search_space=space, log_period=2)
    comp.config("compress.yaml")
    ctx = comp.run()
    strategy = comp.strategies[0]
    server = strategy._server
    assert not server._thread.is_alive()            # closed and joined
    assert not os.path.exists(
        "slim_LightNASStrategy_controller_server.socket")
    ctrl = strategy._controller
    return dict(created=space.created, best=ctrl.best_tokens,
                max_reward=ctrl.max_reward, iters=ctrl._iter,
                tokens=strategy._current_tokens,
                evals=ctx.eval_results, flops=ctx.eval_graph.flops())


def test_light_nas_search_picks_the_jax_package_s_tokens(tmp_path,
                                                         monkeypatch):
    want = _search(jfluid, tmp_path / "jax", monkeypatch)
    got = _search(fluid, tmp_path / "port", monkeypatch)
    for k in ("created", "best", "max_reward", "iters", "tokens", "flops"):
        assert got[k] == want[k], k
    assert got["evals"].keys() == want["evals"].keys()
    for k in want["evals"]:
        np.testing.assert_allclose(got["evals"][k], want["evals"][k],
                                   rtol=1e-5)
    # the over-budget initial token was tried and turned away
    assert got["created"][0] == [3] and got["iters"] >= 3
    assert got["flops"] <= 11 * 16 and len(got["evals"]["acc_top1"]) == 4


@pytest.mark.parametrize("test", [
    "test_controller_server_agent_roundtrip",
    "test_light_nas_yaml_search_end_to_end",
    "test_wrong_key_yields_clear_error"])
def test_reference_light_nas_test_passes_on_the_port(test, port_contrib,
                                                     tmp_path, monkeypatch):
    run_reference_test(on_port("test_light_nas"), test, tmp_path,
                       monkeypatch)
