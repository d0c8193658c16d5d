"""f32 training of the ResNet and MNIST slice in the port against the JAX
package, on the CPU, each step from the same state
(test_f32_training_matches_jax says how and why), and the measurements
behind every training bound of this file and of tests/test_torch_resnet.py:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_resnet_train.py \
        sweep [case]        # each metric per startup seed 0-7
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_resnet_train.py \
        conditioning        # the JAX package against itself, image +1 ulp
"""
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from test_torch_resnet import (  # noqa: F401  (the autouse fixture)
    SEED, _amp_case, _build, _dist, _feed, _fresh_port_state, _mnist_io,
    _momentum, _parity, _rel, _resnet_io, _sgd)

# the ResNets' gradients in f32 (see test_f32_training_matches_jax)
R18_MEDIAN = 4e-2
R18_DIST = 4e-2
R50_MEDIAN = 1.5e-1
R50_DIST = 1.5e-1


def _check(res, bounds):
    """Each metric of `res` within its bound in `bounds`, and the update
    made of the port's own gradients (1e-6)."""
    for key, bound in bounds.items():
        got = res[key][0] if isinstance(res[key], tuple) else res[key]
        assert got <= bound, (key, res[key], bound)
    assert res["update"][0] <= 1e-6, res["update"]


# case -> ((model, optimizer, feed, steps), the bounds its test holds),
# each bound at least 2x the worst of startup seeds 0-7 (CPU; ``python
# tests/test_torch_resnet_train.py sweep`` prints the metrics per seed)
F32_CASES = {
    "resnet18": ((lambda: (_resnet_io(18, 32, 10), _momentum(),
                           _feed(16, 32, 10), 5)),
                 dict(loss=1e-4, median=R18_MEDIAN, dist=R18_DIST,
                      stat=1e-4)),
    "bottleneck50": ((lambda: (_resnet_io(50, 64, 10), _momentum(),
                               _feed(2, 64, 10), 2)),
                     dict(loss=2e-4, median=R50_MEDIAN, dist=R50_DIST,
                          stat=4e-4)),
    "mnist_mlp": ((lambda: (_mnist_io("mlp"), _sgd(),
                            _feed(8, "mlp", 10), 3)),
                  dict(loss=1e-5, grad=1e-4)),
    "mnist_conv_net": ((lambda: (_mnist_io("conv_net"), _sgd(),
                                 _feed(8, "conv_net", 10), 3)),
                       dict(loss=1e-5, grad=1e-4, stat=1e-5)),
}


@pytest.mark.parametrize("case", sorted(F32_CASES))
def test_f32_training_matches_jax(case):
    """f32 training, each step from the JAX state, held to the bounds of
    F32_CASES. resnet18: ResNet-18 at 32x32, batch 16, 10 classes,
    Momentum(1e-3, 0.9), 5 steps. bottleneck50: depth 50 at 64x64, batch
    2, 2 steps. mnist_*: mnist.mlp and mnist.conv_net (its batch norm
    included), SGD(1e-2), batch 8, 3 steps.

    The MNIST models agree nearly to f32's last bits, every gradient
    within 1e-4·max|grad|. The ResNets do not, and cannot: from their
    random initialization a step's gradients are so sensitive that the
    JAX package moves its own by up to 32% of a parameter's max|grad|
    (2.1% of all gradients together) when its image moves by one f32 ulp
    (depth 50, 1000 classes, 64x64, batch 4: ``python
    tests/test_torch_resnet_train.py conditioning``), and the port's differ from
    the JAX package's by as much. So a ResNet's gradients are held by the
    median over its parameters and by all gradients together, not by its
    worst parameter; the losses and the moving statistics, which the
    forward makes, are held tightly; and every parameter and velocity must
    be the momentum step of the port's own gradients (1e-6). Why these
    configurations: at 32x32 with batch 4 (ResNet-18) or batch 2 (depth
    50) the last stage's batch norm normalizes 4 or 2 values per channel,
    and one f32 ulp of the image moves the JAX package's own loss by up to
    36% (``conditioning``)."""
    make, bounds = F32_CASES[case]
    _check(_parity(*make()), bounds)


# ---------------------------------------------------------------------------
# the sweeps behind the bounds (CPU): python tests/test_torch_resnet_train.py
# ---------------------------------------------------------------------------
def _sweep(only=""):
    cases = [(k, make) for k, (make, _) in sorted(F32_CASES.items())]
    cases.append(("resnet18_bf16_amp", _amp_case))
    for tag, make in cases:
        if only not in tag:
            continue
        for seed in range(8):
            pt_framework.switch_main_program(pt_framework.Program())
            pt_framework.switch_startup_program(pt_framework.Program())
            pt_unique_name.switch()
            jfluid.unique_name.switch()
            r = _parity(*make(), seed=seed, amp="amp" in tag)
            line = ("%-18s seed %d: loss %.2e; gradients worst %.2e (%s), "
                    "median %.2e, all %.2e; stat %.2e (%s); update %.1e" % (
                        tag, seed, r["loss"][0], r["grad"][0], r["grad"][1],
                        r["median"], r["dist"], r["stat"][0], r["stat"][1],
                        r["update"][0]))
            if "amp" in tag:
                line += ("; f32 control: loss %.2e, all gradients %.2e; "
                         "bf16 share port %.3f jax %.3f control %.3f" % (
                             r["loss_f32"], r["dist_f32"], r["bf16"]["port"],
                             r["bf16"]["jax"], r["bf16"]["f32"]))
            print(line, flush=True)


def _conditioning():
    """How far the JAX package moves itself when its image moves by one
    f32 ulp, in one f32 Momentum step from its startup values (seed
    SEED): the loss, the worst parameter's max|d|/max|grad| and all
    gradients together, at the configurations the tests considered."""
    for depth, image, batch, classes in ((50, 32, 2, 10), (50, 64, 2, 10),
                                         (50, 64, 4, 1000), (18, 32, 4, 10),
                                         (18, 32, 16, 10)):
        jfluid.unique_name.switch()
        main, startup, io = _build(jfluid, _resnet_io(depth, image, classes),
                                   _momentum())
        startup.random_seed = SEED
        exe = jfluid.Executor(jfluid.CPUPlace())
        scope = jfluid.Scope()
        exe.run(startup, scope=scope)
        names = [v.name for v in main.global_block().vars.values()
                 if v.persistable]
        start = {n: np.array(scope[n]) for n in names}
        grads = sorted(p.name + "@GRAD" for p in main.all_parameters()
                       if p.trainable)
        feed = _feed(batch, image, classes)
        nudged = dict(feed, image=np.nextafter(feed["image"],
                                               np.float32(np.inf)))
        outs = []
        for f in (feed, nudged):
            for n, v in start.items():
                scope.set(n, v.copy())
            outs.append([np.asarray(v) for v in exe.run(
                main, feed=f, scope=scope, fetch_list=[io["loss"]] + grads)])
        (la, *ga), (lb, *gb) = outs
        worst = max((_rel(b, a), n) for n, a, b in zip(grads, ga, gb))
        print("depth %d, %dx%d, batch %d, %d classes: image one ulp up moves "
              "the loss by %.2e, the gradients by %.2e of max|grad| (%s), "
              "%.2e all together" % (
                  depth, image, image, batch, classes,
                  abs(float(lb) - float(la)) / abs(float(la)), worst[0],
                  worst[1], _dist(gb, ga)), flush=True)


if __name__ == "__main__":
    cmd = sys.argv[1:] or ["sweep"]
    if cmd[0] == "conditioning":
        _conditioning()
    else:
        _sweep(*cmd[1:])
