"""ResNet for ImageNet-style training through the fluid layer API
(structure per the reference's image classification book example). Port
of paddle_tpu/models/resnet.py: the same layer calls build the same
Program, op for op and name for name, for every depth of ``_DEPTH_CFG``.

NCHW convs lower to ``F.conv2d`` (cuDNN on the card); the batch-norm
moving statistics are persistable state the Executor writes back after
each step (ops/nn_ops.py ``batch_norm``).
"""
from .. import fluid
from ..fluid import layers
from ..fluid.param_attr import ParamAttr

__all__ = ["resnet", "resnet50", "build_resnet_train"]

_DEPTH_CFG = {
    18: ([2, 2, 2, 2], "basic"),
    34: ([3, 4, 6, 3], "basic"),
    50: ([3, 4, 6, 3], "bottleneck"),
    101: ([3, 4, 23, 3], "bottleneck"),
    152: ([3, 8, 36, 3], "bottleneck"),
}


def _conv_bn(x, num_filters, filter_size, stride=1, act=None, name=None):
    conv = layers.conv2d(
        input=x,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=(filter_size - 1) // 2,
        bias_attr=False,
        param_attr=ParamAttr(name=name + ".conv.w"),
        name=name,
    )
    return layers.batch_norm(
        conv,
        act=act,
        param_attr=ParamAttr(name=name + ".bn.scale"),
        bias_attr=ParamAttr(name=name + ".bn.bias"),
        moving_mean_name=name + ".bn.mean",
        moving_variance_name=name + ".bn.var",
    )


def _shortcut(x, out_ch, stride, name):
    in_ch = x.shape[1]
    if in_ch != out_ch or stride != 1:
        return _conv_bn(x, out_ch, 1, stride, name=name + ".short")
    return x


def _bottleneck(x, num_filters, stride, name):
    c1 = _conv_bn(x, num_filters, 1, 1, act="relu", name=name + ".c1")
    c2 = _conv_bn(c1, num_filters, 3, stride, act="relu", name=name + ".c2")
    c3 = _conv_bn(c2, num_filters * 4, 1, 1, act=None, name=name + ".c3")
    short = _shortcut(x, num_filters * 4, stride, name)
    return layers.elementwise_add(short, c3, act="relu")


def _basic(x, num_filters, stride, name):
    c1 = _conv_bn(x, num_filters, 3, stride, act="relu", name=name + ".c1")
    c2 = _conv_bn(c1, num_filters, 3, 1, act=None, name=name + ".c2")
    short = _shortcut(x, num_filters, stride, name)
    return layers.elementwise_add(short, c2, act="relu")


def resnet(img, class_num=1000, depth=50):
    """img: (B, 3, H, W) → logits (B, class_num)."""
    blocks, kind = _DEPTH_CFG[depth]
    x = _conv_bn(img, 64, 7, 2, act="relu", name="stem")
    x = layers.pool2d(x, pool_size=3, pool_stride=2, pool_padding=1,
                      pool_type="max")
    num_filters = [64, 128, 256, 512]
    block_fn = _bottleneck if kind == "bottleneck" else _basic
    for stage, n_blocks in enumerate(blocks):
        for b in range(n_blocks):
            stride = 2 if b == 0 and stage > 0 else 1
            x = block_fn(
                x, num_filters[stage], stride,
                name="s%d.b%d" % (stage, b),
            )
    x = layers.pool2d(x, pool_type="avg", global_pooling=True)
    x = layers.flatten(x)
    logits = layers.fc(
        input=x, size=class_num,
        param_attr=ParamAttr(name="fc.w"),
        bias_attr=ParamAttr(name="fc.b"),
    )
    return logits


def resnet50(img, class_num=1000):
    return resnet(img, class_num, 50)


def build_resnet_train(depth=50, class_num=1000, image_size=224):
    img = fluid.data(name="image", shape=[None, 3, image_size, image_size],
                     dtype="float32")
    label = fluid.data(name="label", shape=[None, 1], dtype="int64")
    logits = resnet(img, class_num, depth)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(layers.softmax(logits), label)
    return {"image": img, "label": label, "logits": logits,
            "loss": loss, "acc": acc}
