"""MNIST models (parity: reference book ch.2 / fluid tests
recognize_digits). Port of paddle_tpu/models/mnist.py: the same layer
calls build the same Program, op for op and name for name."""
from .. import fluid
from ..fluid import layers


def mlp(img, label, hidden=200):
    h = layers.fc(input=img, size=hidden, act="relu")
    h = layers.fc(input=h, size=hidden, act="relu")
    logits = layers.fc(input=h, size=10)
    loss = layers.mean(
        layers.softmax_with_cross_entropy(logits, label)
    )
    acc = layers.accuracy(input=layers.softmax(logits), label=label)
    return loss, acc, logits


def conv_net(img, label):
    """LeNet-style conv net; img (B, 1, 28, 28)."""
    from ..fluid import nets

    c1 = nets.simple_img_conv_pool(
        input=img, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu",
    )
    c1 = layers.batch_norm(c1)
    c2 = nets.simple_img_conv_pool(
        input=c1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu",
    )
    logits = layers.fc(input=layers.flatten(c2), size=10)
    loss = layers.mean(layers.softmax_with_cross_entropy(logits, label))
    acc = layers.accuracy(input=layers.softmax(logits), label=label)
    return loss, acc, logits
