"""The CRNN-CTC text recogniser of PaddlePaddle/models
(PaddleCV/ocr_recognition/crnn_ctc_model.py: ``ctc_train_net`` and
``ctc_infer``), built by the same layer calls.

Four conv + batch-norm groups (3x3 pad-1 convolutions, each batch norm
with relu; the first three groups end in a 2x2 stride-2 max pool with
``ceil_mode``), ``im2sequence`` over the whole feature-map height, two
fc projections to 3·hidden, a forward and a reverse ``dynamic_gru`` with
relu candidates, an fc to num_classes + 1, ``warpctc`` with the blank last
and ``norm_by_times``, ``reduce_sum`` and Momentum; inference is
``ctc_greedy_decoder`` and ``edit_distance``. Initialisers and the
L2Decay(0.0004) regulariser are the published ones: ``conv_bn_pool``'s
``param_0`` (Normal(0, 0.0005)) takes both convolutions of the first
group, Normal(0, 0.01) every other convolution and the batch-norm
scales, Normal(0, 0) the batch-norm and last fc biases.

Two adaptations to the padded convention of this package (no LoD
tensors): ``im2sequence`` gives the flat (B·T, C·h) rows, reshaped here
to (B, T, C·h) for the fcs (``num_flatten_dims=2``); and the label is an
int32 (B, L) batch padded with the blank plus a ``label_length`` feed, in
place of the LoD ``label``. Every image has the same width, so every
sequence has T steps.

Both packages' layers build the same Program from this file: the module
global ``fluid`` is the only name it reads them through.
"""
import numpy as np

from .. import fluid

__all__ = ["CRNNConfig", "L2_RATE", "LEARNING_RATE", "MOMENTUM",
           "conv_bn_pool", "ocr_convs", "encoder_net", "ctc_train_net",
           "ctc_infer", "synthetic_batch"]

# the published regulariser and optimizer: L2Decay(0.0004), Momentum(1e-3, 0.9)
L2_RATE, LEARNING_RATE, MOMENTUM = 0.0004, 1e-3, 0.9


class CRNNConfig:
    """The published data_reader settings: (1, 48, 512) images, 95 classes
    (the blank is class 95), GRU hidden 200, batch 32; labels of 4-24
    ids."""

    def __init__(self, image_shape=(1, 48, 512), num_classes=95,
                 rnn_hidden=200, batch=32, min_label=4, max_label=24):
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.rnn_hidden = rnn_hidden
        self.batch = batch
        self.min_label = min_label
        self.max_label = max_label

    @property
    def steps(self):
        """T: the feature map's width after the three ceil-mode pools."""
        w = self.image_shape[2]
        for _ in range(3):
            w = -(-w // 2)
        return w


def conv_bn_pool(input, group, out_ch, act="relu", param=None, bias=None,
                 param_0=None, is_test=False, pooling=True):
    tmp = input
    for i in range(group):
        tmp = fluid.layers.conv2d(
            input=tmp, num_filters=out_ch[i], filter_size=3, padding=1,
            param_attr=param if param_0 is None else param_0, act=None)
        tmp = fluid.layers.batch_norm(input=tmp, act=act, param_attr=param,
                                      bias_attr=bias, is_test=is_test)
    if pooling:
        tmp = fluid.layers.pool2d(input=tmp, pool_size=2, pool_type="max",
                                  pool_stride=2, ceil_mode=True)
    return tmp


def ocr_convs(input, regularizer=None, gradient_clip=None, is_test=False):
    b = fluid.ParamAttr(regularizer=regularizer, gradient_clip=gradient_clip,
                        initializer=fluid.initializer.Normal(0.0, 0.0))
    w0 = fluid.ParamAttr(regularizer=regularizer,
                         gradient_clip=gradient_clip,
                         initializer=fluid.initializer.Normal(0.0, 0.0005))
    w1 = fluid.ParamAttr(regularizer=regularizer,
                         gradient_clip=gradient_clip,
                         initializer=fluid.initializer.Normal(0.0, 0.01))
    tmp = conv_bn_pool(input, 2, [16, 16], param=w1, bias=b, param_0=w0,
                       is_test=is_test)
    tmp = conv_bn_pool(tmp, 2, [32, 32], param=w1, bias=b, is_test=is_test)
    tmp = conv_bn_pool(tmp, 2, [64, 64], param=w1, bias=b, is_test=is_test)
    return conv_bn_pool(tmp, 2, [128, 128], param=w1, bias=b,
                        is_test=is_test, pooling=False)


def encoder_net(images, num_classes, rnn_hidden_size=200, regularizer=None,
                gradient_clip=None, is_test=False):
    """The (B, T, num_classes + 1) logits of `images` (B, C, H, W)."""
    conv = ocr_convs(images, regularizer, gradient_clip, is_test)
    sliced = fluid.layers.im2sequence(input=conv, stride=[1, 1],
                                      filter_size=[conv.shape[2], 1])
    steps, width = conv.shape[3], conv.shape[1] * conv.shape[2]
    sliced = fluid.layers.reshape(sliced, [-1, steps, width])
    para_attr = fluid.ParamAttr(
        regularizer=regularizer, gradient_clip=gradient_clip,
        initializer=fluid.initializer.Normal(0.0, 0.02))
    bias_attr = fluid.ParamAttr(
        regularizer=regularizer, gradient_clip=gradient_clip,
        initializer=fluid.initializer.Normal(0.0, 0.02), learning_rate=2.0)
    bias_attr_nobias = fluid.ParamAttr(
        regularizer=regularizer, gradient_clip=gradient_clip,
        initializer=fluid.initializer.Normal(0.0, 0.02))
    fc_1 = fluid.layers.fc(input=sliced, size=rnn_hidden_size * 3,
                           num_flatten_dims=2, param_attr=para_attr,
                           bias_attr=bias_attr_nobias)
    fc_2 = fluid.layers.fc(input=sliced, size=rnn_hidden_size * 3,
                           num_flatten_dims=2, param_attr=para_attr,
                           bias_attr=bias_attr_nobias)
    gru_forward = fluid.layers.dynamic_gru(
        input=fc_1, size=rnn_hidden_size, param_attr=para_attr,
        bias_attr=bias_attr, candidate_activation="relu")
    gru_backward = fluid.layers.dynamic_gru(
        input=fc_2, size=rnn_hidden_size, is_reverse=True,
        param_attr=para_attr, bias_attr=bias_attr,
        candidate_activation="relu")
    w_attr = fluid.ParamAttr(regularizer=regularizer,
                             gradient_clip=gradient_clip,
                             initializer=fluid.initializer.Normal(0.0, 0.02))
    b_attr = fluid.ParamAttr(regularizer=regularizer,
                             gradient_clip=gradient_clip,
                             initializer=fluid.initializer.Normal(0.0, 0.0))
    return fluid.layers.fc(input=[gru_forward, gru_backward],
                           size=num_classes + 1, num_flatten_dims=2,
                           param_attr=w_attr, bias_attr=b_attr)


def _data(cfg):
    images = fluid.data(name="pixel", shape=[None] + list(cfg.image_shape),
                        dtype="float32")
    label = fluid.data(name="label", shape=[None, cfg.max_label],
                       dtype="int32")
    label_length = fluid.data(name="label_length", shape=[None],
                              dtype="int64")
    return images, label, label_length


def _decode(fc_out, label, label_length, num_classes):
    decoded, out_len = fluid.layers.ctc_greedy_decoder(input=fc_out,
                                                       blank=num_classes)
    casted = fluid.layers.cast(x=label, dtype="int64")
    distance, seq_num = fluid.layers.edit_distance(
        decoded, casted, input_length=out_len, label_length=label_length)
    return decoded, out_len, distance


def ctc_train_net(cfg):
    """``ctc_train_net``: the training program's variables as a dict
    (``loss`` the summed CTC cost; ``inference_program`` the program cloned
    for test before the optimizer, as published)."""
    regularizer = fluid.regularizer.L2Decay(L2_RATE)
    images, label, label_length = _data(cfg)
    fc_out = encoder_net(images, cfg.num_classes, cfg.rnn_hidden,
                         regularizer=regularizer)
    cost = fluid.layers.warpctc(input=fc_out, label=label,
                                blank=cfg.num_classes, norm_by_times=True,
                                label_length=label_length)
    sum_cost = fluid.layers.reduce_sum(cost)
    decoded, out_len, distance = _decode(fc_out, label, label_length,
                                         cfg.num_classes)
    inference_program = fluid.default_main_program().clone(for_test=True)
    optimizer = fluid.optimizer.Momentum(learning_rate=LEARNING_RATE,
                                         momentum=MOMENTUM)
    optimizer.minimize(sum_cost)
    return {"images": images, "label": label, "label_length": label_length,
            "fc_out": fc_out, "loss": sum_cost, "decoded": decoded,
            "out_len": out_len, "distance": distance,
            "inference_program": inference_program}


def ctc_infer(cfg):
    """``ctc_infer``: the greedy decoder over the test-mode encoder, and
    the edit distance of its paths to the labels."""
    images, label, label_length = _data(cfg)
    fc_out = encoder_net(images, cfg.num_classes, cfg.rnn_hidden,
                         is_test=True)
    decoded, out_len, distance = _decode(fc_out, label, label_length,
                                         cfg.num_classes)
    return {"images": images, "label": label, "label_length": label_length,
            "fc_out": fc_out, "decoded": decoded, "out_len": out_len,
            "distance": distance}


def synthetic_batch(cfg, batch, rng):
    """A feed of the published schema made from `rng`: images uniform in
    [0, 1) of ``cfg.image_shape`` (f32), labels of min_label..max_label
    ids in [0, num_classes), padded with the blank to max_label (int32),
    and their lengths (int64). No dataset ships with the repository."""
    images = rng.uniform(0.0, 1.0, size=(batch,) + cfg.image_shape).astype(
        np.float32)
    lengths = rng.integers(cfg.min_label, cfg.max_label + 1, size=batch)
    label = np.full((batch, cfg.max_label), cfg.num_classes, np.int32)
    for i, n in enumerate(lengths):
        label[i, :n] = rng.integers(0, cfg.num_classes, size=n)
    return {"pixel": images, "label": label,
            "label_length": lengths.astype(np.int64)}
