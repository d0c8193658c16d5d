"""SSD object detector through the fluid layer API (ref: the reference's
SSD/MobileNet book example built on layers/detection.py multi_box_head +
ssd_loss + detection_output).

Port of paddle_tpu/models/ssd.py: both packages build the same programs.
The VGG-lite backbone is plain conv2d (cuDNN on the card); the priors are
build-time constants; the training loss and the NMS inference head are
the static-shape detection ops (no LoD outputs)."""
from .. import fluid
from ..fluid import layers

__all__ = ["build_ssd_train", "build_ssd_infer", "synthetic_batch"]


def _backbone(img):
    """Small VGG-style feature pyramid: returns two feature maps."""
    c = layers.conv2d(img, 32, 3, stride=2, padding=1, act="relu")
    c = layers.conv2d(c, 32, 3, stride=1, padding=1, act="relu")
    f1 = layers.conv2d(c, 64, 3, stride=2, padding=1, act="relu")
    f2 = layers.conv2d(f1, 64, 3, stride=2, padding=1, act="relu")
    return f1, f2


def _head(img, num_classes, image_size):
    f1, f2 = _backbone(img)
    locs, confs, boxes, variances = layers.detection.multi_box_head(
        inputs=[f1, f2],
        image=img,
        base_size=image_size,
        num_classes=num_classes,
        aspect_ratios=[[1.0, 2.0], [1.0, 2.0]],
        min_ratio=20,
        max_ratio=90,
        flip=True,
        offset=0.5,
    )
    return locs, confs, boxes, variances


def build_ssd_train(num_classes=4, image_size=64, max_gt=8):
    """Build the SSD training graph (per-image loss, batch size 1 for the
    gt-matching path; the reference's LoD gt batching maps to fixed
    max_gt padding)."""
    img = fluid.data(name="image", shape=[1, 3, image_size, image_size],
                     dtype="float32")
    gt_box = fluid.data(name="gt_box", shape=[max_gt, 4], dtype="float32")
    gt_label = fluid.data(name="gt_label", shape=[max_gt, 1],
                          dtype="int64")
    locs, confs, boxes, variances = _head(img, num_classes, image_size)
    loc0 = layers.reshape(layers.slice(locs, [0], [0], [1]), [-1, 4])
    conf0 = layers.reshape(
        layers.slice(confs, [0], [0], [1]), [-1, num_classes]
    )
    loss = layers.detection.ssd_loss(
        loc0, conf0, gt_box, gt_label, boxes, variances,
    )
    return {"image": img, "gt_box": gt_box, "gt_label": gt_label,
            "loss": loss}


def build_ssd_infer(num_classes=4, image_size=64, keep_top_k=20):
    """Inference graph: decode + NMS to a static (N, keep_top_k, 6)
    detection tensor [label, score, x1, y1, x2, y2]."""
    img = fluid.data(name="image", shape=[1, 3, image_size, image_size],
                     dtype="float32")
    locs, confs, boxes, variances = _head(img, num_classes, image_size)
    scores = layers.transpose(layers.softmax(confs), [0, 2, 1])
    decoded = layers.detection.box_coder(
        boxes, variances, layers.reshape(locs, [-1, 4]),
        code_type="decode_center_size",
    )
    out = layers.detection.multiclass_nms(
        layers.reshape(decoded, [1, -1, 4]), scores,
        score_threshold=0.01, nms_top_k=100, keep_top_k=keep_top_k,
        nms_threshold=0.45,
    )
    return {"image": img, "detections": out}


def synthetic_batch(rng, image_size=64, max_gt=8, num_classes=4):
    """One synthetic scene: colored rectangles + their boxes/labels."""
    import numpy as np

    img = rng.uniform(0, 0.1, size=(1, 3, image_size, image_size))
    boxes = np.zeros((max_gt, 4), "float32")
    labels = np.zeros((max_gt, 1), "int64")
    n_obj = int(rng.integers(1, 4))
    for i in range(n_obj):
        x0, y0 = rng.uniform(0.05, 0.6, size=2)
        w, h = rng.uniform(0.2, 0.35, size=2)
        x1, y1 = min(x0 + w, 0.95), min(y0 + h, 0.95)
        cls = int(rng.integers(1, num_classes))
        boxes[i] = [x0, y0, x1, y1]
        labels[i] = cls
        xi0, yi0 = int(x0 * image_size), int(y0 * image_size)
        xi1, yi1 = int(x1 * image_size), int(y1 * image_size)
        img[0, cls % 3, yi0:yi1, xi0:xi1] = 0.9
    return (img.astype("float32"), boxes, labels)
