"""Python-side streaming metrics (ref: python/paddle/fluid/metrics.py)."""
import numpy as np

__all__ = [
    "MetricBase", "CompositeMetric", "Precision", "Recall", "Accuracy",
    "ChunkEvaluator", "EditDistance", "DetectionMAP", "Auc",
]


def _is_number_or_matrix(x):
    return isinstance(x, (int, float, np.ndarray)) or np.isscalar(x)


class MetricBase:
    def __init__(self, name):
        self._name = str(name) if name is not None else self.__class__.__name__

    def __str__(self):
        return self._name

    def reset(self):
        states = {
            attr: value
            for attr, value in self.__dict__.items()
            if not attr.startswith("_")
        }
        for attr, value in states.items():
            if isinstance(value, int):
                setattr(self, attr, 0)
            elif isinstance(value, float):
                setattr(self, attr, 0.0)
            elif isinstance(value, (np.ndarray, np.generic)):
                setattr(self, attr, np.zeros_like(value))
            else:
                setattr(self, attr, None)

    def get_config(self):
        return {
            attr: value
            for attr, value in self.__dict__.items()
            if not attr.startswith("_")
        }

    def update(self, preds, labels):
        raise NotImplementedError

    def eval(self):
        raise NotImplementedError


class CompositeMetric(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self._metrics = []

    def add_metric(self, metric):
        if not isinstance(metric, MetricBase):
            raise ValueError("metric must be MetricBase")
        self._metrics.append(metric)

    def update(self, preds, labels):
        for m in self._metrics:
            m.update(preds, labels)

    def eval(self):
        return [m.eval() for m in self._metrics]


class Precision(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype("int32").flatten()
        labels = np.asarray(labels).astype("int32").flatten()
        for p, l in zip(preds, labels):
            if p == 1:
                if l == 1:
                    self.tp += 1
                else:
                    self.fp += 1

    def eval(self):
        ap = self.tp + self.fp
        return float(self.tp) / ap if ap != 0 else 0.0


class Recall(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        preds = np.rint(np.asarray(preds)).astype("int32").flatten()
        labels = np.asarray(labels).astype("int32").flatten()
        for p, l in zip(preds, labels):
            if l == 1:
                if p == 1:
                    self.tp += 1
                else:
                    self.fn += 1

    def eval(self):
        recall = self.tp + self.fn
        return float(self.tp) / recall if recall != 0 else 0.0


class Accuracy(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.value = 0.0
        self.weight = 0.0

    def update(self, value, weight):
        if not _is_number_or_matrix(value):
            raise ValueError("value must be number or ndarray")
        self.value += float(np.asarray(value).reshape(-1)[0]) * weight
        self.weight += weight

    def eval(self):
        if self.weight == 0:
            raise ValueError("weight is 0; call update first")
        return self.value / self.weight


class ChunkEvaluator(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.num_infer_chunks = 0
        self.num_label_chunks = 0
        self.num_correct_chunks = 0

    def update(self, num_infer_chunks, num_label_chunks, num_correct_chunks):
        self.num_infer_chunks += int(np.asarray(num_infer_chunks).sum())
        self.num_label_chunks += int(np.asarray(num_label_chunks).sum())
        self.num_correct_chunks += int(np.asarray(num_correct_chunks).sum())

    def eval(self):
        precision = (
            float(self.num_correct_chunks) / self.num_infer_chunks
            if self.num_infer_chunks
            else 0.0
        )
        recall = (
            float(self.num_correct_chunks) / self.num_label_chunks
            if self.num_label_chunks
            else 0.0
        )
        f1 = (
            2 * precision * recall / (precision + recall)
            if self.num_correct_chunks
            else 0.0
        )
        return precision, recall, f1


class EditDistance(MetricBase):
    def __init__(self, name=None):
        super().__init__(name)
        self.total_distance = 0.0
        self.seq_num = 0
        self.instance_error = 0

    def update(self, distances, seq_num):
        distances = np.asarray(distances)
        self.total_distance += float(distances.sum())
        self.seq_num += int(seq_num)
        self.instance_error += int((distances > 0).sum())

    def eval(self):
        if self.seq_num == 0:
            raise ValueError("no data updated")
        avg_distance = self.total_distance / self.seq_num
        avg_instance_error = self.instance_error / float(self.seq_num)
        return avg_distance, avg_instance_error


class Auc(MetricBase):
    def __init__(self, name=None, curve="ROC", num_thresholds=4095):
        super().__init__(name)
        self._curve = curve
        self._num_thresholds = num_thresholds
        bins = num_thresholds + 1
        self._stat_pos = np.zeros(bins)
        self._stat_neg = np.zeros(bins)

    def update(self, preds, labels):
        preds = np.asarray(preds)
        labels = np.asarray(labels).flatten()
        pos_prob = preds[:, -1] if preds.ndim == 2 else preds.flatten()
        bins = np.clip(
            (pos_prob * self._num_thresholds).astype(int),
            0,
            self._num_thresholds,
        )
        for b, l in zip(bins, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def eval(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if tot_pos == 0 or tot_neg == 0:
            return 0.5
        tp = np.cumsum(self._stat_pos[::-1])
        fp = np.cumsum(self._stat_neg[::-1])
        tpr = tp / tot_pos
        fpr = fp / tot_neg
        return float(np.trapezoid(tpr, fpr))


class DetectionMAP:
    """Graph mAP evaluator (ref metrics.py DetectionMAP): builds the
    detection_map op over the NMS output + padded gt and streams an
    in-graph running MEAN of per-batch mAPs through persistable state
    (the reference pools detection statistics across batches instead —
    with similarly-sized batches the two converge; per-batch pooling is
    what the static-shape op computes).

    Usage mirrors the reference::

        m = fluid.metrics.DetectionMAP(nms_out, gt_label, gt_box,
                                       gt_difficult, class_num=21)
        cur_map, accum_map = m.get_map_var()
        ... exe.run(fetch_list=[cur_map, accum_map]) per batch ...
        m.reset(exe)    # new evaluation pass
    """

    def __init__(self, input, gt_label, gt_box, gt_difficult=None,
                 class_num=None, background_label=0,
                 overlap_threshold=0.5, evaluate_difficult=True,
                 ap_version="integral"):
        from . import unique_name
        from .layers import detection, tensor
        from .layers.nn import elementwise_add, elementwise_div

        if class_num is None:
            raise ValueError("DetectionMAP needs class_num")
        parts = [tensor.cast(gt_label, "float32"), gt_box]
        if gt_difficult is not None:
            parts.append(tensor.cast(gt_difficult, "float32"))
        label = tensor.concat(parts, axis=-1)
        self._cur_map = detection.detection_map(
            input, label, class_num, background_label=background_label,
            overlap_threshold=overlap_threshold,
            evaluate_difficult=evaluate_difficult, ap_version=ap_version,
        )
        # streaming state rides the jitted step like optimizer state
        self._accum_value = tensor.create_global_var(
            shape=[1], value=0.0, dtype="float32", persistable=True,
            name=unique_name.generate("map_accum_value"),
        )
        self._accum_count = tensor.create_global_var(
            shape=[1], value=0.0, dtype="float32", persistable=True,
            name=unique_name.generate("map_accum_count"),
        )
        block = self._cur_map.block
        new_value = elementwise_add(
            self._accum_value,
            tensor.cast(self._cur_map, "float32"),
        )
        one = tensor.fill_constant([1], "float32", 1.0)
        new_count = elementwise_add(self._accum_count, one)
        self._accum_map = elementwise_div(new_value, new_count)
        block.append_op(
            type="assign", inputs={"X": [new_value]},
            outputs={"Out": [self._accum_value]},
        )
        block.append_op(
            type="assign", inputs={"X": [new_count]},
            outputs={"Out": [self._accum_count]},
        )

    def get_map_var(self):
        return self._cur_map, self._accum_map

    def reset(self, executor, reset_program=None):
        from .executor import global_scope

        scope = global_scope()
        scope.update(self._accum_value.name,
                     np.zeros((1,), np.float32))
        scope.update(self._accum_count.name,
                     np.zeros((1,), np.float32))
