"""contrib.layers.metric_op (ref: contrib/layers/metric_op.py:27 —
ctr_metric_bundle). Port of paddle_tpu/fluid/contrib/layers/metric_op.py."""
from ...initializer import Constant
from ...layer_helper import LayerHelper
from ...layers import nn as L
from ...layers import ops as OPS
from ...layers import tensor as T

__all__ = ["ctr_metric_bundle"]


def ctr_metric_bundle(input, label):
    """Streaming CTR metric accumulators (ref metric_op.py:30): returns
    (local_sqrerr, local_abserr, local_prob, local_q) — persistable
    running sums a trainer divides by instance count (and all-reduces
    across workers first when distributed). The accumulators are
    written by ``assign``: persistable writes, which every run makes,
    fetched or not."""
    helper = LayerHelper("ctr_metric_bundle", **locals())

    def _state():
        v = helper.create_global_variable(
            persistable=True, dtype="float32", shape=[1])
        helper.set_variable_initializer(v, Constant(value=0.0))
        return v

    local_abserr, local_sqrerr = _state(), _state()
    local_prob, local_q = _state(), _state()

    flabel = T.cast(label, "float32")
    err = L.elementwise_sub(input, flabel)
    batch_abs = L.reduce_sum(OPS.abs(err))
    batch_sqr = L.reduce_sum(L.elementwise_mul(err, err))
    batch_prob = L.reduce_sum(input)
    # q-value: sum of p/(1-p) (the reference's sigmoid-odds statistic)
    one = T.fill_constant([1], "float32", 1.0)
    odds = L.elementwise_div(
        input,
        L.elementwise_max(L.elementwise_sub(one, input),
                          T.fill_constant([1], "float32", 1e-6)))
    batch_q = L.reduce_sum(odds)

    block = helper.main_program.current_block()
    for state, batch in ((local_abserr, batch_abs),
                        (local_sqrerr, batch_sqr),
                        (local_prob, batch_prob),
                        (local_q, batch_q)):
        new = L.elementwise_add(state, L.reshape(batch, [1]))
        block.append_op(type="assign", inputs={"X": [new]},
                        outputs={"Out": [state]})
    return local_sqrerr, local_abserr, local_prob, local_q
