"""Recurrent layers (ref: python/paddle/fluid/layers/rnn.py); port of the
``gather_tree`` layer of paddle_tpu/fluid/layers/rnn.py. The ``lstm``,
``gru``, ``beam_search`` and ``beam_search_decode`` layers come with the
RNN slice of paddle_tpu_torch (ROADMAP.md Queue 1, item 6.4)."""
from ..layer_helper import LayerHelper

__all__ = ["gather_tree"]


def gather_tree(ids, parents):
    """Beam-search backtrace (ref operators/gather_tree_op.cc): ids and
    parents are (max_time, batch, beam); returns the full predicted
    sequences re-chained through the parent pointers."""
    helper = LayerHelper("gather_tree", **locals())
    out = helper.create_variable_for_type_inference(ids.dtype)
    out.shape = ids.shape
    helper.append_op(
        type="gather_tree",
        inputs={"Ids": [ids], "Parents": [parents]},
        outputs={"Out": [out]},
    )
    return out
