"""The CRF and CTC-decode op lowerings against the JAX package, and the
reference's CRF tests run against the port, on the CPU.

- ``linear_chain_crf``, ``crf_decoding``, ``chunk_eval`` and
  ``ctc_greedy_decoder`` (``paddle_tpu/ops/crf_ops.py``): each port
  lowering against the JAX lowering on the same seeded numpy inputs and
  attrs, by tests/test_torch_detection.py's rule (integers equal, int64
  where jax gives int32; floats within 1e-6 of the largest value), with
  and without lengths; ``linear_chain_crf``'s gradient in Emission and
  Transition through torch.autograd against jax.vjp, within 1e-5 of the
  largest. ``chunk_eval`` under each of its four schemes (IOB, IOE,
  IOBES, plain), with excluded chunk types; ``ctc_greedy_decoder`` with
  and without ``InputLength``, and on a 2-D input.
- tests/test_crf_ctc.py's numpy oracles (the forward algorithm, Viterbi,
  chunk counts, CTC merging) run against the port: the module is loaded
  afresh with its ``fluid`` and ``global_scope`` bound to the port's
  (tests/test_torch_rcnn.py's ``reference_tests``). Left out: its
  ``warpctc`` test (``misc_ops``, Queue 1 item 6.7).
"""
import numpy as np
import pytest

from paddle_tpu_torch.fluid import executor as pt_executor
from paddle_tpu_torch.fluid import framework as pt_framework
from paddle_tpu_torch.fluid import unique_name as pt_unique_name
from test_torch_detection import _rand, _run_both, check
from test_torch_rcnn import reference_tests

CRF_OPS = ("linear_chain_crf", "crf_decoding", "chunk_eval",
           "ctc_greedy_decoder")


@pytest.fixture(autouse=True)
def _fresh_port_state():
    """Fresh default programs, name generator and scope of the port."""
    old_main = pt_framework.switch_main_program(pt_framework.Program())
    old_startup = pt_framework.switch_startup_program(pt_framework.Program())
    old_gen = pt_unique_name.switch()
    old_scopes = pt_executor._scope_stack[:]
    pt_executor._scope_stack[:] = [pt_executor.Scope()]
    yield
    pt_framework.switch_main_program(old_main)
    pt_framework.switch_startup_program(old_startup)
    pt_unique_name.switch(old_gen)
    pt_executor._scope_stack[:] = old_scopes


def _ints(*shape, hi=5, seed=0):
    return np.random.default_rng(seed).integers(0, hi, size=shape).astype(
        np.int64)


B, T, D = 4, 7, 5
LENS = np.array([7, 3, 0, 5], np.int64)


def _crf_ins(lens=True, label=True):
    ins = {"Emission": [_rand(B, T, D, seed=1)],
           "Transition": [0.5 * _rand(D + 2, D, seed=2)]}
    if label:
        ins["Label"] = [_ints(B, T, hi=D, seed=3)]
    if lens:
        ins["Length"] = [LENS.reshape(B, 1)]
    return ins


def _ctc_probs(seed=4):
    x = _rand(3, 9, 4, seed=seed)
    x[0, 2:5] = x[0, 2:5] + 9 * (np.arange(4) == 2)   # repeats to merge
    x[1, :, 0] += 2.0                                  # blanks to drop
    return x


def _case(name):
    """(op, ins, attrs, differentiable input slots, output slot)."""
    labels = _ints(3, 12, hi=9, seed=5)
    infer = np.where(_ints(3, 12, hi=3, seed=6) == 0,
                     _ints(3, 12, hi=9, seed=7), labels)
    chunk = {"Inference": [infer], "Label": [labels],
             "SeqLength": [np.array([12, 8, 5], np.int64)]}
    return {
        "crf": ("linear_chain_crf", _crf_ins(), {},
                ["Emission", "Transition"], "LogLikelihood"),
        "crf_no_lengths": ("linear_chain_crf", _crf_ins(lens=False), {},
                           ["Emission", "Transition"], "LogLikelihood"),
        "crf_2d": ("linear_chain_crf",
                   {"Emission": [_rand(T, D, seed=1)],
                    "Transition": [_rand(D + 2, D, seed=2)],
                    "Label": [_ints(T, 1, hi=D, seed=3)]}, {},
                   ["Emission", "Transition"], "LogLikelihood"),
        "decode": ("crf_decoding", _crf_ins(label=False), {}, [],
                   "ViterbiPath"),
        "decode_no_lengths": ("crf_decoding",
                              _crf_ins(lens=False, label=False), {}, [],
                              "ViterbiPath"),
        "decode_label": ("crf_decoding", _crf_ins(), {}, [], "ViterbiPath"),
        "chunk_iob": ("chunk_eval", chunk,
                      {"chunk_scheme": "IOB", "num_chunk_types": 4}, [],
                      "F1-Score"),
        "chunk_ioe": ("chunk_eval", chunk,
                      {"chunk_scheme": "IOE", "num_chunk_types": 4,
                       "excluded_chunk_types": [1]}, [], "F1-Score"),
        "chunk_iobes": ("chunk_eval", chunk,
                        {"chunk_scheme": "IOBES", "num_chunk_types": 2}, [],
                        "F1-Score"),
        "chunk_plain": ("chunk_eval",
                        {"Inference": [infer[..., None]],
                         "Label": [labels[..., None]]},
                        {"chunk_scheme": "plain", "num_chunk_types": 8,
                         "excluded_chunk_types": [0, 3]}, [], "F1-Score"),
        "ctc": ("ctc_greedy_decoder", {"Input": [_ctc_probs()]},
                {"blank": 0, "padding_value": -1}, [], "Out"),
        "ctc_lengths": ("ctc_greedy_decoder",
                        {"Input": [_ctc_probs()],
                         "InputLength": [np.array([[9], [4], [0]],
                                                  np.int32)]},
                        {"blank": 3}, [], "Out"),
        "ctc_2d": ("ctc_greedy_decoder", {"Input": [_ctc_probs()[0]]},
                   {"blank": 1}, [], "Out"),
    }[name]


CASES = ("crf", "crf_no_lengths", "crf_2d", "decode", "decode_no_lengths",
         "decode_label", "chunk_iob", "chunk_ioe", "chunk_iobes",
         "chunk_plain", "ctc", "ctc_lengths", "ctc_2d")


@pytest.mark.parametrize("case", CASES)
def test_lowering_matches_jax(case):
    check(*_case(case))


def test_every_crf_op_is_covered():
    assert {_case(c)[0] for c in CASES} == set(CRF_OPS)


def test_chunk_eval_counts_are_int64_and_nonzero():
    got, _ = _run_both(*_case("chunk_iob")[:3])
    for slot in ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks"):
        assert got[slot][0].dtype == np.int64 and got[slot][0][0] > 0


CRF_TESTS = (
    ("TestLinearChainCRF", "test_matches_oracle"),
    ("TestLinearChainCRF", "test_grad_flows_and_model_trains"),
    ("TestCRFDecoding", "test_matches_viterbi_oracle"),
    ("TestCRFDecoding", "test_label_mode_correctness_indicator"),
    ("TestChunkEval", "test_iob_exact"),
    ("TestChunkEval", "test_perfect_match_and_padding"),
    ("TestChunkEval", "test_excluded_types"),
    ("TestChunkEval", "test_plain_scheme"),
    ("TestCTCGreedyDecoder", "test_decode_merge_and_blank"),
    ("TestCTCGreedyDecoder", "test_input_length"))


@pytest.mark.parametrize("cls,test", CRF_TESTS,
                         ids=["%s.%s" % t for t in CRF_TESTS])
def test_reference_crf_test_passes_on_the_port(cls, test):
    mod = reference_tests("test_crf_ctc")
    getattr(getattr(mod, cls)(), test)()
