"""Speculative decoding: a small draft model proposes, the target
verifies a whole block in one step (port of paddle_tpu/serving/spec.py).

Non-speculative decode pays one full target-model dispatch per token.
Speculation breaks that coupling: a cheap draft model (same tokenizer/
vocab, a fraction of the layers/width) runs ``k`` sequential steps to
propose ``k`` tokens, then the target scores the whole candidate block
``[current, d1..dk]`` in ONE batched program
(:func:`~paddle_tpu_torch.models.gpt.build_gpt_verify_block`) and accepts
the longest prefix that matches its own greedy picks. Every emitted
token is the TARGET's greedy argmax — the draft only chooses how many
of them one dispatch yields — so continuations equal non-speculative
decode wherever the verify block's logits round as the step's do; a
useless draft costs speed, never correctness. Acceptance rate (accepted
draft tokens / proposed) is the economics dial, exported as
``serving.spec.accept_rate``.

:class:`DraftModel` owns the draft's programs and its own slot-shaped
KV buffers on the engine's device, kept row-aligned with the target
engine's slots: admission prefills the draft cache from the same token
history, each propose round advances it alongside the target, and
single-token fallback steps (cache-edge headroom) mirror into it via
:meth:`sync_step`, so draft rows never hole. The draft is fp32-resident
(it is small; int8 residency would only dent its accuracy).

Per-round cost: ``k + 1`` draft dispatches (the +1 backfills the row
of the last proposal so a fully-accepted block leaves no gap) plus one
target verify dispatch — profitable whenever the draft step is much
cheaper than the target step and acceptance is decent.
"""
import numpy as np
import torch

__all__ = ["DraftModel"]


class DraftModel:
    """Draft-model sidecar for a :class:`~paddle_tpu_torch.serving.decode.
    DecodeEngine` (``DecodeEngine(..., draft=DraftModel(dcfg, dscope,
    k=4))``).

    ``cfg``/``scope`` are the draft's own config and trained params —
    ``cfg.vocab`` must match the target's (same token ids) and
    ``cfg.max_len`` must cover the engine's ``cache_len``. ``k`` is
    the proposals per round; the verify block is ``k + 1`` wide. The
    params are read by name, so an early-exit draft
    (``GPTConfig(num_layers=2)`` on the target's own scope) needs no
    second weight set. The draft runs on the engine's place.
    """

    def __init__(self, cfg, scope, k=4, name="draft"):
        self.cfg = cfg
        self.k = int(k)
        self.name = str(name)
        if self.k < 1:
            raise ValueError("draft k must be >= 1, got %d" % self.k)
        self._scope = scope
        self._engine = None
        self._params = None
        self._step_pred = None
        self._prefill_preds = {}
        self._buckets = ()
        self._k_buf = self._v_buf = None
        self.slots = 0
        self.cache_len = 0

    # -- wiring ----------------------------------------------------------
    def bind(self, engine):
        """Build the draft's step + prefill programs and slot buffers
        against ``engine``'s geometry, on its place. Called by the
        engine's constructor; idempotent per engine."""
        from .. import fluid
        from ..fluid.inference import Predictor
        from ..models.gpt import build_gpt_decode_step, build_gpt_prefill
        from .decode import _snapshot, default_prompt_buckets

        if self._engine is engine:
            return self
        if self._engine is not None:
            raise RuntimeError(
                "draft %r is already bound to engine %r — one draft "
                "per engine (it mirrors that engine's slots)"
                % (self.name, self._engine.name))
        if self.cfg.vocab != engine.cfg.vocab:
            raise ValueError(
                "draft vocab %d != target vocab %d — speculation needs "
                "a shared token space"
                % (self.cfg.vocab, engine.cfg.vocab))
        if engine.cache_len > self.cfg.max_len:
            raise ValueError(
                "engine cache_len %d exceeds draft max_len %d"
                % (engine.cache_len, self.cfg.max_len))
        slots, cache_len = engine.slots, engine.cache_len
        # the draft prefill ladder must cover ANY live token history
        # (sessions outgrow the prompt buckets), so merge the engine's
        # buckets with a pow2 ladder up to cache_len
        buckets = tuple(sorted(
            set(engine.prompt_buckets)
            | set(default_prompt_buckets(cache_len))))
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            sv = build_gpt_decode_step(self.cfg, cache_len)
            step_prog = fluid.default_main_program()
        prefill = {}
        for b in buckets:
            with fluid.program_guard(fluid.Program(), fluid.Program()):
                pv = build_gpt_prefill(self.cfg, b, cache_len)
                prefill[b] = (fluid.default_main_program(), pv)
        persist = {}
        for prog in [step_prog] + [p for p, _ in prefill.values()]:
            for v in prog.list_vars():
                if not getattr(v, "persistable", False) \
                        or v.name in persist:
                    continue
                if v.name not in self._scope:
                    raise KeyError(
                        "param %r required by the draft programs is "
                        "missing from the draft scope" % v.name)
                persist[v.name] = _snapshot(self._scope[v.name],
                                            engine.device)
        self._engine = engine
        self.slots = slots
        self.cache_len = cache_len
        self._buckets = buckets
        self._params = persist
        self._step_pred = Predictor(
            step_prog, sv["feed_names"], sv["fetch_vars"], scope=persist,
            place=engine.place)
        for b, (prog, pv) in prefill.items():
            self._prefill_preds[b] = Predictor(
                prog, pv["feed_names"], pv["fetch_vars"], scope=persist,
                place=engine.place)
        shape = (slots, self.cfg.num_layers, cache_len, self.cfg.hidden)
        self._k_buf = torch.zeros(shape, dtype=torch.float32,
                                  device=engine.device)
        self._v_buf = torch.zeros(shape, dtype=torch.float32,
                                  device=engine.device)
        return self

    def warmup(self):
        """Run every draft program once (the first launch builds the
        CUDA kernels) on zero caches, without touching the slot
        buffers; returns the per-program report rows."""
        report = []
        source = self._step_pred.warm({
            "gpt_step_tok": np.zeros((self.slots, 1), np.int64),
            "gpt_step_pos": np.zeros((self.slots, 1), np.int64),
            "gpt_step_k": torch.zeros_like(self._k_buf),
            "gpt_step_v": torch.zeros_like(self._v_buf)})
        report.append({"program": "draft_step", "k": self.k,
                       "source": source})
        for b in sorted(self._prefill_preds):
            source = self._prefill_preds[b].warm({
                "gpt_prefill_ids": np.zeros((1, b), np.int64),
                "gpt_prefill_len": np.ones((1, 1), np.int64)})
            report.append({"program": "draft_prefill", "bucket": b,
                           "source": source})
        return report

    # -- slot mirroring --------------------------------------------------
    def prefill_slot(self, slot, tokens):
        """Prefill the draft's cache rows for ``slot`` from the full
        token history whose rows the TARGET slot holds (prompt, or
        prompt + generated for adopted/resumed sessions)."""
        tokens = np.asarray(tokens, np.int64).reshape(-1)
        n = int(tokens.size)
        bucket = next((b for b in self._buckets if b >= n), None)
        if bucket is None:
            raise ValueError(
                "draft history %d exceeds the draft ladder (max %d)"
                % (n, self._buckets[-1]))
        ids = np.zeros((1, bucket), np.int64)
        ids[0, :n] = tokens
        _nxt, k1, v1 = self._prefill_preds[bucket].run(
            {"gpt_prefill_ids": ids,
             "gpt_prefill_len": np.asarray([[n]], np.int64)},
            return_numpy=False)
        # one slot's rows replaced in place (the reference's donated
        # dynamic_update_slice)
        with torch.inference_mode():
            self._k_buf[slot].copy_(k1[0])
            self._v_buf[slot].copy_(v1[0])

    def _step(self, tok, pos):
        # the step is functional: its output caches replace the buffers,
        # which is the state the reference's donated buffers are left in
        nxt, self._k_buf, self._v_buf = self._step_pred.run(
            {"gpt_step_tok": tok, "gpt_step_pos": pos,
             "gpt_step_k": self._k_buf, "gpt_step_v": self._v_buf},
            return_numpy=False)
        return nxt.cpu().numpy()

    def propose(self, tok, pos):
        """One speculation round from the target's ``(tok, pos)`` slot
        arrays: ``k + 1`` sequential draft steps — the first ``k``
        yield proposals (S, k), the last backfills the final
        proposal's cache row so a fully-accepted block leaves the
        draft cache gapless. Caller guarantees ``pos + k + 1 <=
        cache_len`` for live rows."""
        t = np.asarray(tok, np.int64).copy()
        p = np.asarray(pos, np.int64).copy()
        out = np.zeros((t.shape[0], self.k), np.int64)
        for j in range(self.k + 1):
            nxt = self._step(t, p)
            if j < self.k:
                out[:, j] = nxt[:, 0]
            t = nxt.astype(np.int64)
            p = p + 1
        return out

    def sync_step(self, tok, pos):
        """Mirror a non-speculative (fallback) target step: write the
        consumed token's row into the draft cache so later rounds see
        a complete history. The draft's own proposal is discarded."""
        self._step(np.asarray(tok, np.int64), np.asarray(pos, np.int64))

    # -- introspection ---------------------------------------------------
    def resident_bytes(self):
        """Device bytes of the draft's params + slot buffer pair."""
        n = 0
        if self._params:
            n += sum(t.numel() * t.element_size()
                     for t in self._params.values())
        if self._k_buf is not None:
            n += 2 * self._k_buf.numel() * 4
        return n

    def info(self):
        return {"name": self.name, "k": self.k,
                "vocab": self.cfg.vocab, "hidden": self.cfg.hidden,
                "num_layers": self.cfg.num_layers,
                "resident_bytes": self.resident_bytes(),
                "buckets": list(self._buckets)}
