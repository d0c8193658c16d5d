"""ModelRegistry: multiple named models, isolated scopes, atomic hot
reload.

Port of paddle_tpu/serving/registry.py. Each ``load(name, dirname)``
builds a fresh ``Predictor`` over the ``save_inference_model`` directory
— on the card unless ``predictor_opts={"place": CPUPlace()}`` says
otherwise — and the predictor loads its params
into a **private scope** (never the process-wide ``global_scope()``),
so two models with overlapping var names (every fc layer is ``fc_0.w``
somewhere) cannot clobber each other — wraps it in a pre-warmed
:class:`~paddle_tpu.serving.engine.ServingEngine`, and only then
publishes it under ``name`` with one dict assignment (the atomic
version swap). Reloading an already-published name builds and warms the
replacement **fully off to the side** while the old engine keeps
serving; after the swap the old engine drains in the background —
in-flight and queued requests on the old version complete, new requests
route to the new version. No request ever observes a half-loaded model.
"""
import threading

from .. import observability as obs
from .engine import ServingEngine

__all__ = ["ModelRegistry"]


class ModelRegistry:
    """name -> live ServingEngine, with versioned atomic swap.

    ::

        reg = ModelRegistry(max_batch_size=16, max_wait_ms=2.0)
        reg.load("bert", "/models/bert_v1",
                 buckets=[BucketSpec({"ids": (128,)},
                                     dtypes={"ids": "int32"})])
        out = reg.get("bert").predict({"ids": batch})
        reg.reload("bert", "/models/bert_v2")   # hot swap, zero downtime
    """

    def __init__(self, **engine_defaults):
        self._lock = threading.Lock()
        self._models = {}
        self._engine_defaults = dict(engine_defaults)

    def load(self, name, dirname, buckets=(), warm=True,
             predictor_opts=None, **engine_opts):
        """Load (or replace) model `name` from a save_inference_model
        directory and publish it atomically. Returns the live engine."""
        from ..fluid.inference import Predictor

        opts = dict(self._engine_defaults)
        opts.update(engine_opts)
        # every failure below happens BEFORE the publish swap: a build
        # or warmup error on the replacement leaves the currently-
        # published version serving untouched (no version limbo)
        predictor = Predictor.from_model(
            str(dirname), **dict(predictor_opts or {}))
        engine = ServingEngine(
            predictor, buckets=buckets, name=str(name), **opts)
        try:
            warm_report = engine.warmup() if warm else []
        except Exception:
            # don't leak the stillborn engine's dispatch thread
            engine.stop(drain=False, timeout=1.0)
            obs.event("model_load_failed", source="serving",
                      model=str(name), dirname=str(dirname))
            raise
        with self._lock:
            old = self._models.get(name)
            version = (old["version"] + 1) if old else 1
            self._models[name] = {
                "engine": engine, "dirname": str(dirname),
                "version": version, "buckets": tuple(buckets),
                "warm": bool(warm),
                "predictor_opts": dict(predictor_opts or {}),
                "engine_opts": dict(engine_opts),
            }
        obs.event("model_load", source="serving", model=str(name),
                  version=version, dirname=str(dirname),
                  warm_entries=len(warm_report))
        if old is not None:
            # the swap already happened; let the old version finish its
            # queue without blocking the loader
            threading.Thread(
                target=old["engine"].stop, kwargs={"drain": True},
                daemon=True,
                name="serving-drain-%s-v%d" % (name, old["version"]),
            ).start()
        return engine

    def publish(self, name, engine, dirname=None):
        """Publish a pre-built engine-like object — anything with the
        ServingEngine surface (``submit``/``predict``/``stats``/
        ``queue_depth``/``stop``), notably a
        :class:`~paddle_tpu_torch.serving.decode.DecodeEngine`, a
        :class:`~paddle_tpu_torch.serving.router.ServingRouter` fronting N
        replicas or a disaggregated
        :class:`~paddle_tpu_torch.serving.disagg.DisaggRouter` —
        under `name` with the same atomic-swap semantics as :meth:`load`.
        The registry does not build, warm, or reload it; lifecycle
        beyond the swap/drain belongs to the caller."""
        with self._lock:
            old = self._models.get(name)
            version = (old["version"] + 1) if old else 1
            self._models[name] = {
                "engine": engine, "dirname": str(dirname or ""),
                "version": version, "buckets": (), "warm": False,
                "predictor_opts": {}, "engine_opts": {},
                "published": True,
            }
        obs.event("model_publish", source="serving", model=str(name),
                  version=version,
                  engine_kind=type(engine).__name__)
        if old is not None:
            threading.Thread(
                target=old["engine"].stop, kwargs={"drain": True},
                daemon=True,
                name="serving-drain-%s-v%d" % (name, old["version"]),
            ).start()
        return engine

    def reload(self, name, dirname=None):
        """Hot-reload `name` — from a new directory when given, else
        re-reading the one it was loaded from — with the same buckets
        and engine options. Atomic swap; the old version drains."""
        with self._lock:
            cur = self._models.get(name)
        if cur is None:
            raise KeyError("no model %r loaded" % name)
        if cur.get("published"):
            raise ValueError(
                "model %r was publish()ed, not load()ed — reload it "
                "through its own surface (e.g. "
                "ServingRouter.rolling_reload)" % name)
        return self.load(
            name, dirname if dirname is not None else cur["dirname"],
            buckets=cur["buckets"], warm=cur["warm"],
            predictor_opts=cur["predictor_opts"], **cur["engine_opts"])

    def get(self, name):
        """The live engine for `name`, or None."""
        with self._lock:
            entry = self._models.get(name)
        return entry["engine"] if entry is not None else None

    def version(self, name):
        with self._lock:
            entry = self._models.get(name)
        return entry["version"] if entry is not None else None

    def names(self):
        with self._lock:
            return sorted(self._models)

    def info(self):
        """Per-model health snapshot (the /healthz payload). Engines
        that expose ``reuse_info()`` (a DecodeEngine with a draft
        model, prefix pool, or session tier attached — or a disagg
        router aggregating them) get a ``reuse`` block: draft
        attachment, speculation acceptance, pool hit/miss/evict
        counters, and the redundant-prefill savings."""
        with self._lock:
            entries = dict(self._models)
        out = {}
        for name, e in entries.items():
            doc = {
                "version": e["version"],
                "dirname": e["dirname"],
                "kind": getattr(e["engine"], "engine_kind", "predict"),
                "queue_depth": e["engine"].queue_depth(),
                "stats": e["engine"].stats(),
            }
            reuse = getattr(e["engine"], "reuse_info", None)
            if callable(reuse):
                doc["reuse"] = reuse()
            index = getattr(e["engine"], "index_info", None)
            if callable(index):
                # retrieval engines: the served index's geometry (rows,
                # dim, shards, resident bytes) next to the queue stats
                doc["index"] = index()
            out[name] = doc
        return out

    def unload(self, name, drain=True):
        """Remove `name`; its engine stops (draining by default)."""
        with self._lock:
            entry = self._models.pop(name, None)
        if entry is None:
            raise KeyError("no model %r loaded" % name)
        entry["engine"].stop(drain=drain)
        obs.event("model_unload", source="serving", count=False,
                  model=str(name), version=entry["version"])

    def close(self, drain=True):
        """Stop every engine (graceful drain by default)."""
        with self._lock:
            entries = list(self._models.values())
            self._models.clear()
        for e in entries:
            e["engine"].stop(drain=drain)
