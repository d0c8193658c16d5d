"""Stdlib HTTP/JSON frontend over a ModelRegistry.

Port of paddle_tpu/serving/http.py: the same endpoints, bodies, statuses
and headers, so a client (or bench.py's serving lanes) talks to either
package alike. Handler threads do JSON and numpy only; the engines'
dispatch threads are the only ones that touch the card.

Endpoints (``http.server.ThreadingHTTPServer`` — one thread per
connection blocks on its request's future while the single dispatch
thread per model does the batching):

- ``POST /v1/models/<name>:predict`` — body
  ``{"feeds": {"x": [[...]]}, "dtypes": {"x": "float32"}?,
  "deadline_ms": 50?, "timeout_s": 10?}``; replies
  ``{"outputs": [{"data": ..., "shape": ..., "dtype": ...}]}``.
  Feed dtypes default to the model's declared var dtypes (ints arriving
  as JSON numbers coerce to the program's int32/int64), so a plain
  nested-list payload round-trips bit-exact for float32 models.
- ``POST /v1/models/<name>:generate`` — decode engines only
  (:class:`~paddle_tpu_torch.serving.decode.DecodeEngine` or a
  :class:`~paddle_tpu_torch.serving.disagg.DisaggRouter` published into
  the registry). Body ``{"prompt": [ids], "max_new_tokens": 32?,
  "eos_id": 2?, "deadline_ms": 50?, "timeout_s": 10?, "stream": true?,
  "tenant": "chat"?, "priority": "interactive"|0..2?}`` — ``tenant``
  must be a non-empty string and ``priority`` an int 0..2 or a named
  class (400 otherwise); both feed the disagg fleet's multi-tenant
  admission and are harmless on a lone engine.
  With ``stream`` (the default) the reply is **chunked
  transfer-encoding** (HTTP/1.1), one JSON line per token flushed as
  the engine's step loop produces it — ``{"token": 7, "index": 0}`` —
  closed by a ``{"done": true, "finish_reason": ..., "tokens": [...]}``
  line. The response headers are only sent once the FIRST token (or
  failure) is known, so queue-time errors still map to real statuses;
  a client disconnect mid-stream cancels the request and frees its
  engine slot at the next dispatch iteration. ``"stream": false``
  returns one aggregate JSON document.
- ``POST /v1/models/<name>:lookup`` / ``:search`` — retrieval engines
  only (the retrieval engine comes with ROADMAP.md Queue 1 item 10; until
  then every engine answers these verbs 400 wrong-kind).
  ``:lookup`` body ``{"ids": [3, 14, 159], "deadline_ms": 50?,
  "timeout_s": 10?}`` replies ``{"embeddings": [[...]], "shape": ...,
  "dtype": ...}`` — rows bit-identical to the sharded table's gather.
  ``:search`` body ``{"query": [[...]], "k": 10?}`` replies
  ``{"ids": [[...]], "scores": [[...]], "k": 10}`` — exact brute-force
  top-k per query row. Posting any verb to a mismatched engine kind
  answers 400 with the model's actual kind (and the verb it speaks)
  named in the body.
- ``GET /healthz`` — ``{"status": "ok", "models": {...}}`` with
  per-model kind, version, queue depth, lifetime counters, and (for
  retrieval engines) the index block: rows, dim, shards, resident
  bytes.
- ``GET /metrics`` — the telemetry hub's Prometheus text
  (``render_prom()``): serving histograms with p50/p90/p99 quantiles,
  shed/deadline-miss counters, queue-depth gauges.

Status mapping (the admission-control surface): 429 shed (queue full —
the JSON body names the shedding model + replica and the response
carries a ``Retry-After`` header derived from the engine's observed
queue drain rate), 504 deadline missed or wait timeout, 503
draining/stopped or a replica fleet with zero live replicas, 404
unknown model, 400 malformed request. Both ``:predict`` and the
``:generate`` streaming path carry ``Retry-After`` on 429 AND 503 —
a draining engine and a zero-replica fleet are as retryable as a full
queue.

Standalone entry point (serves on the card)::

    python -m paddle_tpu_torch.serving.http --model mnist=/models/mnist \
        --port 8500 --max-batch-size 16 --max-wait-ms 2
"""
import json
import re
import threading
import time
from concurrent.futures import TimeoutError as _FutureTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import observability as obs
from .engine import DeadlineExceededError, EngineClosedError, ShedError

__all__ = ["ServingHandler", "ServingServer", "main"]

_PREDICT_RE = re.compile(r"^/v1/models/([^/:]+):predict$")
_GENERATE_RE = re.compile(r"^/v1/models/([^/:]+):generate$")
_LOOKUP_RE = re.compile(r"^/v1/models/([^/:]+):lookup$")
_SEARCH_RE = re.compile(r"^/v1/models/([^/:]+):search$")

_VERB_FOR_KIND = {"predict": ":predict", "decode": ":generate",
                  "retrieval": ":lookup or :search"}


def _kind_of(engine):
    return getattr(engine, "engine_kind", "predict")


def _wrong_kind_doc(name, engine, wanted):
    """400 body naming the engine's actual kind and the verb it speaks,
    so a misrouted client learns where to go instead of guessing."""
    kind = _kind_of(engine)
    return {
        "error": "model %r is a %r engine, not %r — use %s"
                 % (name, kind, wanted,
                    _VERB_FOR_KIND.get(kind, ":predict")),
        "model": name, "kind": kind,
    }


class ServingHandler(BaseHTTPRequestHandler):
    server_version = "paddle-tpu-serving/0.1"
    # chunked transfer-encoding (the :generate stream) needs HTTP/1.1;
    # every other response carries Content-Length so keep-alive is safe
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 — stdlib signature
        pass  # request logging goes through the telemetry hub, not stderr

    def _send_json(self, code, doc, headers=None):
        body = json.dumps(doc).encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    @staticmethod
    def _shed_doc(e, name, engine):
        """429 body: who shed (model + replica), so a client/router tier
        above can steer, not just back off."""
        return {
            "error": str(e),
            "model": getattr(e, "model", None) or name,
            "replica": getattr(e, "replica", None),
            "retry_after_s": getattr(e, "retry_after", None),
        }

    @staticmethod
    def _shed_headers(e, engine):
        """Retry-After derived from the shedding engine's queue drain
        rate (whole seconds, >= 1 per RFC 9110)."""
        hint = getattr(e, "retry_after", None)
        if hint is None:
            hinter = getattr(engine, "retry_after_hint", None)
            hint = hinter() if hinter is not None else None
        seconds = max(1, int(-(-float(hint) // 1))) if hint else 1
        return {"Retry-After": str(seconds)}

    def _fleet_prom(self):
        """Federated ``scope=fleet`` exposition: every published engine
        that aggregates a fleet (``fleet_render_prom``) contributes its
        merged view; a registry with only lone engines answers with the
        process hub so the page is never empty."""
        parts = []
        registry = self.server.registry
        for name in sorted(registry.info()):
            engine = registry.get(name)
            render = getattr(engine, "fleet_render_prom", None)
            if render is None:
                continue
            try:
                parts.append(render())
            except Exception:  # noqa: BLE001 — metrics must not 500
                continue
        return "".join(parts) or obs.render_prom()

    def do_GET(self):  # noqa: N802 — stdlib handler name
        path, _, query = self.path.partition("?")
        if path == "/healthz":
            self._send_json(200, {
                "status": "ok",
                "models": self.server.registry.info(),
            })
        elif path == "/metrics":
            from urllib.parse import parse_qs

            scope = (parse_qs(query).get("scope") or ["process"])[0]
            text = (self._fleet_prom() if scope == "fleet"
                    else obs.render_prom())
            body = text.encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._send_json(404, {"error": "not found: %s" % self.path})

    # -- decode streaming (:generate) -----------------------------------
    def _chunk(self, doc):
        """One chunked-transfer frame holding a JSON line, flushed so
        the client sees each token as the step loop emits it."""
        data = (json.dumps(doc) + "\n").encode("utf-8")
        self.wfile.write(b"%X\r\n" % len(data) + data + b"\r\n")
        self.wfile.flush()

    def _generate_errdoc(self, exc, name, engine):
        """(status, doc, headers) for a pre-stream generate failure.
        429 AND 503 both carry Retry-After: a draining engine or a
        zero-replica fleet is as retryable as a full queue."""
        if isinstance(exc, ShedError):
            return (429, self._shed_doc(exc, name, engine),
                    self._shed_headers(exc, engine))
        if isinstance(exc, DeadlineExceededError):
            return 504, {"error": str(exc), "model": name}, None
        if isinstance(exc, EngineClosedError):
            return (503, {"error": str(exc), "model": name},
                    self._shed_headers(exc, engine))
        if isinstance(exc, (TimeoutError, _FutureTimeout)):
            return (504, {"error": "timed out waiting for model %r"
                          % name, "model": name}, None)
        if type(exc).__name__ == "NoReplicasError":
            # fleet with zero live replicas: unavailable, not internal
            # (matched by name to avoid importing the router here)
            return (503, {"error": str(exc), "model": name},
                    self._shed_headers(exc, engine))
        return (500, {"error": "%s: %s" % (type(exc).__name__, exc),
                      "model": name}, None)

    @staticmethod
    def _parse_tenant_priority(body):
        """Validate the multi-tenant request fields; raises ValueError
        (400 upstream) on malformed values. Returns kwargs to forward
        only when the fields are present, so engines that predate them
        keep working."""
        kw = {}
        if "tenant" in body:
            tenant = body["tenant"]
            if not isinstance(tenant, str) or not tenant.strip():
                raise ValueError(
                    "tenant must be a non-empty string, got %r"
                    % (tenant,))
            kw["tenant"] = tenant.strip()
        if "priority" in body and body["priority"] is not None:
            from .disagg.tenancy import resolve_priority

            resolve_priority(body["priority"])  # raises on malformed
            kw["priority"] = body["priority"]
        return kw

    def _trace_ctx(self, body=None):
        """TraceContext for this request: an incoming W3C
        ``traceparent`` header wins (distributed callers pick the
        sampling bit); ``"trace": true`` in the body forces a fresh
        sampled context; otherwise the deterministic stride sampler
        over ``$PADDLE_TPU_TRACE_SAMPLE`` decides."""
        ctx = obs.TraceContext.from_header(
            self.headers.get("traceparent"))
        if ctx is not None:
            return ctx if ctx.sampled else None
        if body and body.get("trace") and obs.trace_dir() is not None:
            return obs.TraceContext.new()
        return obs.sample_request()

    def _do_generate(self, name, engine):
        if _kind_of(engine) != "decode":
            return self._send_json(
                400, _wrong_kind_doc(name, engine, "decode"))
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
            prompt = body["prompt"]
            kw = {"max_new": body.get("max_new_tokens"),
                  "eos_id": body.get("eos_id"),
                  "deadline_ms": body.get("deadline_ms")}
            if body.get("session") is not None:
                # resumable-conversation id (engines with a session
                # tier hibernate/adopt KV under it); forwarded only
                # when present so engines that predate it keep working
                session = body["session"]
                if not isinstance(session, str) or not session.strip():
                    raise ValueError(
                        "session must be a non-empty string, got %r"
                        % (session,))
                kw["session"] = session.strip()
            kw.update(self._parse_tenant_priority(body))
            timeout_s = body.get("timeout_s")
            stream = bool(body.get("stream", True))
        except (ValueError, KeyError, TypeError) as e:
            return self._send_json(
                400, {"error": "bad request: %s: %s"
                               % (type(e).__name__, e)})
        tctx = self._trace_ctx(body)
        t_req = time.time() if tctx is not None else None
        if tctx is not None:
            kw["trace_ctx"] = tctx
        try:
            handle = engine.submit(prompt, **kw)
        except (ValueError, TypeError) as e:
            return self._send_json(
                400, {"error": "bad request: %s: %s"
                               % (type(e).__name__, e)})
        except Exception as e:  # noqa: BLE001 — admission errors -> statuses
            return self._send_json(*self._generate_errdoc(e, name, engine))

        if not stream:
            try:
                toks = handle.result(timeout_s)
            except Exception as e:  # noqa: BLE001
                return self._send_json(
                    *self._generate_errdoc(e, name, engine))
            if tctx is not None:
                obs.export_span(
                    "http.generate", tctx, t_req, time.time() - t_req,
                    {"proc": "http", "model": name,
                     "tokens": len(toks)})
            return self._send_json(200, {
                "tokens": toks, "n_tokens": len(toks),
                "finish_reason": handle.finish_reason, "model": name,
                "trace_id": tctx.trace_id if tctx is not None
                else None})

        # hold the headers until the first token (or failure) exists:
        # a request shed/expired in the queue must answer 429/504, not
        # a 200 that dies mid-stream
        gen = handle.tokens(timeout=timeout_s)
        try:
            first = next(gen, None)
        except Exception as e:  # noqa: BLE001
            handle.cancel()
            return self._send_json(*self._generate_errdoc(e, name, engine))
        self.send_response(200)
        self.send_header("Content-Type", "application/jsonl")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        try:
            try:
                if first is not None:
                    self._chunk({"token": first, "index": 0})
                    for i, tok in enumerate(gen, start=1):
                        self._chunk({"token": tok, "index": i})
                toks = handle.so_far()
                done = {"done": True,
                        "finish_reason": handle.finish_reason,
                        "tokens": toks, "n_tokens": len(toks)}
                if tctx is not None:
                    done["trace_id"] = tctx.trace_id
                self._chunk(done)
            except (BrokenPipeError, ConnectionResetError):
                # client went away: free the slot at the next dispatch
                # iteration instead of decoding to nobody
                handle.cancel()
                obs.event("client_disconnect", source="serving",
                          model=name, streamed=len(handle.so_far()))
                self.close_connection = True
                return
            except Exception as e:  # noqa: BLE001 — mid-stream engine error
                self._chunk({"error": "%s: %s" % (type(e).__name__, e),
                             "done": True, "finish_reason": "error"})
                return
        finally:
            if not handle.done:
                handle.cancel()
            if tctx is not None:
                obs.export_span(
                    "http.generate", tctx, t_req, time.time() - t_req,
                    {"proc": "http", "model": name,
                     "tokens": len(handle.so_far())})
            try:
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True

    # -- retrieval (:lookup / :search) -----------------------------------
    def _do_retrieval(self, name, engine, op):
        """``:lookup`` (``{"ids": [...]}`` -> embedding rows) and
        ``:search`` (``{"query": [[...]], "k": 10?}`` -> top-k ids +
        scores) against a retrieval engine; same status mapping as
        ``:predict`` (429 shed + Retry-After, 504 deadline/timeout,
        503 draining, 400 malformed)."""
        if _kind_of(engine) != "retrieval":
            return self._send_json(
                400, _wrong_kind_doc(name, engine, "retrieval"))
        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
            if op == "lookup":
                feeds = {"op": "lookup", "ids": body["ids"]}
            else:
                feeds = {"op": "search", "query": body["query"],
                         "k": body.get("k")}
            deadline_ms = body.get("deadline_ms")
            timeout_s = body.get("timeout_s")
        except (ValueError, KeyError, TypeError) as e:
            return self._send_json(
                400, {"error": "bad request: %s: %s"
                               % (type(e).__name__, e)})
        tctx = self._trace_ctx(body)
        t_req = time.time() if tctx is not None else None
        try:
            fut = engine.submit(feeds, deadline_ms=deadline_ms,
                                trace_ctx=tctx)
        except ShedError as e:
            return self._send_json(429, self._shed_doc(e, name, engine),
                                   headers=self._shed_headers(e, engine))
        except EngineClosedError as e:
            return self._send_json(503, {"error": str(e), "model": name})
        except (ValueError, KeyError, TypeError) as e:
            return self._send_json(
                400, {"error": "bad request: %s: %s"
                               % (type(e).__name__, e)})
        try:
            out = fut.result(
                timeout_s if timeout_s is not None
                else engine.request_timeout_s)
        except DeadlineExceededError as e:
            return self._send_json(504, {"error": str(e), "model": name})
        except ShedError as e:
            return self._send_json(429, self._shed_doc(e, name, engine),
                                   headers=self._shed_headers(e, engine))
        except _FutureTimeout:
            return self._send_json(
                504, {"error": "timed out waiting for model %r" % name,
                      "model": name})
        except EngineClosedError as e:
            return self._send_json(503, {"error": str(e), "model": name})
        except Exception as e:  # noqa: BLE001 — engine errors -> 500
            if type(e).__name__ == "NoReplicasError":
                return self._send_json(
                    503, {"error": str(e), "model": name})
            return self._send_json(
                500, {"error": "%s: %s" % (type(e).__name__, e)})
        if tctx is not None:
            obs.export_span(
                "http.%s" % op, tctx, t_req, time.time() - t_req,
                {"proc": "http", "model": name})
        if op == "lookup":
            emb = out["embeddings"]
            doc = {"embeddings": emb.tolist(),
                   "shape": list(emb.shape), "dtype": str(emb.dtype),
                   "model": name}
        else:
            doc = {"ids": out["ids"].tolist(),
                   "scores": out["scores"].tolist(),
                   "k": int(out["ids"].shape[-1]), "model": name}
        if tctx is not None:
            doc["trace_id"] = tctx.trace_id
        self._send_json(200, doc)

    def do_POST(self):  # noqa: N802 — stdlib handler name
        g = _GENERATE_RE.match(self.path)
        if g:
            name = g.group(1)
            engine = self.server.registry.get(name)
            if engine is None:
                return self._send_json(
                    404, {"error": "unknown model %r" % name})
            return self._do_generate(name, engine)
        for op, rx in (("lookup", _LOOKUP_RE), ("search", _SEARCH_RE)):
            r = rx.match(self.path)
            if r:
                name = r.group(1)
                engine = self.server.registry.get(name)
                if engine is None:
                    return self._send_json(
                        404, {"error": "unknown model %r" % name})
                return self._do_retrieval(name, engine, op)
        m = _PREDICT_RE.match(self.path)
        if not m:
            return self._send_json(
                404, {"error": "not found: %s (expected "
                               "/v1/models/<name>:predict, :generate, "
                               ":lookup, or :search)"
                               % self.path})
        name = m.group(1)
        engine = self.server.registry.get(name)
        if engine is None:
            return self._send_json(404, {"error": "unknown model %r" % name})
        if _kind_of(engine) in ("decode", "retrieval"):
            return self._send_json(
                400, _wrong_kind_doc(name, engine, "predict"))
        import numpy as np

        try:
            n = int(self.headers.get("Content-Length") or 0)
            body = json.loads(self.rfile.read(n) or b"{}")
            raw = body["feeds"]
            dtypes = body.get("dtypes") or {}
            feeds = {
                k: (np.asarray(v, dtype=np.dtype(dtypes[k]))
                    if k in dtypes else np.asarray(v))
                for k, v in raw.items()
            }
            deadline_ms = body.get("deadline_ms")
            timeout_s = body.get("timeout_s")
        except (ValueError, KeyError, TypeError) as e:
            return self._send_json(
                400, {"error": "bad request: %s: %s"
                               % (type(e).__name__, e)})
        tctx = self._trace_ctx(body)
        t_req = time.time() if tctx is not None else None
        try:
            if tctx is not None:
                try:
                    fut = engine.submit(feeds, deadline_ms=deadline_ms,
                                        trace_ctx=tctx)
                except TypeError:
                    # engine predates the kwarg: serve untraced
                    fut = engine.submit(feeds, deadline_ms=deadline_ms)
            else:
                fut = engine.submit(feeds, deadline_ms=deadline_ms)
        except ShedError as e:
            return self._send_json(429, self._shed_doc(e, name, engine),
                                   headers=self._shed_headers(e, engine))
        except EngineClosedError as e:
            return self._send_json(
                503, {"error": str(e), "model": name})
        except (ValueError, KeyError) as e:
            return self._send_json(
                400, {"error": "bad request: %s: %s"
                               % (type(e).__name__, e)})
        try:
            outs = fut.result(
                timeout_s if timeout_s is not None
                else engine.request_timeout_s)
        except DeadlineExceededError as e:
            return self._send_json(504, {"error": str(e), "model": name})
        except ShedError as e:
            # the router retried across every replica and all of them
            # shed — same backpressure contract as a direct shed
            return self._send_json(429, self._shed_doc(e, name, engine),
                                   headers=self._shed_headers(e, engine))
        except _FutureTimeout:
            return self._send_json(
                504, {"error": "timed out waiting for model %r" % name,
                      "model": name})
        except EngineClosedError as e:
            return self._send_json(503, {"error": str(e), "model": name})
        except Exception as e:  # noqa: BLE001 — model errors -> 500, not a dead conn
            if type(e).__name__ == "NoReplicasError":
                # fleet router with zero live replicas: unavailable,
                # not an internal error (avoids importing router here)
                return self._send_json(
                    503, {"error": str(e), "model": name})
            return self._send_json(
                500, {"error": "%s: %s" % (type(e).__name__, e)})
        if tctx is not None:
            obs.export_span(
                "http.predict", tctx, t_req, time.time() - t_req,
                {"proc": "http", "model": name})
        self._send_json(200, {"outputs": [
            {"data": o.tolist(), "shape": list(o.shape),
             "dtype": str(o.dtype)}
            for o in outs
        ]})


class ServingServer:
    """ThreadingHTTPServer bound to a ModelRegistry; ``start()`` serves
    on a background thread, ``stop()`` shuts it down (and optionally
    drains the registry)."""

    def __init__(self, registry, host="127.0.0.1", port=0):
        self.registry = registry
        self._httpd = ThreadingHTTPServer((host, int(port)), ServingHandler)
        self._httpd.registry = registry
        self._httpd.daemon_threads = True
        self.host = self._httpd.server_address[0]
        self.port = int(self._httpd.server_address[1])
        self._thread = None

    @property
    def url(self):
        return "http://%s:%d" % (self.host, self.port)

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.05},
                daemon=True, name="serving-http")
            self._thread.start()
            obs.event("http_start", source="serving", count=False,
                      host=self.host, port=self.port)
        return self

    def stop(self, close_registry=False):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if close_registry:
            self.registry.close()


def main(argv=None):
    """CLI: serve one or more save_inference_model dirs over HTTP."""
    import argparse

    from .registry import ModelRegistry

    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.serving.http",
        description="JSON/HTTP serving frontend for paddle_tpu_torch "
                    "models (on the card)")
    p.add_argument("--model", action="append", required=True,
                   metavar="NAME=DIR",
                   help="model name=save_inference_model dir (repeatable)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=2.0)
    p.add_argument("--queue-capacity", type=int, default=64)
    args = p.parse_args(argv)

    registry = ModelRegistry(
        max_batch_size=args.max_batch_size, max_wait_ms=args.max_wait_ms,
        queue_capacity=args.queue_capacity)
    for spec in args.model:
        name, sep, dirname = spec.partition("=")
        if not sep or not name or not dirname:
            p.error("--model wants NAME=DIR, got %r" % spec)
        registry.load(name, dirname)
    server = ServingServer(registry, host=args.host, port=args.port).start()
    print("serving %s on %s" % (", ".join(registry.names()), server.url),
          flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop(close_registry=True)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
