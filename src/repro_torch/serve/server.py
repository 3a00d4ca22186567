"""SSE HTTP frontend over the LLM facade -- stdlib ``http.server`` only.

A copy of ``repro.serve.server`` over the port's ``LLM`` (duck-typed:
generate / stream / health / stats_payload / start_pump).  The network
shape the reduced unit is built for: the comparator head emits the token
id directly on the device, so the only thing that crosses the wire per
step is that id (plus, optionally, the k-winner candidate bus) -- no
distribution is materialized anywhere between the card and the client.

Endpoints:

  POST /v1/completions      body: {"prompt": [token ids],
                                   "max_new_tokens": int,
                                   "temperature": float, "top_k": int,
                                   "seed": int, "stop": [[ids], ...],
                                   "head_mode": str,
                                   "n_candidates": int,
                                   "stream": bool}
        stream=false -> one JSON RequestOutput (token_ids,
                        finish_reason, timing).
        stream=true  -> Server-Sent Events: one ``data: {...}`` line per
                        TokenChunk as the engine emits it, terminated by
                        ``data: [DONE]``.

  GET /v1/stats             {"engine": aggregate counters (prefills,
                            prefill_chunks, decode_steps, iterations,
                            fused_rows, completed, deferred,
                            preemptions, drafted, accepted,
                            acceptance_rate, host_syncs,
                            emitted_tokens, queue_depth, active_slots,
                            ttft_ms_p50/p99, tokens_per_dispatch),
                            "kv": aggregate pool usage,
                            "replicas": [per-replica engine+kv]}.
                            Counters SUM over replicas, peaks MAX,
                            ratios are recomputed from the summed
                            terms and percentiles re-derived from the
                            pooled samples (serve/router.py documents
                            the merge rules), so the aggregate
                            invariant engine.emitted_tokens ==
                            Σ replicas[i].engine.emitted_tokens always
                            holds; a single LLM reports one replica
                            equal to the aggregate.

  GET /healthz              liveness: 200 {"ok": true, ...} while the
                            engine pump thread is healthy, 503 once it
                            has died (load balancers probe this).  A
                            Router fleet is ok while at least one
                            replica is healthy and not draining; the
                            payload carries the per-replica states.

Error responses — including 404s for unknown paths — are always JSON
(``{"error": ...}``), never empty bodies.

Requests are served by a ``ThreadingHTTPServer``: handler threads only
submit and read per-request chunk queues; the engine itself runs on the
LLM's background pump thread, so concurrent streamed and non-streamed
completions interleave inside the same continuous batch.

Under tensor parallelism (an ``LLM`` whose engine spans a tp group, or
a rank-group ``Router``) one process runs per rank: rank 0 -- the
front's ``leader`` -- binds the server and runs the pump, which tells
every other rank each tick; ``serve_forever`` on any other rank runs
the front's ``follow`` loop instead, and returns when rank 0's pump
stops (on ``server.shutdown()`` or an interrupt of rank 0).
"""
from __future__ import annotations

import json
import signal
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from repro_torch.serve.params import SamplingParams

_PARAM_KEYS = ("max_new_tokens", "temperature", "top_k", "seed", "stop",
               "head_mode", "n_candidates", "spec_k", "prefix_cache",
               "attn_approx")


def params_from_json(body: dict) -> SamplingParams:
    kw = {k: body[k] for k in _PARAM_KEYS if body.get(k) is not None}
    return SamplingParams(**kw)


def _chunk_json(chunk) -> dict:
    d = {"rid": chunk.rid, "token": chunk.token, "index": chunk.index,
         "finish_reason": chunk.finish_reason}
    if chunk.candidate_ids is not None:
        d["candidate_ids"] = list(chunk.candidate_ids)
    return d


class _Handler(BaseHTTPRequestHandler):
    llm = None                 # LLM or Router; bound by make_server
    quiet: bool = True

    # -- plumbing ------------------------------------------------------------
    def log_message(self, fmt, *args):
        if not self.quiet:
            super().log_message(fmt, *args)

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def send_error(self, code, message=None, explain=None):
        # stdlib default is an HTML error page; every error THIS server
        # produces — including 501s for unknown methods — is JSON, so
        # clients never have to parse two formats.
        short = self.responses.get(code, ("error",))[0]
        try:
            self._json(code, {"error": message or short})
        except OSError:
            pass                       # client already gone

    # -- endpoints -----------------------------------------------------------
    def do_GET(self):
        if self.path == "/healthz":
            # liveness for load balancers: the server socket answering
            # is not enough — the engine pump thread(s) must be alive
            # (or cleanly not started, for inline-stepping deployments)
            # and must not have died on an engine error.  ``health()``
            # is the LLM/Router-common surface: a Router is healthy
            # while ANY replica still accepts work (its payload carries
            # the per-replica breakdown).
            h = self.llm.health()
            return self._json(200 if h.get("ok") else 503, h)
        if self.path != "/v1/stats":
            return self._json(404, {"error": f"unknown path {self.path}"})
        # {"engine": aggregate, "kv": aggregate, "replicas": [...]}: the
        # top-level engine/kv keys are the AGGREGATE over replicas
        # (sums for counters, max for peaks, ratios recomputed from the
        # summed terms, percentiles re-derived from pooled samples —
        # serve/router.py aggregate_engine_stats documents the rules),
        # so ``engine.emitted_tokens == sum(r.engine.emitted_tokens for
        # r in replicas)`` holds by construction; on a single LLM the
        # replicas list has one entry equal to the aggregate.
        self._json(200, self.llm.stats_payload())

    def do_POST(self):
        if self.path != "/v1/completions":
            return self._json(404, {"error": f"unknown path {self.path}"})
        try:
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            prompt = body.get("prompt")
            if not isinstance(prompt, list) or not prompt \
                    or not all(isinstance(t, int) for t in prompt):
                raise ValueError(
                    "'prompt' must be a non-empty list of token ids "
                    "(the server is tokenizer-free)")
            params = params_from_json(body)
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            return self._json(400, {"error": str(e)})
        # optional session id: Router pins all requests of a session to
        # one replica (KV prefix affinity across a conversation); a
        # single LLM accepts and ignores it.
        session = body.get("session")
        try:
            if body.get("stream"):
                # submit (and validate params/prompt) BEFORE any headers
                # go out: a resolve error must be a clean 400, not bytes
                # inside an already-open 200 event stream
                it = self.llm.stream(prompt, params, session=session)
                return self._stream(it)
            out = self.llm.generate([prompt], params,
                                    sessions=[session])[0]
            self._json(200, out.as_dict())
        except ValueError as e:           # bad params/config combination
            self._json(400, {"error": str(e)})

    def _stream(self, it) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            for chunk in it:
                self.wfile.write(
                    b"data: " + json.dumps(_chunk_json(chunk)).encode()
                    + b"\n\n")
                self.wfile.flush()
            self.wfile.write(b"data: [DONE]\n\n")
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass           # client went away; close() below cancels
        finally:
            it.close()     # unfinished -> engine.cancel via the facade


def make_server(llm, host: str = "127.0.0.1", port: int = 8000,
                quiet: bool = True) -> ThreadingHTTPServer:
    """Bind (but don't run) the SSE server over an ``LLM`` or anything
    with its surface (duck-typed: generate/stream/health/stats_payload/
    start_pump; the JAX package's ``serve.router.Router`` is one).
    Starts the background engine pump(s) — handler threads never step an
    engine inline.  Pass port=0 for an
    ephemeral port (``server.server_address``)."""
    handler = type("Handler", (_Handler,), {"llm": llm, "quiet": quiet})
    srv = ThreadingHTTPServer((host, port), handler)
    llm.start_pump()
    return srv


def serve_forever(llm, host: str = "127.0.0.1",
                  port: int = 8000) -> None:
    """Serve until interrupted (rank 0), or follow rank 0's ticks until
    its pump stops (any other rank of a tp front; an interrupt there is
    ignored while it follows: rank 0's stop ends every rank)."""
    if not getattr(llm, "leader", True):
        main = threading.current_thread() is threading.main_thread()
        old = signal.signal(signal.SIGINT, signal.SIG_IGN) if main else None
        try:
            llm.follow()
        finally:
            if main:
                signal.signal(signal.SIGINT, old)
        return
    srv = make_server(llm, host, port)
    h, p = srv.server_address[:2]
    print(f"serving on http://{h}:{p}  "
          f"(POST /v1/completions, GET /v1/stats)", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        llm.stop_pump()
