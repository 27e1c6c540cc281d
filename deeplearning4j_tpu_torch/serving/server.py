"""ModelServer: the HTTP front of the serving path (↔ deeplearning4j_tpu/serving/server.py).

stdlib ``ThreadingHTTPServer`` over a ``ModelRegistry``, with the JAX
package's wire format. Endpoints:

- ``POST /v1/models/<name>:predict`` — body
  ``{"inputs": ..., "deadline_ms": <optional>}``; 200 returns
  ``{"model", "version", "outputs"}``; failures return the error envelope
  (errors.py) with status 400/404/429/503/504.
- ``POST /v1/models/<name>:generate`` — the continuous-batching
  generation engine (``serving/generation.py``; ``generators={name:
  GenerationEngine}``). Body ``{"prompt": [ids...], "max_new_tokens",
  "temperature", "eos_id", "deadline_ms", "stream"}`` (all but the prompt
  optional); ``X-Priority`` (critical | normal | batch) feeds the
  engine's preemption. Streamed (the default) as chunked
  ``application/x-ndjson``: ``{"token": id}`` lines, then ``{"done":
  true, "n_tokens", "finish_reason"}`` or a terminal ``{"error": ...}``;
  with ``"stream": false`` one body ``{"model", "version", "tokens",
  "n_tokens", "finish_reason"}``. A client that hangs up mid-stream
  cancels its request and frees the slot.
- ``GET /models``  — registry contents.
- ``GET /healthz`` — process liveness, always 200 while serving.
- ``GET /readyz``  — 200 once every registered model and every generator
  is warm and the server is not draining; 503 otherwise.

Not yet ported: admission control and overload planes (tenants among
them), circuit breakers, the response cache, metrics, tracing and the
``/debug`` planes.
"""

from __future__ import annotations

import json
import queue
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.parallel.inference import (
    InferenceDeadlineExpired,
    InferenceQueueFull,
    InferenceShutdown,
)
from deeplearning4j_tpu_torch.serving.errors import (
    BadRequestError,
    DeadlineExceededError,
    DeadlineExpiredError,
    ModelNotFoundError,
    NotReadyError,
    QueueFullError,
    ServingError,
)
from deeplearning4j_tpu_torch.serving.overload import validate_priority
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.utils.pytree import tree_map

_PREDICT_RE = re.compile(r"^/v1/models/([^/:]+):predict$")
_GENERATE_RE = re.compile(r"^/v1/models/([^/:]+):generate$")


class _HTTPServer(ThreadingHTTPServer):
    # socketserver's listen backlog is 5: when the accept loop waits on the
    # interpreter lock, a burst of new connections overflows it, the kernel
    # drops their SYNs and each client waits a 1 s retransmit
    request_queue_size = 128
    daemon_threads = True


class ModelServer:
    def __init__(self, registry: Optional[ModelRegistry] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 default_deadline_ms: float = 30000.0,
                 generators: Optional[dict] = None):
        self.registry = registry if registry is not None else ModelRegistry()
        self.default_deadline_ms = float(default_deadline_ms)
        self.generators: dict = {}
        self._draining = False
        self._started = False
        self._serve_thread: Optional[threading.Thread] = None
        # requests inside handle_predict: stop(drain=True) waits for zero
        self._in_flight = 0
        self._idle = threading.Condition()
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # noqa: N802 - stdlib API
                pass

            def _send(self, status: int, body: dict):
                raw = json.dumps(body).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                retry_ms = (body.get("error") or {}).get("retry_after_ms")
                if retry_ms is not None:
                    # HTTP Retry-After is whole seconds; the body keeps ms
                    self.send_header("Retry-After",
                                     str(max(1, -(-int(retry_ms) // 1000))))
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):  # noqa: N802 - stdlib API
                path = self.path.partition("?")[0]
                if path == "/healthz":
                    self._send(200, {"status": "ok"})
                elif path == "/readyz":
                    body = server.readiness()
                    self._send(200 if body["ready"] else 503, body)
                elif path == "/models":
                    self._send(200, {"models": server.registry.describe()})
                else:
                    self._send(404, ServingError(
                        f"no route {self.path}").to_json())

            def do_POST(self):  # noqa: N802 - stdlib API
                n = int(self.headers.get("Content-Length", 0) or 0)
                raw = self.rfile.read(n) if n else b""
                path = self.path.partition("?")[0]
                m = _PREDICT_RE.match(path)
                g = _GENERATE_RE.match(path)
                if not m and not g:
                    self._send(404, ServingError(
                        f"no route {self.path}").to_json())
                    return
                try:
                    payload = json.loads(raw) if raw else {}
                except ValueError as e:
                    self._send(400, BadRequestError(
                        f"invalid JSON body: {e}").to_json())
                    return
                if g is not None:
                    self._do_generate(g.group(1), payload)
                    return
                self._send(*server.handle_predict(m.group(1), payload))

            def _do_generate(self, name: str, payload):
                status, body, stream = server.handle_generate(
                    name, payload, priority=self.headers.get("X-Priority"))
                if stream is None:
                    self._send(status, body)
                    return
                # chunked ndjson, one event a line: {"token": id}* then
                # {"done": ...} or a terminal {"error": {...}}
                self.send_response(200)
                self.send_header("Content-Type", "application/x-ndjson")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                try:
                    for ev in stream.wire_events():
                        line = json.dumps(ev).encode() + b"\n"
                        self.wfile.write(b"%X\r\n" % len(line)
                                         + line + b"\r\n")
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                except OSError:
                    # the client went away mid-stream: free its decode
                    # slot instead of generating tokens nobody reads
                    stream.cancel()

        self._httpd = _HTTPServer((host, port), Handler)
        for gname, engine in (generators or {}).items():
            self.add_generator(gname, engine)

    # -- surface -------------------------------------------------------------

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._httpd.server_address[0]}:{self.port}"

    @property
    def draining(self) -> bool:
        return self._draining

    def readiness(self) -> dict:
        models = {e["name"]: e["warmed"] for e in self.registry.describe()}
        gens = {name: eng.warmed for name, eng in self.generators.items()}
        ready = (self._started and not self._draining
                 and all(models.values()) and all(gens.values()))
        body = {"ready": ready, "draining": self._draining, "models": models}
        if gens:
            body["generators"] = gens
        return body

    # -- predict path (handler-independent for direct testing) ---------------

    def _timeout_s(self, deadline_ms) -> float:
        if deadline_ms is None:
            return self.default_deadline_ms / 1000.0
        if isinstance(deadline_ms, bool) or not isinstance(
                deadline_ms, (int, float)) or not deadline_ms > 0:
            raise BadRequestError("deadline_ms must be a positive number")
        return min(float(deadline_ms), self.default_deadline_ms) / 1000.0

    def handle_predict(self, name: str, payload) -> Tuple[int, dict]:
        with self._idle:
            self._in_flight += 1
        try:
            entry = self.registry.get(name)
            if self._draining or not self._started:
                raise NotReadyError("server is draining" if self._draining
                                    else "server not started")
            if not isinstance(payload, dict) or "inputs" not in payload:
                raise BadRequestError('body must be {"inputs": ...}')
            timeout = self._timeout_s(payload.get("deadline_ms"))
            deadline = time.monotonic() + timeout
            features = entry.parse_inputs(payload["inputs"])
            try:
                out, version = entry.predict_versioned(
                    features, timeout=timeout, deadline=deadline)
            except InferenceDeadlineExpired as e:
                raise DeadlineExpiredError(str(e)) from e
            except TimeoutError as e:
                raise DeadlineExceededError(
                    str(e) or "deadline exceeded") from e
            except InferenceQueueFull as e:
                raise QueueFullError(str(e)) from e
            except InferenceShutdown as e:
                raise NotReadyError("server is draining") from e
            outputs = tree_map(lambda a: np.asarray(a).tolist(), out)
            return 200, {"model": name, "version": version,
                         "outputs": outputs}
        except ServingError as e:
            return e.http_status, e.to_json()
        except Exception as e:  # noqa: BLE001 — surface, never crash
            return 500, {"error": {"code": "INTERNAL",
                                   "message": str(e)[:300],
                                   "retryable": False}}
        finally:
            with self._idle:
                self._in_flight -= 1
                self._idle.notify_all()

    # -- generation path -----------------------------------------------------

    def add_generator(self, name: str, engine):
        """Serve a ``GenerationEngine`` under ``name`` at ``POST
        /v1/models/<name>:generate``. On a started server it is warmed
        (if it is not yet) and started here."""
        if name in self.generators:
            raise ValueError(f"generator '{name}' already registered")
        engine.name = name
        self.generators[name] = engine
        if self._started:
            if not engine.warmed:
                engine.warm()
            engine.start()
        return engine

    def handle_generate(self, name: str, payload, *, priority=None):
        """Validate and submit one generation request → ``(status, body,
        stream)``: ``stream`` is the live ``GenerationStream`` of a
        streaming request (the handler writes its events), None when the
        response is complete (an error envelope, or the collected body of
        ``{"stream": false}``). Every check runs before the submit, so a
        400 never leaves a stream decoding for nobody."""
        handle = None
        try:
            prio = validate_priority(priority)
            engine = self.generators.get(name)
            if engine is None:
                raise ModelNotFoundError(f"no generator named '{name}'")
            if self._draining or not self._started:
                raise NotReadyError("server is draining" if self._draining
                                    else "server not started")
            if not isinstance(payload, dict) or "prompt" not in payload:
                raise BadRequestError('body must be {"prompt": [ids...]}')
            mnt = payload.get("max_new_tokens")
            if mnt is not None and (isinstance(mnt, bool)
                                    or not isinstance(mnt, int)):
                raise BadRequestError("max_new_tokens must be an integer")
            temp = payload.get("temperature")
            if temp is not None and (isinstance(temp, bool)
                                     or not isinstance(temp, (int, float))):
                raise BadRequestError("temperature must be a number")
            eos = payload.get("eos_id")
            if eos is not None and (isinstance(eos, bool)
                                    or not isinstance(eos, int)):
                raise BadRequestError("eos_id must be an integer")
            stream_mode = payload.get("stream", True)
            if not isinstance(stream_mode, bool):
                raise BadRequestError("stream must be true or false")
            timeout = self._timeout_s(payload.get("deadline_ms"))
            handle = engine.submit(payload["prompt"], max_new_tokens=mnt,
                                   temperature=temp, eos_id=eos,
                                   priority=prio)
            if stream_mode:
                handle._wire_timeout = timeout
                return 200, None, handle
            try:
                # the whole stream's budget, not a per-token gap
                res = handle.result(timeout=timeout)
            except queue.Empty:
                handle._expire()
                raise DeadlineExceededError(
                    "generation did not finish before the deadline"
                    ) from None
            return 200, {"model": name, "version": engine.version,
                         "tokens": res["tokens"],
                         "n_tokens": len(res["tokens"]),
                         "finish_reason": res["finish_reason"]}, None
        except ServingError as e:
            if handle is not None:
                handle.cancel()  # idempotent; no-op on a finished stream
            return e.http_status, e.to_json(), None
        except Exception as e:  # noqa: BLE001 — surface, never crash
            if handle is not None:
                handle.cancel()
            return 500, {"error": {"code": "INTERNAL",
                                   "message": str(e)[:300],
                                   "retryable": False}}, None

    # -- lifecycle -----------------------------------------------------------

    def start(self, *, warm: bool = True) -> "ModelServer":
        """Serve. ``warm`` drives every bucket of every registered model
        before ``/readyz`` turns 200 (HTTP answers meanwhile; predicts
        against a model not yet warm are served, /readyz says 503)."""
        if self._started:
            return self
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="model-server")
        self._serve_thread.start()
        self._started = True
        if warm:
            try:
                for entry in self.registry.entries():
                    if not entry.warmed:
                        entry.warm()
                for eng in self.generators.values():
                    if not eng.warmed:
                        eng.warm()
            except BaseException:
                # a failed start leaves nothing running
                self._httpd.shutdown()
                self._serve_thread.join(timeout=10)
                self._started = False
                raise
        # only a warmed engine gets its scheduler (warm() refuses to run
        # beside one); requests to another wait in its queue
        for eng in self.generators.values():
            if eng.warmed:
                eng.start()
        return self

    def stop(self, *, drain: bool = True, timeout: float = 30.0) -> bool:
        """Graceful shutdown; returns True if every in-flight request
        finished within ``timeout``."""
        drained = True
        if self._started:
            self._draining = True
            if drain:
                # one budget across the predict drain and every engine's
                deadline = time.monotonic() + timeout
                with self._idle:
                    while self._in_flight > 0:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            drained = False
                            break
                        self._idle.wait(left)
                for eng in self.generators.values():
                    drained = eng.drain(
                        max(0.0, deadline - time.monotonic())) and drained
            self._httpd.shutdown()
            if self._serve_thread is not None:
                self._serve_thread.join(timeout=10)
            self._started = False
        self._httpd.server_close()
        for eng in self.generators.values():
            eng.stop()
        self.registry.shutdown_all()
        return drained
