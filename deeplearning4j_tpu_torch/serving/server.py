"""ModelServer: the HTTP front of the serving path (↔ deeplearning4j_tpu/serving/server.py).

stdlib ``ThreadingHTTPServer`` over a ``ModelRegistry``, with the JAX
package's wire format. Endpoints:

- ``POST /v1/models/<name>:predict`` — body
  ``{"inputs": ..., "deadline_ms": <optional>}``; 200 returns
  ``{"model", "version", "outputs"}``; failures return the error envelope
  (errors.py) with status 400/404/429/503/504.
- ``GET /models``  — registry contents.
- ``GET /healthz`` — process liveness, always 200 while serving.
- ``GET /readyz``  — 200 once every registered model is warm and the
  server is not draining; 503 otherwise.

Not yet ported: admission control and overload planes, circuit breakers,
the response cache, metrics, tracing and the ``/debug`` planes, and the
``:generate`` route.
"""

from __future__ import annotations

import json
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
    NotReadyError,
    QueueFullError,
    ServingError,
)
from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
from deeplearning4j_tpu_torch.utils.pytree import tree_map

_PREDICT_RE = re.compile(r"^/v1/models/([^/:]+):predict$")


class ModelServer:
    def __init__(self, registry: Optional[ModelRegistry] = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 default_deadline_ms: float = 30000.0):
        self.registry = registry if registry is not None else ModelRegistry()
        self.default_deadline_ms = float(default_deadline_ms)
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
                m = _PREDICT_RE.match(self.path.partition("?")[0])
                if not m:
                    self._send(404, ServingError(
                        f"no route {self.path}").to_json())
                    return
                try:
                    payload = json.loads(raw) if raw else {}
                except ValueError as e:
                    self._send(400, BadRequestError(
                        f"invalid JSON body: {e}").to_json())
                    return
                self._send(*server.handle_predict(m.group(1), payload))

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True

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
        ready = (self._started and not self._draining
                 and all(models.values()))
        return {"ready": ready, "draining": self._draining, "models": models}

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
            except BaseException:
                # a failed start leaves nothing running
                self._httpd.shutdown()
                self._serve_thread.join(timeout=10)
                self._started = False
                raise
        return self

    def stop(self, *, drain: bool = True, timeout: float = 30.0) -> bool:
        """Graceful shutdown; returns True if every in-flight request
        finished within ``timeout``."""
        drained = True
        if self._started:
            self._draining = True
            if drain:
                deadline = time.monotonic() + timeout
                with self._idle:
                    while self._in_flight > 0:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            drained = False
                            break
                        self._idle.wait(left)
            self._httpd.shutdown()
            if self._serve_thread is not None:
                self._serve_thread.join(timeout=10)
            self._started = False
        self._httpd.server_close()
        self.registry.shutdown_all()
        return drained
