"""Stdlib HTTP client for ModelServer (↔ deeplearning4j_tpu/serving/client.py).

Raises the same typed exceptions the server sheds with: a 429 comes back
as ``QueueFullError``, a 504 as ``DeadlineExceededError``, a preempted
generation as ``SlotPreemptedError``, and so on. ``generate`` yields the
tokens of a streamed generation as they arrive; ``generate_tokens`` waits
for the collected response.

Not yet ported: the retry policy and correlation-id tracing.
"""

from __future__ import annotations

import http.client
import json
import urllib.error
import urllib.request
from typing import Any, Optional

import numpy as np

from deeplearning4j_tpu_torch.serving.errors import (
    ConnectionFailedError,
    NotReadyError,
    QueueFullError,
    ServingError,
    error_from_code,
)


def _jsonable(value):
    if isinstance(value, dict):
        return {k: _jsonable(v) for k, v in value.items()}
    if isinstance(value, np.ndarray):
        return value.tolist()
    if hasattr(value, "tolist"):  # torch tensors, numpy scalars
        return value.tolist()
    return value


class ServingClient:
    def __init__(self, base_url: str, *, timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    @staticmethod
    def _raise_typed(e: urllib.error.HTTPError):
        try:
            body = json.loads(e.read())
        except ValueError:
            # a proxy's plain-text 429/503 still maps to the typed class
            cls = {429: QueueFullError, 503: NotReadyError}.get(
                e.code, ServingError)
            raise cls(f"HTTP {e.code}") from e
        err = body.get("error", {})
        raise error_from_code(err.get("code", "INTERNAL"),
                              err.get("message", f"HTTP {e.code}"),
                              err.get("retry_after_ms")) from e

    def _request(self, path: str, payload: Optional[dict] = None,
                 headers: Optional[dict] = None) -> dict:
        data = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(
            self.base_url + path, data=data,
            headers={"Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            self._raise_typed(e)

    def predict(self, model: str, inputs: Any, *,
                deadline_ms: Optional[float] = None) -> dict:
        """POST a predict; returns ``{"model", "version", "outputs"}``.
        Typed ServingError on failure."""
        payload = {"inputs": _jsonable(inputs)}
        if deadline_ms is not None:
            payload["deadline_ms"] = deadline_ms
        return self._request(f"/v1/models/{model}:predict", payload)

    @staticmethod
    def _generate_payload(prompt, max_new_tokens, temperature, eos_id,
                          stream, deadline_ms):
        payload = {"prompt": [int(t) for t in np.asarray(prompt).reshape(-1)],
                   "stream": stream}
        if max_new_tokens is not None:
            payload["max_new_tokens"] = int(max_new_tokens)
        if temperature is not None:
            payload["temperature"] = float(temperature)
        if eos_id is not None:
            payload["eos_id"] = int(eos_id)
        if deadline_ms is not None:
            payload["deadline_ms"] = deadline_ms
        return payload

    def generate(self, model: str, prompt, *,
                 max_new_tokens: Optional[int] = None,
                 temperature: Optional[float] = None,
                 eos_id: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 priority: Optional[str] = None):
        """POST a streaming generation; returns an iterator of the token
        ids as the server produces them. The request is sent here, so a
        shed (429/503/400) raises here, not at the first ``next()``. A
        terminal error line raises its typed ``ServingError`` mid-stream
        (tokens already yielded stand); a stream that ends without its
        terminal line raises ``ConnectionFailedError``. ``deadline_ms``
        bounds the whole stream on the server."""
        payload = self._generate_payload(prompt, max_new_tokens, temperature,
                                         eos_id, True, deadline_ms)
        headers = {"Content-Type": "application/json"}
        if priority is not None:
            headers["X-Priority"] = priority
        req = urllib.request.Request(
            self.base_url + f"/v1/models/{model}:generate",
            data=json.dumps(payload).encode(), headers=headers)
        try:
            resp = urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            self._raise_typed(e)

        def _stream():
            with resp:
                try:
                    for line in resp:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            ev = json.loads(line)
                        except ValueError as e:
                            raise ConnectionFailedError(
                                f"stream truncated mid-event: "
                                f"{line[:80]!r}") from e
                        if "token" in ev:
                            yield int(ev["token"])
                        elif "error" in ev:
                            err = ev["error"]
                            raise error_from_code(
                                err.get("code", "INTERNAL"),
                                err.get("message", ""),
                                err.get("retry_after_ms"))
                        elif ev.get("done"):
                            return
                except (ConnectionError, http.client.IncompleteRead) as e:
                    raise ConnectionFailedError(
                        f"generation stream broke: {e}") from e
                raise ConnectionFailedError(
                    "stream ended without a terminal done/error line")

        return _stream()

    def generate_tokens(self, model: str, prompt, *,
                        max_new_tokens: Optional[int] = None,
                        temperature: Optional[float] = None,
                        eos_id: Optional[int] = None,
                        deadline_ms: Optional[float] = None,
                        priority: Optional[str] = None) -> dict:
        """Non-streaming generation: one collected response ``{"model",
        "version", "tokens", "n_tokens", "finish_reason"}``."""
        payload = self._generate_payload(prompt, max_new_tokens, temperature,
                                         eos_id, False, deadline_ms)
        headers = {} if priority is None else {"X-Priority": priority}
        return self._request(f"/v1/models/{model}:generate", payload,
                             headers)

    def models(self) -> list:
        return self._request("/models")["models"]

    def ready(self) -> dict:
        """The /readyz body (``{"ready", "draining", "models"}``) —
        returned for both 200 and 503 so callers can poll the flip."""
        req = urllib.request.Request(self.base_url + "/readyz")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            return json.loads(e.read())
