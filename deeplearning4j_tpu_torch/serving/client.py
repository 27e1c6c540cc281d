"""Stdlib HTTP client for ModelServer (↔ deeplearning4j_tpu/serving/client.py).

Raises the same typed exceptions the server sheds with: a 429 comes back
as ``QueueFullError``, a 504 as ``DeadlineExceededError``, and so on.

Not yet ported: the retry policy, correlation-id tracing and the
``generate`` stream.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Optional

import numpy as np

from deeplearning4j_tpu_torch.serving.errors import (
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
                              err.get("message", f"HTTP {e.code}")) from e

    def _request(self, path: str, payload: Optional[dict] = None) -> dict:
        data = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(
            self.base_url + path, data=data,
            headers={"Content-Type": "application/json"})
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
