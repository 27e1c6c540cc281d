"""Structured serving errors (↔ deeplearning4j_tpu/serving/errors.py).

Each failure a client can see maps to one class with a stable ``code``, an
HTTP status and a ``retryable`` hint. The server renders them as
``{"error": {code, message, retryable}}``; the client parses that body
back into the same class. The codes and statuses are the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Type

_BY_CODE: Dict[str, Type["ServingError"]] = {}


class ServingError(RuntimeError):
    """Base class; subclasses fix ``code``/``http_status``/``retryable``.

    ``retry_after_ms``: an optional backoff hint of a retryable failure,
    rendered into the error body (and by the server as ``Retry-After``).
    """

    code = "INTERNAL"
    http_status = 500
    retryable = False

    def __init__(self, *args, retry_after_ms=None):
        super().__init__(*args)
        self.retry_after_ms = retry_after_ms

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        _BY_CODE[cls.code] = cls

    @property
    def message(self) -> str:
        return str(self)

    def to_json(self) -> dict:
        err = {"code": self.code, "message": self.message,
               "retryable": self.retryable}
        if self.retry_after_ms is not None:
            err["retry_after_ms"] = self.retry_after_ms
        return {"error": err}


class BadRequestError(ServingError):
    """Malformed body / inputs that don't match the model's input spec."""

    code = "INVALID_ARGUMENT"
    http_status = 400


class ModelNotFoundError(ServingError):
    """No registry entry under the requested name."""

    code = "NOT_FOUND"
    http_status = 404


class NotReadyError(ServingError):
    """Server not started yet, warming up, or draining for shutdown."""

    code = "UNAVAILABLE"
    http_status = 503
    retryable = True


class QueueFullError(ServingError):
    """Load shed: the model's request queue is full."""

    code = "RESOURCE_EXHAUSTED"
    http_status = 429
    retryable = True


class DeadlineExceededError(ServingError):
    """The request's deadline elapsed before a result was produced."""

    code = "DEADLINE_EXCEEDED"
    http_status = 504


class DeadlineExpiredError(DeadlineExceededError):
    """The deadline expired while the request was still queued: it was
    dropped before dispatch."""

    code = "DEADLINE_EXPIRED"
    http_status = 504


class ConnectionFailedError(ServingError):
    """The server could not be reached, or a response (a generation
    stream) ended without its terminal line: raised by the client, never
    sent by the server. Retryable."""

    code = "CONNECTION_FAILED"
    http_status = 503
    retryable = True


class SlotPreemptedError(ServingError):
    """A generation request's decode slot was taken by a ``critical``
    request mid-stream: its KV slab row was released. Retryable, with
    ``retry_after_ms`` the engine's estimate of when a slot frees up."""

    code = "SLOT_PREEMPTED"
    http_status = 503
    retryable = True


def error_from_code(code: str, message: str = "",
                    retry_after_ms=None) -> ServingError:
    """Rebuild the typed exception from a wire ``code`` (client side)."""
    return _BY_CODE.get(code, ServingError)(message,
                                            retry_after_ms=retry_after_ms)
