"""Priority classes of requests (↔ deeplearning4j_tpu/serving/overload.py).

Only the class vocabulary and its ``X-Priority`` validator are ported: the
generation engine preempts by them. The overload manager itself (AIMD
limit, tenant quotas, the brownout ladder) is ROADMAP queue 1 item 9.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.serving.errors import BadRequestError

# Priority classes, best first. The header value must be one of these.
PRIORITIES = ("critical", "normal", "batch")


def validate_priority(priority) -> str:
    """``X-Priority`` header value → a known class (default ``normal``).
    Anything outside the fixed vocabulary is a 400, never a silent
    default."""
    if priority is None or priority == "":
        return "normal"
    p = str(priority).strip().lower()
    if p not in PRIORITIES:
        raise BadRequestError(
            f"X-Priority must be one of {list(PRIORITIES)}, "
            f"got {priority!r}")
    return p
