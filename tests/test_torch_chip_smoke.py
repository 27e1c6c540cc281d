"""``chip_smoke.py``'s profiler bookkeeping on the CPU, on made-up traces.

``_window_start`` finds where the traced calls begin in a trace's kernel
records: past the TRACE_EDGE_S pause that opens the recording window,
where a trace kept records of the warm-up call before it. It must drop
those records and nothing else, so that a launch count over the expected
one still fails the card run.
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

PAUSE_US = chip_smoke.TRACE_EDGE_S * 1e6


def _trace(per_call, calls, warmup_records=0, inner_pause_us=0.0):
    """(start µs, end µs, name) records: ``warmup_records`` kernels, the
    window's opening pause, then ``calls`` calls of ``per_call`` 10-µs
    kernels 5 µs apart, with ``inner_pause_us`` of host time after each
    call's first kernel."""
    out, t = [], 0.0
    for k in range(warmup_records):
        out.append((t, t + 10.0, f"warm_{k}"))
        t += 15.0
    t += PAUSE_US
    for c in range(calls):
        for k in range(per_call):
            out.append((t, t + 10.0, f"kernel_{k}"))
            t += 15.0
            if k == 0:
                t += inner_pause_us
    return out


@pytest.mark.parametrize("per_call,calls,warmup,inner,want", [
    (1, 5, 0, 0.0, 0),            # a clean trace: nothing to drop
    (1, 5, 1, 0.0, 1),            # the warm-up's sweep kept: dropped
    (100, 5, 7, 0.0, 7),          # a few of a step-kernel warm-up's
    (100, 5, 100, 0.0, 100),      # the whole warm-up call
    (1, 5, 2, 0.0, 0),            # more than one call's worth: kept
    (3, 5, 0, PAUSE_US, 0),       # a pause inside the function
    (3, 5, 1, PAUSE_US, 0),       # ... which also hides the opening one
])
def test_window_start_drops_only_the_warm_up_records(per_call, calls, warmup,
                                                     inner, want):
    records = sorted(_trace(per_call, calls, warmup, inner))
    start = chip_smoke._window_start(records, calls)
    assert start == want
    if want:
        assert all(n.startswith("warm_") for _, _, n in records[:start])
        assert not any(n.startswith("warm_") for _, _, n in records[start:])
