"""The port's sparse cross-entropy on the card: out-of-range class ids.

Marked ``cuda``: each test needs an NVIDIA card and skips without one.
On a CUDA tensor ``torch.gather`` with an id outside [0, C) fails by a
device-side assert that breaks the CUDA context for the rest of the
process; ``sparse_softmax_cross_entropy`` checks the ids first and
raises cleanly, so the card stays usable. Each case runs in a child
process, so that a regression cannot take this test process's context
with it. On a host with the card and without JAX:

    python -m pytest --noconftest tests/test_torch_loss_cuda.py -q

(``--noconftest``: the repository's conftest configures JAX.)
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]

CHILD = """
import torch
from deeplearning4j_tpu_torch.ops.loss import sparse_softmax_cross_entropy

dev = torch.device("cuda", 0)
logits = torch.randn(3, 7, device=dev)
try:
    sparse_softmax_cross_entropy(logits, torch.tensor([0, 6, {bad}],
                                                      device=dev))
except RuntimeError as e:
    assert "out of bounds" in str(e), e
else:
    raise SystemExit("no error for class id {bad}")
# the context survived: the card still computes
ok = sparse_softmax_cross_entropy(logits, torch.tensor([0, 6, 3],
                                                       device=dev))
torch.cuda.synchronize()
assert torch.isfinite(ok).item()
print("clean")
"""


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the device-side assert this "
                    "guards against happens only on a CUDA tensor")


@pytest.mark.parametrize("bad", [-1, 7])
def test_out_of_range_class_id_raises_and_the_card_goes_on(card, bad):
    res = subprocess.run([sys.executable, "-c", CHILD.format(bad=bad)],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("clean")
