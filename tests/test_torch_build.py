"""The port's kernel build: which library a source builds to.

No ``nvcc`` is needed: the library's path carries a digest of everything
the compiler reads (the source, every ``csrc/*.cuh`` header, the flags),
so these tests edit a copy of ``csrc/`` and watch the path.
"""

import shutil

import pytest

from deeplearning4j_tpu_torch.kernels import _build

SOURCES = sorted(p.stem for p in _build.CSRC.glob("*.cu"))


@pytest.fixture
def csrc(tmp_path):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    return copy


@pytest.mark.parametrize("name, includes", [
    ("flash_fwd", ("wgmma_sm90.cuh", "mma_tf32.cuh")),
    ("flash_bwd", ("wgmma_sm90.cuh", "mma_tf32.cuh")),
    ("gru_scan", ("mma_tf32.cuh",)),
    ("lstm_scan", ("mma_tf32.cuh",)),
])
def test_the_sources_include_a_shared_header(name, includes):
    """Both flash sources include the bf16 (wgmma) and the float32 (3xTF32
    mma.sync) tile helpers; the GRU and LSTM sweeps the float32 ones
    (which bring in the bf16 header's cp.async copies)."""
    headers = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert "wgmma_sm90.cuh" in headers and "mma_tf32.cuh" in headers
    text = (_build.CSRC / f"{name}.cu").read_text()
    for header in includes:
        assert f'#include "{header}"' in text


def test_an_identical_copy_builds_to_the_same_library(csrc):
    for name in SOURCES:
        path = _build.library_path(name, csrc)
        assert path == _build.library_path(name)
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"


@pytest.mark.parametrize("name", SOURCES)
def test_editing_a_header_rebuilds_the_library(csrc, name):
    before = _build.library_path(name, csrc)
    header = csrc / "wgmma_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.library_path(name, csrc) != before


def test_a_new_header_rebuilds_the_library(csrc):
    before = _build.library_path("flash_fwd", csrc)
    (csrc / "extra.cuh").write_text("// new\n")
    assert _build.library_path("flash_fwd", csrc) != before


def test_editing_a_source_rebuilds_only_its_library(csrc):
    before = {n: _build.library_path(n, csrc) for n in SOURCES}
    src = csrc / "flash_fwd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n, csrc) for n in SOURCES}
    assert {n for n in SOURCES if after[n] != before[n]} == {"flash_fwd"}


def test_build_loads_the_library_at_the_digest_path(tmp_path, monkeypatch):
    """An up-to-date library (its digest covers the headers) is taken as
    it is: nothing is compiled."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_built", {})
    monkeypatch.setattr(_build, "nvcc_path", lambda: pytest.fail("nvcc ran"))
    path = _build.library_path("flash_fwd")
    path.write_bytes(b"")
    built = _build.build("flash_fwd")
    assert built.path == path and built.seconds == 0.0
