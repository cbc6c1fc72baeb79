"""The port's nvcc build cache (gaussianip_tpu_torch/_nvcc.py): a library is
named by a hash of its source, every csrc/*.cuh header and all the flags,
so an edit to any of them builds anew. Needs no nvcc."""

import os

from gaussianip_tpu_torch import _nvcc


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "h.cuh"\n__global__ void k() {}\n')
    (csrc / "h.cuh").write_text("constexpr int A = 1;\n")
    monkeypatch.setattr(_nvcc, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_nvcc, "BUILD_DIR", str(tmp_path / "build"))
    return csrc


def test_target_changes_with_source_header_and_flags(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    first = _nvcc._target("k")
    assert first == _nvcc._target("k")
    assert os.path.dirname(first) == str(tmp_path / "build")
    seen = {first}
    for edit in (lambda: (csrc / "h.cuh").write_text("constexpr int A = 2;\n"),
                 lambda: (csrc / "g.cuh").write_text("// a new header\n"),
                 lambda: (csrc / "k.cu").write_text("// edited\n"),
                 lambda: monkeypatch.setattr(
                     _nvcc, "NVCC_FLAGS", _nvcc.NVCC_FLAGS + ("-lcuda",))):
        edit()
        seen.add(_nvcc._target("k"))
    assert len(seen) == 5


def test_build_reuses_a_built_target(tmp_path, monkeypatch):
    """A library already built under its hash is reused: no nvcc runs (this
    machine has none)."""
    _csrc(tmp_path, monkeypatch)
    path = _nvcc._target("k")
    os.makedirs(os.path.dirname(path))
    open(path, "wb").close()
    monkeypatch.setattr(_nvcc, "_nvcc", lambda: (_ for _ in ()).throw(
        AssertionError("nvcc ran for a built target")))
    assert _nvcc.build(["k"]) == {"k": path}
