"""seldon_tpu_torch.ops._build: the name of a kernel's library follows
every input of its build — the source, every header under ``csrc/`` and
the compiler flags — so an edited file is rebuilt and a stale library is
never loaded. Runs without nvcc: only the names are computed."""

import pytest

from seldon_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "kern.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("constexpr int BK = 128;\n")
    return tmp_path


@pytest.mark.parametrize("edit", ["source", "header", "new header",
                                  "flags"])
def test_library_name_follows_every_build_input(csrc, monkeypatch, edit):
    src = csrc / "kern.cu"
    before = _build._lib_path("kern", src)
    assert _build._lib_path("kern", src) == before  # deterministic
    if edit == "source":
        src.write_text('#include "common.cuh"\n// edited\n')
    elif edit == "header":
        (csrc / "common.cuh").write_text("constexpr int BK = 64;\n")
    elif edit == "new header":
        (csrc / "extra.h").write_text("#define X 1\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    after = _build._lib_path("kern", src)
    assert after != before
    assert after.parent == _build.BUILD_DIR
    assert after.name.startswith("libkern_") and after.suffix == ".so"


def test_other_files_do_not_rename_the_library(csrc):
    src = csrc / "kern.cu"
    before = _build._lib_path("kern", src)
    (csrc / "other.cu").write_text("// another kernel\n")
    (csrc / "notes.txt").write_text("not compiled\n")
    assert _build._lib_path("kern", src) == before
