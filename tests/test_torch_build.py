"""The library name that `kernels/build.py` gives a kernel: a hash of the
source, the shared headers and the flags, so that an edited header never
reuses a stale library. Runs on the CPU; nothing is compiled."""

from __future__ import annotations

import pytest

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\nint f() { return g(); }\n')
    (tmp_path / "h.cuh").write_text("inline int g() { return 1; }\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_unchanged_tree_keeps_its_path(csrc):
    assert build.library_path("k") == build.library_path("k")


@pytest.mark.parametrize("edit", ["header", "new_header", "source"])
def test_edit_changes_the_path(csrc, edit):
    before = build.library_path("k")
    if edit == "header":
        (csrc / "h.cuh").write_text("inline int g() { return 2; }\n")
    elif edit == "new_header":
        (csrc / "other.cuh").write_text("inline int z() { return 0; }\n")
    else:
        (csrc / "k.cu").write_text('#include "h.cuh"\nint f() { return -g(); }\n')
    after = build.library_path("k")
    assert after != before
    assert after.parent == before.parent and after.name.startswith("libk-")


def test_path_ignores_files_that_are_not_headers(csrc):
    before = build.library_path("k")
    (csrc / "notes.txt").write_text("not a header\n")
    (csrc / "other.cu").write_text("int z() { return 0; }\n")
    assert build.library_path("k") == before
