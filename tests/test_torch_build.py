"""The port's build plumbing on the CPU: a library's file name must change
with its source, with every ``csrc/*.cuh`` header and with its flags, so a
stale shared library never loads after an edit; a misaligned view is handed
over as an aligned copy.  Nothing is compiled."""

import shutil

import pytest
import torch

from repro_torch.kernels import build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A private copy of ``csrc/`` that the build module hashes instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", build.SOURCES)
@pytest.mark.parametrize("header", ["common.cuh", "sm90.cuh", "added.cuh"])
def test_library_name_follows_every_header(csrc, name, header):
    before = build.library_path(name)
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    assert build.library_path(name) != before


@pytest.mark.parametrize("name", build.SOURCES)
def test_library_name_follows_its_source_and_flags(csrc, name, monkeypatch):
    before = build.library_path(name)
    other = next(n for n in build.SOURCES if n != name)
    with open(csrc / f"{other}.cu", "a") as f:
        f.write("\n// edited\n")
    assert build.library_path(name) == before  # another source is another library
    with open(csrc / f"{name}.cu", "a") as f:
        f.write("\n// edited\n")
    edited = build.library_path(name)
    assert edited != before
    monkeypatch.setitem(build.SOURCE_FLAGS, name, build.SOURCE_FLAGS.get(name, ()) + ("-lineinfo",))
    assert build.library_path(name) != edited


def test_flags_add_the_per_source_ones():
    assert build.flags("flash_attention") == build.NVCC_FLAGS + ("-Xptxas", "-v")
    assert build.flags("block_transform") == build.NVCC_FLAGS + ("-Xptxas", "-v")
    for name in build.SOURCES:
        assert build.flags(name)[: len(build.NVCC_FLAGS)] == build.NVCC_FLAGS
        assert "sm_90a" in " ".join(build.flags(name))


@pytest.mark.parametrize("offset", [0, 1, 2, 3, 4])
def test_aligned_copies_only_a_misaligned_view(offset):
    flat = torch.arange(4 * 64 + 8, dtype=torch.float32)  # the allocator aligns storage to 64 bytes
    view = flat[offset: offset + 4 * 64].view(4, 64)
    got = build.aligned(view)
    assert got.data_ptr() % 16 == 0 and got.is_contiguous() and torch.equal(got, view)
    assert (got is view) == (offset % 4 == 0)
