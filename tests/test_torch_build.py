"""The port's kernel build (``repro_torch.kernels._build``): a library's
path hashes its source and every local header the source includes, so an
edited header is rebuilt rather than loaded stale. CPU only: nothing is
compiled here."""

import shutil

import pytest

from repro_torch.kernels import _build
from repro_torch.kernels.attention import kernel as AK

CSRC = AK.SOURCE.parent


def _copy_csrc(tmp_path):
    dst = tmp_path / "csrc"
    shutil.copytree(CSRC, dst)
    return dst


def _library(path):
    return _build.CudaLibrary("flash_attention_bwd", path, lambda lib: None)


@pytest.mark.parametrize("source", ["flash_attention.cu", "flash_attention_bwd.cu"])
def test_both_attention_sources_include_the_shared_header(source):
    names = [p.name for p in _build.local_sources(CSRC / source)]
    assert names == [source, "hopper.cuh"]


@pytest.mark.parametrize("source", ["flash_attention.cu", "flash_attention_bwd.cu"])
def test_library_path_is_stable_when_nothing_changes(tmp_path, source):
    src = _copy_csrc(tmp_path) / source
    first = _library(src).path()
    assert _library(src).path() == first
    assert first.parent == _build.BUILD_DIR and first.name.startswith("libflash_attention_bwd-")
    # the same files elsewhere hash the same: the path follows content, not location
    assert _library(CSRC / source).path() == first


@pytest.mark.parametrize("source", ["flash_attention.cu", "flash_attention_bwd.cu"])
def test_editing_an_included_header_changes_the_library_path(tmp_path, source):
    csrc = _copy_csrc(tmp_path)
    before = _library(csrc / source).path()
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// an edit\n")
    after = _library(csrc / source).path()
    assert after != before
    header.write_text(header.read_text().replace("\n// an edit\n", ""))
    assert _library(csrc / source).path() == before


def test_editing_the_source_changes_the_library_path(tmp_path):
    csrc = _copy_csrc(tmp_path)
    src = csrc / "flash_attention_bwd.cu"
    before = _library(src).path()
    src.write_text(src.read_text() + "\n// an edit\n")
    assert _library(src).path() != before


def test_local_includes_are_followed_once_and_missing_ones_skipped(tmp_path):
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n#include "a.cuh"\n')
    (tmp_path / "b.cuh").write_text('  #  include "a.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda.h>\n#include "a.cuh"\n#include "missing.cuh"\n// #include "b.cuh" in a comment\n')
    assert [p.name for p in _build.local_sources(src)] == ["k.cu", "a.cuh", "b.cuh"]
