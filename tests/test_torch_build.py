"""The kernel build's cache key (``repro_torch.kernels.build``): a library
is keyed by its sources, every local header they include and the flags,
so that editing a shared header (the flash kernels' ``csrc/wgmma.cuh``, the
SSD kernels' ``csrc/ssd_wgmma.cuh``) builds anew instead of loading a stale
``.so``. Runs on the CPU: it hashes
files and compiles nothing."""
from repro_torch.kernels.build import CudaLibrary, included
from repro_torch.kernels.flash_attention import flash_attention as fkern
from repro_torch.kernels.ssd import ssd as skern


def _lib(tmp_path, *sources):
    return CudaLibrary("probe", [tmp_path / s for s in sources], tmp_path / "_build",
                       lambda lib: None)


def test_editing_an_included_header_changes_the_key(tmp_path):
    (tmp_path / "inner.cuh").write_text("#pragma once\nconstexpr int A = 1;\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "k.cu").write_text('#include <cuda_runtime.h>\n#include "outer.cuh"\n'
                                   "int f() { return A; }\n")
    (tmp_path / "other.cuh").write_text("constexpr int B = 2;\n")
    lib = _lib(tmp_path, "k.cu")
    assert included(lib.sources) == [tmp_path / n for n in ("k.cu", "outer.cuh", "inner.cuh")]
    before = lib.path()
    (tmp_path / "other.cuh").write_text("constexpr int B = 3;\n")  # not included
    assert lib.path() == before
    (tmp_path / "inner.cuh").write_text("#pragma once\nconstexpr int A = 2;\n")
    edited = lib.path()
    assert edited != before and edited.parent == tmp_path / "_build"
    (tmp_path / "inner.cuh").write_text("#pragma once\nconstexpr int A = 1;\n")
    assert lib.path() == before  # the key is the content, not the time


def test_a_header_shared_by_two_sources_counts_once(tmp_path):
    (tmp_path / "h.cuh").write_text("#pragma once\n")
    for name in ("a.cu", "b.cu"):
        (tmp_path / name).write_text('#include "h.cuh"\n')
    assert included(_lib(tmp_path, "a.cu", "b.cu").sources) == [
        tmp_path / n for n in ("a.cu", "h.cuh", "b.cu")]


def test_flash_libraries_hash_the_shared_wgmma_header():
    for lib in (fkern.LIBRARY, fkern.BWD_LIBRARY):
        names = [p.name for p in included(lib.sources)]
        assert names[0] == lib.sources[0].name and "wgmma.cuh" in names


def test_ssd_libraries_hash_the_shared_wgmma_header():
    for lib in (skern.LIBRARY, skern.BWD_LIBRARY):
        names = [p.name for p in included(lib.sources)]
        assert names[0] == lib.sources[0].name and "ssd_wgmma.cuh" in names
