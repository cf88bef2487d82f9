"""CPU guards for the ctypes boundary of the CUDA kernels: the C entry
points in `cover_vla_tpu_torch/csrc/*.cu` and the argument types that
`_build._SIGNATURES` hands to ctypes must agree (a pointer passed as a C
int is cut to 32 bits without any error on the card), every source is
part of the build, and the build directory stays out of git."""

import ctypes
import os
import re
import subprocess

import pytest

from cover_vla_tpu_torch import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(cvla_\w+)\s*\(([^)]*)\)', re.S)
_KINDS = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
          ctypes.c_float: "float"}


def _kind(param: str) -> str:
    param = " ".join(param.split())
    if "*" in param:
        return "pointer"
    ctype = param.rsplit(" ", 1)[0].replace("const ", "")
    assert ctype in ("int", "float"), f"unexpected C parameter {param!r}"
    return ctype


def _c_entry_points() -> dict[str, list[str]]:
    found = {}
    for path in _build.sources():
        if not path.endswith(".cu"):
            continue
        with open(path) as f:
            text = f.read()
        for name, params in _ENTRY.findall(text):
            assert name not in found, f"{name} defined twice"
            found[name] = [_kind(p) for p in params.split(",")]
    return found


def test_every_entry_point_has_a_signature():
    assert sorted(_c_entry_points()) == sorted(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_signature_matches_c_declaration(name):
    declared = _c_entry_points()[name]
    bound = [_KINDS[t] for t in _build._SIGNATURES[name]]
    assert bound == declared, (
        f"{name}: ctypes {bound} vs C declaration {declared}")
    # the stream is the last argument and a pointer
    assert declared[-1] == "pointer"


def test_parser_tells_the_kinds_apart():
    assert [_kind(p) for p in ("const void* q", "void *out", "int B",
                               "float scale", "const int n")] == [
        "pointer", "pointer", "int", "float", "int"]


@pytest.mark.parametrize("name", ["attention.cu", "dense_wgmma.cu",
                                  "prefix_attention.cu", "decode_wgmma.cuh",
                                  "flash_wgmma.cuh", "wgmma.cuh", "tma.cuh"])
def test_source_is_part_of_the_build(name):
    listed = {os.path.basename(p) for p in _build.sources()}
    assert name in listed
    # and nothing under csrc/ is left out of the hash and the compile
    on_disk = {f for f in os.listdir(_build.CSRC_DIR)
               if f.endswith((".cu", ".cuh"))}
    assert on_disk == listed


def test_includes_resolve_inside_csrc():
    for path in _build.sources():
        with open(path) as f:
            for inc in re.findall(r'#include\s+"([^"]+)"', f.read()):
                assert os.path.exists(os.path.join(_build.CSRC_DIR, inc)), (
                    f"{os.path.basename(path)} includes missing {inc}")


def test_build_directory_is_ignored_by_git():
    rel = os.path.relpath(_build.BUILD_DIR, REPO)
    assert rel == os.path.join("cover_vla_tpu_torch", "build")
    probe = os.path.join(rel, "kernels-0123456789abcdef.so")
    out = subprocess.run(["git", "check-ignore", "-q", probe], cwd=REPO)
    if out.returncode == 128:       # not a git checkout: read the file
        with open(os.path.join(REPO, ".gitignore")) as f:
            patterns = {line.strip() for line in f}
        assert patterns & {"build/", "cover_vla_tpu_torch/build/"}
    else:
        assert out.returncode == 0, f"{probe} is not ignored"


def test_wgmma_kernels_issue_warpgroup_products():
    """K2 and K3 reach the wgmma body, and the flags keep the `a` of
    sm_90a without which wgmma does not assemble."""
    for name in ("dense_wgmma.cu", "prefix_attention.cu"):
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            assert '#include "flash_wgmma.cuh"' in f.read()
    with open(os.path.join(_build.CSRC_DIR, "wgmma.cuh")) as f:
        assert "wgmma.mma_async.sync.aligned" in f.read()
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
