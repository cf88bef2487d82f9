"""Build and load the package's CUDA kernels at first use.

The sources under ``csrc/`` are compiled with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per ``.cu`` file and all of them at
once, and linked into one shared library with a plain C interface,
``build/kernels-<hash of the sources and flags>.so`` inside this package
directory, which is loaded with ``ctypes``. A library whose hash matches
is reused; nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

# no --use_fast_math: the kernels keep IEEE divisions and round-to-nearest
# bf16 conversions so they stay within tolerance of their plain twins
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k_suf, v_suf, k_pre, v_pre, prefix_pad, suffix_mask, out,
    # B, N, S, Hkv, G, P, D, split, scale, stream
    "cvla_shared_prefix_gqa": [_P] * 8 + [_I] * 8 + [_F, _P],
    # q, k, v, out, B, Sq, Skv, H, D, scale, stream
    "cvla_mha_dense": [_P] * 4 + [_I] * 5 + [_F, _P],
    # q, k, v, mask, out, B, Sq, Skv, Hkv, G, D, scale, out_f32, stream
    "cvla_prefix_gqa": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
}


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: str
    build_seconds: float   # 0.0 when an existing library was reused
    compiler_log: str      # nvcc's -Xptxas -v report (registers, spills)


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu"))
                  + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _compile_and_link(work: str) -> str:
    """One `nvcc -c` per .cu file, all running at once, then one link into
    `work`/kernels.so. Returns the compilers' output."""
    nvcc = _nvcc()
    jobs = []
    for src in (s for s in sources() if s.endswith(".cu")):
        obj = os.path.join(work, os.path.basename(src)[:-3] + ".o")
        jobs.append((obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    outputs = [(proc.communicate()[0], proc.returncode) for _, proc in jobs]
    log = "".join(out for out, _ in outputs)
    if any(rc != 0 for _, rc in outputs):
        raise RuntimeError(f"nvcc failed:\n{log}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", os.path.join(work, "kernels.so"),
         *(obj for obj, _ in jobs)], capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    return log


@functools.cache
def load() -> KernelLibrary:
    """Compile (if needed) and load the kernel library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, f"kernels-{_digest()}.so")
    seconds, log = 0.0, ""
    if not os.path.exists(path):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            log = _compile_and_link(work)
            os.replace(os.path.join(work, "kernels.so"), path)   # atomic
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return KernelLibrary(lib=lib, path=path, build_seconds=seconds,
                         compiler_log=log)
