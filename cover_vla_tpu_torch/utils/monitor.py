"""Timing / logging / device-memory observability.

Mirrors the reference's monitor utilities (Timer, the log_execution_time
decorator, setup_logger, log_allocated_gpu_memory, blockprint), with the
device memory read from ``torch.cuda`` and traces taken by
``torch.profiler``.

The JAX package also points XLA's persistent compilation cache at a shared
directory (``enable_persistent_compile_cache``). The port compiles no
programs at run time and has no counterpart; the nearest thing is the
kernels' build cache in ``_build.py``, where a library built from the same
sources and flags is reused.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import sys
import time
from typing import Optional


class Timer:
    """Incremental wall-clock timer: elapsed() returns time since last call."""

    def __init__(self):
        self._t = time.time()

    def elapsed(self) -> float:
        now = time.time()
        dt = now - self._t
        self._t = now
        return dt

    def reset(self):
        self._t = time.time()


def log_execution_time(logger: Optional[logging.Logger] = None):
    """Decorator: log the wall time of each call."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **kw):
            t0 = time.time()
            out = fn(*a, **kw)
            (logger or logging.getLogger(fn.__module__)).info(
                "%s took %.3fs", fn.__name__, time.time() - t0)
            return out
        return wrapped
    return deco


def setup_logger(name: str = "cover_vla_tpu_torch",
                 log_file: Optional[str] = None,
                 level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        fmt = logging.Formatter(
            "[%(asctime)s] %(name)s %(levelname)s: %(message)s")
        sh = logging.StreamHandler(sys.stderr)
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if log_file:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


def log_device_memory(logger: Optional[logging.Logger] = None,
                      tag: str = "") -> dict:
    """Per-CUDA-device memory of this process: bytes allocated now, at
    peak, and the device's total. Without a CUDA device the result says
    available=False rather than reporting zeros."""
    import torch
    if not torch.cuda.is_available():
        return {"cuda": {"available": False,
                         "reason": "no CUDA device in this process"}}
    out = {}
    for i in range(torch.cuda.device_count()):
        entry = {"available": True,
                 "bytes_in_use": torch.cuda.memory_allocated(i),
                 "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
                 "bytes_limit": torch.cuda.get_device_properties(i)
                 .total_memory}
        out[f"cuda:{i}"] = entry
        if logger:
            logger.info("%s cuda:%d: %.2f/%.2f GB (peak %.2f)", tag, i,
                        entry["bytes_in_use"] / 2**30,
                        entry["bytes_limit"] / 2**30,
                        entry["peak_bytes_in_use"] / 2**30)
    return out


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler scope over the CPU and CUDA activities; the chrome
    trace is written to `log_dir` (viewable in TensorBoard / Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class blockprint:
    """Context manager silencing stdout."""

    def __enter__(self):
        self._stdout = sys.stdout
        sys.stdout = open(os.devnull, "w")
        return self

    def __exit__(self, *exc):
        sys.stdout.close()
        sys.stdout = self._stdout
        return False
