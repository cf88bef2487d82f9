"""Timing / logging / device-memory observability, and the program's spans.

Mirrors the reference's monitor utilities (Timer, setup_logger,
log_allocated_gpu_memory, blockprint), with the device memory read from
``torch.cuda`` and traces taken by ``torch.profiler``.

Spans and transfer counters: ``span(name, **ids)`` marks a stage of the
program and ``to_device`` / ``to_host`` make its host-device copies. Both
do nothing beyond their work unless recording is on (``recording()``,
and ``profile_trace`` for its scope); then each span is kept as a
``SpanRecord`` (read with ``drain()``) and opens a
``torch.profiler.record_function`` range, so that a profiled run shows it
in the same trace, on the same clock, as the device work it launched.

The JAX package also points XLA's persistent compilation cache at a shared
directory (``enable_persistent_compile_cache``). The port compiles no
programs at run time and has no counterpart; the nearest thing is the
kernels' build cache in ``_build.py``, where a library built from the same
sources and flags is reused.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import sys
import threading
import time
from typing import Optional

import torch


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
    """torch.profiler scope over the CPU and CUDA activities, with the
    program's spans recorded; the chrome trace is written to `log_dir`
    (viewable in TensorBoard / Perfetto), the spans as `user_annotation`
    events."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with recording(), profile(activities=acts) as prof:
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


# ---------------------------------------------------------------------------
# Spans and host-device transfer counters
# ---------------------------------------------------------------------------

_recording = False
_records: list = []
_open = threading.local()      # .stack: the spans open on this thread
_sid = itertools.count()


class SpanRecord:
    """One span: `name`; `sid`, its number in this process; `parent`, the
    sid of the span open on the same thread when it opened (None for a
    root); `boundary`, the ids given to its root span as sorted (key,
    value) pairs, shared by the whole tree; `t0` and `t1`, the host clock
    (`time.perf_counter`) at its start and end (`t1` None while open);
    `counts`, the transfers made while it was the innermost open span:
    `h2d_copies`, `h2d_bytes`, `h2d_wait_s`, `d2h_copies`, `d2h_bytes`,
    `d2h_wait_s` (the wait: the host clock around the copy), and the
    quantities `count` added under it."""

    __slots__ = ("name", "sid", "parent", "boundary", "t0", "t1", "counts")

    def __init__(self, name, sid, parent, boundary, t0):
        self.name, self.sid, self.parent = name, sid, parent
        self.boundary, self.t0, self.t1 = boundary, t0, None
        self.counts = {}


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "ids", "rec", "range")

    def __init__(self, name, ids):
        self.name, self.ids = name, ids

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        boundary = (tuple(sorted(self.ids.items())) if self.ids
                    else parent.boundary if parent is not None else None)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.rec = SpanRecord(self.name, next(_sid),
                              None if parent is None else parent.sid,
                              boundary, time.perf_counter())
        _records.append(self.rec)
        stack.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        self.rec.t1 = time.perf_counter()
        _stack().pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, **ids):
    """A stage of the program, as a context manager. `ids` name the tree
    it roots (a chunk boundary: the engine's sequence number and boundary
    index); a span given none inherits its parent's. With recording off
    it is a shared object that does nothing."""
    if not _recording:
        return _NO_SPAN
    return _Span(name, ids)


@contextlib.contextmanager
def recording():
    """Record spans and transfer counters within this scope."""
    global _recording
    was = _recording
    _recording = True
    try:
        yield
    finally:
        _recording = was


def drain() -> list:
    """The spans recorded so far, in the order they opened; clears them."""
    global _records
    out, _records = _records, []
    return out


def _count(kind: str, nbytes: int, wait_s: float) -> None:
    stack = _stack()
    if not stack:
        return
    c = stack[-1].counts
    c[kind + "_copies"] = c.get(kind + "_copies", 0) + 1
    c[kind + "_bytes"] = c.get(kind + "_bytes", 0) + nbytes
    c[kind + "_wait_s"] = c.get(kind + "_wait_s", 0.0) + wait_s


def count(key: str, n) -> None:
    """With recording on, add `n` to the counter `key` of the innermost
    open span (a quantity the host knows, such as the rows a product ran
    over); nothing otherwise."""
    if not _recording:
        return
    stack = _stack()
    if stack:
        c = stack[-1].counts
        c[key] = c.get(key, 0) + n


def to_device(x, device, dtype=None) -> torch.Tensor:
    """`torch.as_tensor(x, dtype=dtype, device=device)`: the same copy,
    dtype, blocking and stream. With recording on, a host value (an
    array, a scalar or a CPU tensor bound for another device) counts as
    one host-to-device copy of the result's bytes on the innermost open
    span, with the host clock around it as its wait (on a CUDA device a
    pageable copy waits for its stream). On a CPU device the same calls
    count, though nothing moves."""
    if not _recording:
        return torch.as_tensor(x, dtype=dtype, device=device)
    host = not isinstance(x, torch.Tensor) or (
        x.device.type == "cpu" and torch.device(device).type != "cpu")
    t0 = time.perf_counter()
    out = torch.as_tensor(x, dtype=dtype, device=device)
    if host:
        _count("h2d", out.numel() * out.element_size(),
               time.perf_counter() - t0)
    return out


def to_host(t: torch.Tensor) -> torch.Tensor:
    """`t.cpu()`; with recording on, one device-to-host copy of its bytes
    and the host clock around it on the innermost open span."""
    if not _recording:
        return t.cpu()
    t0 = time.perf_counter()
    out = t.cpu()
    _count("d2h", out.numel() * out.element_size(), time.perf_counter() - t0)
    return out
