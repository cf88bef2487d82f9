"""The per-layer metrics that read the program's spans and counters: device
time by innermost span on a synthetic trace (`trace.by_span`), and the
counters over a synthetic window of span records; each reads nothing
without them."""

from types import SimpleNamespace

import pytest

from coverbench import trace
from coverbench.backbones import gemma
from coverbench.metrics import (denoise_ms_per_boundary,
                                h2d_copies_per_boundary,
                                h2d_wait_ms_per_boundary,
                                prefix_ms_per_boundary,
                                resolve_wait_ms_per_boundary,
                                tokenize_ms_per_boundary,
                                verify_ms_per_boundary)

DEVICE = (prefix_ms_per_boundary, denoise_ms_per_boundary,
          verify_ms_per_boundary)
HOST = (tokenize_ms_per_boundary, h2d_copies_per_boundary,
        h2d_wait_ms_per_boundary, resolve_wait_ms_per_boundary)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def span_trace():
    """Spans on the host thread: prefix [0, 100), denoise [100, 200),
    towers [200, 250), heads [250, 300). Device: a GEMM [10, 90) launched
    in the prefix, K1 [130, 170) launched in the denoise through the
    runtime, elementwise kernels [215, 235) and [262, 272) launched in the
    towers and heads, and one [400, 410) with no host record."""
    return {"traceEvents": [
        _x("user_annotation", "pi0.prefix", 0, 100),
        _x("user_annotation", "pi0.denoise", 100, 100),
        _x("user_annotation", "step.verifier_towers", 200, 50),
        _x("user_annotation", "step.verifier_heads", 250, 50),
        _x("cpu_op", "aten::mm", 10, 5, **{"External id": 1}),
        _x("cuda_runtime", "cudaLaunchKernel", 120, 5, correlation=5),
        _x("cpu_op", "aten::add", 210, 5, **{"External id": 3}),
        _x("cpu_op", "aten::mul", 260, 5, **{"External id": 4}),
        _x("kernel", "nvjet_tst_64x96_h_bz_NNT", 10, 80, tid=7,
           **{"External id": 1}),
        _x("kernel", "void (anonymous namespace)::decode_wgmma_kernel<256>"
           "(P)", 130, 40, tid=7, correlation=5),
        _x("kernel", "void at::native::elementwise_kernel<128, 2>(f)", 215,
           20, tid=7, **{"External id": 3}),
        _x("kernel", "void at::native::elementwise_kernel<128, 2>(f)", 262,
           10, tid=7, **{"External id": 4}),
        _x("kernel", "void at::native::elementwise_kernel<128, 2>(f)", 400,
           10, tid=7),
    ]}


def test_by_span_and_device_metrics():
    rows = {r["span"]: r for r in trace.by_span(span_trace(), 2,
                                                gemma.KERNELS)}
    assert rows["pi0.prefix"]["ms_per_step"] == pytest.approx(0.04)
    assert rows["pi0.denoise"]["categories"] == {"K1": pytest.approx(0.02)}
    assert rows[trace.NO_SPAN]["launches_per_step"] == 0.5
    # idle by the span open when each gap began: [90, 130) in the prefix,
    # [170, 215) in the denoise, [235, 262) in the towers, [272, 400) in
    # the heads
    assert rows["pi0.prefix"]["idle_ms_per_step"] == pytest.approx(0.02)
    assert rows["step.verifier_heads"]["idle_ms_per_step"] == \
        pytest.approx(0.064)

    s = trace.summarize(span_trace(), 500e-6, 2, gemma.KERNELS)
    ctx = {"trace": s}
    assert prefix_ms_per_boundary.read(ctx) == pytest.approx(0.04)
    assert denoise_ms_per_boundary.read(ctx) == pytest.approx(0.02)
    assert verify_ms_per_boundary.read(ctx) == pytest.approx(0.015)
    assert s["device_by_span"][0] == ["pi0.prefix", pytest.approx(80e-6)]
    assert dict(s["idle_gaps_by_span"])["step.verifier_heads"] == \
        pytest.approx(128e-6)
    assert len(s["device_by_span"]) <= 10


def _rec(sid, name, t0, t1=None, parent=None, **counts):
    return SimpleNamespace(sid=sid, name=name, parent=parent, t0=t0,
                           t1=t0 if t1 is None else t1, counts=counts,
                           boundary=None)


def window_spans():
    """Two boundaries enqueued inside the window [10, 20] and one after;
    two resolves inside it and one before; the harness's env steps."""
    return [
        _rec(10, "engine.resolve", 5, d2h_wait_s=9.9),
        _rec(0, "engine.step_async", 11, 11.5),
        _rec(1, "engine.tokenize", 11.0, 11.002, parent=0),
        _rec(2, "step.inputs", 11.01, parent=0, h2d_copies=10,
             h2d_wait_s=0.001),
        _rec(3, "pi0.denoise", 11.1, parent=0, h2d_copies=11,
             h2d_wait_s=0.5),
        _rec(4, "bench.noise", 11.05, parent=0),
        _rec(8, "engine.resolve", 12, d2h_copies=5, d2h_wait_s=0.2),
        _rec(11, "bench.env_step", 13),
        _rec(5, "engine.step_async", 15, 15.5),
        _rec(6, "engine.tokenize", 15.0, 15.004, parent=5),
        _rec(12, "step.inputs", 15.01, parent=5, h2d_copies=14,
             h2d_wait_s=0.3),
        _rec(9, "engine.resolve", 16, d2h_copies=5, d2h_wait_s=0.4),
        _rec(7, "engine.step_async", 25, 26),
        _rec(13, "step.inputs", 25.01, parent=7, h2d_copies=99,
             h2d_wait_s=9.0),
    ]


def test_span_counters_over_the_window():
    ctx = {"spans": window_spans(), "opened": 10.0, "closed": 20.0}
    assert tokenize_ms_per_boundary.read(ctx) == pytest.approx(3.0)
    assert h2d_copies_per_boundary.read(ctx) == pytest.approx(17.5)
    assert h2d_wait_ms_per_boundary.read(ctx) == pytest.approx(400.5)
    assert resolve_wait_ms_per_boundary.read(ctx) == pytest.approx(300.0)


@pytest.mark.parametrize("metric", DEVICE + HOST,
                         ids=[m.__name__.split(".")[-1]
                              for m in DEVICE + HOST])
def test_span_metric_reads_nothing_without_spans(metric):
    """An untraced run records no span and has no trace: every reader
    returns None, and a trace without spans gives no device time."""
    untraced = {"trace": None, "spans": [], "opened": 10.0, "closed": 20.0}
    assert metric.read(untraced) is None
    bare = trace.summarize({"traceEvents": span_trace()["traceEvents"][4:]},
                           500e-6, 2, gemma.KERNELS)
    assert metric.read(dict(untraced, trace=bare)) is None
