"""The window's whole-boundary rate on a synthetic timeline, and the
trace readers on a synthetic two-stream trace."""

from types import SimpleNamespace

import pytest

from coverbench import harness, trace, yardstick
from coverbench.backbones import gemma
from coverbench.metrics import (chunk_ms_p90, enqueue_ms,
                                gemm_ms_per_boundary,
                                glue_ms_per_boundary, k1_roofline,
                                k2_roofline, k3_roofline,
                                launches_per_boundary, step_mfu,
                                verified_actions_per_s, window_idle_share)


class FakeCohort:
    """Resolves a boundary every `period` seconds of a fake clock."""

    def __init__(self, clock, period):
        self.clock, self.period = clock, period
        self.current = None

    def enqueue(self):
        t = self.clock[0]
        self.current = SimpleNamespace(t_enqueue=(t, t + 0.01),
                                       t_resolved=None)

    def finish(self):
        self.clock[0] += self.period
        self.current.t_resolved = self.clock[0]
        return self.current


def test_window_counts_whole_boundaries():
    clock = [100.0]
    pipe = harness.Pipeline([FakeCohort(clock, 0.3), FakeCohort(clock, 0.3)])
    pipe.run(turns=4)                           # warm-up
    opened = pipe.run(turns=1)[-1].t_resolved
    window = pipe.run(until=opened + 2.0)
    closed = window[-1].t_resolved
    # it closes on the first boundary resolved at or after the end
    assert closed >= opened + 2.0 > window[-2].t_resolved
    assert len(window) == 7 and closed - opened == pytest.approx(2.1)
    ctx = {"window": window, "window_s": closed - opened, "E": 16,
           "chunk": 4}
    assert verified_actions_per_s.read(ctx) == pytest.approx(
        7 * 16 * 4 / 2.1)
    assert enqueue_ms.read(ctx) == pytest.approx(10.0)
    # a boundary resolves in its cohort's next turn, after the other's
    assert chunk_ms_p90.read(ctx) == pytest.approx(600.0)


def _ev(name, ts, dur, cat="kernel", ext=None, stream=7):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": stream, "args": {}}
    if ext is not None:
        e["args"]["External id"] = ext
    return e


def _op(name, ts, dur, ext, types=None):
    e = {"ph": "X", "cat": "cpu_op", "name": name, "ts": ts, "dur": dur,
         "tid": 1, "args": {"External id": ext}}
    if types:
        e["args"]["Input type"] = types
    return e


def synthetic_trace():
    """Two streams: stream 7 runs a bf16 GEMM [0, 100), K1 [100, 150),
    an elementwise kernel [400, 450); stream 8 runs an int8 GEMM
    [50, 130), K3 [200, 260), K2 [260, 300), a memcpy [300, 310). The
    union is [0, 150) + [200, 310) + [400, 450) = 310 us."""
    return {"traceEvents": [
        _op("aten::mm", 0, 5, 1, ["c10::BFloat16", "c10::BFloat16"]),
        _op("aten::_int_mm", 40, 5, 2, ["signed char", "signed char"]),
        _op("aten::add", 380, 5, 3, ["float", "float"]),
        _op("aten::copy_", 150, 60, 4),
        _ev("nvjet_tst_64x96_h_bz_NNT", 0, 100, ext=1),
        _ev("void (anonymous namespace)::decode_wgmma_kernel<256>(P)",
            100, 50),
        _ev("void at::native::elementwise_kernel<128, 2>(f)", 400, 50,
            ext=3),
        _ev("cutlass_80_tensorop_i8i8_gemm", 50, 80, ext=2, stream=8),
        _ev("void (anonymous namespace)::flash_wgmma_kernel<256, 2, true>"
            "(W)", 200, 60, stream=8),
        _ev("void (anonymous namespace)::flash_wgmma_kernel<64, 3, false>"
            "(W)", 260, 40, stream=8),
        _ev("Memcpy DtoH (Device -> Pinned)", 300, 10, cat="gpu_memcpy",
            stream=8),
    ]}


def test_trace_summary_two_streams():
    s = trace.summarize(synthetic_trace(), window_s=500e-6, boundaries=2,
                        kernels=gemma.KERNELS)
    assert s["busy_s"] == pytest.approx(310e-6)
    cats = s["by_category"]
    assert cats["gemm_bf16"] == {"us": 100.0, "launches": 1}
    assert cats["gemm_int8"] == {"us": 80.0, "launches": 1}
    assert cats["K1"]["us"] == 50.0 and cats["K3"]["us"] == 60.0
    assert cats["K2"]["us"] == 40.0
    assert cats["elementwise"]["us"] == 50.0
    assert cats["copy_memset"]["us"] == 10.0
    assert s["launches"] == 7
    # the idle gaps: [150, 200) under aten::copy_, [310, 400) under none
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(50e-6)
    assert gaps["no_operator"] == pytest.approx(90e-6)
    assert s["device_ops"][0][1] == pytest.approx(100e-6)

    ctx = {"trace": s, "window": [object()] * 10, "window_s": 0.002}
    # 155 us of device work a boundary, 10 boundaries in 2 ms
    assert window_idle_share.read(ctx) == pytest.approx(100 * (1 - 1.55 / 2))
    assert launches_per_boundary.read(ctx) == 3.5
    assert gemm_ms_per_boundary.read(ctx) == pytest.approx(0.09)
    assert glue_ms_per_boundary.read(ctx) == pytest.approx(0.03)


def test_rooflines_from_shapes():
    s = trace.summarize(synthetic_trace(), window_s=500e-6, boundaries=2,
                        kernels=gemma.KERNELS)
    dev = "NVIDIA H100 80GB HBM3"
    hbm, peak = yardstick.PEAK_HBM_BYTES[dev], yardstick.PEAK_FLOPS[dev]
    k1 = gemma.k1_work([300, 280], n=5, s=5, hq=8, hkv=1, d=256, p_len=328)
    k2 = yardstick.k2_work(b=16, s=576, h=16, d=64)
    k3 = gemma.k3_work([300, 280], p_len=328, hq=8, hkv=1, d=256)
    work = {"K1": [k1[0], k1[1], 1], "K2": [k2[0], k2[1], 1],
            "K3": [k3[0], k3[1], 1]}
    ctx = {"trace": s, "kernel_work": work, "device_name": dev}
    for mod, (nbytes, flops), us in ((k1_roofline, k1, 50.0),
                                     (k2_roofline, k2, 40.0),
                                     (k3_roofline, k3, 60.0)):
        want = 100 * max(nbytes / hbm, flops / peak) / (us * 1e-6)
        assert mod.read(ctx) == pytest.approx(want)
    # FLOPs of the attended pairs: K3 counts valid x valid per row
    assert k3[1] == 4 * 8 * 256 * (300 ** 2 + 280 ** 2)
    assert k1[1] == 4 * 5 * 5 * 8 * 256 * (300 + 280 + 2 * 5)
    # a card outside the tables reads nothing, never 0
    assert k1_roofline.read(dict(ctx, device_name="other")) is None
    assert k1_roofline.read(dict(ctx, trace=None)) is None


def test_step_mfu():
    import json, os
    with open(os.path.join(harness.HERE, "configs",
                           "pi0_cover_bf16.json")) as f:
        cfg = json.load(f)
    window = [object()] * 10
    ctx = {"config": cfg, "K": 8, "N": 5, "E": 16, "window": window,
           "window_s": 5.0, "device_name": "NVIDIA H100 80GB HBM3"}
    flops = yardstick.analytic_flops(cfg, 8, 5, 16)
    assert flops == pytest.approx(200.0158e12, rel=1e-5)
    assert step_mfu.read(ctx) == pytest.approx(100 * flops * 2 / 989e12)
    assert step_mfu.read(dict(ctx, device_name="cpu")) is None
