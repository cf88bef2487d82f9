"""`scripts/torch_roofline.py`: the category breakdown of a torch.profiler
chrome trace, on synthetic traces written the way the profiler writes
them (device events on two streams, CPU operators joined to their kernels
through `External id`, copies with their bytes, a hand kernel's work
record), checked exactly; a trace without device events raises. Also the
hand kernels' work reckoning shared with `chip_smoke.py`
(`ops/kernel_work.py`)."""

import gzip
import importlib.util
import json
import os

import pytest
import torch

from cover_vla_tpu_torch import bench
from cover_vla_tpu_torch.ops import kernel_work

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"
K1_NAME = ("void (anonymous namespace)::decode_wgmma_kernel<256>((anonymous "
           "namespace)::DecodeParams)")
K2_NAME = ("void (anonymous namespace)::flash_wgmma_kernel<64, 3, false>("
           "(anonymous namespace)::WgParams)")
K3_NAME = ("void (anonymous namespace)::flash_wgmma_kernel<256, 2, true>("
           "(anonymous namespace)::WgParams)")
ADD_NAME = ("void at::native::vectorized_elementwise_kernel<4, "
            "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int)")


@pytest.fixture(scope="module")
def rf():
    spec = importlib.util.spec_from_file_location(
        "torch_roofline", os.path.join(ROOT, "scripts", "torch_roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dev(name, ts, dur, stream, ext=None, cat="kernel", **args):
    a = {"device": 0, "stream": stream, **args}
    if ext is not None:
        a["External id"] = ext
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream,
            "ts": ts, "dur": dur, "args": a}


def _op(name, ts, ext, dims, types, **args):
    return {"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": 1,
            "ts": ts, "dur": 5.0, "args": {"External id": ext,
                                          "Input Dims": dims,
                                          "Input type": types, **args}}


def _trace(events, work=None, device=H100):
    t = {"deviceProperties": [{"id": 0, "name": device}],
         "traceEvents": events}
    if work is not None:
        t["cvlaKernelWork"] = work
    return t


def _events():
    """Two steps. Stream 7: a bf16 GEMM (aten::mm [64, 128] @ [128, 256],
    two kernels: the GEMM and its split-K reduction), K1 (no operator),
    an HtoD copy of 4 MB; stream 9: an elementwise add inside the GEMM's
    time and an fp32 addmm. Each kernel 10 us but the copy (4)."""
    ev = []
    for s, t0 in enumerate((0.0, 1000.0)):
        ext = 100 * (s + 1)
        ev += [
            _op("aten::mm", t0, ext, [[64, 128], [128, 256]],
                ["c10::BFloat16", "c10::BFloat16"]),
            _dev("nvjet_tst_128x80_64x8_1x2_h_bz_NNT", t0 + 10, 10.0, 7, ext),
            _dev("void cublasLt::splitKreduce_kernel<32, 16>()", t0 + 20, 10.0,
                 7, ext),
            _dev(K1_NAME, t0 + 40, 10.0, 7),
            _dev("Memcpy HtoD (Pageable -> Device)", t0 + 60, 4.0, 7, ext + 1,
                 cat="gpu_memcpy", bytes=4_000_000),
            _op("aten::add", t0, ext + 2, [[8, 8], [8, 8]],
                ["float", "float"]),
            _dev(ADD_NAME, t0 + 15, 10.0, 9, ext + 2),
            _op("aten::addmm", t0, ext + 3, [[32], [16, 64], [64, 32], [], []],
                ["float", "float", "float", "Scalar", "Scalar"]),
            _dev("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8",
                 t0 + 100, 10.0, 9, ext + 3),
        ]
    return ev


def test_categories_counts_and_rates(rf):
    work = {"shared_prefix_gqa": {"launches": 2, "flops": 2e9,
                                  "bytes": 1e8}}
    res = rf.roofline(_trace(_events(), work), steps=2)
    cats = {r["category"]: r for r in res["categories"]}
    assert list(cats) == ["K1", "gemm_bf16", "gemm_fp32", "elementwise",
                          "copy_memset"]
    # per step: the GEMM's two kernels cover 10-30 us, the add's 15-25 us
    # lie inside them, so the union is 20 + 10 + 4 + 10 = 44 us and the
    # sum 54
    assert res["busy_ms_per_step"] == pytest.approx(0.044, abs=1e-12)
    assert res["category_sum_ms_per_step"] == pytest.approx(0.054, abs=1e-12)
    assert res["device"] == H100 and res["device_events"] == 12
    g = cats["gemm_bf16"]
    assert g["launches_per_step"] == 2 and g["ms_per_step"] == 0.02
    assert g["share_of_busy"] == pytest.approx(20 / 44, rel=1e-12)
    # the operator's work once over both of its kernels' 20 us
    flops = 2 * 64 * 128 * 256
    nbytes = (64 * 128 + 128 * 256 + 64 * 256) * 2
    assert g["tflops"] == pytest.approx(flops / 20e-6 / 1e12, rel=1e-12)
    assert g["tbs"] == pytest.approx(nbytes / 20e-6 / 1e12, rel=1e-12)
    assert g["flops_frac"] == pytest.approx(g["tflops"] / 989, rel=1e-12)
    f = cats["gemm_fp32"]                     # addmm's bias comes first
    assert f["tflops"] == pytest.approx(2 * 16 * 64 * 32 / 10e-6 / 1e12,
                                        rel=1e-12)
    assert f["peak_tflops"] == 67.0
    k1 = cats["K1"]
    assert k1["launches_per_step"] == 1 and k1["ms_per_step"] == 0.01
    assert k1["launches_lost"] == 0 and g["launches_lost"] is None
    assert k1["tflops"] == pytest.approx(2e9 / 20e-6 / 1e12, rel=1e-12)
    assert k1["tbs"] == pytest.approx(1e8 / 20e-6 / 1e12, rel=1e-12)
    assert k1["hbm_frac"] == pytest.approx(k1["tbs"] / 3.35, rel=1e-12)
    c = cats["copy_memset"]
    assert c["tbs"] == pytest.approx(4e6 / 4e-6 / 1e12, rel=1e-12)
    assert c["tflops"] is None
    e = cats["elementwise"]
    assert e["launches_per_step"] == 1 and e["tflops"] is None \
        and e["tbs"] is None
    assert all(r["share_of_busy"] <= 1 for r in res["categories"])


def test_hand_kernels_and_peaks(rf, tmp_path):
    """K2 / K3 by the template's EXACT flag, an unknown card's null peaks,
    a `flops` entry on the operator, the newest trace of a directory
    (gzip too), a launch the trace lost, and a work record with fewer
    launches than the trace."""
    ev = [_dev(K2_NAME, 0.0, 10.0, 7), _dev(K3_NAME, 20.0, 10.0, 7),
          _op("aten::_int_mm", 0, 5, [[32, 64], [64, 16]],
              ["signed char", "signed char"], flops=99.0),
          _dev("void gemm_int8_kernel()", 40.0, 10.0, 7, 5)]
    # a shapeless operator with two kernels gives no rate
    ev += [_op("aten::mm", 0, 6, None, None),
           _dev("nvjet_a", 60.0, 10.0, 7, 6), _dev("nvjet_b", 70.0, 10.0, 7, 6)]
    res = rf.roofline(_trace(ev, device="Some GPU"), steps=1)
    cats = {r["category"]: r for r in res["categories"]}
    assert list(cats) == ["K2", "K3", "gemm_bf16", "gemm_int8"]
    assert cats["gemm_bf16"]["tflops"] is None \
        and cats["gemm_bf16"]["tbs"] is None
    assert cats["gemm_bf16"]["launches_per_step"] == 2
    assert cats["K2"]["tflops"] is None and cats["K2"]["peak_tflops"] is None
    i8 = cats["gemm_int8"]
    assert i8["tflops"] == pytest.approx(99.0 / 10e-6 / 1e12, rel=1e-12)
    assert i8["tbs"] == pytest.approx((32 * 64 + 64 * 16 + 32 * 16 * 4)
                                      / 10e-6 / 1e12, rel=1e-12)
    assert i8["flops_frac"] is None and i8["hbm_frac"] is None

    old = tmp_path / "a" / "old.json"
    old.parent.mkdir()
    old.write_text(json.dumps(_trace([])))
    new = tmp_path / "b" / "trace.json.gz"
    new.parent.mkdir()
    with gzip.open(new, "wt") as f:
        json.dump(_trace(ev), f)
    os.utime(old, (1, 1))
    assert rf.trace_path(str(tmp_path)) == str(new)
    assert rf.load_trace(str(new))["traceEvents"] == ev
    # a launch the device tracer lost: the work of the one it holds
    lost = rf.roofline(_trace(ev, {"mha_dense": {"launches": 2, "flops": 4e6,
                                                 "bytes": 2e6}}), steps=1)
    k2 = next(r for r in lost["categories"] if r["category"] == "K2")
    assert k2["launches_lost"] == 1 and k2["launches_per_step"] == 1
    assert k2["tflops"] == pytest.approx(2e6 / 10e-6 / 1e12, rel=1e-12)
    assert k2["tbs"] == pytest.approx(1e6 / 10e-6 / 1e12, rel=1e-12)
    with pytest.raises(RuntimeError, match="1 in its work record"):
        rf.roofline(_trace(ev + [_dev(K2_NAME, 90.0, 10.0, 7)], {
            "mha_dense": {"launches": 1, "flops": 1.0, "bytes": 1.0}}),
            steps=1)


def test_no_device_events_raise(rf, tmp_path):
    cpu_only = [_op("aten::mm", 0, 1, [[2, 2], [2, 2]], ["float", "float"])]
    with pytest.raises(RuntimeError, match="no device event"):
        rf.roofline(_trace(cpu_only), steps=1)
    with pytest.raises(FileNotFoundError):
        rf.trace_path(str(tmp_path))
    (tmp_path / "trace.json").write_text(json.dumps(_trace(cpu_only)))
    with pytest.raises(RuntimeError, match="no device event"):
        rf.main(["--trace-dir", str(tmp_path), "--steps", "1"])


def test_the_union_is_the_bench_busy_time(rf, tmp_path):
    (tmp_path / "trace.json").write_text(json.dumps(_trace(_events())))
    res = rf.main(["--trace-dir", str(tmp_path), "--steps", "2"])
    assert res["busy_ms_per_step"] * 2e-3 == pytest.approx(
        bench.trace_device_busy_s(str(tmp_path)), rel=1e-12)


def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "pid": 1,
            "tid": tid, "ts": ts, "dur": dur, "args": {}}


def _spanned():
    """`_events()` with the program's spans: the operators (at t0) inside
    `pi0.prefix`, K1's launch (a runtime call on the host thread) inside
    `pi0.denoise`, both inside `engine.step_async`, which ends at t0 + 55;
    the copy launched from a second thread that holds no span then; in the
    first step a span of that thread covers the gap from 110 us; the
    profiler's device-side copies of the spans and its step annotation."""
    ev = _events()
    for s, t0 in enumerate((0.0, 1000.0)):
        c = 900 + s
        for e in ev:
            if e["ts"] == t0 + 40 or e["ts"] == t0 + 60:
                e["args"]["correlation"] = c if e["ts"] == t0 + 40 else c + 2
        ev += [_span("engine.step_async", t0 - 1, 56.0),
               _span("pi0.prefix", t0, 3.0),
               _span("pi0.denoise", t0 + 3.5, 2.5),
               {"ph": "X", "cat": "cuda_runtime", "name": "cuLaunchKernelEx",
                "pid": 1, "tid": 1, "ts": t0 + 4, "dur": 1.0,
                "args": {"correlation": c}},
               {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
                "pid": 1, "tid": 2, "ts": t0 + 40, "dur": 1.0,
                "args": {"correlation": c + 2}},
               {"ph": "X", "cat": "gpu_user_annotation",
                "name": "pi0.prefix", "pid": 0, "tid": 7, "ts": t0 + 10,
                "dur": 20.0, "args": {}}]
    ev[1:1] = [_span("bench.env_step", 105.0, 45.0, tid=2),
               _span("ProfilerStep#1", -5.0, 2000.0)]
    return ev


def test_by_span_attributes_device_and_idle_time(rf, tmp_path):
    rows = {r["span"]: r for r in rf.by_span(_trace(_spanned()), steps=2)}
    assert list(rows)[:3] == ["pi0.prefix", "pi0.denoise", "no_span"]
    p, d, n = rows["pi0.prefix"], rows["pi0.denoise"], rows["no_span"]
    assert p["ms_per_step"] == pytest.approx(0.04, abs=1e-12)
    assert p["launches_per_step"] == 4
    assert p["categories"] == pytest.approx(
        {"gemm_bf16": 0.02, "elementwise": 0.01, "gemm_fp32": 0.01},
        abs=1e-12)
    # K1, outside any operator, through its runtime call's correlation
    assert d["categories"] == pytest.approx({"K1": 0.01}, abs=1e-12)
    # the copy's launch lies in no span of its own thread
    assert n["categories"] == pytest.approx({"copy_memset": 0.004},
                                            abs=1e-12)
    # gaps from 30 and 50 us in the root span, from 64 us in none, the
    # 900 us gap from 110 us under the second thread's span
    assert rows["engine.step_async"]["idle_ms_per_step"] == pytest.approx(
        0.02, abs=1e-12)
    assert n["idle_ms_per_step"] == pytest.approx(0.036, abs=1e-12)
    assert rows["bench.env_step"]["idle_ms_per_step"] == pytest.approx(
        0.45, abs=1e-12)
    assert rows["bench.env_step"]["launches_per_step"] == 0
    assert p["idle_ms_per_step"] == d["idle_ms_per_step"] == 0
    assert sum(r["ms_per_step"] for r in rows.values()) == pytest.approx(
        0.054, abs=1e-12)
    assert rf.by_span(_trace(_events()), steps=2) == []

    t = _trace(_spanned())
    t["cvlaSpanCounts"] = {"pi0.denoise": {"h2d_copies": 22,
                                            "h2d_bytes": 400}}
    (tmp_path / "trace.json").write_text(json.dumps(t))
    res = rf.main(["--trace-dir", str(tmp_path), "--steps", "2"])
    assert res["by_span"] == rf.by_span(t, steps=2)
    assert res["span_counts"] == {"pi0.denoise": {"h2d_copies": 11,
                                                   "h2d_bytes": 200}}


def test_spans_leave_the_categories_unchanged(rf):
    plain = rf.roofline(_trace(_events()), steps=2)
    assert rf.roofline(_trace(_spanned()), steps=2) == plain


def test_kernel_work_reckoning():
    """The bytes and FLOPs `chip_smoke.py` bounds the kernels with: every
    input once plus the bf16 result, and the attended pairs."""
    bf = torch.bfloat16
    b, n, s, hq, hkv, d, p = 2, 3, 5, 4, 1, 16, 7
    q = torch.zeros((b, n, s, hq, d), dtype=bf)
    kv = torch.zeros((b, n, s, hkv, d), dtype=bf)
    kp = torch.zeros((b, p, hkv, d), dtype=bf)
    pad = torch.tensor([[True] * 4 + [False] * 3, [True] * 7])
    smask = torch.ones((b, s, s), dtype=torch.bool)
    nbytes, flops = kernel_work.k1_work((q, kv, kv, kp, kp, pad, smask))
    assert nbytes == 2 * (q.numel() * 2 + 2 * kv.numel() + 2 * kp.numel()) \
        + pad.numel() + smask.numel()
    assert flops == 4 * n * s * hq * d * ((4 + s) + (7 + s))
    q2 = torch.zeros((2, 9, 3, 8), dtype=bf)
    assert kernel_work.k2_work((q2, q2, q2)) == (4 * q2.numel() * 2,
                                                 4 * 2 * 3 * 9 * 9 * 8)
    q3 = torch.zeros((1, 4, 8, 16), dtype=bf)
    k3 = torch.zeros((1, 6, 1, 16), dtype=bf)
    mask = torch.zeros((1, 4, 6), dtype=torch.bool)
    mask[0, :, :3] = True
    assert kernel_work.k3_work((q3, k3, k3, mask)) == (
        2 * q3.numel() * 2 + 2 * k3.numel() * 2 + mask.numel(),
        4 * 8 * 16 * 12)
    assert set(kernel_work.WORK) == {"shared_prefix_gqa", "mha_dense",
                                     "prefix_gqa"}
