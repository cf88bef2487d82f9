"""The port's spans and transfer counters (`utils.monitor`): the span tree
of a chunk boundary in `BatchedCoVerEngine`, in the fused and the injected
selection modes, on tiny fp32 configs on the CPU; nothing recorded and no
profiler range entered with recording off; the step's outputs unchanged by
recording; `to_device` / `to_host` counting on the innermost span; the
spans in `profile_trace`'s chrome trace."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from cover_vla_tpu_torch import configs
from cover_vla_tpu_torch.data.stats import DatasetStatistics
from cover_vla_tpu_torch.data.tokenizer import HashTokenizer
from cover_vla_tpu_torch.engine import BatchedCoVerEngine
from cover_vla_tpu_torch.engine.verified_step import (
    make_verified_step_batched)
from cover_vla_tpu_torch.models import pi0, verifier
from cover_vla_tpu_torch.utils import monitor

E, K, N = 2, 2, 2
PCFG, VCFG = configs.tiny_pi0_config(), configs.tiny_verifier_config()
STATS = DatasetStatistics.from_json()
STEP_SPANS = ("step.inputs", "pi0.prefix", "pi0.denoise",
              "step.candidates", "step.verifier_towers",
              "step.verifier_heads", "step.select")
PROPOSE_SPANS = ("step.inputs", "pi0.prefix", "pi0.denoise",
                 "step.candidates")


@pytest.fixture(scope="module")
def params():
    return (pi0.init_pi0(0, PCFG, device="cpu"),
            verifier.init_verifier(1, VCFG, 2, device="cpu"))


@pytest.fixture(autouse=True)
def no_records():
    monitor.drain()
    yield
    monitor.drain()


def _observation(seed):
    rng = np.random.default_rng(seed)
    # 64 x 64 frames: the policy's LANCZOS4 resize to 56 and the
    # verifier's resizes to 256 and 64 all run
    return (rng.integers(0, 256, (E, 64, 64, 3), dtype=np.uint8),
            rng.normal(size=(E, 7)).astype(np.float32))


def _engine(params, selection="verifier", score_fn=None):
    ccfg = configs.CoVerConfig(n_samples=N, n_rephrases=K,
                               selection=selection)
    engine = BatchedCoVerEngine(
        *params, PCFG, VCFG, ccfg, num_episodes=E, stats=STATS,
        policy_tokenizer=HashTokenizer(PCFG.paligemma.vocab_size),
        verifier_tokenizer=HashTokenizer(VCFG.text.vocab_size,
                                         add_bos=False),
        score_fn=score_fn, device="cpu")
    engine.reset(["put the carrot on the plate"] * E)
    return engine


def _run_ticks(engine, ticks):
    for t in range(ticks):
        engine.step_async(*_observation(t))()


def _trees(records):
    """{boundary ids: [records of the tree]} and the records by sid."""
    by_sid = {r.sid: r for r in records}
    trees = {}
    for r in records:
        trees.setdefault(r.boundary, []).append(r)
    return trees, by_sid


def test_batched_step_span_tree(params):
    engine = _engine(params)
    chunk = PCFG.chunk_size
    with monitor.recording():
        _run_ticks(engine, 2 * chunk)
    records = monitor.drain()
    assert all(r.t1 is not None and r.t1 >= r.t0 for r in records)
    trees, by_sid = _trees(records)
    # one tree a chunk boundary, none for the ticks between
    assert sorted(trees) == [(("boundary", b), ("engine", engine._seq))
                             for b in range(2)]
    for ids, tree in trees.items():
        roots = [r for r in tree if r.parent is None]
        assert [r.name for r in roots] == ["engine.step_async",
                                           "engine.resolve"]
        enqueue, resolve = roots
        children = [r.name for r in tree if r.parent == enqueue.sid]
        assert children == ["engine.tokenize", *STEP_SPANS]
        assert [r for r in tree if r.parent == resolve.sid] == []
        assert resolve.t0 >= enqueue.t1
        for r in tree:
            if r.parent is not None:
                parent = by_sid[r.parent]
                assert parent.t0 <= r.t0 <= r.t1 <= parent.t1

        counts = {r.name: r.counts for r in tree}
        # raw image, proprio, tokens, masks, history, its length, and the
        # LANCZOS4 tables (2 an axis)
        assert counts["step.inputs"]["h2d_copies"] == 6 + 4
        # the suffix mask, then the time-embedding scale each Euler step
        assert counts["pi0.denoise"]["h2d_copies"] == \
            1 + PCFG.num_denoise_steps
        assert counts["step.verifier_towers"]["h2d_copies"] >= 1
        assert counts["engine.resolve"]["d2h_copies"] == 5
        assert counts["engine.resolve"]["d2h_bytes"] == (
            2 * E * chunk * 7 * 4 + E * 4 + E * 1 + E * 4)
        assert "h2d_copies" not in counts["engine.tokenize"]
        assert counts["engine.step_async"] == {}
        assert all(c.get("h2d_wait_s", 0.0) >= 0.0 for c in counts.values())


def test_injected_mode_records_the_propose_half(params):
    def score_fn(exec_chunks):
        return exec_chunks[..., 0].sum(axis=(-1,))

    engine = _engine(params, selection="injected", score_fn=score_fn)
    with monitor.recording():
        _run_ticks(engine, PCFG.chunk_size)
    trees, _ = _trees(monitor.drain())
    (tree,) = trees.values()
    enqueue, resolve = [r for r in tree if r.parent is None]
    assert [r.name for r in tree if r.parent == enqueue.sid] == [
        "engine.tokenize", *PROPOSE_SPANS]
    # the scores come back to the host, then the selection runs
    assert [r.name for r in tree if r.parent == resolve.sid] == [
        "step.select"]
    assert resolve.counts["d2h_copies"] == 6
    select = next(r for r in tree if r.name == "step.select")
    assert select.counts["h2d_copies"] == 1       # the injected scores


def _step_inputs(seed):
    rng = np.random.default_rng(seed)
    raw, proprio = _observation(seed)
    t, tv = PCFG.tokenizer_max_length, VCFG.text.context_length
    return dict(
        raw_image=raw, proprio=proprio,
        lang_tokens=rng.integers(1, 100, (E, K, t)).astype(np.int32),
        lang_masks=np.arange(t)[None, None].repeat(E, 0).repeat(K, 1) < 5,
        verifier_tokens=rng.integers(1, 100, (E, tv)).astype(np.int32),
        history=rng.normal(size=(E, 10, 7)).astype(np.float32),
        history_len=np.array([3, 10], np.int32),
        noise=torch.from_numpy(rng.normal(size=(
            E, K, N, PCFG.chunk_size, PCFG.max_action_dim)
        ).astype(np.float32)))


def _step(params):
    ccfg = configs.CoVerConfig(n_samples=N, n_rephrases=K)
    return make_verified_step_batched(PCFG, VCFG, ccfg, STATS, device="cpu")


def test_recording_off_enters_no_profiler_range(params, monkeypatch):
    entered = []

    class Spy:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Spy)
    step = _step(params)
    step(*params, **_step_inputs(0))
    assert entered == [] and monitor.drain() == []
    assert monitor.span("step.select") is monitor.span("engine.resolve")
    with monitor.recording():
        step(*params, **_step_inputs(0))
    assert entered == list(STEP_SPANS)


def test_outputs_bitwise_equal_with_recording(params):
    step = _step(params)
    off = step(*params, **_step_inputs(1))
    with monitor.recording():
        on = step(*params, **_step_inputs(1))
    assert [r.name for r in monitor.drain()] == list(STEP_SPANS)
    for field, a, b in zip(off._fields, off, on):
        assert a.dtype == b.dtype and torch.equal(a, b), field


@pytest.mark.parametrize("value, dtype", [
    (np.arange(6, dtype=np.int32).reshape(2, 3), torch.long),
    (np.linspace(0, 1, 5, dtype=np.float32), None),
    ([1, 1, 0, 0], torch.int32),
    (0.25, None),
])
def test_to_device_counts_on_the_innermost_span(value, dtype):
    want = torch.as_tensor(value, dtype=dtype, device="cpu")
    with monitor.recording():
        with monitor.span("outer", boundary=7):
            with monitor.span("inner"):
                got = monitor.to_device(value, "cpu", dtype)
                # a tensor already on the device is not a copy
                assert monitor.to_device(got, "cpu", torch.float64).dtype \
                    == torch.float64
            host = monitor.to_host(got)
    outer, inner = monitor.drain()
    assert got.dtype == want.dtype and got.device == want.device
    assert torch.equal(got, want) and torch.equal(host, want)
    assert inner.parent == outer.sid and inner.boundary == outer.boundary \
        == (("boundary", 7),)
    assert inner.counts["h2d_copies"] == 1
    assert inner.counts["h2d_bytes"] == want.numel() * want.element_size()
    assert inner.counts["h2d_wait_s"] >= 0.0
    assert outer.counts == {
        "d2h_copies": 1, "d2h_bytes": want.numel() * want.element_size(),
        "d2h_wait_s": outer.counts["d2h_wait_s"]}
    # off: the same tensor, nothing counted
    assert torch.equal(monitor.to_device(value, "cpu", dtype), want)
    assert monitor.drain() == []


def test_spans_nest_per_thread():
    seen = {}

    def other():
        with monitor.span("other") as rec:
            seen["rec"] = rec

    with monitor.recording():
        with monitor.span("main", engine=0, boundary=1) as main:
            t = threading.Thread(target=other)
            t.start()
            t.join()
            # a transfer with no span open on its thread counts nowhere
            t = threading.Thread(
                target=lambda: monitor.to_device(np.zeros(3), "cpu"))
            t.start()
            t.join()
    assert seen["rec"].parent is None and seen["rec"].boundary is None
    assert main.boundary == (("boundary", 1), ("engine", 0))
    assert sorted(r.name for r in monitor.drain()) == ["main", "other"]


def test_profile_trace_holds_the_spans(tmp_path):
    with monitor.profile_trace(str(tmp_path / "trace")):
        with monitor.span("engine.step_async", engine=0, boundary=0):
            with monitor.span("pi0.prefix"):
                torch.ones(4).sum()
    assert not monitor._recording
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert {"engine.step_async", "pi0.prefix"} <= names
    assert [r.name for r in monitor.drain()] == ["engine.step_async",
                                                 "pi0.prefix"]
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
