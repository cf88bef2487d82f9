"""One run of one cell: set-up, warm-up, the measured window, the traced
sub-window, and the comparison with the reference.

The entry the window drives is the port's closed-loop batched evaluation:
`BatchedCoVerEngine.step_async` and its resolver, with the verified step
of `make_verified_step_batched` under the all-kernel path. Two cohorts of
E episodes run in turns, each on its own CUDA stream: while the card runs
one cohort's chunk boundary, the host resolves the other's, steps its
environments through the chunk and enqueues its next boundary. A boundary
falls every `chunk_size` ticks; episodes last `episode_ticks`, then the
cohort resets with new episode seeds drawn from the run's seed.

The flow's noise is the benchmark's: a wrapper around the program's step
draws it from a generator of its own (seeded from the run's seed) and
hands it to the step as `noise=`, keeping the generator's state so that
the reference draws the same noise.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from coverbench import (backbones, check, fake_env, trace as trace_mod,
                        weights, yardstick)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "coverbench")
WARM_BOUNDARIES = 2      # resolved boundaries of each cohort before timing
TRACE_HALF_CYCLES = 4    # boundaries in the profiled sub-window
RESULT_FIELDS = ("exec_chunk", "verifier_chunk", "winner_idx",
                 "winner_group", "max_score", "used_stage2", "deferred",
                 "scores", "raw_gripper")


def _json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    chips: int


def load_cell(workload: str, root: str = ROOT) -> Cell:
    """Everything about one cell, found by the names in BENCHMARK.json."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return Cell(
        name=workload, config=_json(os.path.join(root, entry["file"])),
        traffic=_json(os.path.join(HERE, "traffic",
                                   cell["traffic"] + ".json")),
        limits=_json(os.path.join(HERE, "workloads", workload + ".json")),
        end_to_end=mine(bench["end_to_end"]),
        per_layer=mine(bench["per_layer"]), chips=cell["chips"])


def port_configs(config: dict, traffic: dict):
    """The program's config objects for a configuration file and a mix,
    built by the configuration's backbone module."""
    return backbones.load(config).port_configs(config, traffic)


@dataclass
class Boundary:
    cohort: int
    generation: int
    in_episode: int
    originals: list
    n_samples: int
    raw: np.ndarray
    proprio: np.ndarray
    lang_tokens: np.ndarray
    lang_masks: np.ndarray
    vtoks: np.ndarray
    history: np.ndarray
    history_len: np.ndarray
    noise_state: torch.Tensor
    result: object = None
    host: Optional[dict] = None
    t_enqueue: tuple = (0.0, 0.0)
    t_resolved: float = 0.0
    traced: bool = False


class NoiseStep:
    """The program's batched step with the benchmark's noise; records the
    arguments of every call."""

    def __init__(self, step, seed: int, shape, noise_std: float, device,
                 log: list):
        self.step, self.shape, self.noise_std = step, shape, noise_std
        self.device, self.log = device, log
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def __call__(self, pp, vp, raw, proprio, lt, lm, vt, hist, hist_len,
                 generator=None):
        from cover_vla_tpu_torch.utils import monitor
        with monitor.span("bench.noise"):
            state = self.gen.get_state()
            noise = torch.randn(self.shape, generator=self.gen,
                                dtype=torch.float32,
                                device=self.device) * self.noise_std
        res = self.step(pp, vp, raw, proprio, lt, lm, vt, hist, hist_len,
                        noise=noise)
        self.log.append(dict(raw=raw, proprio=proprio, lang_tokens=lt,
                             lang_masks=lm, vtoks=vt, history=hist.copy(),
                             history_len=hist_len.copy(), noise_state=state,
                             result=res))
        return res


class Cohort:
    """E lockstep episodes on one engine and one stream."""

    def __init__(self, idx, engine, step: NoiseStep, stream, traffic, seed,
                 chunk, boundaries: list):
        self.idx, self.engine, self.step = idx, engine, step
        self.stream, self.chunk = stream, chunk
        self.E = traffic["episodes_per_cohort"]
        self.ticks = traffic["episode_ticks"]
        self.n_samples = traffic["n_samples"]
        self.rng = np.random.default_rng([seed, 1000 + idx])
        self.boundaries = boundaries
        self.generation = -1
        self.pending = None
        self.reset()

    def ctx(self):
        return (torch.cuda.stream(self.stream) if self.stream is not None
                else contextlib.nullcontext())

    def reset(self):
        self.generation += 1
        n = len(fake_env.ID_TASKS)
        tasks = [fake_env.ID_TASKS[(e + self.generation + self.idx) % n]
                 for e in range(self.E)]
        seeds = self.rng.integers(0, 2 ** 31 - 1, self.E)
        self.envs = [fake_env.FakeWidowXEnv(t, max_steps=self.ticks)
                     for t in tasks]
        self.obs = [env.reset(int(s)) for env, s in zip(self.envs, seeds)]
        self.originals = [env.instruction for env in self.envs]
        self.engine.reset(self.originals)
        self.tick = 0
        self.in_episode = 0

    def enqueue(self):
        imgs = np.stack([o["image"] for o in self.obs])
        props = np.stack([fake_env.proprio(o["eef_pos"]) for o in self.obs])
        t0 = time.perf_counter()
        with self.ctx():
            self.pending = self.engine.step_async(imgs, props)
        t1 = time.perf_counter()
        rec = self.step.log.pop()
        b = Boundary(cohort=self.idx, generation=self.generation,
                     in_episode=self.in_episode, originals=self.originals,
                     n_samples=self.n_samples, t_enqueue=(t0, t1), **rec)
        self.boundaries.append(b)
        self.in_episode += 1
        self.current = b

    def _step_envs(self, actions):
        from cover_vla_tpu_torch.utils import monitor
        with monitor.span("bench.env_step"):
            for e, env in enumerate(self.envs):
                self.obs[e], _ = env.step(actions[e])
        self.tick += 1

    def finish(self) -> Boundary:
        """Resolve the pending boundary, run the chunk's ticks; the cohort
        resets when its episodes are over."""
        b = self.current
        with self.ctx():
            actions = self.pending()
        b.t_resolved = time.perf_counter()
        self._step_envs(actions)
        for _ in range(self.chunk - 1):
            with self.ctx():
                actions = self.engine.step_async(None, None)()
            self._step_envs(actions)
        if self.tick >= self.ticks:
            self.reset()
        return b


class Pipeline:
    """The cohorts in turns: each turn resolves one cohort's pending
    boundary, runs its chunk's ticks and enqueues its next boundary, while
    the other cohorts' boundaries run on the card."""

    def __init__(self, cohorts):
        self.cohorts = cohorts
        self.turn = 0
        for c in cohorts:
            c.enqueue()

    def step(self):
        """-> (the boundary resolved, the boundary enqueued)."""
        c = self.cohorts[self.turn]
        self.turn = (self.turn + 1) % len(self.cohorts)
        done = c.finish()
        c.enqueue()
        return done, c.current

    def run(self, turns: int = None, until: float = None) -> list:
        """`turns` turns, or turns until a boundary resolves at or after
        `until` (host clock). -> the boundaries resolved, in order."""
        done = []
        while (turns is not None and len(done) < turns) or \
                (until is not None and (not done
                                        or done[-1].t_resolved < until)):
            done.append(self.step()[0])
        return done


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class RunOutput:
    correct: bool
    attempted: int
    failed: int
    metrics: dict
    device: dict
    compared: dict
    breakdown: Optional[dict] = None
    answers: list = field(default_factory=list)
    check_s: float = 0.0
    timeline: str = ""


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, faults=None, control: Optional[str] = None,
        metric_readers=None) -> RunOutput:
    """One run of `cell`. `faults`: a callable applied to the program's
    step and engine before set-up ends (the fault tests); `control`:
    "program_w8a8" judges the program on its int8 route against this
    cell's reference, "reference_int4" judges the reference on the int4
    grid against the int8 one (the controls of the limits)."""
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    from cover_vla_tpu_torch.data.tokenizer import HashTokenizer
    from cover_vla_tpu_torch.engine.batched_engine import BatchedCoVerEngine
    from cover_vla_tpu_torch.engine.verified_step import (
        make_verified_step_batched)
    from cover_vla_tpu_torch.models import verifier
    from cover_vla_tpu_torch.models.params import ParamTree
    from cover_vla_tpu_torch.ops import quant
    from cover_vla_tpu_torch.utils import monitor

    dev = torch.device(device)
    on_cuda = dev.type == "cuda"
    if on_cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    cfg, traffic = cell.config, cell.traffic
    bb = backbones.load(cfg)
    pcfg, vcfg, ccfg, members = bb.port_configs(cfg, traffic)
    E, K, N = (traffic["episodes_per_cohort"], traffic["n_rephrases"],
               traffic["n_samples"])
    chunk = pcfg.chunk_size
    stats_path = os.path.join(HERE, "configs", "bridge_statistics.json")
    stats = DatasetStatistics.from_json(stats_path)
    rephrases = _json(os.path.join(HERE, "traffic", "rephrases.json"))[
        "rephrases"]

    # weights: the benchmark's, in the program's layout
    meta = {"policy": bb.policy_meta(pcfg),
            "verifier": verifier.init_verifier(0, vcfg, members,
                                               device="meta")}
    wts = weights.make(meta, seed, dev, bb)
    del meta
    ptree, vtree = ParamTree(wts["policy"]), ParamTree(wts["verifier"])
    w8a8 = cfg["gemm_route"] == "w8a8" or control == "program_w8a8"
    if w8a8:
        ptree = bb.quantize(ptree)
        vtree = quant.quantize_verifier(vtree)

    step = make_verified_step_batched(pcfg, vcfg, ccfg, stats, device=dev)
    boundaries, cohorts = [], []
    shape = (E, K, N, chunk, pcfg.max_action_dim)
    for idx in range(traffic["cohorts"]):
        log = []
        ns = NoiseStep(step, (seed * 8 + idx) % (2 ** 63), shape,
                       ccfg.noise_std, dev, log)
        engine = BatchedCoVerEngine(
            ptree, vtree, pcfg, vcfg, ccfg, num_episodes=E, stats=stats,
            policy_tokenizer=HashTokenizer(bb.prompt_vocab(cfg["policy"])),
            verifier_tokenizer=HashTokenizer(vcfg.text.vocab_size,
                                             add_bos=False),
            rephrases=rephrases, step_fn=ns, device=dev)
        stream = torch.cuda.Stream(dev) if on_cuda else None
        cohorts.append(Cohort(idx, engine, ns, stream, traffic, seed, chunk,
                              boundaries))
    if faults is not None:
        faults(cohorts)

    # warm-up: every shape of the window, on both streams
    pipe = Pipeline(cohorts)
    pipe.run(turns=WARM_BOUNDARIES * len(cohorts))

    # a traced run records the program's spans over the profiled
    # sub-window and the window, and no other run does
    trace_summary = None
    with (monitor.recording() if traced else contextlib.nullcontext()):
        if traced:
            trace_summary = _profile(pipe, dev, bb.KERNELS)
            pipe.run(turns=len(cohorts))

        # the window opens and closes on a resolved boundary
        first = pipe.run(turns=1)[-1]
        opened = first.t_resolved
        setup_s = opened - t_start
        window = pipe.run(until=opened + seconds)
        closed = window[-1].t_resolved
    spans = monitor.drain() if traced else []
    timeline = _timeline(first, window)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0
    for b in boundaries:
        b.host = {f: getattr(b.result, f).cpu().numpy()
                  for f in RESULT_FIELDS}
        b.result = None

    # the program's state goes before the reference runs
    del pipe, cohorts, step, ptree, vtree
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()

    ctx = {"setup_s": setup_s, "window_s": closed - opened,
           "window": window, "E": E, "K": K, "N": N, "chunk": chunk,
           "config": cfg, "trace": trace_summary, "spans": spans,
           "opened": opened, "closed": closed,
           "device_name": (torch.cuda.get_device_name(dev) if on_cuda
                           else "cpu")}
    if trace_summary is not None:
        ctx["kernel_work"] = kernel_work(
            [b for b in boundaries if b.traced], boundaries, cfg, rephrases,
            K, N)

    t_check = time.perf_counter()
    answers = _compare(cell, boundaries, window, seed, cfg, K, stats_path,
                       rephrases, wts, dev, control)
    check_s = time.perf_counter() - t_check
    correct, failed, compared = check.verdict(answers, cell.limits)
    metrics = {}
    readers = metric_readers or {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = readers[m["name"]](ctx) if m["name"] in readers else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if on_cuda else "cpu",
                   "kind": ctx["device_name"], "count": 1,
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace_summary is not None:
        device_info["busy_s"] = trace_summary["busy_s"]
        device_info["window_s"] = trace_summary["window_s"]
        breakdown = {k: trace_summary[k] for k in (
            "device_ops", "idle_gaps", "device_by_span",
            "idle_gaps_by_span")}
    return RunOutput(correct=correct, attempted=len(window) * E,
                     failed=failed, metrics=metrics, device=device_info,
                     compared=compared, breakdown=breakdown, answers=answers,
                     check_s=check_s, timeline=timeline)


def _timeline(first, window) -> str:
    """How the window's turns went: the host clock between a cohort's
    resolution and the next one, by the cohort that resolved first, and
    the host's time inside `step_async` a boundary."""
    done = [first] + window
    gaps = {}
    for a, b in zip(done, done[1:]):
        gaps.setdefault(a.cohort, []).append(b.t_resolved - a.t_resolved)
    enq = [b.t_enqueue[1] - b.t_enqueue[0] for b in window]
    return (f"window {len(window)} boundaries in "
            f"{window[-1].t_resolved - first.t_resolved:.3f} s; resolve gap "
            "after cohort " + ", ".join(
                f"{c} {1e3 * np.mean(g):.1f} ms (n {len(g)})"
                for c, g in sorted(gaps.items()))
            + f"; step_async {1e3 * np.mean(enq):.1f} ms a boundary")


def _profile(pipe, dev, kernels) -> dict:
    """Profile TRACE_HALF_CYCLES boundaries from a drained device: their
    device work and resolutions fall inside the profiled sub-window. The
    host's operators are traced too (tracing the device alone costs more
    on this card's host), without their shapes: the profiler adds some
    30 us of host time to each operator, so the sub-window's host runs
    slower than the window's and its idle share reads high."""
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced = [pipe.step()[1] for _ in range(TRACE_HALF_CYCLES)]
        _sync(dev)
        window_s = time.perf_counter() - t0
    for b in traced:
        b.traced = True
    return trace_mod.summarize(_exported(prof), window_s, len(traced),
                               kernels)


def _exported(prof) -> dict:
    """The profiler's chrome trace, through a file under $TMPDIR that is
    deleted once read."""
    tmp = tempfile.mkdtemp(prefix="coverbench-trace-")
    path = os.path.join(tmp, "trace.json")
    try:
        prof.export_chrome_trace(path)
        return trace_mod.load(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
        os.rmdir(tmp)


def kernel_work(traced, boundaries, cfg, rephrases, k, n) -> dict:
    """(bytes, FLOPs, launches) of K2 and of the backbone's kernels over
    the traced boundaries, from the cell's shapes and the prompts' valid
    tokens as the reference's tokenizer counts them."""
    from coverbench import reference
    bb = backbones.load(cfg)
    pol, ver = cfg["policy"], cfg["verifier"]
    pv = pol["vision"]
    n_img = yardstick.num_patches(pv)
    work = {name: [0.0, 0.0, 0] for name in ("K2", *bb.KERNELS)}

    def add(name, nbytes, flops, launches):
        work[name][0] += nbytes * launches
        work[name][1] += flops * launches
        work[name][2] += launches

    for b in traced:
        e_count = b.lang_tokens.shape[0]
        earlier = _earlier(b, boundaries)
        rows = []
        for e in range(e_count):
            _, prompts, _, _ = check.episode_state(
                earlier, e, b.originals[e], rephrases, k,
                cfg["cover"]["max_history"])
            for p in prompts:
                _, m = reference.tokenize(p, pol["tokenizer_max_length"],
                                          bb.prompt_vocab(pol), True)
                rows.append(n_img + int(m.sum()))
        for name, w in bb.kernel_work(pol, rows, n).items():
            add(name, *w)
        vv, vt = ver["vision"], ver["text"]
        for tower, seq in ((pv, n_img), (vv, yardstick.num_patches(vv)),
                           (vt, vt["context_length"])):
            add("K2", *yardstick.k2_work(
                e_count, seq, tower["num_heads"],
                tower["width"] // tower["num_heads"]), tower["depth"])
    return work


def _earlier(b, boundaries):
    return [x for x in boundaries
            if x.cohort == b.cohort and x.generation == b.generation
            and x.in_episode < b.in_episode]


def _compare(cell, boundaries, window, seed, cfg, k, stats_path, rephrases,
             wts, dev, control):
    stats = _json(stats_path)
    ck = cell.limits["sample"]
    picked = check.sample(window, seed, ck["boundaries"],
                          ck["episodes_per_boundary"],
                          cell.traffic["episodes_per_cohort"])
    w8a8 = cfg["gemm_route"] == "w8a8"
    return check.run(picked, lambda b: _earlier(b, boundaries), cfg, k,
                     stats, rephrases, wts, 127 if w8a8 else None,
                     cell.limits, dev,
                     control_levels=7 if control == "reference_int4" else None)
