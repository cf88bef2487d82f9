"""Verification-scaling experiment on the PyTorch port: every stage of
`scripts/verification_scaling.py`.

The repo's verification-scaling experiment (`scripts/verification_scaling.py`)
trains a tiny π0 and a tiny verifier ensemble on the scriptable fake env and
measures how the success rate moves with the candidate count N under three
selection modes (`first`, `random`, `verifier`), plus a privileged `oracle`
ceiling and appearance-shifted OOD tasks. This script runs its stages on the
port, with the JAX script's flags and defaults:

  demos              scripted-expert demonstrations + fitted statistics
  train_policy       flow-matching behaviour cloning (training/train_pi0.py)
  rankdata           the trained policy rolled through the batched engine,
                     every candidate labelled by its true progress
  pretrain_backbone  the verifier's vision tower regressing scene geometry
                     on domain-randomized synthetic frames
  train_verifier     quality regression (or listwise) on the rankdata
  eval               the success-rate grid through the closed-loop episode
                     path (`eval.evaluator.evaluate_suite_batched` ->
                     `engine/batched_engine.py` -> `engine/verified_step.py`
                     -> the towers and the hand kernels), each cell beside
                     the JAX package's committed cell
  calibrate          the ID scenes' affinity prototype stamped into a
                     verifier tree (the deference gate's calibration)
  dagger_note        one DAgger round's meta and cells in a run
  report             the JAX script's markdown report of a run, each cell
                     beside JAX's
  all                demos .. train_verifier, a DAgger round, eval, report

It imports neither `jax` nor the JAX package nor `ml_dtypes`: the committed
pickles are read by `convert.from_jax.load_pickle`, and the trees it writes
are pickled by hand so that the JAX script's `_load_tree` reads bf16 leaves
as `ml_dtypes.bfloat16` arrays (`save_pickle`).

    python scripts/torch_verification_scaling.py train_policy --device cpu \\
        --steps 2 --batch 4                # a quick check on the CPU
    bash scripts/torch_verification_scaling_train.sh   # every stage, card
    python scripts/torch_verification_scaling.py eval --config fast \\
        --trials 300                       # the 13 grid cells on the card

Stage inputs are bare names (`--data rankdata.npz`), read from the artifact
directory (`--art-dir`, `$VS_TORCH_ART_DIR`, default
`experiments/verification_scaling_torch/trained/`) when an earlier port stage
wrote them there, else from `experiments/verification_scaling/` (or
`$VS_TORCH_SRC_DIR`), which is never written; a name with a directory part is
a path. Stages write only into the artifact directory: the artifact and its
`<artifact>.meta.json` (arguments, wall, ms a step, card peak, device-busy
share of a profiled window, kernel launches, the card's `nvidia-smi` line).
`eval` of the committed JAX trees writes
`experiments/verification_scaling_torch/results.json` (or under
`$VS_TORCH_OUT_DIR`); of a tree from the artifact directory, the artifact
directory's `results.json`. Runs are keyed by attention config (`eager`,
`fast`, `all_kernel`) and `--run-name`; episode pickles go to the gitignored
`episodes/` beside the results.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import fcntl
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TASK = "widowx_carrot_on_plate"
MAX_ENV_STEPS = 60
CONFIGS = ("eager", "fast", "all_kernel")


def src_dir() -> str:
    return os.environ.get("VS_TORCH_SRC_DIR", os.path.join(
        REPO, "experiments", "verification_scaling"))


def out_dir() -> str:
    return os.environ.get("VS_TORCH_OUT_DIR", os.path.join(
        REPO, "experiments", "verification_scaling_torch"))


def art_dir() -> str:
    return os.environ.get("VS_TORCH_ART_DIR", os.path.join(
        REPO, "experiments", "verification_scaling_torch", "trained"))


def input_path(name: str) -> str:
    """A stage's input: a name with a directory part is a path; a bare
    name is read from the artifact directory when a port stage wrote it
    there, else from the experiment's committed directory."""
    if os.path.dirname(name):
        return name
    made = os.path.join(art_dir(), name)
    return made if os.path.exists(made) else os.path.join(src_dir(), name)


def output_path(name: str) -> str:
    os.makedirs(art_dir(), exist_ok=True)
    return os.path.join(art_dir(), name)


# ---------------------------------------------------------------------------
# the experiment's configs (scripts/verification_scaling.py:57-90)
# ---------------------------------------------------------------------------


def experiment_configs():
    from cover_vla_tpu_torch.configs import (
        GemmaConfig, Pi0Config, SiglipTextConfig, VerifierConfig, VitConfig)
    pcfg = Pi0Config(
        paligemma=GemmaConfig(width=64, depth=2, mlp_dim=128, num_heads=4,
                              num_kv_heads=1, head_dim=16, vocab_size=1024),
        expert=GemmaConfig(width=64, depth=2, mlp_dim=128, num_heads=4,
                           num_kv_heads=1, head_dim=16, vocab_size=0),
        vision=VitConfig(width=64, depth=2, mlp_dim=128, num_heads=4,
                         patch_size=14, image_size=112),
        chunk_size=4, n_action_steps=4, max_state_dim=32, max_action_dim=32,
        proj_width=64, num_denoise_steps=5, tokenizer_max_length=8)
    # VS_VISION_SCALE=big: the JAX experiment's higher-capacity verifier
    # vision tower (text.embed_dim must equal vision.width)
    big = os.environ.get("VS_VISION_SCALE", "") == "big"
    vw, vd, vm = (96, 5, 192) if big else (64, 3, 128)
    vcfg = VerifierConfig(
        vision=VitConfig(width=vw, depth=vd, mlp_dim=vm, num_heads=4,
                         patch_size=8, image_size=128, gelu_approx=False),
        text=SiglipTextConfig(width=64, depth=2, mlp_dim=128, num_heads=4,
                              vocab_size=512, context_length=16,
                              embed_dim=vw),
        text_pooling_output_dim=64, vision_pooling_output_dim=64,
        pooling_heads=4, pooling_layers=2, traj_layers=2, traj_heads=4)
    return pcfg, vcfg


def attention_configs(pcfg, vcfg, config: str):
    """(Pi0Config, VerifierConfig) of an attention config: `eager` (no
    hand kernel), `fast` (K1 in the expert's decode, K2 in the three
    towers) or `all_kernel` (K3 in the prefill too)."""
    from cover_vla_tpu_torch.configs import (
        fast_pi0_config, fast_verifier_config, replace)
    if config == "eager":
        return pcfg, vcfg
    fast_p = fast_pi0_config(pcfg)
    if config == "all_kernel":
        fast_p = replace(fast_p, attention_impl="cuda")
    elif config != "fast":
        raise ValueError(f"unknown config {config!r} (one of {CONFIGS})")
    return fast_p, fast_verifier_config(vcfg)


def load_trees(policy_file: str, verifier_file: str, pcfg, vcfg, device):
    """The committed JAX trees (bare names under the experiment's
    directory, or paths) and the committed statistics, on `device`."""
    from cover_vla_tpu_torch.convert.from_jax import (
        load_pickle, pi0_from_jax, verifier_from_jax)
    pp = pi0_from_jax(load_pickle(os.path.join(src_dir(), policy_file)),
                      pcfg, device=device)
    vp = verifier_from_jax(load_pickle(os.path.join(src_dir(), verifier_file)),
                           vcfg, device=device)
    stats = load_pickle(os.path.join(src_dir(), "stats.pkl"))
    return pp, vp, stats


# ---------------------------------------------------------------------------
# writing trees the JAX script reads (scripts/verification_scaling.py:120-129)
# ---------------------------------------------------------------------------


class _GlobalName:
    """A global written into a pickle stream by module and name, without
    importing the module (`ml_dtypes`, the JAX package's statistics)."""

    def __init__(self, module: str, name: str):
        self.module, self.name = module, name

    def __call__(self, *args):      # save_reduce wants a callable
        raise TypeError(f"{self.module}.{self.name} is a name only")


class _BF16:
    """A bf16 leaf, held as its uint16 bits."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits


_ML_BF16 = _GlobalName("ml_dtypes", "bfloat16")
_BF16_DTYPE = object()      # stands for the dtype of a `_BF16` leaf
# numpy's dtype state of ml_dtypes.bfloat16: version, byte order, no
# subarray / names / fields, itemsize 2, alignment 2, flags
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)
# the JAX package's statistics module, spelt in two parts because no
# source of the port names a module of the JAX package
_JAX_STATS_MODULE = "cover_vla_tpu" + ".data.stats"


class _TreePickler(pickle._Pickler):
    """The pure-Python pickler, writing a bf16 leaf as numpy writes an
    `ml_dtypes.bfloat16` array and the port's statistics as the JAX
    package's classes (what `pickle.dump` of the JAX tree gives)."""

    def __init__(self, f):
        from cover_vla_tpu_torch.data import stats
        super().__init__(f, protocol=4)
        self.dispatch = dict(pickle._Pickler.dispatch)
        self.dispatch[_GlobalName] = _TreePickler._save_global_name
        self._stats_names = {}
        for cls in (stats.FieldStats, stats.DatasetStatistics):
            self.dispatch[cls] = _TreePickler._save_stats
            self._stats_names[cls] = _GlobalName(_JAX_STATS_MODULE,
                                                 cls.__name__)

    def _save_global_name(self, obj):
        self.save(obj.module)
        self.save(obj.name)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)

    def _save_stats(self, obj):
        self.save(self._stats_names[type(obj)])
        self.save(())
        self.write(pickle.NEWOBJ)
        self.memoize(obj)
        self.save(dict(obj.__dict__))
        self.write(pickle.BUILD)

    def reducer_override(self, obj):
        if isinstance(obj, _BF16):
            fn, args, state = obj.bits.__reduce__()
            return fn, args, state[:2] + (_BF16_DTYPE,) + state[3:]
        if obj is _BF16_DTYPE:
            return np.dtype, (_ML_BF16, False, True), _BF16_DTYPE_STATE
        return NotImplemented


def host_tree(tree):
    """A parameter tree (ParamTree or dicts of tensors / arrays) as nested
    dicts of numpy arrays in sorted key order, bf16 leaves as `_BF16`."""
    import torch
    from cover_vla_tpu_torch.models.params import ParamTree
    if isinstance(tree, (dict, ParamTree)):
        return {k: host_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            return _BF16(t.view(torch.int16).numpy().view(np.uint16).copy())
        return t.numpy().copy()
    return tree


def save_pickle(path: str, obj) -> None:
    """Pickle a tree (see `host_tree`) or statistics for the JAX script's
    `_load_tree` and the port's `load_pickle`."""
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    host = obj if isinstance(obj, DatasetStatistics) else host_tree(obj)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _TreePickler(f).dump(host)
    os.replace(tmp, path)


def load_stats():
    from cover_vla_tpu_torch.convert.from_jax import load_pickle
    return load_pickle(input_path("stats.pkl"))


def write_meta(artifact: str, info: dict) -> str:
    path = output_path(artifact + ".meta.json")
    with open(path, "w") as f:
        json.dump(info, f, indent=1)
    return path


# ---------------------------------------------------------------------------
# the card's cost of a stage
# ---------------------------------------------------------------------------


def stage_device(args):
    import torch
    from cover_vla_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # the experiment's fp32 matmuls stay fp32 (the JAX stages pinned
        # HIGHEST), as do the image ops' separable products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


class StageCost:
    """Wall, ms a step, card peak, kernel launches and the device-busy
    share of one profiled window of `window` steps from step `at` (on the
    card only)."""

    def __init__(self, dev, steps: int, at: int = 20, window: int = 20):
        import torch
        from cover_vla_tpu_torch.ops import cuda_attention as ca
        self.dev, self.steps = dev, steps
        self.at = at if steps >= at + window else None
        self.window = window
        self._stack = None
        self.busy = None
        ca.reset_launch_counts()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        self.t0 = time.perf_counter()
        self.t_steps = None

    def _sync(self):
        import torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def before(self, it: int) -> None:
        """Call at the start of step `it`."""
        from cover_vla_tpu_torch.utils.monitor import profile_trace
        if it == 0:
            self._sync()
            self.t_steps = time.perf_counter()
        if self.dev.type != "cuda" or self.at is None:
            return
        if it == self.at:
            self._sync()
            self._dir = tempfile.mkdtemp(prefix="vs_stage_trace_")
            self._stack = contextlib.ExitStack()
            self._stack.enter_context(profile_trace(self._dir))
            self._tp = time.perf_counter()
        elif it == self.at + self.window:
            self._stop()

    def _stop(self):
        from cover_vla_tpu_torch.bench import trace_device_busy_s
        self._sync()
        wall = time.perf_counter() - self._tp
        self._stack.close()
        self._stack = None
        busy = trace_device_busy_s(self._dir)
        shutil.rmtree(self._dir, ignore_errors=True)
        self.busy = {"steps": self.window, "wall_ms": wall * 1e3,
                     "device_busy_ms": None if busy is None else busy * 1e3,
                     "idle_share": None if busy is None
                     else max(0.0, 1.0 - busy / wall)}

    def summary(self, steps_run: int) -> dict:
        import torch
        from cover_vla_tpu_torch.ops import cuda_attention as ca
        if self._stack is not None:
            self._stop()
        self._sync()
        end = time.perf_counter()
        steps_s = end - (self.t_steps or self.t0)
        card = card_line(self.dev)
        return {
            "device": (torch.cuda.get_device_name(self.dev)
                       if self.dev.type == "cuda" else "cpu"),
            "card": card, "torch": torch.__version__,
            "wall_s": end - self.t0, "steps": steps_run,
            "ms_per_step": steps_s * 1e3 / max(1, steps_run),
            "card_peak_gb": (torch.cuda.max_memory_allocated(self.dev) / 1e9
                             if self.dev.type == "cuda" else None),
            "profiled_window": self.busy,
            "launches": dict(ca.launch_counts)}


def cost_line(stage: str, cost: dict) -> str:
    busy = cost["profiled_window"]
    idle = ("not measured" if busy is None or busy["idle_share"] is None
            else f"{busy['idle_share']:.3f}")
    peak = ("" if cost["card_peak_gb"] is None
            else f", card peak {cost['card_peak_gb']:.2f} GB")
    return (f"{stage}: wall {cost['wall_s']:.1f} s, {cost['steps']} steps, "
            f"{cost['ms_per_step']:.2f} ms a step{peak}, idle share {idle}, "
            f"launches {cost['launches']} | {cost['card']}")


# ---------------------------------------------------------------------------
# demos (scripts/verification_scaling.py:137-160)
# ---------------------------------------------------------------------------


def cmd_demos(args):
    from cover_vla_tpu_torch.eval import fake_expert
    t0 = time.time()
    demos = fake_expert.collect_demos(
        n_episodes=args.n_demos, max_steps=MAX_ENV_STEPS, seed=0,
        action_noise=args.demo_noise, task_name=TASK)
    stats = fake_expert.fit_statistics(demos)
    arrays = {k: v for k, v in demos.items() if isinstance(v, np.ndarray)}
    np.savez_compressed(output_path("demos.npz"), **arrays)
    save_pickle(output_path("stats.pkl"), stats)
    # against the committed demonstrations of the same arguments
    committed = os.path.join(src_dir(), "demos.npz")
    same = None
    if os.path.exists(committed):
        with np.load(committed) as ref:
            same = set(ref.files) == set(arrays) and all(
                ref[k].dtype == v.dtype and ref[k].shape == v.shape
                and ref[k].tobytes() == v.tobytes()
                for k, v in arrays.items())
    wall = time.time() - t0
    write_meta("demos.npz", {
        "stage": "demos", "args": vars_of(args), "wall_s": wall,
        "steps": int(len(demos["actions"])),
        "episodes": int(demos["n_episodes"]),
        "expert_success_rate": float(demos["expert_success_rate"]),
        "byte_equal_to_committed": same})
    print(f"demos: {len(demos['actions'])} steps / "
          f"{demos['n_episodes']} episodes, expert success "
          f"{demos['expert_success_rate']:.2f} ({wall:.0f}s); "
          f"byte-equal to the committed demos: {same}")


def load_demos():
    d = dict(np.load(input_path("demos.npz")))
    d["n_episodes"] = int(d["episode"].max()) + 1
    return d, load_stats()


def vars_of(args) -> dict:
    return {k: v for k, v in vars(args).items() if k != "fn"}


def task_rephrases(instruction: str, k: int):
    """First k rephrases of the instruction from the vendored store."""
    from cover_vla_tpu_torch.eval.rephrase import load_rephrases
    return load_rephrases().get(instruction, [])[:k]


def task_instruction() -> str:
    from cover_vla_tpu_torch.eval.benchmark import TASK_INSTRUCTIONS
    return TASK_INSTRUCTIONS.get(TASK, TASK.replace("_", " "))


# ---------------------------------------------------------------------------
# train_policy (scripts/verification_scaling.py:168-237)
# ---------------------------------------------------------------------------


def stage_schedule(lr: float, steps: int, warm_cap: int):
    """optax.warmup_cosine_decay_schedule(0.0, lr, warm, max(steps, warm +
    1)) with end value 0, warm = min(warm_cap, max(1, steps // 10)): the
    schedule of every training stage of the experiment."""
    from cover_vla_tpu_torch.training import optim
    warm = min(warm_cap, max(1, steps // 10))
    return optim.warmup_cosine(lr, warm, max(steps, warm + 1),
                               end_lr_ratio=0.0)


def policy_batch(data: dict, idx: np.ndarray, v: np.ndarray, pcfg) -> dict:
    """The π0 batch of rows `idx` under instruction variants `v`: raw
    frames through the engine's uint8 LANCZOS4 device resize."""
    import torch
    from cover_vla_tpu_torch.engine.verified_step import _policy_image
    dev = data["frames"].device
    i = torch.as_tensor(idx, device=dev)
    vv = torch.as_tensor(v, device=dev)
    imgs = _policy_image(data["frames"][i], pcfg.vision.image_size)
    return {"images": imgs[:, None],
            "img_masks": torch.ones((len(idx), 1), dtype=torch.bool,
                                    device=dev),
            "lang_tokens": data["lang_tokens"][vv],
            "lang_masks": data["lang_masks"][vv],
            "state": data["state"][i], "actions": data["actions"][i]}


def policy_data(args, pcfg, dev):
    """The policy dataset, staged on `dev`: frames, states, action chunks
    and the instruction variants' tokens."""
    import torch
    from cover_vla_tpu_torch.data.tokenizer import make_policy_tokenizer
    from cover_vla_tpu_torch.eval import fake_expert
    demos, stats = load_demos()
    ds = fake_expert.build_policy_dataset(demos, stats, pcfg.chunk_size)
    instr = task_instruction()
    variants = [instr] + task_rephrases(instr, 7) if args.rephrases \
        else [instr]
    tok = make_policy_tokenizer(pcfg.paligemma.vocab_size)
    lt, lm = tok.encode_batch(variants, pcfg.tokenizer_max_length)
    return {"frames": torch.from_numpy(ds["frames"]).to(dev),
            "state": torch.from_numpy(ds["state"]).to(dev),
            "actions": torch.from_numpy(ds["actions"]).to(dev),
            "lang_tokens": torch.from_numpy(lt).long().to(dev),
            "lang_masks": torch.from_numpy(lm).to(dev)}, len(variants)


def cmd_train_policy(args):
    import torch
    from cover_vla_tpu_torch.training import optim, train_pi0

    dev = stage_device(args)
    pcfg, _ = experiment_configs()
    data, n_variants = policy_data(args, pcfg, dev)
    n = len(data["state"])
    print(f"policy dataset: {n} chunks; instruction variants: {n_variants}")
    tx = optim.adamw(stage_schedule(args.lr, args.steps, 50),
                     weight_decay=1e-5)
    state = train_pi0.init_train_state(0, pcfg, tx, device=dev)
    step_fn = train_pi0.make_train_step(pcfg, tx)
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(1)
    cost = StageCost(dev, args.steps)
    losses = []
    for it in range(args.steps):
        cost.before(it)
        idx = rng.integers(0, n, args.batch)
        # paraphrase augmentation: each example under a random variant
        v = rng.integers(0, n_variants, args.batch)
        state, metrics = step_fn(state, gen, policy_batch(data, idx, v, pcfg))
        if it % 100 == 0 or it == args.steps - 1:
            losses.append((it, float(metrics["loss"])))
            print(f"  policy step {it}: loss={losses[-1][1]:.4f} "
                  f"({time.perf_counter() - cost.t0:.0f}s)", flush=True)
    info = cost.summary(args.steps)
    save_pickle(output_path(args.policy_out), state.params)
    write_meta(args.policy_out, {"stage": "train_policy",
                                 "args": vars_of(args), "losses": losses,
                                 **info})
    print(cost_line("train_policy", info))
    print(f"saved {args.policy_out}")


# ---------------------------------------------------------------------------
# rankdata (scripts/verification_scaling.py:245-422)
# ---------------------------------------------------------------------------


_OBJ_SHAPES = ("square", "circle", "ellipse_v", "ellipse_h", "triangle")
_TARGET_SHAPES = ("square", "circle", "ring")
# shape-noun grounding vocabulary (scripts/verification_scaling.py:445-458):
# domain-randomized states name the rendered shapes; colour adjectives are
# decoys uncorrelated with the rendering
_SHAPE_NOUNS = {
    "square": ("block", "cube", "box", "sponge"),
    "circle": ("ball", "orange", "apple"),
    "ellipse_v": ("can", "bottle", "cup"),
    "ellipse_h": ("zucchini", "banana", "pickle"),
    "triangle": ("cone", "wedge", "slice"),
}
_RECEPTACLE_NOUNS = {
    "square": ("towel", "plate", "pad", "paper"),
    "circle": ("dish", "saucer"),
    "ring": ("basket", "bowl", "pot"),
}
_DECOY_ADJECTIVES = ("", "yellow ", "red ", "green ", "blue ", "gray ",
                     "purple ", "brown ", "white ")


def _noun_instruction(rng, appearance: dict, obj_shape: str) -> str:
    noun = _SHAPE_NOUNS[obj_shape]
    rnoun = _RECEPTACLE_NOUNS[appearance["target_shape"]]
    prep = "into" if appearance["target_shape"] == "ring" else "on"
    return (f"put the {_DECOY_ADJECTIVES[rng.integers(9)]}"
            f"{noun[rng.integers(len(noun))]} {prep} the "
            f"{_DECOY_ADJECTIVES[rng.integers(9)]}"
            f"{rnoun[rng.integers(len(rnoun))]}")


def grounded_instruction(rng, appearance: dict) -> str:
    """Instruction naming the rendered shapes (decoy colour adjectives)."""
    return _noun_instruction(rng, appearance, appearance["obj_shape"])


def wrong_noun_instruction(rng, appearance: dict, d_shape: str) -> str:
    """Counterfactual instruction naming a distractor's shape as the pick
    object (the receptacle noun stays right)."""
    return _noun_instruction(rng, appearance, d_shape)


def random_appearance(rng) -> dict:
    """One random scene appearance: colours and sizes, object and
    receptacle geometry, 0-2 distractor blobs."""
    return {
        "bg": int(rng.integers(40, 130)),
        "obj_color": tuple(int(c) for c in rng.integers(40, 235, 3)),
        "obj_r": int(rng.integers(5, 12)),
        "obj_shape": _OBJ_SHAPES[rng.integers(len(_OBJ_SHAPES))],
        "target_color": tuple(int(c) for c in rng.integers(40, 235, 3)),
        "target_r": int(rng.integers(12, 18)),
        "target_shape": _TARGET_SHAPES[rng.integers(len(_TARGET_SHAPES))],
        "distractors": tuple(
            {"color": tuple(int(c) for c in rng.integers(40, 235, 3)),
             "r": int(rng.integers(4, 9)),
             "shape": _OBJ_SHAPES[rng.integers(len(_OBJ_SHAPES))]}
            for _ in range(rng.integers(0, 3))),
    }


def env_positions(env, obj=None, grasped=None) -> np.ndarray:
    """ee, object, target xyz + grasp flag + gripper: fp32[11]."""
    return np.concatenate(
        [env._ee, env._obj if obj is None else obj, env._target,
         [float(env._grasped) if grasped is None else grasped,
          float(env._gripper)]]).astype(np.float32)


class RankdataCollector:
    """The records of `rankdata` and the execution scores of every chunk
    boundary: at each boundary every live episode's candidates are
    labelled with `fake_expert.chunk_quality` on a copy of its env and
    recorded with the frame, the engine's trajectories, the privileged
    positions and the instruction (plus, with --wrong-noun-frac, a
    counterfactual slate); the executed candidate is then a random one,
    the oracle's best (--oracle-frac) or the DAgger verifier's pick."""

    def __init__(self, args, rng, dagger_score=None):
        self.args, self.rng, self.dagger_score = args, rng, dagger_score
        self.frames, self.trajs, self.quals = [], [], []
        self.positions, self.instrs = [], []
        self.counters = {"random": 0, "oracle": 0, "dagger": 0}

    def factory(self, engine):
        from cover_vla_tpu_torch.eval.fake_expert import chunk_quality
        args, rng = self.args, self.rng

        def for_envs(envs):
            def score_fn(exec_chunks, proposal):
                live = ~engine.done
                kn = exec_chunks.shape[1]
                q = np.zeros((len(envs), kn), np.float32)
                tr = np.asarray(proposal.trajectories.cpu())
                for e, env in enumerate(envs):
                    if not live[e]:
                        continue
                    for i in range(kn):
                        q[e, i] = chunk_quality(env, exec_chunks[e, i])
                    frame = env.render()
                    self._record(frame, tr[e], q[e], env_positions(env),
                                 getattr(env, "_grounded_instruction",
                                         env.instruction))
                    # wrong-noun counterfactual slate: the same frame under
                    # an instruction naming a distractor's shape, qualities
                    # toward that distractor
                    if (args.wrong_noun_frac > 0 and not env._grasped
                            and getattr(env, "_grounded_instruction", None)
                            and rng.random() < args.wrong_noun_frac):
                        dcands = [(dpos, d) for dpos, d in env._distractors
                                  if d["shape"] != env.appearance["obj_shape"]]
                        if dcands:
                            dpos, d = dcands[rng.integers(len(dcands))]
                            sim0 = copy.deepcopy(env)
                            sim0._obj = np.array([dpos[0], dpos[1], 0.02])
                            qw = np.array(
                                [chunk_quality(sim0, exec_chunks[e, i])
                                 for i in range(kn)], np.float32)
                            self._record(frame, tr[e], qw, env_positions(
                                env, obj=sim0._obj, grasped=0.0),
                                wrong_noun_instruction(
                                    rng, env.appearance, d["shape"]))
                            self.counters["wrong_noun"] = \
                                self.counters.get("wrong_noun", 0) + 1
                # execution scores: random / oracle-best / verifier (DAgger)
                u = rng.random()
                dagger = self.dagger_score is not None
                if dagger and u < args.dagger_frac:
                    self.counters["dagger"] += 1
                    return self.dagger_score(envs, proposal)
                if u < (args.dagger_frac if dagger else 0.0) \
                        + args.oracle_frac:
                    self.counters["oracle"] += 1
                    return q
                self.counters["random"] += 1
                return rng.random((len(envs), kn)).astype(np.float32)
            return score_fn
        return for_envs

    def _record(self, frame, traj, qual, pos, instr):
        self.frames.append(frame)
        self.trajs.append(traj)
        self.quals.append(qual)
        self.positions.append(pos)
        self.instrs.append(instr)

    def arrays(self) -> dict:
        return {"frames": np.stack(self.frames),
                "trajs": np.stack(self.trajs),
                "quals": np.stack(self.quals),
                "positions": np.stack(self.positions),
                "instrs": np.asarray(self.instrs)}


def rankdata_summary(quals: np.ndarray, positions: np.ndarray) -> dict:
    """State count and the quality-spread distribution of a rankdata
    file (what `train_verifier` filters and stratifies on)."""
    spread = quals.max(1) - quals.min(1)
    return {"states": int(len(quals)),
            "spread_p10": float(np.percentile(spread, 10)),
            "spread_p50": float(np.median(spread)),
            "spread_p90": float(np.percentile(spread, 90)),
            "share_spread_gt_0.02": float(np.mean(spread > 0.02)),
            "share_spread_gt_5": float(np.mean(spread > 5.0)),
            "share_grasped": float(np.mean(positions[:, 9] > 0.5)),
            "quality_mean": float(quals.mean())}


def verifier_prep(x, size: int):
    """Raw frames (uint8 or float, 256x256) -> verifier input: PIL-bicubic
    to `size` and mean/std 0.5 normalisation
    (scripts/verification_scaling.py:727-740)."""
    from cover_vla_tpu_torch.ops.image import resize_bicubic_pil
    x = resize_bicubic_pil(x.float(), size, size)
    return ((x / 255.0) - 0.5) / 0.5


def state_scores(params, vcfg, images, text_tokens, trajs):
    """`verifier.score_actions` of every state at once: images [B, H, W,
    3] (preprocessed), text_tokens [B, T], trajs [B, N, H, 7] -> [B, N]
    cosine scores of the ensemble-fused embeddings."""
    import torch
    from cover_vla_tpu_torch.models import verifier
    feats = verifier.extract_features(params, vcfg, images, text_tokens)
    it = verifier.member_image_text_embed(params["members"], vcfg, feats)
    b, n = trajs.shape[:2]
    ac = verifier.member_action_embed(
        params["members"], vcfg, trajs.reshape(b * n, *trajs.shape[2:]))
    fi = verifier._l2norm(it.mean(dim=0))
    fa = verifier._l2norm(ac.mean(dim=0)).reshape(b, n, -1)
    return torch.einsum("bd,bnd->bn", fi, fa)


def cmd_rankdata(args):
    import torch
    from cover_vla_tpu_torch.configs import CoVerConfig
    from cover_vla_tpu_torch.convert.from_jax import (
        load_pickle, pi0_from_jax, verifier_from_jax)
    from cover_vla_tpu_torch.data.tokenizer import (
        make_policy_tokenizer, make_verifier_tokenizer)
    from cover_vla_tpu_torch.engine.batched_engine import (
        BatchedCoVerEngine, evaluate_batched)
    from cover_vla_tpu_torch.eval.adapters import BridgeSimplerAdapter
    from cover_vla_tpu_torch.eval.fake_env import FakeWidowXEnv

    dev = stage_device(args)
    pcfg0, vcfg0 = experiment_configs()
    pcfg, vcfg = attention_configs(pcfg0, vcfg0, args.config)
    stats = load_stats()
    pp = pi0_from_jax(load_pickle(input_path(args.policy_params)), pcfg0,
                      device=dev)
    N, E = args.n_candidates, args.n_parallel
    ccfg = CoVerConfig(
        n_samples=N, n_rephrases=1, noise_std=args.noise_std,
        selection="injected", gripper_vote=False,
        rescore_threshold=float("inf"),
        max_history=vcfg.history_length - pcfg.chunk_size)

    dagger_score = None
    if args.dagger_params:
        dp = verifier_from_jax(load_pickle(input_path(args.dagger_params)),
                               vcfg0, device=dev)
        vt, _ = make_verifier_tokenizer(vcfg.text.vocab_size).encode_batch(
            [task_instruction()], vcfg.text.context_length)
        vt = torch.from_numpy(vt).long().to(dev)

        @torch.no_grad()
        def dagger_score(envs, proposal):
            raw = torch.from_numpy(np.stack([env.render() for env in envs]))
            imgs = verifier_prep(raw.to(dev), vcfg.vision.image_size)
            return state_scores(dp, vcfg, imgs, vt.expand(len(envs), -1),
                                proposal.trajectories).cpu().numpy()

    engine = BatchedCoVerEngine(
        pp, None, pcfg, vcfg, ccfg, num_episodes=E, stats=stats,
        policy_tokenizer=make_policy_tokenizer(pcfg.paligemma.vocab_size),
        verifier_tokenizer=make_verifier_tokenizer(vcfg.text.vocab_size),
        seed=9, device=dev)
    collector = RankdataCollector(args, np.random.default_rng(123),
                                  dagger_score)
    engine.score_fn_factory = collector.factory(engine)
    adapter = BridgeSimplerAdapter()
    n_cohorts = -(-args.episodes // E)
    cost = StageCost(dev, n_cohorts, at=1, window=1)
    ep_done = 0
    arng = np.random.default_rng(777)
    cohort = 0
    while ep_done < args.episodes:
        cost.before(cohort)
        # --domain-rand: appearance-randomized scenes, privileged labels
        aps = [None] * E
        if args.domain_rand:
            aps = [random_appearance(arng)
                   if arng.random() >= args.id_frac else None
                   for _ in range(E)]
        envs = [FakeWidowXEnv(TASK, max_steps=MAX_ENV_STEPS, appearance=ap)
                for ap in aps]
        for env, ap in zip(envs, aps):
            if ap is not None:
                env._grounded_instruction = grounded_instruction(arng, ap)
        seeds = [50_000 + ep_done + j for j in range(E)]
        evaluate_batched(engine, envs, adapter, max_steps=MAX_ENV_STEPS,
                         seeds=seeds)
        ep_done += E
        cohort += 1
        if cohort % 5 == 1:
            print(f"  rankdata ep {ep_done}/{args.episodes}: "
                  f"{len(collector.frames)} states "
                  f"({time.perf_counter() - cost.t0:.0f}s)", flush=True)
    info = cost.summary(cohort)
    arrays = collector.arrays()
    np.savez_compressed(output_path(args.out), **arrays)
    summary = {"episodes": ep_done, "n_candidates": N,
               "exec_mix": collector.counters,
               **rankdata_summary(arrays["quals"], arrays["positions"])}
    committed = os.path.join(src_dir(), os.path.basename(args.out))
    reference = None
    if os.path.exists(committed) and not os.path.dirname(args.out):
        with np.load(committed) as ref:
            reference = rankdata_summary(ref["quals"], ref["positions"])
    write_meta(args.out, {"stage": "rankdata", "args": vars_of(args),
                          "summary": summary,
                          "committed_summary": reference, **info})
    print(cost_line("rankdata", info))
    print(f"rankdata: {summary['states']} states x {N} candidates from "
          f"{ep_done} episodes (exec mix {collector.counters}); quality "
          f"spread p50={summary['spread_p50']:.3f}, share > 0.02 "
          f"{summary['share_spread_gt_0.02']:.3f}")


# ---------------------------------------------------------------------------
# pretrain_backbone (scripts/verification_scaling.py:505-724)
# ---------------------------------------------------------------------------


def synth_localisation_frames(n: int, seed: int = 5, id_frac: float = 0.25):
    """Domain-randomized synthetic localisation frames: random scene
    states under randomized appearances, labelled with the privileged
    positions and the object / target shape ids."""
    from cover_vla_tpu_torch.eval.fake_env import FakeWidowXEnv
    rng = np.random.default_rng(seed)
    frames = np.empty((n, 256, 256, 3), np.uint8)
    positions = np.empty((n, 11), np.float32)
    shapes = np.empty((n, 2), np.int32)
    for i in range(n):
        ap = None
        if rng.random() >= id_frac:
            ap = random_appearance(rng)
        env = FakeWidowXEnv("widowx_carrot_on_plate", appearance=ap)
        env.reset(seed=int(rng.integers(1 << 31)))
        # random episode phase: scattered ee, sometimes mid-carry
        env._ee = rng.uniform([-0.16, -0.16, 0.0], [0.16, 0.16, 0.2])
        env._obj = rng.uniform([-0.12, -0.12, 0.02], [0.12, 0.12, 0.02])
        env._target = rng.uniform([-0.15, -0.15, 0.02], [0.15, 0.15, 0.02])
        if rng.random() < 0.35:
            env._grasped = True
            env._obj = env._ee.copy()
            env._gripper = 0.1
        frames[i] = env.render()
        positions[i] = np.concatenate(
            [env._ee, env._obj, env._target,
             [float(env._grasped), float(env._gripper)]])
        shapes[i] = (_OBJ_SHAPES.index(env.appearance["obj_shape"]),
                     _TARGET_SHAPES.index(env.appearance["target_shape"]))
    return frames, positions, shapes


def localisation_targets(positions, shapes=None) -> np.ndarray:
    """xy of the three blobs and the grasp flag / 0.1, plus the 2.0
    one-hots of the object and target shapes."""
    targets = np.concatenate([
        positions[:, 0:2], positions[:, 3:5], positions[:, 6:8],
        positions[:, 9:10]], axis=1).astype(np.float32) / 0.1
    if shapes is not None:
        oh_obj = 2.0 * np.eye(len(_OBJ_SHAPES), dtype=np.float32)[shapes[:, 0]]
        oh_tgt = 2.0 * np.eye(len(_TARGET_SHAPES),
                              dtype=np.float32)[shapes[:, 1]]
        targets = np.concatenate([targets, oh_obj, oh_tgt], axis=1)
    return targets


def shift_flip(img, dy, dx, fh, fv):
    """Per-row `jnp.roll(img, (dy, dx), (0, 1))`, then a horizontal flip
    where fh and a vertical one where fv, as one gather. img [B, H, W,
    C]; dy, dx int [B]; fh, fv bool [B]."""
    import torch
    b, h, w = img.shape[:3]
    dev = img.device
    r = torch.arange(h, device=dev)
    c = torch.arange(w, device=dev)
    rows = (torch.where(fv[:, None], h - 1 - r, r) - dy[:, None]) % h
    cols = (torch.where(fh[:, None], w - 1 - c, c) - dx[:, None]) % w
    bi = torch.arange(b, device=dev)[:, None, None]
    return img[bi, rows[:, :, None], cols[:, None, :]]


def pretrain_draws(gen, b: int, dev) -> dict:
    """jax.random's draws of the pretraining augmentation, from `gen`:
    shifts in [-16, 16], fair flips."""
    import torch
    dyx = torch.randint(-16, 17, (2, b), generator=gen, device=dev)
    flips = torch.rand((2, b), generator=gen, device=dev) < 0.5
    return {"dy": dyx[0], "dx": dyx[1], "fh": flips[0], "fv": flips[1]}


def pretrain_augment(img, y, dy, dx, fh, fv):
    """Shift / flip frames with the position labels moved to match
    (frame column <-> world x, row <-> y; 400 px a unit, labels / 0.1):
    scripts/verification_scaling.py:633-648 for a batch of draws."""
    import torch
    img = shift_flip(img, dy, dx, fh, fv)
    # a device tensor divisor: a host scalar one is a multiplication by a
    # rounded reciprocal on the card
    forty = torch.tensor(40.0, dtype=y.dtype, device=y.device)
    y = y.clone()
    y[:, 0:6:2] = y[:, 0:6:2] + (dx.float() / forty)[:, None]
    y[:, 1:6:2] = y[:, 1:6:2] + (dy.float() / forty)[:, None]
    y[:, 0:6:2] = torch.where(fh[:, None], y[:, 0:6:2] * -1.0, y[:, 0:6:2])
    y[:, 1:6:2] = torch.where(fv[:, None], y[:, 1:6:2] * -1.0, y[:, 1:6:2])
    return img, y


def pretrain_loss(tree, vcfg, images, y):
    """MSE of a linear head over the tower's last attention sublayer
    output (the features the verifier heads consume)."""
    from cover_vla_tpu_torch.models import siglip
    out = siglip.vit_forward(tree["vision"], vcfg.vision, images)
    feats = out.last_attn_out.float()
    pred = feats.reshape(feats.shape[0], -1) @ tree["head"]["kernel"] \
        + tree["head"]["bias"]
    return ((pred - y) ** 2).mean()


def pretrain_update(tx, opt_state, tree, vcfg, images, y):
    """One optimizer step of `pretrain_loss` over every leaf of `tree`, in
    place; returns (loss, the new optimizer state)."""
    from cover_vla_tpu_torch.training import optim
    from cover_vla_tpu_torch.utils.tree import flatten
    loss, _, _, opt_state = optim.grad_step(
        tx, opt_state, flatten(tree),
        lambda: (pretrain_loss(tree, vcfg, images, y), {}))
    return loss, opt_state


def f32_tree(tree):
    """Floating leaves as fp32 copies, as plain nested dicts."""
    from cover_vla_tpu_torch.models.params import ParamTree
    if isinstance(tree, (dict, ParamTree)):
        return {k: f32_tree(tree[k]) for k in tree}
    t = tree.detach()
    return t.float().clone() if t.is_floating_point() else t.clone()


def tower_features(vision, vcfg, images, chunk: int = 256):
    """fp32 [B, patches * width] last-attention features, under no_grad
    (K2 under a kernel config), `chunk` images a call."""
    import torch
    from cover_vla_tpu_torch.models import siglip
    out = []
    with torch.no_grad():
        for s in range(0, len(images), chunk):
            f = siglip.vit_forward(vision, vcfg.vision,
                                   images[s:s + chunk]).last_attn_out
            out.append(f.float().reshape(f.shape[0], -1))
    return torch.cat(out)


def probe_error(vision, vcfg, fit_imgs, fit_y, val_imgs, val_y) -> float:
    """Mean absolute localisation error (world units) of a ridge probe
    fitted on one tower's features: the same measure for any tower,
    whether or not its training head shipped."""
    import torch
    f = tower_features(vision, vcfg, fit_imgs).double()
    g = tower_features(vision, vcfg, val_imgs).double()
    y = fit_y[:, :6].double()
    fm, ym = f.mean(0), y.mean(0)
    f, g = f - fm, g - fm
    k = f @ f.T
    lam = 1e-3 * torch.trace(k) / len(k)
    alpha = torch.linalg.solve(k + lam * torch.eye(len(k), dtype=k.dtype,
                                                   device=k.device), y - ym)
    pred = g @ (f.T @ alpha) + ym
    return float((pred - val_y[:, :6].double()).abs().mean() * 0.1)


def cmd_pretrain_backbone(args):
    """The verifier's vision tower regresses the privileged scene geometry
    (and the shapes) from pixels through the features the verifier heads
    consume; the head is discarded and the tower ships."""
    import torch
    from cover_vla_tpu_torch.convert.from_jax import load_pickle, place_like
    from cover_vla_tpu_torch.models import verifier
    from cover_vla_tpu_torch.training import optim
    from cover_vla_tpu_torch.utils.tree import flatten

    dev = stage_device(args)
    _, vcfg = experiment_configs()
    _, vcfg_k = attention_configs(*experiment_configs(), args.config)
    t0 = time.perf_counter()
    shapes = None
    if args.synthetic:
        frames, positions, shapes = synth_localisation_frames(
            args.synthetic, id_frac=args.id_frac)
        print(f"pretrain: {args.synthetic} domain-randomized synthetic "
              f"frames (id_frac={args.id_frac}, "
              f"{time.perf_counter() - t0:.0f}s)", flush=True)
    else:
        with np.load(input_path("rankdata.npz")) as rd:
            frames, positions = rd["frames"], rd["positions"]
    n = len(frames)
    targets = localisation_targets(positions, shapes)
    print(f"pretrain: {n} frames, {targets.shape[1]} targets")

    vision0 = f32_tree(verifier.init_verifier(
        7, vcfg, 1, device=dev)["backbone"]["vision"])
    if args.init_from:
        vision = place_like(load_pickle(input_path(args.init_from)),
                            vision0, dev)
        print(f"  fine-tuning from {args.init_from}")
    else:
        vision = vision0
    p_dim = vcfg.vision.num_patches * vcfg.vision.width
    gen = torch.Generator(device=dev).manual_seed(8)
    head = {"kernel": torch.randn((p_dim, targets.shape[1]), generator=gen,
                                  device=dev) * (p_dim ** -0.5),
            "bias": torch.zeros((targets.shape[1],), device=dev)}
    tree = {"vision": vision, "head": head}
    tx = optim.adamw(stage_schedule(args.lr, args.steps, 100),
                     weight_decay=1e-5)
    opt_state = tx.init(flatten(tree))

    # the dataset is staged on the card once; batches, augmentation and
    # preprocessing run there
    rng = np.random.default_rng(3)
    val = rng.permutation(n)[:min(256, max(1, n // 5))]
    train = np.setdiff1d(np.arange(n), val)
    dev_frames = torch.from_numpy(frames).to(dev)
    dev_targets = torch.from_numpy(targets).to(dev)
    train_idx = torch.from_numpy(train).to(dev)
    size = vcfg.vision.image_size
    val_imgs = verifier_prep(dev_frames[torch.from_numpy(val).to(dev)], size)
    val_y = dev_targets[torch.from_numpy(val).to(dev)]

    def step():
        idx = train_idx[torch.randint(0, len(train), (args.batch,),
                                      generator=gen, device=dev)]
        f_b, y_b = pretrain_augment(dev_frames[idx], dev_targets[idx],
                                    **pretrain_draws(gen, args.batch, dev))
        return pretrain_update(tx, opt_state, tree, vcfg,
                               verifier_prep(f_b, size), y_b)

    scan = min(100, max(1, args.steps))     # steps between readings
    n_dispatch = max(1, args.steps // scan)
    cost = StageCost(dev, n_dispatch * scan, at=200, window=20)
    curve = []
    for it in range(n_dispatch):
        for s in range(scan):
            cost.before(it * scan + s)
            loss, opt_state = step()
        if it % 10 == 0 or it == n_dispatch - 1:
            with torch.no_grad():
                vl = float(pretrain_loss(tree, vcfg, val_imgs, val_y))
            curve.append(((it + 1) * scan, float(loss), vl))
            print(f"  pretrain step {(it + 1) * scan}: loss={float(loss):.4f}"
                  f" val={vl:.4f} ({time.perf_counter() - cost.t0:.0f}s)",
                  flush=True)
    info = cost.summary(n_dispatch * scan)
    save_pickle(output_path("pretrained_vision.pkl"), tree["vision"])
    with torch.no_grad():
        feats = tower_features(tree["vision"], vcfg, val_imgs)
        pred = feats @ tree["head"]["kernel"] + tree["head"]["bias"]
        err = float((pred[:, :6] - val_y[:, :6]).abs().mean() * 0.1)
    # the port's tower and the committed JAX tower through the same ridge
    # probe, fitted on (up to 4,096) unaugmented training frames
    fit = torch.from_numpy(train[:4096]).to(dev)
    fit_imgs = verifier_prep(dev_frames[fit], size)
    probes = {"port": probe_error(tree["vision"], vcfg_k, fit_imgs,
                                  dev_targets[fit], val_imgs, val_y)}
    committed = os.path.join(src_dir(), "pretrained_vision.pkl")
    if os.path.exists(committed):
        jax_tower = place_like(load_pickle(committed), vision0, dev)
        probes["committed_jax"] = probe_error(jax_tower, vcfg_k, fit_imgs,
                                              dev_targets[fit], val_imgs,
                                              val_y)
    write_meta("pretrained_vision.pkl", {
        "stage": "pretrain_backbone", "args": vars_of(args),
        "frames": n, "val_frames": int(len(val)), "curve": curve,
        "val_localisation_error": err, "probe_localisation_error": probes,
        **info})
    print(cost_line("pretrain_backbone", info))
    print(f"saved pretrained_vision.pkl (val mean abs localisation error "
          f"{err:.4f} world units; blob spacing ~0.1); ridge probe on the "
          f"same frames: {probes}")


# ---------------------------------------------------------------------------
# train_verifier (scripts/verification_scaling.py:743-1095)
# ---------------------------------------------------------------------------


def verifier_draws(gen, b: int, dev) -> dict:
    """jax.random's draws of the verifier augmentation, from `gen`: shifts
    in [-24, 24], fair flips, a channel permutation, channel scales in
    [0.6, 1.4) and offsets in [-40, 40)."""
    import torch
    dyx = torch.randint(-24, 25, (2, b), generator=gen, device=dev)
    flips = torch.rand((2, b), generator=gen, device=dev) < 0.5
    perm = torch.rand((b, 3), generator=gen, device=dev).argsort(dim=-1)
    scale = 0.6 + 0.8 * torch.rand((b, 3), generator=gen, device=dev)
    offset = -40.0 + 80.0 * torch.rand((b, 3), generator=gen, device=dev)
    return {"dy": dyx[0], "dx": dyx[1], "fh": flips[0], "fv": flips[1],
            "perm": perm, "scale": scale, "offset": offset}


def verifier_augment(img, tr, dy, dx, fh, fv, perm, scale, offset,
                     color_aug: bool, pad_value: float):
    """Label-preserving augmentation (scripts/verification_scaling.py:
    954-985) for a batch of draws: whole-frame shifts, axis flips with the
    trajectory's matching delta axis negated (padding rows stay padding)
    and, with color_aug, a channel permutation and per-channel affine map
    clipped to [0, 255]. img [B, H, W, 3]; tr [B, N, T, 7]."""
    import torch
    img = shift_flip(img, dy, dx, fh, fv)
    pad = (tr == pad_value).all(dim=-1, keepdim=True)
    sign = torch.ones((len(tr), 7), dtype=tr.dtype, device=tr.device)
    sign[:, 0] = torch.where(fh, -1.0, 1.0)
    sign[:, 1] = torch.where(fv, -1.0, 1.0)
    tr = torch.where(pad, tr, tr * sign[:, None, None, :])
    if color_aug:
        x = img.float()
        x = x.gather(-1, perm[:, None, None, :].expand(x.shape))
        x = x * scale[:, None, None, :] + offset[:, None, None, :]
        img = x.clamp(0.0, 255.0)
    return img, tr


def standardize_slates(q):
    """Per-slate standardization of the regression targets:
    (q - mean) / (population std + 0.1)."""
    return (q - q.mean(dim=1, keepdim=True)) / (
        q.std(dim=1, keepdim=True, correction=0) + 0.1)


def verifier_data(args, vcfg, dev) -> dict:
    """The concatenated rankdata with its filters, the instruction
    variants, the grounded per-state tokens, the held-out split and the
    strata, staged on `dev`."""
    import torch
    from cover_vla_tpu_torch.data.tokenizer import make_verifier_tokenizer
    from cover_vla_tpu_torch.eval.benchmark import TASK_INSTRUCTIONS

    instr = task_instruction()
    parts = [dict(np.load(input_path(name))) for name in args.data]
    frames = np.concatenate([p["frames"] for p in parts])
    trajs = np.concatenate([p["trajs"] for p in parts])
    quals = np.concatenate([p["quals"] for p in parts])
    # per-state instructions (files without the key: the ID instruction)
    state_instrs = np.concatenate([
        np.asarray(p["instrs"]) if "instrs" in p
        else np.full(len(p["frames"]), instr) for p in parts])
    if args.dr_phase == "carry":
        # domain-randomized states only where the object is grasped
        grasped = np.concatenate([p["positions"][:, 9].astype(bool)
                                  for p in parts])
        is_dr = state_instrs != instr
        keep_phase = ~is_dr | grasped
        frames, trajs, quals = (frames[keep_phase], trajs[keep_phase],
                                quals[keep_phase])
        state_instrs = state_instrs[keep_phase]
        print(f"verifier rankdata: --dr-phase carry keeps "
              f"{keep_phase.sum()}/{len(keep_phase)} states "
              f"({int((is_dr & keep_phase).sum())} DR carry)")
    if len(parts) > 1:
        print(f"verifier rankdata: concatenated {len(parts)} files "
              f"{list(args.data)} -> {len(frames)} states")
    # states whose candidates differ in outcome
    spread = quals.max(1) - quals.min(1)
    keep = np.nonzero(spread > args.min_spread)[0]
    print(f"verifier rankdata: {len(keep)}/{len(frames)} states with "
          f"quality spread > {args.min_spread}")

    tok = make_verifier_tokenizer(vcfg.text.vocab_size)
    variants = [instr] + task_rephrases(instr, 7) if args.rephrases \
        else [instr]
    if args.cross_task_text:
        extra = []
        for t, ins in TASK_INSTRUCTIONS.items():
            if t.startswith("widowx"):
                extra += [ins] + task_rephrases(ins, 2)
        variants += [v for v in dict.fromkeys(extra) if v not in variants]
    vt_all, _ = tok.encode_batch(variants, vcfg.text.context_length)
    print(f"  verifier instruction variants: {len(variants)}")
    uniq_instrs, instr_inv = np.unique(state_instrs, return_inverse=True)
    uniq_tok, _ = tok.encode_batch(list(uniq_instrs),
                                   vcfg.text.context_length)
    is_id_state = state_instrs == instr
    n_grounded = int((~is_id_state).sum())
    if n_grounded:
        print(f"  grounded instructions: {n_grounded}/{len(state_instrs)} "
              f"states, {len(uniq_instrs)} unique")

    # held-out split and strata (high-stakes: spread > 5)
    rng = np.random.default_rng(1)
    perm = rng.permutation(keep)
    val = perm[:max(32, len(perm) // 10)]
    train = perm[len(val):]
    if not len(train):
        raise ValueError(f"{len(keep)} states leave none to train on after "
                         f"the {len(val)} held out")
    hi = train[spread[train] > 5.0]
    lo = train[spread[train] <= 5.0]
    print(f"  strata: {len(hi)} high-stakes / {len(lo)} routine; "
          f"{len(val)} held-out")
    stratified = bool(len(hi)) and bool(len(lo))

    def on(x, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        return t if dtype is None else t.to(dtype)

    v_idx = val[:256]
    return {
        "frames": on(frames), "trajs": on(trajs, torch.float32),
        "quals": on(quals, torch.float32),
        "instr_inv": on(instr_inv.astype(np.int64)),
        "is_id": on(is_id_state), "uniq_tok": on(uniq_tok, torch.long),
        "vt_all": on(vt_all, torch.long),
        "hi": on(hi if stratified else train),
        "lo": on(lo if stratified else train),
        "val_imgs": verifier_prep(on(frames[v_idx]), vcfg.vision.image_size),
        "val_trajs": on(trajs[v_idx], torch.float32),
        "val_quals": quals[v_idx].astype(np.float32),
        "val_tok": on(uniq_tok[instr_inv[v_idx]], torch.long),
        "n_states": int(len(keep)), "n_states_total": int(len(frames)),
        "strata": [int(len(hi)), int(len(lo)), int(len(val))]}


def verifier_batch(data: dict, draws_gen, args, vcfg, pad_value: float):
    """One stratified batch: half high-stakes states, half routine ones,
    augmented, standardized (regression), preprocessed, each under a
    random instruction variant (ID states) or its own grounded
    instruction."""
    import torch
    gen, b = draws_gen, args.batch
    dev = data["frames"].device
    b1 = b // 2
    hi, lo = data["hi"], data["lo"]
    idx = torch.cat([
        hi[torch.randint(0, len(hi), (b1,), generator=gen, device=dev)],
        lo[torch.randint(0, len(lo), (b - b1,), generator=gen, device=dev)]])
    f_b, t_b = data["frames"][idx], data["trajs"][idx]
    q = data["quals"][idx]
    if args.augment:
        f_b, t_b = verifier_augment(f_b, t_b, **verifier_draws(gen, b, dev),
                                    color_aug=args.color_aug,
                                    pad_value=pad_value)
    if args.objective == "regression":
        q = standardize_slates(q)
    r = torch.randint(0, len(data["vt_all"]), (b,), generator=gen,
                      device=dev)
    g_toks = data["uniq_tok"][data["instr_inv"][idx]]
    toks = torch.where(data["is_id"][idx][:, None], data["vt_all"][r],
                       g_toks)
    return {"images": verifier_prep(f_b, vcfg.vision.image_size),
            "text_tokens": toks, "cand_trajs": t_b, "qualities": q}


def selection_regret(scores: np.ndarray, quals: np.ndarray):
    """Mean regret of the argmax pick against the best candidate, and the
    share of states where it is the best."""
    picks = scores.argmax(1)
    picked = np.take_along_axis(quals, picks[:, None], 1)[:, 0]
    return (float(np.mean(quals.max(1) - picked)),
            float(np.mean(picks == quals.argmax(1))))


def init_verifier_params(args, vcfg, dev):
    """The verifier tree a run starts from (fp32 backbone) and whether its
    vision tower counts as pretrained."""
    from cover_vla_tpu_torch.convert.from_jax import (
        load_pickle, place_like, verifier_from_jax)
    from cover_vla_tpu_torch.models import verifier
    from cover_vla_tpu_torch.models.params import ParamTree
    if args.init_params:
        # warm start: the checkpoint's own backbone counts as pretrained
        params = verifier_from_jax(load_pickle(input_path(args.init_params)),
                                   vcfg, device=dev)
        print(f"  warm start from {args.init_params}")
        return params, True
    params = verifier.init_verifier(2, vcfg, args.members, device=dev)
    tree = {"backbone": f32_tree(params["backbone"]),
            "members": params["members"]}
    pv_path = input_path(args.pretrained_vision)
    pretrained = args.pretrained and os.path.exists(pv_path)
    if pretrained:
        vision = load_pickle(pv_path)
        if "backbone" in vision:        # a verifier tree: its own tower
            vision = vision["backbone"]["vision"]
        tree["backbone"]["vision"] = place_like(
            vision, tree["backbone"]["vision"], dev)
        print(f"  loaded pretrained vision tower ({pv_path})")
    return ParamTree(tree), pretrained


def cmd_train_verifier(args):
    import torch
    from cover_vla_tpu_torch.training import optim, train_verifier
    from cover_vla_tpu_torch.utils.tree import flatten, unflatten

    dev = stage_device(args)
    pcfg0, vcfg = experiment_configs()
    _, vcfg_k = attention_configs(pcfg0, vcfg, args.config)
    data = verifier_data(args, vcfg, dev)
    params, pretrained = init_verifier_params(args, vcfg, dev)
    freeze = {"auto": pretrained, "true": True,
              "false": False}[args.freeze_backbone]
    print(f"  freeze_backbone={freeze} (pretrained={pretrained})")
    # the schedule is read at the optimizer's count: the learning rate
    # inject_hyperparams received per step
    tx = optim.adamw(stage_schedule(args.lr, args.steps, 50),
                     weight_decay=1e-5)
    state = train_verifier.FullVerifierTrainState(
        params, tx.init(flatten(params)), optim.counter())
    # the frozen backbone's features run under no_grad, where K2 may run;
    # a backbone that trains is differentiated through eager attention
    step_cfg = vcfg_k if freeze else vcfg
    if args.objective == "listwise":
        step_fn = train_verifier.make_listwise_train_step(
            step_cfg, tx, tau=args.tau, train_backbone=not freeze)
    else:
        step_fn = train_verifier.make_regression_train_step(
            step_cfg, tx, q_scale=1.0, train_backbone=not freeze)

    @torch.no_grad()
    def val_regret(p):
        """Selection regret on held-out states, scored as the engine
        scores (ensemble-fused embeddings, one dot)."""
        sc = state_scores(p, vcfg_k, data["val_imgs"], data["val_tok"],
                          data["val_trajs"]).cpu().numpy()
        return selection_regret(sc, data["val_quals"])

    gen = torch.Generator(device=dev).manual_seed(17)
    scan = min(int(os.environ.get("VS_SCAN_STEPS", "50")),
               max(1, args.steps))
    n_dispatch = max(1, args.steps // scan)
    val_every = max(1, 200 // scan)
    cost = StageCost(dev, n_dispatch * scan, at=100, window=20)
    best = (1e9, None)
    curve = []
    pad_value = vcfg.action_padding_value
    for it in range(n_dispatch):
        for s in range(scan):
            cost.before(it * scan + s)
            state, metrics = step_fn(state, verifier_batch(
                data, gen, args, vcfg, pad_value))
        if it % val_every == 0 or it == n_dispatch - 1:
            vr, va = val_regret(state.params)
            if vr < best[0]:
                best = (vr, {k: v.detach().clone()
                             for k, v in flatten(state.params).items()})
            curve.append(((it + 1) * scan, float(metrics["loss"]),
                          float(metrics["rank_acc"]), vr, va))
            print(f"  verifier step {(it + 1) * scan}: "
                  f"loss={float(metrics['loss']):.4f} "
                  f"rank_acc={float(metrics['rank_acc']):.3f} "
                  f"val_regret={vr:.3f} val_top1={va:.3f} "
                  f"({time.perf_counter() - cost.t0:.0f}s)", flush=True)
    info = cost.summary(n_dispatch * scan)
    save_pickle(output_path(args.out),
                unflatten(best[1]) if best[1] is not None else state.params)
    write_meta(args.out, {"val_regret": round(float(best[0]), 4),
                          "data_files": list(args.data),
                          "n_states": data["n_states"],
                          "n_states_total": data["n_states_total"],
                          "stage": "train_verifier", "args": vars_of(args),
                          "strata_hi_lo_val": data["strata"],
                          "freeze_backbone": freeze, "curve": curve,
                          **info})
    print(cost_line("train_verifier", info))
    print(f"saved {args.out} (best val_regret={best[0]:.3f})")


# ---------------------------------------------------------------------------
# statistics and the oracle (scripts/verification_scaling.py:1103-1129)
# ---------------------------------------------------------------------------


def wilson_ci(k: int, n: int, z: float = 1.96):
    """95% Wilson score interval for a binomial proportion."""
    if n == 0:
        return (0.0, 0.0)
    p = k / n
    denom = 1 + z * z / n
    centre = (p + z * z / (2 * n)) / denom
    half = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return (max(0.0, centre - half), min(1.0, centre + half))


def two_proportion_z(k1: int, n1: int, k2: int, n2: int) -> float:
    """Pooled two-proportion z of k1/n1 against k2/n2 (0 when both are
    all successes or all failures)."""
    p = (k1 + k2) / (n1 + n2)
    se = math.sqrt(p * (1 - p) * (1 / n1 + 1 / n2))
    return 0.0 if se == 0 else (k1 / n1 - k2 / n2) / se


def oracle_score_factory(envs):
    """Privileged progress oracle as an injected-score scorer: each
    candidate's score is the true potential gain a copy of the live env
    makes executing it (`eval/fake_expert.chunk_quality`)."""
    from cover_vla_tpu_torch.eval.fake_expert import chunk_quality

    def score_fn(exec_chunks: np.ndarray) -> np.ndarray:  # [E, KN, chunk, 7]
        e_n, kn = exec_chunks.shape[:2]
        return np.asarray(
            [[chunk_quality(envs[e], exec_chunks[e, i]) for i in range(kn)]
             for e in range(e_n)], np.float32)

    return score_fn


# ---------------------------------------------------------------------------
# one cell (scripts/verification_scaling.py:1132-1198)
# ---------------------------------------------------------------------------


def run_cell(policy_params, verifier_params, pcfg, vcfg, stats,
             mode: str, n_samples: int, trials: int, n_parallel: int,
             seed: int, out_dir=None, n_rephrases: int = 1,
             task: str = TASK, gripper_vote=None, rescore_threshold=None,
             defer_threshold=None, device=None):
    """One cell of the grid; `gripper_vote`, `rescore_threshold` and
    `defer_threshold` (the verifier arm only) override the CoVerConfig
    defaults as the JAX script's knobs do."""
    from cover_vla_tpu_torch.configs import CoVerConfig
    from cover_vla_tpu_torch.data.tokenizer import (
        make_policy_tokenizer, make_verifier_tokenizer)
    from cover_vla_tpu_torch.eval.evaluator import (
        EvalConfig, evaluate_suite_batched)
    from cover_vla_tpu_torch.eval.fake_env import make_fake_env
    from cover_vla_tpu_torch.eval.rephrase import load_rephrases

    if out_dir:
        shutil.rmtree(out_dir, ignore_errors=True)  # stale episode pkls
    if mode == "oracle":
        # the verifier-quality ceiling: injected oracle scores, pure
        # grouped argmax, no gripper vote
        ccfg = CoVerConfig(
            n_samples=n_samples, n_rephrases=n_rephrases, noise_std=1.0,
            selection="injected", gripper_vote=False,
            rescore_threshold=float("inf"),
            max_history=vcfg.history_length - pcfg.chunk_size)
        score_fn_factory = oracle_score_factory
    else:
        kw = {}
        if rescore_threshold is not None:
            kw["rescore_threshold"] = float(rescore_threshold)
        if defer_threshold is not None and mode == "verifier":
            kw["defer_threshold"] = float(defer_threshold)
        ccfg = CoVerConfig(
            n_samples=n_samples, n_rephrases=n_rephrases, noise_std=1.0,
            selection=mode,
            gripper_vote=(mode == "verifier" if gripper_vote is None
                          else bool(gripper_vote) and mode == "verifier"),
            max_history=vcfg.history_length - pcfg.chunk_size, **kw)
        score_fn_factory = None
    ecfg = EvalConfig(task_suite=task, num_trials_per_task=trials,
                      max_steps=MAX_ENV_STEPS, seed=1000, seed_period=10_000)
    out = evaluate_suite_batched(
        policy_params, verifier_params, pcfg, vcfg, ccfg, ecfg,
        n_parallel=n_parallel,
        env_fn=lambda t: make_fake_env(t, max_steps=MAX_ENV_STEPS),
        stats=stats, seed=seed,
        rephrases=load_rephrases() if n_rephrases > 1 else None,
        policy_tokenizer=make_policy_tokenizer(pcfg.paligemma.vocab_size),
        verifier_tokenizer=make_verifier_tokenizer(vcfg.text.vocab_size),
        out_dir=out_dir, score_fn_factory=score_fn_factory, device=device)
    task_stats = out["summary"]["per_task"][task]
    succ = [e["success"] for e in task_stats["per_episode"]]
    k, n = int(np.sum(succ)), len(succ)
    lo, hi = wilson_ci(k, n)
    cell = {"mode": mode, "n_samples": n_samples,
            "n_rephrases": n_rephrases, "successes": k,
            "episodes": n, "success_rate": k / n,
            "ci95": [round(lo, 4), round(hi, 4)],
            "mean_steps": task_stats["mean_steps"],
            "actions_per_sec": round(out["actions_per_sec"], 1)}
    if task != TASK:
        cell["task"] = task
    if defer_threshold is not None and mode == "verifier":
        cell["defer_threshold"] = float(defer_threshold)
    return cell


# (mode, N samples per rephrase, K rephrases): scripts/verification_scaling.py
# :1204-1224, the K=8 cells the reference's 8-rephrase x 5-sample protocol
GRID = [("first", 1, 1), ("random", 5, 1), ("random", 16, 1),
        ("random", 40, 1), ("random", 80, 1),
        ("verifier", 1, 1), ("verifier", 5, 1), ("verifier", 16, 1),
        ("verifier", 40, 1), ("verifier", 80, 1),
        ("random", 5, 8), ("verifier", 5, 8), ("verifier", 16, 8)]

ORACLE_NS = (5, 16, 40, 80)

OOD_TASKS = ("widowx_redbull_on_plate_appearance",
             "widowx_zucchini_on_towel_appearance",
             "widowx_tennis_ball_in_basket_appearance",
             "widowx_redbull_on_plate", "widowx_zucchini_on_towel",
             "widowx_tennis_ball_in_basket")
OOD_MODES = (("first", 1), ("random", 16), ("verifier", 16), ("oracle", 16))


# ---------------------------------------------------------------------------
# the results file
# ---------------------------------------------------------------------------


def card_line(dev) -> str:
    """`nvidia-smi`'s name and power limit of the card, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def jax_cells(path: str, policy: str = "policy_params.pkl"):
    """The JAX package's committed cells, keyed as the grid keys them; the
    grid of a run of the rephrase-augmented policy is JAX's
    `rephrase_policy_grid` (its `policy` names the tree first)."""
    with open(path) as f:
        ref = json.load(f)
    cells = ref["grid"]
    rp = ref.get("rephrase_policy_grid")
    if rp and os.path.basename(policy) == rp.get("policy", "").split()[0]:
        cells = rp["cells"]
    elif os.path.basename(policy) != "policy_params.pkl":
        cells = []
    grid = {(c["mode"], c["n_samples"], c.get("n_rephrases", 1)): c
            for c in cells}
    ood = {(c["task"], c["mode"], c["n_samples"]): c
           for c in ref.get("ood_grid", []) if cells}
    return grid, ood


def beside_jax(cell: dict, ref) -> dict:
    """`cell` with the JAX cell's successes and interval and the
    two-proportion z against it (the JAX fields stay None where JAX has
    no such cell)."""
    if ref is None:
        return {**cell, "jax_successes": None, "jax_episodes": None,
                "jax_ci95": None, "z_vs_jax": None, "in_jax_ci95": None}
    lo, hi = ref["ci95"]
    return {**cell, "jax_successes": ref["successes"],
            "jax_episodes": ref["episodes"], "jax_ci95": ref["ci95"],
            "z_vs_jax": round(two_proportion_z(
                cell["successes"], cell["episodes"], ref["successes"],
                ref["episodes"]), 4),
            "in_jax_ci95": bool(lo <= cell["success_rate"] <= hi)}


@contextlib.contextmanager
def locked_results(path: str):
    """The results dict under an exclusive lock, written back on exit
    (configs may run in concurrent processes)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            results = {"task": TASK, "runs": []}
            if os.path.exists(path):
                with open(path) as f:
                    results = json.load(f)
            yield results
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(results, f, indent=1)
            os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def cell_key(c: dict):
    return (c.get("task", TASK), c["mode"], c["n_samples"],
            c.get("n_rephrases", 1))


def is_run(r: dict, config: str, name) -> bool:
    return r["config"] == config and r.get("name") == name


def find_run(results: dict, config: str, name):
    return next((r for r in results["runs"] if is_run(r, config, name)), None)


def record(path: str, config: str, run_info: dict, cell: dict, ood: bool,
           name=None):
    """Put `cell` into the run of (`config`, `name`), replacing a cell of
    the same key."""
    with locked_results(path) as results:
        run = find_run(results, config, name)
        if run is None:
            run = {"config": config, "grid": [], "ood_grid": []}
            if name is not None:
                run["name"] = name
            results["runs"].append(run)
        run.update(run_info)
        cells = run["ood_grid" if ood else "grid"]
        cells[:] = [c for c in cells if cell_key(c) != cell_key(cell)]
        cells.append(cell)


# ---------------------------------------------------------------------------
# eval (scripts/verification_scaling.py:1227-1399)
# ---------------------------------------------------------------------------


def eval_tree_paths(args):
    """The policy and verifier pickles of an eval run: the committed JAX
    trees by default; a given bare name is read from the artifact
    directory when a port stage wrote it there. Also the results file:
    the artifact directory's when a tree comes from there."""
    paths = []
    for name, default in ((args.policy_params, "policy_params.pkl"),
                          (args.verifier_params, "verifier_params.pkl")):
        paths.append(os.path.abspath(
            os.path.join(src_dir(), default) if name is None
            else input_path(name)))
    trained = any(os.path.dirname(p) == os.path.abspath(art_dir())
                  for p in paths)
    base = art_dir() if trained else out_dir()
    return paths[0], paths[1], base


def results_path(args) -> str:
    """The results file of `dagger_note` and `report`: `--results`, else
    the artifact directory's when `--art-dir` names one, else
    experiments/verification_scaling_torch/results.json."""
    if args.results:
        return args.results
    return os.path.join(art_dir() if args.art_dir else out_dir(),
                        "results.json")


def eval_knobs(args) -> dict:
    """The non-default knobs of an eval run (a run under one must be
    named, so that its cells never replace the default run's)."""
    knobs = {k: getattr(args, k) for k in ("gripper_vote",
                                           "rescore_threshold",
                                           "defer_threshold")
             if getattr(args, k) is not None}
    if knobs and not (args.run_name or (args.record_mode
                                        and args.modes == ["verifier"])):
        raise SystemExit(
            f"eval: {sorted(knobs)} change what a cell measures; name the "
            "run with --run-name (or, for the verifier arm alone, "
            "--record-mode with --modes verifier)")
    return knobs


def cmd_eval(args):
    import torch
    from cover_vla_tpu_torch.device import resolve_device

    knobs = eval_knobs(args)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        # the image ops' separable products must run in true fp32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    pcfg0, vcfg0 = experiment_configs()
    pcfg, vcfg = attention_configs(pcfg0, vcfg0, args.config)
    policy_path, verifier_path, base = eval_tree_paths(args)
    pp, vp, stats = load_trees(policy_path, verifier_path, pcfg0, vcfg0, dev)
    if base == art_dir():
        stats = load_stats()        # the statistics the trees trained with
    if args.quantize != "none":
        from cover_vla_tpu_torch.ops import quant
        pp = quant.quantize_pi0_policy(pp)
        if args.quantize == "int8_full":
            vp = quant.quantize_verifier(vp)
        print(f"  quantized policy tree ({args.quantize})")

    res_path = args.results or os.path.join(base, "results.json")
    existing = set()
    if os.path.exists(res_path):
        with locked_results(res_path) as results:
            if not args.merge:
                # a fresh run of this config replaces its entry; other
                # configs' runs stay
                results["runs"] = [r for r in results["runs"] if not is_run(
                    r, args.config, args.run_name)]
            elif args.skip_existing:
                run = find_run(results, args.config, args.run_name)
                existing = {cell_key(c) for c in (run["grid"] + run["ood_grid"]
                                                  if run else [])}
    jax_grid, jax_ood = jax_cells(os.path.join(src_dir(), "results.json"),
                                  policy_path)
    trees = {"policy_params": os.path.relpath(policy_path, REPO),
             "verifier_params": os.path.relpath(verifier_path, REPO)}
    run_info = {"device": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"),
                "card": card_line(dev), "torch": torch.__version__,
                "n_parallel": args.n_parallel, "seed": 7,
                # cells recorded under another mode name keep their trees
                # in the cell, so the run's stay its own
                **({} if args.record_mode else trees)}
    episodes = os.path.join(base, "episodes", *(
        [args.run_name] if args.run_name else []), args.config)

    def rec_mode(mode):
        return args.record_mode if (args.record_mode
                                    and mode == "verifier") else mode

    def one(mode, n_samples, n_reph, trials, jax_ref, ood, name, task=TASK):
        if (task, rec_mode(mode), n_samples, n_reph) in existing:
            print(f"  {args.config:10s} {task[7:]:28s} {rec_mode(mode):13s} "
                  f"N={n_samples:3d} K={n_reph}: kept (--skip-existing)")
            return None
        t0 = time.time()
        cell_knobs = knobs if mode != "oracle" else {}
        cell = run_cell(pp, vp, pcfg, vcfg, stats, mode, n_samples,
                        trials=trials, n_parallel=args.n_parallel, seed=7,
                        out_dir=os.path.join(episodes, name),
                        n_rephrases=n_reph, task=task, device=dev,
                        **cell_knobs)
        cell["mode"] = rec_mode(mode)
        cell["wall_s"] = round(time.time() - t0, 1)
        cell.update(config=args.config, device=run_info["device"],
                    n_parallel=args.n_parallel)
        if args.record_mode:
            cell.update(trees)
        if args.quantize != "none":
            cell["quantize"] = args.quantize
        # the knobs this cell ran under (the vote and the deference act on
        # the verifier arm only); JAX committed no cell under a knob
        applied = {k: v for k, v in cell_knobs.items()
                   if mode == "verifier" or k == "rescore_threshold"}
        cell.update(applied)
        cell = beside_jax(cell, None if applied else jax_ref)
        record(res_path, args.config, run_info, cell, ood, args.run_name)
        ref = (f"JAX {jax_ref['successes']}/{jax_ref['episodes']} z "
               f"{cell['z_vs_jax']:+.2f}" if cell["jax_successes"] is not None
               else "no JAX cell")
        print(f"  {args.config:10s} {cell.get('task', TASK)[7:]:28s} "
              f"{cell['mode']:13s} N={n_samples:3d} K={n_reph}: "
              f"{cell['successes']}/{cell['episodes']} "
              f"[{cell['ci95'][0]:.2f},{cell['ci95'][1]:.2f}] ({ref}; "
              f"{cell['actions_per_sec']} actions/s, {cell['wall_s']} s)",
              flush=True)
        return cell

    ran = {}
    for mode, n_samples, n_reph in GRID:
        if args.modes and mode not in args.modes:
            continue
        if args.cells and f"{mode},{n_samples},{n_reph}" not in args.cells:
            continue
        suffix = f"_K{n_reph}" if n_reph > 1 else ""
        ran[mode, n_samples, n_reph] = one(
            mode, n_samples, n_reph, args.trials,
            jax_grid.get((rec_mode(mode), n_samples, n_reph)), False,
            f"{rec_mode(mode)}_N{n_samples}{suffix}")

    # the offline analyzer must read the verifier N=16 cell's episode
    # pickles to the same success rate
    v16 = ran.get(("verifier", 16, 1))
    if v16 is not None and not args.record_mode:
        from cover_vla_tpu_torch.eval import analyze
        agg = analyze.aggregate(analyze.load_episodes(
            os.path.join(episodes, "verifier_N16")))
        if abs(agg["per_task"][TASK]["success_rate"]
               - v16["success_rate"]) >= 1e-9:
            raise AssertionError("analyzer disagreement on verifier N=16")
        print("  analyzer cross-check of verifier N=16 ok")

    if args.with_oracle and (not args.modes or "oracle" in args.modes):
        for n_samples in ORACLE_NS:
            if args.cells and f"oracle,{n_samples},1" not in args.cells:
                continue
            one("oracle", n_samples, 1, args.trials,
                jax_grid.get(("oracle", n_samples, 1)), False,
                f"oracle_N{n_samples}")

    if args.ood:
        for task in (args.ood_tasks or OOD_TASKS):
            short = task.replace("widowx_", "")
            for mode, n_samples in OOD_MODES:
                if args.modes and mode not in args.modes:
                    continue
                one(mode, n_samples, 1, args.trials,
                    jax_ood.get((task, rec_mode(mode), n_samples)), True,
                    f"ood_{short}_{rec_mode(mode)}_N{n_samples}", task=task)

    # the analyzer's view of stage-2 language selection in the K=8 cell
    if ran.get(("verifier", 5, 8)) is not None and not args.record_mode:
        from cover_vla_tpu_torch.eval import analyze
        switch = analyze.instruction_switch_stats(analyze.load_episodes(
            os.path.join(episodes, "verifier_N5_K8")))
        with locked_results(res_path) as results:
            find_run(results, args.config, args.run_name)[
                "instruction_switch_K8"] = switch
        print(f"  K=8 instruction switches: {switch['episodes_with_switch']}"
              f"/{switch['episodes']} episodes")
    print(f"saved {res_path}")


# ---------------------------------------------------------------------------
# calibrate (scripts/verification_scaling.py:1402-1477)
# ---------------------------------------------------------------------------


def embed_frames(vp, vcfg, frames: np.ndarray, instruction: str, dev,
                 chunk: int = 64) -> np.ndarray:
    """`verifier.image_text_embed` of raw uint8 frames under one
    instruction, `chunk` frames a call: fp32 [B, d] on the host."""
    import torch
    from cover_vla_tpu_torch.data.tokenizer import make_verifier_tokenizer
    from cover_vla_tpu_torch.models import verifier
    vt, _ = make_verifier_tokenizer(vcfg.text.vocab_size).encode_batch(
        [instruction], vcfg.text.context_length)
    out = []
    with torch.no_grad():
        for i in range(0, len(frames), chunk):
            imgs = verifier_prep(torch.from_numpy(
                np.ascontiguousarray(frames[i:i + chunk])).to(dev),
                vcfg.vision.image_size)
            toks = torch.from_numpy(np.broadcast_to(
                vt[0], (len(imgs), vt.shape[1])).astype(np.int64)).to(dev)
            out.append(verifier.image_text_embed(vp, vcfg, imgs, toks)
                       .float().cpu().numpy())
    return np.concatenate(out)


def calibration_frames(n: int, rankdata: str = "rankdata.npz") -> np.ndarray:
    """`n` ID frames of the ranking data, chosen by a `default_rng(0)`
    permutation."""
    with np.load(input_path(rankdata)) as rd:
        frames = rd["frames"]
    idx = np.random.default_rng(0).permutation(len(frames))[:n]
    return frames[idx]


def ood_scene_frames(task: str, envs: int) -> np.ndarray:
    """Frames of short random rollouts of `task`: per env (seed 1000 + s)
    the reset frame and four random steps (`default_rng(s)`)."""
    from cover_vla_tpu_torch.eval.fake_env import FakeWidowXEnv
    frames = []
    for s in range(envs):
        env = FakeWidowXEnv(task, max_steps=MAX_ENV_STEPS)
        env.reset(seed=1000 + s)
        frames.append(env.render())
        arng = np.random.default_rng(s)
        for _ in range(4):
            a = np.zeros(7)
            a[:3] = arng.uniform(-0.05, 0.05, 3)
            a[6] = arng.choice([-1.0, 1.0])
            env.step(a)
            frames.append(env.render())
    return np.stack(frames)


def calibration_prototype(vp, vcfg, id_frames, dev):
    """(the L2-normalised mean ID embedding, the ID affinities): the host
    arithmetic of the JAX script, in fp32."""
    id_emb = embed_frames(vp, vcfg, id_frames, task_instruction(), dev)
    proto = id_emb.mean(0)
    proto = proto / np.linalg.norm(proto)
    return proto, id_emb @ proto


def stamp_calibration(vp, proto: np.ndarray):
    """The verifier tree with `calibration.prototype` (fp32) set."""
    import torch
    from cover_vla_tpu_torch.models.params import ParamTree
    dev = next(iter(vp.parameters())).device
    return ParamTree({**{k: vp[k] for k in vp if k != "calibration"},
                      "calibration": {"prototype": torch.from_numpy(
                          proto.astype(np.float32)).to(dev)}})


def affinity_line(label: str, aff: np.ndarray, p90: bool = False) -> str:
    return (f"{label} ({len(aff)} frames): " + " ".join(
        f"p{p:02d}={np.percentile(aff, p):.4f}" for p in (1, 2, 5, 10, 50))
        + (f" p90={np.percentile(aff, 90):.4f}" if p90 else ""))


def cmd_calibrate(args):
    """Affinity calibration for the phase-aware deference: the ID frames'
    prototype under the ID instruction, stamped into the verifier tree as
    `calibration.prototype`, with the ID and each OOD task's affinity
    percentiles (the evidence for `eval --defer-threshold`). The prototype
    sees ID frames only; the OOD distributions are diagnostic output."""
    from cover_vla_tpu_torch.convert.from_jax import (
        load_pickle, verifier_from_jax)
    from cover_vla_tpu_torch.eval.benchmark import TASK_INSTRUCTIONS

    dev = stage_device(args)
    pcfg0, vcfg0 = experiment_configs()
    _, vcfg = attention_configs(pcfg0, vcfg0, args.config)
    src = input_path(args.verifier_params)
    vp = verifier_from_jax(load_pickle(src), vcfg0, device=dev)
    t0 = time.perf_counter()
    proto, id_aff = calibration_prototype(
        vp, vcfg, calibration_frames(args.frames), dev)
    print(affinity_line("ID affinity", id_aff), flush=True)
    ood = {}
    for task in args.ood_tasks or OOD_TASKS:
        emb = embed_frames(vp, vcfg, ood_scene_frames(task, args.ood_envs),
                           TASK_INSTRUCTIONS.get(task, task.replace("_", " ")),
                           dev)
        ood[task] = emb @ proto
        print(affinity_line(f"OOD {task.replace('widowx_', ''):40s}",
                            ood[task], p90=True), flush=True)
    # never written back into the committed directory
    out = (args.out if args.out and os.path.dirname(args.out)
           else output_path(args.out or os.path.basename(args.verifier_params)))
    if os.path.abspath(os.path.dirname(out)) == os.path.abspath(src_dir()):
        raise SystemExit(f"calibrate: {out} is in the committed directory")
    save_pickle(out, stamp_calibration(vp, proto))
    pct = {f"p{p:02d}": float(np.percentile(id_aff, p))
           for p in (1, 2, 5, 10, 50)}
    with open(out + ".meta.json", "w") as f:
        json.dump({"stage": "calibrate", "args": vars_of(args),
                   "source": os.path.relpath(src, REPO),
                   "config": args.config, "card": card_line(dev),
                   "wall_s": time.perf_counter() - t0,
                   "id_frames": int(len(id_aff)), "id_affinity": pct,
                   "ood_affinity": {t: {f"p{p:02d}": float(np.percentile(
                       a, p)) for p in (1, 2, 5, 10, 50, 90)}
                       for t, a in ood.items()}}, f, indent=1)
    print(f"saved calibration prototype into {out}")
    return proto, id_aff, ood


# ---------------------------------------------------------------------------
# dagger_note (scripts/verification_scaling.py:1480-1518)
# ---------------------------------------------------------------------------


def cmd_dagger_note(args):
    """Record one DAgger round in the run's `dagger_rounds`: the
    checkpoint's training meta (`<checkpoint>.meta.json`, from the
    artifact directory, else the committed one) beside the run's N=16 and
    N=80 cells of `--mode`."""
    res_path = results_path(args)
    meta = {}
    mpath = input_path(args.checkpoint + ".meta.json")
    if os.path.exists(mpath):
        with open(mpath) as f:
            meta = json.load(f)
    with locked_results(res_path) as results:
        run = find_run(results, args.config, args.run_name)
        if run is None:
            raise SystemExit(f"dagger_note: no run ({args.config}, "
                             f"{args.run_name}) in {res_path}")
        cells = {(c["mode"], c["n_samples"]): c for c in run["grid"]
                 if c.get("n_rephrases", 1) == 1}
        entry = {"round": args.round,
                 "checkpoint": args.checkpoint,
                 "mode": args.mode,
                 "data": meta.get("n_states"),
                 "data_files": meta.get("data_files"),
                 "val_regret": meta.get("val_regret"),
                 "n16": cells.get((args.mode, 16)),
                 "n80": cells.get((args.mode, 80))}
        rounds = [r for r in run.get("dagger_rounds", [])
                  if r["round"] != args.round]
        rounds.append(entry)
        rounds.sort(key=lambda r: r["round"])
        run["dagger_rounds"] = rounds
    print(f"dagger round {args.round} ({args.mode}): "
          f"val_regret={meta.get('val_regret')} "
          f"data={meta.get('n_states')} states "
          f"n16={entry['n16'] and entry['n16']['success_rate']} "
          f"n80={entry['n80'] and entry['n80']['success_rate']}")
    return entry


# ---------------------------------------------------------------------------
# report (scripts/verification_scaling.py:1526-1838)
# ---------------------------------------------------------------------------


REPRODUCE = [
    "",
    "Reproduce: `python scripts/torch_verification_scaling.py all "
    "--config fast` on the card, `--device cpu` on the CPU (stages: demos, "
    "train_policy, rankdata, pretrain_backbone, train_verifier, eval, "
    "report; the committed trees: `eval`, then `report`). CI regression: "
    "`tests/test_torch_verification_scaling.py`."]


def render_report(res: dict, diag, reproduce, extra=None) -> str:
    """The JAX script's report of a results dict in its schema (`grid`,
    `ood_grid`, `rephrase_policy_grid`, `ood_ablation_nodefer`,
    `dagger_rounds`, `instruction_switch_K8`, `task`, `trials_per_cell`) and
    `ood_diagnostics.json`'s dict (or None), line for line but for two
    places: the reference's README is cited by its path in the reference
    repository, and `reproduce` replaces the Reproduce paragraph;
    `extra` lines go before it."""
    cells = {(c["mode"], c["n_samples"], c.get("n_rephrases", 1)): c
             for c in res["grid"]}
    ns = sorted({c["n_samples"] for c in res["grid"]
                 if c["mode"] != "first" and c.get("n_rephrases", 1) == 1})

    def fmt(c):
        if c is None:
            return "—"
        return (f"{100 * c['success_rate']:.0f}% "
                f"[{100 * c['ci95'][0]:.0f}, {100 * c['ci95'][1]:.0f}]")

    lines = [
        "# Verification scaling on the fake-env benchmark",
        "",
        "The repo's analog of the reference's headline table"
        " (`reference/README.md:136-155`): a tiny pi0"
        " behaviour-cloned from a noisy scripted expert, a tiny"
        " contrastively-trained verifier ensemble, and the real batched"
        " CoVer engine, on the scriptable `FakeWidowXEnv`"
        f" (task `{res['task']}`, {res['trials_per_cell']} episodes/cell,"
        " 95% Wilson CIs).",
        "",
        "Selection modes (`CoVerConfig.selection`): **verifier** = the"
        " CoVer loop (two-stage verified selection + gripper vote);"
        " **random** = a uniformly random candidate executes (statistically"
        " identical to plain pi0 — candidates are iid); **first** ="
        " candidate 0 (plain pi0, shares the verifier arm's noise stream);"
        " **oracle** = privileged selection by true env progress"
        " (`fake_expert.chunk_quality`) — the ceiling a perfect scorer"
        " would reach through the same sample->select loop.",
        "",
        "| selection | " + " | ".join(f"N={n}" for n in ns) + " |",
        "|---|" + "---|" * len(ns),
    ]
    # every mode of the grid; alternate-checkpoint rows (--record-mode)
    # slot in after verifier
    fixed = ["first", "random", "verifier", "oracle"]
    extra_modes = sorted({c["mode"] for c in res["grid"]} - set(fixed))
    for mode in fixed[:3] + extra_modes + fixed[3:]:
        row = [fmt(cells.get((mode, n, 1)) or
                   (cells.get((mode, 1, 1)) if mode == "first" else None))
               for n in ns]
        lines.append(f"| {mode} | " + " | ".join(row) + " |")
    f1 = cells.get(("first", 1, 1))
    if f1:
        lines += ["", f"pi0 baseline (N=1): {fmt(f1)}."]
    v16, r16 = cells.get(("verifier", 16, 1)), cells.get(("random", 16, 1))
    if v16 and r16:
        lines += ["",
                  f"At N=16 the verifier arm reaches "
                  f"{100 * v16['success_rate']:.0f}% vs "
                  f"{100 * r16['success_rate']:.0f}% for random selection "
                  f"({v16['successes']}/{v16['episodes']} vs "
                  f"{r16['successes']}/{r16['episodes']})."]
    # rephrase axis (the reference's 8-rephrase x 5-sample protocol)
    k8 = [(m, cells.get((m, 5, 8))) for m in ("random", "verifier")]
    if any(c for _, c in k8):
        lines += ["", "## Rephrase axis (K=8, the reference's "
                      "protocol shape)", "",
                  "| selection | N=5, K=1 | N=5 x K=8 | N=16, K=1 "
                  "| N=16 x K=8 |", "|---|---|---|---|---|"]
        for m, c in k8:
            lines.append(
                f"| {m} | {fmt(cells.get((m, 5, 1)))} | {fmt(c)} "
                f"| {fmt(cells.get((m, 16, 1)))} "
                f"| {fmt(cells.get((m, 16, 8)))} |")
        sw = res.get("instruction_switch_K8")
        if sw:
            lines += ["",
                      f"Stage-2 language selection switched the "
                      f"instruction in {sw['episodes_with_switch']}/"
                      f"{sw['episodes']} episodes "
                      f"({100 * sw['switch_rate']:.0f}%); per-instruction "
                      "win counts in results.json."]
    # the paired rephrase-policy sub-experiment
    rp = res.get("rephrase_policy_grid")
    if rp:
        rcells = {(c["mode"], c["n_samples"], c.get("n_rephrases", 1)): c
                  for c in rp["cells"]}
        lines += [
            "", "## Rephrase-augmented policy (paired sub-experiment)", "",
            "The reference's best ID column pairs rephrase eval with a"
            " policy FINETUNED on rephrased instructions"
            " (`INTACT-pi0-rephrase-bridge`, task_augmentation.py:27-80)."
            " These cells re-measure the key grid entries with"
            f" `{rp.get('policy', 'policy_rephrase.pkl')}` — the same BC"
            " recipe trained under the vendored rephrase store's"
            " instruction variants — against the SAME committed verifier.",
            "",
            "| cell | base policy | rephrase-augmented policy |",
            "|---|---|---|"]
        show = [("first", 1, 1), ("random", 16, 1), ("verifier", 5, 1),
                ("verifier", 16, 1), ("random", 5, 8), ("verifier", 5, 8),
                ("verifier", 16, 8), ("oracle", 16, 1)]
        for m, n, k in show:
            if rcells.get((m, n, k)) is None:
                continue
            tag = f"{m} N={n}" + (f" ×K={k}" if k > 1 else "")
            lines.append(f"| {tag} | {fmt(cells.get((m, n, k)))} "
                         f"| {fmt(rcells.get((m, n, k)))} |")
        rsw = rp.get("instruction_switch_K8")
        if rsw:
            lines += ["", f"Instruction-switch rate at K=8 under the"
                          f" rephrase policy: {rsw['episodes_with_switch']}"
                          f"/{rsw['episodes']} episodes"
                          f" ({100 * rsw['switch_rate']:.0f}%)."]

    # OOD appearance variants (the reference's OOD table shape)
    ood = {(c["task"], c["mode"], c["n_samples"]): c
           for c in res.get("ood_grid", [])}
    if ood:
        ood_tasks = sorted({t for t, _, _ in ood})
        tiers = [
            ("unseen appearance (colors/sizes — the round-4 OOD "
             "definition)",
             [t for t in ood_tasks if t.endswith("_appearance")]),
            ("unseen geometry + clutter (novel shapes, a ring "
             "receptacle, distractor blobs — the round-5 hard axes)",
             [t for t in ood_tasks if not t.endswith("_appearance")]),
        ]
        lines += [
            "", "## OOD variants",
            "",
            "Policy, backbone, and verifier heads are trained ONLY on the"
            " ID task; these cells shift the rendered scene"
            " (`fake_env.TASK_APPEARANCES` — the cartoon of the"
            " reference's unseen-object scenes) and the instruction."]
        ood_extra = sorted({m for _, m, _ in ood}
                           - {"first", "random", "verifier", "oracle"})
        for title, tasks in tiers:
            if not tasks:
                continue
            hdr_extra = "".join(f"| {m} N=16 " for m in ood_extra)
            lines += [
                "", f"### {title}", "",
                "| task | first (pi0) | random N=16 | verifier N=16 "
                + hdr_extra + "| oracle N=16 |",
                "|---|" + "---|" * (4 + len(ood_extra))]
            for t in tasks:
                short = t.replace("widowx_", "").replace("_appearance", "")
                cols = "".join(f"| {fmt(ood.get((t, m, 16)))} "
                               for m in ood_extra)
                lines.append(
                    f"| {short} | {fmt(ood.get((t, 'first', 1)))} "
                    f"| {fmt(ood.get((t, 'random', 16)))} "
                    f"| {fmt(ood.get((t, 'verifier', 16)))} "
                    + cols
                    + f"| {fmt(ood.get((t, 'oracle', 16)))} |")

            def _avg(mode, n, _tasks=tasks):
                cs = [ood.get((t, mode, n)) for t in _tasks]
                cs = [c for c in cs if c]
                return (f"{100 * np.mean([c['success_rate'] for c in cs]):.0f}%"
                        if len(cs) == len(_tasks) else "—")
            lines.append(
                f"| **average** | {_avg('first', 1)} "
                f"| {_avg('random', 16)} | {_avg('verifier', 16)} "
                + "".join(f"| {_avg(m, 16)} " for m in ood_extra)
                + f"| {_avg('oracle', 16)} |")
        # every arm that scores below the no-selection baseline is named
        harm = []
        for t in ood_tasks:
            base = ood.get((t, "first", 1))
            for m in {m for _, m, _ in ood} - {"first", "random", "oracle"}:
                c = ood.get((t, m, 16))
                if base and c and c["success_rate"] < base["success_rate"]:
                    sep = ("non-overlapping CIs"
                           if c["ci95"][1] < base["ci95"][0]
                           else "overlapping CIs")
                    harm.append(
                        f"`{m}` on {t.replace('widowx_', '')} "
                        f"({100 * c['success_rate']:.0f}% vs baseline "
                        f"{100 * base['success_rate']:.0f}%, {sep})")
        if harm:
            lines += [
                "", "**Active harm (known negative):** " + "; ".join(harm)
                + ". A selection arm scoring below candidate-0 execution"
                " means its argmax is anti-correlated with progress on"
                " that appearance — worse than not verifying at all. These"
                " cells are kept in `results.json` as an honest record;"
                " the arm is NOT a recommended configuration, and the CI"
                " regression suite forbids this class of regression for"
                " the default `verifier` arm"
                " (`tests/test_verification_scaling.py`)."]
    # the verifier arm without the phase-aware deference gate
    nodefer = res.get("ood_ablation_nodefer")
    if nodefer and ood:
        nd = {(c["task"], c["n_samples"]): c for c in nodefer}
        any_defer = next((c for c in res.get("ood_grid", [])
                          if c["mode"] == "verifier"
                          and "defer_threshold" in c), None)
        thr = any_defer and any_defer["defer_threshold"]
        lines += [
            "", "### Ablation: verification without phase-aware deference",
            "",
            "The shipping verifier arm defers APPROACH-phase picks to"
            " candidate 0 when the scene's affinity to the checkpoint's ID"
            " calibration prototype is below the threshold"
            + (f" ({thr})" if thr is not None else "")
            + " (`CoVerConfig.defer_threshold`, engine step 7b) — a"
            " know-when-you-don't-know fallback generalising the"
            " reference's absolute-score stage-1 gate"
            " (run_simpler_eval_with_openpi.py:346-365). Without it, the"
            " verifier's approach-phase argmax on unfamiliar scenes is"
            " ANTI-correlated with progress (self-induced state drift;"
            " mean pick rank 9.2/16 on zucchini) and actively harms:", "",
            "| task | verifier N=16 (no deference) | verifier N=16 "
            "(shipping) | first (pi0) |", "|---|---|---|---|"]
        for t in sorted({t for t, _ in nd}):
            short = t.replace("widowx_", "")
            lines.append(
                f"| {short} | {fmt(nd.get((t, 16)))} "
                f"| {fmt(ood.get((t, 'verifier', 16)))} "
                f"| {fmt(ood.get((t, 'first', 1)))} |")

    # the DAgger-round curve
    rounds = res.get("dagger_rounds")
    if rounds:
        lines += [
            "", "## DAgger rounds (ranking data recollected under the "
            "deployed verifier's own selection)", "",
            "| round | data (ranked states) | val_regret | verifier N=16 "
            "| verifier N=80 |", "|---|---|---|---|---|"]
        for r in rounds:
            lines.append(
                f"| {r['round']} | {r.get('data', '—')} "
                f"| {r.get('val_regret', '—')} "
                f"| {fmt(r.get('n16'))} | {fmt(r.get('n80'))} |")

    # language sensitivity (wrong-noun rejection)
    if diag is not None:
        lang = diag.get("lang", {})
        rows = [(k, v) for k, v in lang.items() if isinstance(v, dict)
                and "noun_sensitivity" in v]
        if rows:
            lines += [
                "", "## Language sensitivity (noun grounding)", "",
                f"On {lang.get('slates', '?')} grounded domain-randomized"
                " slates (`ood_diagnostics.py lang`): selection gain over"
                " random when the verifier scores under the recorded"
                " shape-noun instruction vs the SAME slate with the object"
                " noun swapped to a different shape's noun. A positive gap"
                " means the score READS the instruction — the cartoon of"
                " the reference's wrong-instruction rejection.", "",
                "| checkpoint | gain (correct noun) | gain (wrong noun) "
                "| gain (ID instruction) | noun sensitivity |",
                "|---|---|---|---|---|"]
            for k, v in rows:
                lines.append(
                    f"| {k} | {v['grounded']['vs_random_gain']} "
                    f"| {v['wrong_noun']['vs_random_gain']} "
                    f"| {v['id_instruction']['vs_random_gain']} "
                    f"| **{v['noun_sensitivity']}** |")

    v16, r16 = cells.get(("verifier", 16, 1)), cells.get(("random", 16, 1))
    o40 = cells.get(("oracle", 40, 1))
    if v16 and r16 and v16["ci95"][0] > r16["ci95"][1]:
        lines += [
            "", "## Interpretation", "",
            "**Learned verification scaling works end-to-end.** The"
            " trained verifier — no privileged inputs at eval time —"
            " turns candidate count into success through the real engine"
            " (two-stage gate, group-mean language selection, gripper"
            " vote), beating random selection at N=16 with"
            " non-overlapping 95% CIs and degrading nowhere (the round-3"
            " from-scratch verifier was <= random everywhere and"
            " collapsed at N=40). What closed the gap, in order of"
            " impact: (1) ranking data collected THROUGH the engine's own"
            " batched propose/select programs at 25x scale (1500"
            " episodes, ~13k candidate slates) with an execution mix that"
            " reaches late-episode release states; (2) in-domain"
            " localisation pretraining of the vision tower"
            " (`pretrain_backbone` — the synthetic stand-in for the"
            " pretrained SigLIP2 the reference freezes), after which the"
            " backbone is FROZEN exactly as the reference freezes its"
            " SigLIP2 (finetune_trajectory_bridge_ddp.py:189-191);"
            " (3) fp32 head/backbone weights and patch-8 towers sized to"
            " localise the scene. The oracle arm — the same engine"
            " programs with injected privileged scores — still marks the"
            " ceiling"
            + (f" ({100 * o40['success_rate']:.0f}% at N=40)."
               if o40 else ".") + " The remaining verifier-to-oracle gap"
            " is scorer quality, attackable with more data/DAgger rounds"
            " (`rankdata --dagger-params`).",
        ]
    lines += list(extra or []) + list(reproduce)
    return "\n".join(lines) + "\n"


def report_results(results: dict, config: str, name=None) -> dict:
    """The JAX report's results dict from the port's runs of `config`: the
    run `name` for the grid and the OOD grid (and its `dagger_rounds`),
    the run `rephrase_policy` as `rephrase_policy_grid`, and, where a run
    `defer` has OOD verifier cells, those as the shipping verifier arm and
    the run `name`'s as `ood_ablation_nodefer`."""
    main = find_run(results, config, name)
    if main is None:
        raise SystemExit(f"report: no run ({config}, {name}) in the results")
    eps = [c["episodes"] for c in main["grid"]] or [0]
    res = {"task": results.get("task", TASK), "grid": main["grid"],
           "trials_per_cell": max(set(eps), key=eps.count),
           "instruction_switch_K8": main.get("instruction_switch_K8"),
           "ood_grid": main.get("ood_grid", [])}
    if main.get("dagger_rounds"):
        res["dagger_rounds"] = main["dagger_rounds"]
    rp = find_run(results, config, "rephrase_policy")
    if rp and rp["grid"]:
        res["rephrase_policy_grid"] = {
            "policy": os.path.basename(rp.get("policy_params",
                                              "policy_rephrase.pkl")),
            "cells": rp["grid"],
            "instruction_switch_K8": rp.get("instruction_switch_K8")}
    defer = find_run(results, config, "defer")
    shipping = [c for c in (defer or {}).get("ood_grid", [])
                if c["mode"] == "verifier"]
    if shipping:
        res["ood_ablation_nodefer"] = [c for c in res["ood_grid"]
                                       if c["mode"] == "verifier"]
        res["ood_grid"] = [c for c in res["ood_grid"]
                           if c["mode"] != "verifier"] + shipping
    return res


def beside_jax_lines(results: dict, config: str) -> list:
    """The report's added section: every cell of `config`'s runs that has a
    JAX cell, with the port's successes, JAX's and the two-proportion z."""
    lines = ["", "## The port beside the JAX package", "",
             f"Every cell of the port's `{config}` runs that the JAX package"
             " committed, on the card named in each run: the port's"
             " successes, JAX's, and the pooled two-proportion z (|z| >="
             " 2.58 is a difference at the 1% level).", "",
             "| run | task | cell | port | JAX | z |",
             "|---|---|---|---|---|---|"]
    for run in results["runs"]:
        if run["config"] != config:
            continue
        for c in run["grid"] + run.get("ood_grid", []):
            if c.get("jax_successes") is None:
                continue
            tag = f"{c['mode']} N={c['n_samples']}" + (
                f" ×K={c['n_rephrases']}" if c.get("n_rephrases", 1) > 1
                else "")
            lines.append(
                f"| {run.get('name') or 'default'} "
                f"| {c.get('task', TASK).replace('widowx_', '')} | {tag} "
                f"| {c['successes']}/{c['episodes']} "
                f"| {c['jax_successes']}/{c['jax_episodes']} "
                f"| {c['z_vs_jax']:+.2f} |")
    return lines


def cmd_report(args):
    """The JAX script's report of the port's results, beside JAX's cells,
    written beside the results file as `report.md` (never into docs/)."""
    res_path = results_path(args)
    with open(res_path) as f:
        results = json.load(f)
    diag = None                   # the config's section of the diagnostics
    diag_path = os.path.join(os.path.dirname(res_path), "ood_diagnostics.json")
    if os.path.exists(diag_path):
        with open(diag_path) as f:
            diag = json.load(f).get(args.config)
    md = render_report(report_results(results, args.config, args.run_name),
                       diag, REPRODUCE,
                       extra=beside_jax_lines(results, args.config))
    path = os.path.join(os.path.dirname(res_path), "report.md")
    with open(path, "w") as f:
        f.write(md)
    print(md)
    print(f"wrote {path}")
    return path


# ---------------------------------------------------------------------------
# all (scripts/verification_scaling.py:2087-2113)
# ---------------------------------------------------------------------------


def all_stages(art: str) -> list:
    """The JAX `all` pipeline's stage argv, in order. `eval` names the
    trees the stages trained (the port's `eval` defaults to the committed
    trees, the JAX script's to its artifact directory's)."""
    return [["demos"],
            ["train_policy"],
            ["rankdata"],
            ["pretrain_backbone"],
            ["train_verifier"],
            # DAgger round: ranking states recollected under the first
            # verifier's own selection, then both files
            ["rankdata", "--dagger-params",
             os.path.join(art, "verifier_params.pkl"),
             "--out", "rankdata2.npz"],
            ["train_verifier", "--data", "rankdata.npz", "rankdata2.npz"],
            ["eval", "--policy-params", "policy_params.pkl",
             "--verifier-params", "verifier_params.pkl"],
            ["report"]]


def cmd_all(args, parser):
    """Each stage re-parsed from its own argv, so that every default
    applies, with the common flags passed on."""
    art = os.path.abspath(art_dir())
    common = ["--config", args.config, "--art-dir", art]
    if args.device:
        common += ["--device", args.device]
    for argv in all_stages(art):
        stage_args = parser.parse_args(argv + common)
        stage_args.fn(stage_args)


# ---------------------------------------------------------------------------
# the command line (scripts/verification_scaling.py:1877-1995)
# ---------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default=None,
                        help="torch device (CUDA unless 'cpu' is named)")
    common.add_argument("--art-dir", default=None,
                        help="the port stages' artifact directory "
                             "(default $VS_TORCH_ART_DIR or "
                             "experiments/verification_scaling_torch/"
                             "trained)")
    common.add_argument("--config", default="eager", choices=CONFIGS,
                        help="attention config of the stage's inference: "
                             "eager, fast (K1, K2) or all_kernel (K1-K3)")

    d = sub.add_parser("demos", parents=[common])
    d.add_argument("--n-demos", type=int, default=300)
    d.add_argument("--demo-noise", type=float, default=0.008)
    d.set_defaults(fn=cmd_demos)

    p = sub.add_parser("train_policy", parents=[common])
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--policy-out", default="policy_params.pkl",
                   help="output pkl under the artifact dir")
    p.add_argument("--rephrases", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="paraphrase-augment instructions from the vendored "
                        "rephrase store")
    p.set_defaults(fn=cmd_train_policy)

    rk = sub.add_parser("rankdata", parents=[common])
    rk.add_argument("--episodes", type=int, default=1500)
    rk.add_argument("--n-candidates", type=int, default=16)
    rk.add_argument("--n-parallel", type=int, default=25)
    rk.add_argument("--noise-std", type=float, default=1.0)
    rk.add_argument("--oracle-frac", type=float, default=0.3,
                    help="prob a boundary executes the true-best candidate")
    rk.add_argument("--dagger-params", default="",
                    help="verifier pkl; its argmax drives execution with "
                         "prob --dagger-frac (DAgger round 2)")
    rk.add_argument("--dagger-frac", type=float, default=0.5)
    rk.add_argument("--policy-params", default="policy_params.pkl",
                    help="policy pkl to roll")
    rk.add_argument("--wrong-noun-frac", type=float, default=0.0,
                    help="prob of also recording a wrong-noun "
                         "counterfactual slate for approach-phase "
                         "domain-randomized states")
    rk.add_argument("--domain-rand", action="store_true",
                    help="randomize scene appearance per episode")
    rk.add_argument("--id-frac", type=float, default=0.25,
                    help="with --domain-rand: fraction of episodes on the "
                         "exact ID appearance")
    rk.add_argument("--out", default="rankdata.npz",
                    help="output npz name under the artifact dir")
    rk.set_defaults(fn=cmd_rankdata)

    pb = sub.add_parser("pretrain_backbone", parents=[common])
    pb.add_argument("--steps", type=int, default=20000)
    pb.add_argument("--batch", type=int, default=64)
    pb.add_argument("--lr", type=float, default=1e-3)
    pb.add_argument("--synthetic", type=int, default=32768,
                    help="pretrain on this many domain-randomized synthetic"
                         " frames; 0 = on the rankdata frames instead")
    pb.add_argument("--id-frac", type=float, default=0.25,
                    help="fraction of synthetic frames keeping the exact"
                         " ID appearance")
    pb.add_argument("--init-from", default="",
                    help="existing vision-tower pkl to fine-tune from")
    pb.set_defaults(fn=cmd_pretrain_backbone)

    v = sub.add_parser("train_verifier", parents=[common])
    v.add_argument("--data", nargs="*", default=["rankdata.npz"],
                   help="rankdata npz name(s), concatenated")
    v.add_argument("--steps", type=int, default=4000)
    v.add_argument("--batch", type=int, default=24)
    v.add_argument("--lr", type=float, default=1e-3)
    v.add_argument("--members", type=int, default=2)
    v.add_argument("--tau", type=float, default=1.0)
    v.add_argument("--objective", default="regression",
                   choices=["regression", "listwise"])
    v.add_argument("--min-spread", type=float, default=0.02)
    v.add_argument("--augment", action=argparse.BooleanOptionalAction,
                   default=True)
    v.add_argument("--rephrases", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="train under random instruction variants")
    v.add_argument("--cross-task-text", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="also train under the other widowx task "
                        "instructions")
    v.add_argument("--pretrained", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="init the vision tower from --pretrained-vision "
                        "when present")
    v.add_argument("--pretrained-vision", default="pretrained_vision.pkl",
                   help="the pretrained vision tower's pkl, or a verifier "
                        "pkl whose backbone's vision tower is taken")
    v.add_argument("--freeze-backbone", default="auto",
                   choices=["auto", "true", "false"],
                   help="auto = freeze iff the pretrained tower loaded")
    v.add_argument("--color-aug", action="store_true",
                   help="add the label-preserving photometric "
                        "augmentation")
    v.add_argument("--dr-phase", default="all", choices=["all", "carry"],
                   help="'carry' drops approach-phase domain-randomized "
                        "states")
    v.add_argument("--init-params", default="",
                   help="verifier pkl to warm-start from")
    v.add_argument("--out", default="verifier_params.pkl",
                   help="output pkl name under the artifact dir")
    v.set_defaults(fn=cmd_train_verifier)

    e = sub.add_parser("eval", parents=[common],
                       help="the success-rate grid on the port")
    e.add_argument("--trials", type=int, default=100)
    e.add_argument("--n-parallel", type=int, default=10)
    e.add_argument("--with-oracle", action=argparse.BooleanOptionalAction,
                   default=True)
    e.add_argument("--modes", nargs="*", default=None,
                   help="restrict to these selection modes")
    e.add_argument("--cells", nargs="*", default=None,
                   help="restrict the ID grid (and the oracle cells) to "
                        "'mode,N,K' triples, e.g. verifier,16,1")
    e.add_argument("--merge", action="store_true",
                   help="keep this run's earlier cells (a cell run again "
                        "replaces its earlier value); without it the run "
                        "starts empty")
    e.add_argument("--skip-existing", action="store_true",
                   help="with --merge: keep every existing cell of the run "
                        "and run only the missing ones")
    e.add_argument("--ood", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="also run the OOD appearance-variant cells")
    e.add_argument("--ood-tasks", nargs="*", default=None,
                   help="restrict the OOD cells to these task names")
    e.add_argument("--rescore-threshold", type=float, default=None,
                   help="override the stage-1 gate threshold (default "
                        "0.1; inf disables the gate); a knob: name the run")
    e.add_argument("--gripper-vote", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="override the verifier arm's gripper majority "
                        "vote; a knob: name the run")
    e.add_argument("--defer-threshold", type=float, default=None,
                   help="phase-aware deference threshold of the verifier "
                        "arm (CoVerConfig.defer_threshold); the verifier "
                        "tree must carry `calibrate`'s prototype; a knob: "
                        "name the run")
    e.add_argument("--results", default=None,
                   help="results file (default: beside the trees, see "
                        "above)")
    e.add_argument("--verifier-params", default=None,
                   help="verifier pkl (default: the committed JAX tree)")
    e.add_argument("--policy-params", default=None,
                   help="policy pkl (default: the committed JAX tree)")
    e.add_argument("--run-name", default=None,
                   help="name of the run in the results file (runs are "
                        "keyed by config and name)")
    e.add_argument("--record-mode", default=None,
                   help="record verifier cells under this mode name, e.g. "
                        "verifier_int8 with --quantize int8_full")
    e.add_argument("--quantize", default="none",
                   choices=["none", "int8", "int8_full"],
                   help="int8 (w8a8) policy, and verifier backbone under "
                        "int8_full, through ops/quant")
    e.set_defaults(fn=cmd_eval)

    cb = sub.add_parser("calibrate", parents=[common],
                        help="stamp the ID affinity prototype into a "
                             "verifier tree")
    cb.add_argument("--verifier-params", default="verifier_params.pkl")
    cb.add_argument("--out", default=None,
                    help="write the stamped tree here (default: the same "
                         "name in the artifact directory)")
    cb.add_argument("--frames", type=int, default=512,
                    help="ID rankdata frames for the prototype")
    cb.add_argument("--ood-tasks", nargs="*", default=None)
    cb.add_argument("--ood-envs", type=int, default=40,
                    help="episodes per OOD task for the diagnostic "
                         "affinity distribution")
    cb.set_defaults(fn=cmd_calibrate)

    dn = sub.add_parser("dagger_note", parents=[common],
                        help="record one DAgger round in a run")
    dn.add_argument("--round", type=int, required=True)
    dn.add_argument("--checkpoint", required=True,
                    help="verifier checkpoint whose .meta.json supplies "
                         "val_regret / data size")
    dn.add_argument("--mode", default="verifier",
                    help="grid mode whose N=16/N=80 cells this round "
                         "produced (e.g. verifier_dag via --record-mode)")
    dn.add_argument("--run-name", default=None)
    dn.add_argument("--results", default=None)
    dn.set_defaults(fn=cmd_dagger_note)

    r = sub.add_parser("report", parents=[common],
                       help="the markdown report beside the results")
    r.add_argument("--run-name", default=None)
    r.add_argument("--results", default=None)
    r.set_defaults(fn=cmd_report)

    a = sub.add_parser("all", parents=[common],
                       help="every stage, as the JAX script's all")
    a.set_defaults(fn=lambda args: cmd_all(args, ap))
    args = ap.parse_args(argv)
    if args.art_dir:
        os.environ["VS_TORCH_ART_DIR"] = os.path.abspath(args.art_dir)
    return args.fn(args)


if __name__ == "__main__":
    main()
