"""Trajectory data pipeline: chunking, padding, interleaving, statistics,
paraphrase augmentation.

Reimplements the *semantics* of the reference's Octo-lineage tf.data RLDS
pipeline (INT-ACT/src/data/: rlds_dataset.py apply_trajectory_transforms,
traj_transforms.py chunking + pad masks, utils/data_utils.py stats +
normalisation, utils/task_augmentation.py paraphrase table) without a
TensorFlow dependency: trajectories are numpy dicts; chunking/shuffling/
interleaving are deterministic seeded generators feeding the train step.
A numpy-only module: batches are byte-equal to the JAX package's.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from cover_vla_tpu_torch.data.stats import normalize_bound, normalize_gaussian


Trajectory = Dict[str, np.ndarray]  # keys: images [T,H,W,3]u8, states [T,S],
#                                            actions [T,A], task (str)


def chunk_trajectory(traj: Trajectory, chunk_size: int) -> Dict[str, np.ndarray]:
    """Per-frame action chunks with pad masks (traj_transforms.chunk_act_obs
    semantics): actions[t] -> actions[t : t+chunk]; steps past the episode
    end repeat the final action and are marked in `action_is_pad`."""
    actions = np.asarray(traj["actions"])
    t, a = actions.shape
    idx = np.arange(t)[:, None] + np.arange(chunk_size)[None, :]
    pad = idx >= t
    idx = np.minimum(idx, t - 1)
    return {
        "images": traj["images"],
        "states": traj["states"],
        "actions": actions[idx],              # [T, chunk, A]
        "action_is_pad": pad,                 # [T, chunk]
        "task": traj.get("task", ""),
    }


def subsample(frames: Dict[str, np.ndarray], length: int,
              rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Random frame subsampling (traj_transforms.subsample)."""
    t = len(frames["images"])
    if t <= length:
        return frames
    keep = np.sort(rng.choice(t, size=length, replace=False))
    out = {k: (v[keep] if isinstance(v, np.ndarray) and len(v) == t else v)
           for k, v in frames.items()}
    return out


@dataclass
class ParaphraseAugment:
    """Hash-table paraphrase substitution
    (utils/task_augmentation.py:27-80): with probability `prob`, replace the
    instruction by a uniformly sampled rephrase."""
    table: Dict[str, List[str]]
    prob: float = 0.5

    def __call__(self, task: str, rng: np.random.Generator) -> str:
        reph = self.table.get(task)
        if reph and rng.random() < self.prob:
            return reph[rng.integers(len(reph))]
        return task


def _traj_frames(traj: Trajectory, chunk_size: int, rng,
                 paraphrase: Optional[ParaphraseAugment],
                 subsample_length: Optional[int],
                 skip_unlabeled: bool) -> Iterator[Dict]:
    task = traj.get("task", "")
    if skip_unlabeled and not task:
        return
    chunked = chunk_trajectory(traj, chunk_size)
    if subsample_length:
        chunked = subsample(chunked, subsample_length, rng)
    n = len(chunked["images"])
    for t in range(n):
        out_task = task
        if paraphrase is not None:
            out_task = paraphrase(task, rng)
        yield {
            "image": chunked["images"][t],
            "state": chunked["states"][t],
            "actions": chunked["actions"][t],
            "action_is_pad": chunked["action_is_pad"][t],
            "task": out_task,
        }


@dataclass
class FrameDataset:
    """Chunked frames of one in-memory dataset (episode-order shuffled)."""
    trajectories: List[Trajectory]
    chunk_size: int = 4
    paraphrase: Optional[ParaphraseAugment] = None
    subsample_length: Optional[int] = None
    skip_unlabeled: bool = False

    def frames(self, seed: int = 0) -> Iterator[Dict]:
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.trajectories))
        for ti in order:
            yield from _traj_frames(
                self.trajectories[ti], self.chunk_size, rng,
                self.paraphrase, self.subsample_length, self.skip_unlabeled)


@dataclass
class StreamingFrameDataset:
    """Chunked frames over a re-iterable episode SOURCE (e.g. an
    rlds.RldsShardDataset): memory stays O(one episode) for arbitrarily
    large datasets. Episodes stream in shard order; frame-level mixing
    happens downstream in `interleave`'s shuffle buffer (the
    rlds_dataset.py shuffle_buffer role)."""
    source: object  # any re-iterable of Trajectory dicts
    chunk_size: int = 4
    paraphrase: Optional[ParaphraseAugment] = None
    subsample_length: Optional[int] = None
    skip_unlabeled: bool = False

    def frames(self, seed: int = 0) -> Iterator[Dict]:
        rng = np.random.default_rng(seed)
        for traj in self.source:
            yield from _traj_frames(
                traj, self.chunk_size, rng, self.paraphrase,
                self.subsample_length, self.skip_unlabeled)


def interleave(datasets: Sequence[FrameDataset],
               weights: Optional[Sequence[float]] = None,
               shuffle_buffer: int = 1000, seed: int = 0) -> Iterator[Dict]:
    """Weighted interleave + shuffle buffer
    (make_interleaved_dataset semantics, finite epochs)."""
    rng = np.random.default_rng(seed)
    iters = [d.frames(seed=seed + i) for i, d in enumerate(datasets)]
    w = np.asarray(weights if weights is not None
                   else [1.0] * len(datasets), np.float64)
    w = w / w.sum()
    buf: List[Dict] = []
    alive = list(range(len(iters)))
    while alive:
        probs = w[alive] / w[alive].sum()
        i = rng.choice(alive, p=probs)
        try:
            buf.append(next(iters[i]))
        except StopIteration:
            alive.remove(i)
            continue
        if len(buf) >= shuffle_buffer:
            j = rng.integers(len(buf))
            buf[j], buf[-1] = buf[-1], buf[j]
            yield buf.pop()
    rng.shuffle(buf)
    yield from buf


def batcher(frames: Iterator[Dict], batch_size: int) -> Iterator[Dict]:
    batch: List[Dict] = []
    for f in frames:
        batch.append(f)
        if len(batch) == batch_size:
            yield _collate(batch)
            batch = []


def _collate(batch: List[Dict]) -> Dict:
    out = {}
    for k in batch[0]:
        vals = [b[k] for b in batch]
        out[k] = vals if isinstance(vals[0], str) else np.stack(vals)
    return out


# --------------------------------------------------------------------------
# statistics (utils/data_utils.py compute + save)
# --------------------------------------------------------------------------


def compute_statistics(trajectories: Sequence[Trajectory]) -> Dict:
    """Dataset statistics in the bridge_statistics.json schema."""
    actions = np.concatenate([np.asarray(t["actions"]) for t in trajectories])
    proprio = np.concatenate([np.asarray(t["states"]) for t in trajectories])

    def field_stats(x):
        return {
            "mean": x.mean(0).tolist(), "std": x.std(0).tolist(),
            "max": x.max(0).tolist(), "min": x.min(0).tolist(),
            "p99": np.percentile(x, 99, axis=0).tolist(),
            "p01": np.percentile(x, 1, axis=0).tolist(),
        }

    return {
        "action": field_stats(actions),
        "proprio": field_stats(proprio),
        "num_transitions": int(len(actions)),
        "num_trajectories": int(len(trajectories)),
    }


def save_statistics(stats: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(stats, f, indent=2)


# --------------------------------------------------------------------------
# pi0 batch assembly
# --------------------------------------------------------------------------


def make_pi0_batch(frames: Dict, tokenizer, cfg, stats=None,
                   state_norm: str = "bound") -> Dict[str, np.ndarray]:
    """Collated frames -> the train_pi0.loss_fn batch format: images to
    [-1,1] (trainer.py:385-425 preprocess_batch), state/action
    normalisation per the dataset statistics (IDENTITY if stats is None,
    matching the CoVer bridge config), tokenized tasks, zero-padding to the
    32-dim state/action layout."""
    images = frames["image"].astype(np.float32) / 255.0 * 2.0 - 1.0
    if images.ndim == 4:
        images = images[:, None]  # single camera

    state = np.asarray(frames["state"], np.float32)
    actions = np.asarray(frames["actions"], np.float32)
    if stats is not None:
        if state_norm == "bound":
            state = normalize_bound(state, stats.proprio.p01,
                                    stats.proprio.p99).astype(np.float32)
            actions = np.concatenate([
                normalize_bound(actions[..., :-1], stats.action.p01[:-1],
                                stats.action.p99[:-1]),
                actions[..., -1:]], axis=-1).astype(np.float32)
        else:
            state = normalize_gaussian(state, stats.proprio.mean,
                                       stats.proprio.std).astype(np.float32)

    b = len(state)
    state_pad = np.zeros((b, cfg.max_state_dim), np.float32)
    state_pad[:, :state.shape[1]] = state
    act_pad = np.zeros((b, actions.shape[1], cfg.max_action_dim), np.float32)
    act_pad[..., :actions.shape[2]] = actions

    tokens, masks = tokenizer.encode_batch(frames["task"],
                                           cfg.tokenizer_max_length)
    return {
        "images": images,
        "img_masks": np.ones((b, images.shape[1]), bool),
        "lang_tokens": tokens,
        "lang_masks": masks,
        "state": state_pad,
        "actions": act_pad,
        "actions_is_pad": frames["action_is_pad"],
    }


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch: overlaps host-side decode/collation with
    device steps (the tf.data prefetch counterpart; the pure-Python reader
    decodes ~900 frames/s single-threaded, ~30x the full-size trainer's
    consumption rate, so depth=2 fully hides the input pipeline)."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(_END)
        except BaseException as e:  # surface errors in the consumer thread
            q.put(e)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _END:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
