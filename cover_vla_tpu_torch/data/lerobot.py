"""LeRobotDataset v2.x reader/writer (numpy-first, no torch/hf-datasets).

Implements the on-disk dataset format of the reference's LeRobot stack
(lerobot_custom/lerobot/common/datasets/lerobot_dataset.py — SURVEY §2.4
"Dataset stack") in numpy: metadata + parquet + mp4 parsed into plain
numpy dicts that feed the host-side input pipeline (`data/pipeline.py`),
with no torch tensors or hf `datasets` dependency on the hot path. The
JAX package's reader, copied: pyarrow and cv2 are imported inside the
functions that need them.

Format contract (utils.py:55-57, 446-450):
    meta/info.json            codebase_version, fps, features, path
                              templates, chunks_size
    meta/tasks.jsonl          {"task_index": i, "task": str}
    meta/episodes.jsonl       {"episode_index": i, "tasks": [...],
                              "length": n}
    meta/stats.json (v2.0) or meta/episodes_stats.jsonl (v2.1)
    data/chunk-XXX/episode_XXXXXX.parquet      per-episode frame table
    videos/chunk-XXX/<video_key>/episode_XXXXXX.mp4

Behaviour parity (lerobot_dataset.py):
    * `delta_timestamps` -> `delta_indices` = round(d*fps) after the
      multiples-of-1/fps check (utils.py:542-577);
    * window indices clamped to the episode range with `{key}_is_pad`
      marking out-of-episode steps (lerobot_dataset.py:665-678);
    * video frames fetched by timestamp within `tolerance_s`
      (lerobot_dataset.py:695-715); image features may also be embedded
      PNG bytes in the parquet ({"bytes": ...}, the image-writer format);
    * items carry the resolved `task` string (lerobot_dataset.py:749-751).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np

DEFAULT_PARQUET_PATH = \
    "data/chunk-{episode_chunk:03d}/episode_{episode_index:06d}.parquet"
DEFAULT_VIDEO_PATH = ("videos/chunk-{episode_chunk:03d}/{video_key}/"
                      "episode_{episode_index:06d}.mp4")
DEFAULT_CHUNK_SIZE = 1000


def _read_jsonl(path: str) -> List[Dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def check_delta_timestamps(delta_timestamps: Dict[str, List[float]],
                           fps: float, tolerance_s: float) -> None:
    """Every delta must be a multiple of 1/fps within tolerance
    (utils.py:542-567) — otherwise the shifted timestamps would not land
    on dataset frames."""
    for key, deltas in delta_timestamps.items():
        bad = [d for d in deltas
               if abs(d * fps - round(d * fps)) / fps > tolerance_s]
        if bad:
            raise ValueError(
                f"delta_timestamps[{key!r}] not multiples of 1/{fps}: {bad}")


def get_delta_indices(delta_timestamps: Dict[str, List[float]],
                      fps: float) -> Dict[str, List[int]]:
    return {k: [round(d * fps) for d in deltas]
            for k, deltas in delta_timestamps.items()}


def decode_video_frames(path: str, timestamps: Sequence[float],
                        tolerance_s: float, fps: float) -> np.ndarray:
    """Fetch frames nearest the query timestamps from an mp4 via cv2
    (the torchcodec/pyav role of video_utils.decode_video_frames).
    Returns uint8 RGB [len(timestamps), H, W, 3]."""
    import cv2
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    want = sorted(range(len(timestamps)), key=lambda i: timestamps[i])
    out: Dict[int, np.ndarray] = {}
    idx = 0
    wi = 0
    ok, frame = cap.read()
    while ok and wi < len(want):
        ts = idx / fps
        target = timestamps[want[wi]]
        if abs(ts - target) <= 1.0 / fps / 2 + tolerance_s:
            out[want[wi]] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            wi += 1
            continue  # same frame may satisfy the next (clamped) query
        ok, frame = cap.read()
        idx += 1
    cap.release()
    if wi < len(want):
        missing = [timestamps[i] for i in want[wi:]]
        raise ValueError(f"timestamps {missing} not found in {path} "
                         f"(tolerance {tolerance_s})")
    return np.stack([out[i] for i in range(len(timestamps))])


@dataclass
class LeRobotMeta:
    """Parsed meta/ directory (LeRobotDatasetMetadata role)."""
    root: str
    info: Dict[str, Any]
    tasks: Dict[int, str]
    episodes: List[Dict]
    stats: Optional[Dict] = None

    @classmethod
    def load(cls, root: str) -> "LeRobotMeta":
        with open(os.path.join(root, "meta", "info.json")) as f:
            info = json.load(f)
        tasks = {t["task_index"]: t["task"]
                 for t in _read_jsonl(os.path.join(root, "meta",
                                                   "tasks.jsonl"))}
        episodes = _read_jsonl(os.path.join(root, "meta", "episodes.jsonl"))
        stats = None
        spath = os.path.join(root, "meta", "stats.json")
        if os.path.exists(spath):
            with open(spath) as f:
                stats = json.load(f)
        return cls(root, info, tasks, episodes, stats)

    @property
    def fps(self) -> float:
        return float(self.info["fps"])

    @property
    def features(self) -> Dict[str, Dict]:
        return self.info["features"]

    @property
    def video_keys(self) -> List[str]:
        return [k for k, v in self.features.items()
                if v["dtype"] == "video"]

    @property
    def image_keys(self) -> List[str]:
        return [k for k, v in self.features.items()
                if v["dtype"] == "image"]

    @property
    def camera_keys(self) -> List[str]:
        return self.video_keys + self.image_keys

    def episode_chunk(self, ep: int) -> int:
        return ep // int(self.info.get("chunks_size", DEFAULT_CHUNK_SIZE))

    def parquet_path(self, ep: int) -> str:
        tmpl = self.info.get("data_path", DEFAULT_PARQUET_PATH)
        return os.path.join(self.root, tmpl.format(
            episode_chunk=self.episode_chunk(ep), episode_index=ep))

    def video_path(self, ep: int, video_key: str) -> str:
        tmpl = self.info.get("video_path") or DEFAULT_VIDEO_PATH
        return os.path.join(self.root, tmpl.format(
            episode_chunk=self.episode_chunk(ep), episode_index=ep,
            video_key=video_key))


class LeRobotDataset:
    """Frame-level random access with delta_timestamps windows
    (lerobot_dataset.py:360-760), returning numpy arrays.

    Items: every non-video feature column; camera keys as uint8
    [h, w, 3] (or [n_deltas, h, w, 3] when windowed); `{key}_is_pad`
    bool masks for windowed keys; `task` resolved to the instruction
    string."""

    def __init__(self, root: str,
                 episodes: Optional[Sequence[int]] = None,
                 delta_timestamps: Optional[Dict[str, List[float]]] = None,
                 tolerance_s: float = 1e-4):
        self.meta = LeRobotMeta.load(root)
        self.tolerance_s = tolerance_s
        all_eps = [e["episode_index"] for e in self.meta.episodes]
        self.episode_ids = list(episodes) if episodes is not None else all_eps
        lengths = {e["episode_index"]: e["length"]
                   for e in self.meta.episodes}
        starts = np.cumsum([0] + [lengths[e] for e in self.episode_ids])
        # episode_data_index over the SELECTED episodes (from/to frames)
        self.episode_data_index = {"from": starts[:-1], "to": starts[1:]}
        self.num_frames = int(starts[-1])
        self.delta_indices = None
        if delta_timestamps:
            check_delta_timestamps(delta_timestamps, self.meta.fps,
                                   tolerance_s)
            self.delta_indices = get_delta_indices(delta_timestamps,
                                                   self.meta.fps)
        self._tables: Dict[int, Dict[str, np.ndarray]] = {}

    def __len__(self) -> int:
        return self.num_frames

    # -- parquet --------------------------------------------------------

    def _table(self, ep: int) -> Dict[str, np.ndarray]:
        """Per-episode column cache: parquet -> {col: np.ndarray}."""
        if ep not in self._tables:
            import pyarrow.parquet as pq
            tab = pq.read_table(self.meta.parquet_path(ep))
            cols: Dict[str, Any] = {}
            for name in tab.column_names:
                arr = tab.column(name).to_pylist()
                if arr and isinstance(arr[0], dict):  # embedded PNG bytes
                    cols[name] = arr
                else:
                    cols[name] = np.asarray(arr)
            self._tables[ep] = cols
        return self._tables[ep]

    @staticmethod
    def _decode_image(cell) -> np.ndarray:
        import cv2
        buf = np.frombuffer(cell["bytes"], np.uint8)
        return cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB)

    # -- item assembly --------------------------------------------------

    def _locate(self, idx: int) -> tuple:
        ep_pos = int(np.searchsorted(self.episode_data_index["to"], idx,
                                     side="right"))
        ep = self.episode_ids[ep_pos]
        local = idx - int(self.episode_data_index["from"][ep_pos])
        return ep_pos, ep, local

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        if not 0 <= idx < self.num_frames:
            raise IndexError(idx)
        ep_pos, ep, local = self._locate(idx)
        cols = self._table(ep)
        n = len(cols["timestamp"])
        item: Dict[str, Any] = {}

        def window(key):
            """Clamped window + pad mask (lerobot_dataset.py:665-678)."""
            deltas = self.delta_indices[key]
            q = [max(0, min(n - 1, local + d)) for d in deltas]
            pad = np.array([(local + d < 0) or (local + d >= n)
                            for d in deltas])
            return q, pad

        for key, feat in self.meta.features.items():
            if feat["dtype"] == "video":
                continue
            windowed = self.delta_indices and key in self.delta_indices
            q = window(key)[0] if windowed else [local]
            if feat["dtype"] == "image":
                vals = np.stack([self._decode_image(cols[key][i])
                                 for i in q])
            else:
                vals = np.asarray(cols[key])[q]
            item[key] = vals if windowed else vals[0]
            if windowed:
                item[f"{key}_is_pad"] = window(key)[1]

        for key in self.meta.video_keys:
            windowed = self.delta_indices and key in self.delta_indices
            q = window(key)[0] if windowed else [local]
            ts = [float(cols["timestamp"][i]) for i in q]
            frames = decode_video_frames(self.meta.video_path(ep, key), ts,
                                         self.tolerance_s, self.meta.fps)
            item[key] = frames if windowed else frames[0]
            if windowed:
                item[f"{key}_is_pad"] = window(key)[1]

        item["task"] = self.meta.tasks[int(cols["task_index"][local])]
        return item

    # -- pipeline bridge ------------------------------------------------

    def trajectories(self, image_key: Optional[str] = None,
                     state_key: str = "observation.state",
                     action_key: str = "action") -> Iterator[Dict]:
        """Yield episodes as `data/pipeline.py` Trajectory dicts (images
        [T,H,W,3]u8 / states / actions / task) — the bridge into
        `StreamingFrameDataset` + `make_pi0_batch`. Re-iterable source."""
        image_key = image_key or self.meta.camera_keys[0]
        for ep in self.episode_ids:
            cols = self._table(ep)
            n = len(cols["timestamp"])
            if image_key in self.meta.video_keys:
                ts = [float(t) for t in cols["timestamp"]]
                images = decode_video_frames(
                    self.meta.video_path(ep, image_key), ts,
                    self.tolerance_s, self.meta.fps)
            else:
                images = np.stack([self._decode_image(c)
                                   for c in cols[image_key]])
            yield {
                "images": images,
                "states": np.asarray(cols[state_key], np.float32),
                "actions": np.asarray(cols[action_key], np.float32),
                "task": self.meta.tasks[int(cols["task_index"][0])],
            }

    def __iter__(self):
        return self.trajectories()


# -------------------------------------------------------------------------
# Writer (dataset creation — the image_writer/create() role, minimal)
# -------------------------------------------------------------------------


@dataclass
class LeRobotWriter:
    """Create a v2.1-layout dataset episode by episode. Camera features
    are written as mp4 (cv2.VideoWriter) when `use_videos`, else as
    embedded PNG bytes in the parquet."""
    root: str
    fps: float
    features: Dict[str, Dict]        # name -> {dtype, shape, names}
    robot_type: str = "widowx"
    use_videos: bool = True
    _tasks: Dict[str, int] = field(default_factory=dict)
    _episodes: List[Dict] = field(default_factory=list)
    _frames: int = 0

    def add_episode(self, frames: Dict[str, np.ndarray], task: str) -> int:
        """frames: feature name -> [T, ...] arrays (camera keys uint8
        RGB [T,H,W,3])."""
        import pyarrow as pa
        import pyarrow.parquet as pq
        ep = len(self._episodes)
        task_idx = self._tasks.setdefault(task, len(self._tasks))
        n = len(next(iter(frames.values())))
        chunk = ep // DEFAULT_CHUNK_SIZE

        cols: Dict[str, Any] = {}
        for key, feat in self.features.items():
            if feat["dtype"] == "video":
                self._write_video(key, ep, chunk, frames[key])
            elif feat["dtype"] == "image":
                import cv2
                cols[key] = [
                    {"bytes": cv2.imencode(
                        ".png", cv2.cvtColor(f, cv2.COLOR_RGB2BGR)
                    )[1].tobytes(), "path": None}
                    for f in frames[key]]
            else:
                cols[key] = [np.asarray(v).tolist() for v in frames[key]]
        cols["timestamp"] = (np.arange(n) / self.fps).tolist()
        cols["frame_index"] = np.arange(n).tolist()
        cols["episode_index"] = [ep] * n
        cols["index"] = (self._frames + np.arange(n)).tolist()
        cols["task_index"] = [task_idx] * n

        path = os.path.join(self.root, DEFAULT_PARQUET_PATH.format(
            episode_chunk=chunk, episode_index=ep))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        pq.write_table(pa.table(cols), path)
        self._episodes.append({"episode_index": ep, "tasks": [task],
                               "length": n})
        self._frames += n
        return ep

    def _write_video(self, key: str, ep: int, chunk: int,
                     frames: np.ndarray) -> None:
        import cv2
        path = os.path.join(self.root, DEFAULT_VIDEO_PATH.format(
            episode_chunk=chunk, episode_index=ep, video_key=key))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        h, w = frames.shape[1:3]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                             self.fps, (w, h))
        if not vw.isOpened():
            raise RuntimeError("cv2.VideoWriter cannot encode mp4 here; "
                               "use use_videos=False (PNG-bytes images)")
        for f in frames:
            vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        vw.release()

    def finalize(self, stats: Optional[Dict] = None) -> str:
        meta_dir = os.path.join(self.root, "meta")
        os.makedirs(meta_dir, exist_ok=True)
        n_video = sum(1 for f in self.features.values()
                      if f["dtype"] == "video")
        info = {
            "codebase_version": "v2.1",
            "robot_type": self.robot_type,
            "fps": self.fps,
            "total_episodes": len(self._episodes),
            "total_frames": self._frames,
            "total_tasks": len(self._tasks),
            "total_videos": n_video * len(self._episodes),
            "chunks_size": DEFAULT_CHUNK_SIZE,
            "total_chunks": max(1, -(-len(self._episodes)
                                     // DEFAULT_CHUNK_SIZE)),
            "data_path": DEFAULT_PARQUET_PATH,
            "video_path": DEFAULT_VIDEO_PATH if n_video else None,
            "splits": {"train": f"0:{len(self._episodes)}"},
            "features": self.features,
        }
        with open(os.path.join(meta_dir, "info.json"), "w") as f:
            json.dump(info, f, indent=2)
        with open(os.path.join(meta_dir, "tasks.jsonl"), "w") as f:
            for task, i in sorted(self._tasks.items(), key=lambda kv: kv[1]):
                f.write(json.dumps({"task_index": i, "task": task}) + "\n")
        with open(os.path.join(meta_dir, "episodes.jsonl"), "w") as f:
            for e in self._episodes:
                f.write(json.dumps(e) + "\n")
        if stats is not None:
            with open(os.path.join(meta_dir, "stats.json"), "w") as f:
                json.dump(stats, f)
        return self.root
