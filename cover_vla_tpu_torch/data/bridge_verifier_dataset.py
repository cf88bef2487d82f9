"""Verifier training dataset: the normalized Bridge-verifier JSON format.

The reference verifier trainer's dataset and its streaming load: a JSON
with lookup tables
  {"action_histories": {id: [[...7floats...], ...]},
   "instructions": {id: str},
   "samples": [{"image": path, "instruction_id": id,
                 "action_history_id": id}, ...]}
Images are loaded lazily per batch; histories are top-padded to
history_length with the -5.0 fill.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from cover_vla_tpu_torch.models.verifier import pad_action_histories
from cover_vla_tpu_torch.ops.image import _bicubic_matrix


def _stream_json_field(path: str, key: str, chunk_size: int = 1 << 16):
    """Incrementally parse one top-level array/object field of a large JSON
    file (the reference's ijson streaming load):
    yields array elements, or (key, value) pairs for an object field, while
    only ever holding one element plus a read buffer in memory."""
    dec = json.JSONDecoder()
    target = f'"{key}"'
    with open(path) as f:
        buf = ""
        # scan to the field's opening bracket
        start = None
        while start is None:
            chunk = f.read(chunk_size)
            if not chunk:
                raise KeyError(f"{key!r} not found in {path}")
            buf += chunk
            i = buf.find(target)
            if i >= 0:
                for j in range(i + len(target), len(buf)):
                    if buf[j] in "[{":
                        start = j
                        break
                else:
                    continue  # bracket not buffered yet
            else:
                buf = buf[-len(target):]
        is_array = buf[start] == "["
        closer = "]" if is_array else "}"
        buf = buf[start + 1:]

        def refill():
            nonlocal buf
            chunk = f.read(chunk_size)
            if not chunk:
                raise ValueError(f"truncated JSON while streaming {key!r}")
            buf += chunk

        def decode_value():
            # raw_decode succeeds on a TRUNCATED number/literal ('123' of
            # '12345' straddling a chunk boundary) — a scalar is only
            # complete when at least one delimiter char of lookahead
            # follows it, so refill-and-retry until end < len(buf)
            nonlocal buf
            buf = buf.lstrip()
            while True:
                try:
                    v, end = dec.raw_decode(buf)
                except ValueError:
                    refill()
                    buf = buf.lstrip()
                    continue
                if end == len(buf):
                    refill()   # raises at genuine EOF (truncated field)
                    continue
                return v, end

        while True:
            buf = buf.lstrip()
            while not buf:
                refill()
                buf = buf.lstrip()
            if buf[0] == closer:
                return
            if buf[0] == ",":
                buf = buf[1:]
                continue
            if not is_array:
                # parse  "key" : value
                while True:
                    try:
                        k, end = dec.raw_decode(buf)
                        break
                    except ValueError:
                        refill()
                buf = buf[end:].lstrip()
                while not buf or buf[0] != ":":
                    refill()
                    buf = buf.lstrip()
                buf = buf[1:]
                v, end = decode_value()
                buf = buf[end:]
                yield k, v
            else:
                v, end = decode_value()
                buf = buf[end:]
                yield v


class BridgeVerifierDataset:
    def __init__(self, json_path: str, image_root: Optional[str] = None,
                 history_length: int = 10, image_size: int = 384,
                 streaming: bool = False):
        if streaming:
            # one streamed pass per table: peak memory is the decoded
            # tables, never the whole file string (ijson-equivalent)
            self.action_histories = dict(
                _stream_json_field(json_path, "action_histories"))
            self.instructions = dict(
                _stream_json_field(json_path, "instructions"))
            self.samples = list(_stream_json_field(json_path, "samples"))
        else:
            with open(json_path) as f:
                raw = json.load(f)
            self.action_histories: Dict[str, List] = raw["action_histories"]
            self.instructions: Dict[str, str] = raw["instructions"]
            self.samples: List[Dict] = raw["samples"]
        self.image_root = image_root or os.path.dirname(json_path)
        self.history_length = history_length
        self.image_size = image_size

    def __len__(self) -> int:
        return len(self.samples)

    def split(self, val_fraction: float, seed: int = 0):
        """Deterministic train/val split by sample index (the reference's
        in-training validation split)."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.samples))
        n_val = max(1, int(len(order) * val_fraction))
        val_idx = set(order[:n_val].tolist())
        import copy
        train, val = copy.copy(self), copy.copy(self)
        train.samples = [s for i, s in enumerate(self.samples)
                         if i not in val_idx]
        val.samples = [s for i, s in enumerate(self.samples) if i in val_idx]
        return train, val

    def _load_image(self, rel: str) -> np.ndarray:
        path = os.path.join(self.image_root, rel)
        if rel.endswith(".npy"):
            img = np.load(path)
        else:
            from PIL import Image
            img = np.asarray(Image.open(path).convert("RGB"))
        return img

    def get(self, idx: int, tokenizer=None, context_length: int = 64) -> Dict:
        s = self.samples[idx]
        img = self._load_image(s["image"])
        hist = np.asarray(
            self.action_histories[str(s["action_history_id"])], np.float32)
        instr = self.instructions[str(s["instruction_id"])]
        out = {
            "image": img,
            "instruction": instr,
            "action_history": pad_action_histories(
                [hist], self.history_length)[0],
        }
        if tokenizer is not None:
            toks, _ = tokenizer.encode_batch([instr], context_length)
            out["text_tokens"] = toks[0]
        return out

    def batches(self, batch_size: int, tokenizer, context_length: int = 64,
                seed: int = 0, preprocess=None) -> Iterator[Dict]:
        """Shuffled epochs of collated batches ready for the verifier
        train step (images preprocessed to [-1,1] at image_size)."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.samples))
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idxs = order[start:start + batch_size]
            items = [self.get(int(i), tokenizer, context_length)
                     for i in idxs]
            images = np.stack([_default_preprocess(it["image"],
                                                   self.image_size)
                               if preprocess is None else
                               preprocess(it["image"]) for it in items])
            yield {
                "images": images,
                "text_tokens": np.stack([it["text_tokens"] for it in items]),
                "action_histories": np.stack(
                    [it["action_history"] for it in items]),
                "instructions": [it["instruction"] for it in items],
            }


def _resize_np(img: np.ndarray, h: int, w: int, matrix_fn) -> np.ndarray:
    """Separable fp32 resize of an HWC image by resampling matrices. Both
    passes contract the leading axis of a contiguous array (the width
    pass on the transposed image): the same sums in the same order as
    contracting the middle axis, ~20x faster."""
    x = img.astype(np.float32)
    if img.shape[0] != h:
        x = np.einsum("hs,swc->hwc", matrix_fn(img.shape[0], h), x)
    if img.shape[1] != w:
        xt = np.ascontiguousarray(x.transpose(1, 0, 2))
        x = np.einsum("ws,shc->whc", matrix_fn(img.shape[1], w),
                      xt).transpose(1, 0, 2)
    return x


def _default_preprocess(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 HWC -> [-1,1] float at size² (open_clip bicubic + mean/std .5)."""
    x = _resize_np(img, size, size, _bicubic_matrix)
    return ((x / 255.0) - 0.5) / 0.5


def save_normalized_dataset(path: str, samples: Sequence[Dict]) -> None:
    """Write the normalized JSON format from raw (image, instruction,
    history) triples — the converse of the loader, for dataset prep."""
    action_histories, instructions, out_samples = {}, {}, []
    instr_ids: Dict[str, str] = {}
    for i, s in enumerate(samples):
        hid = str(i)
        action_histories[hid] = np.asarray(s["action_history"]).tolist()
        instr = s["instruction"]
        if instr not in instr_ids:
            instr_ids[instr] = str(len(instr_ids))
            instructions[instr_ids[instr]] = instr
        out_samples.append({"image": s["image"],
                            "instruction_id": instr_ids[instr],
                            "action_history_id": hid})
    with open(path, "w") as f:
        json.dump({"action_histories": action_histories,
                   "instructions": instructions,
                   "samples": out_samples}, f)
