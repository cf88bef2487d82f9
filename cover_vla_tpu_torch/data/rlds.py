"""Streaming RLDS/TFDS shard reader (and fixture writer), numpy only.

TFDS stores one episode per TFRecord record as a `tf.train.Example` whose
ragged step fields are flattened, e.g. (bridge_dataset layout):

  steps/observation/image_0     BytesList  [T]   encoded JPEG/PNG per step
  steps/observation/state       FloatList  [T*S] flattened proprio
  steps/action                  FloatList  [T*A] flattened actions
  steps/language_instruction    BytesList  [T] or [1]

This module parses both layers without TensorFlow: the TFRecord framing
(length + masked CRC32C + payload) and the protobuf wire format of
tf.train.Example. Reading streams shard by shard, record by record, so
memory stays O(one episode). A writer for the same format serves test
fixtures and dataset export. PIL is imported only for encoded images:
raw frames (`image_format="raw"`) need none. A reader without
`RldsSpec.raw_image_hw` takes a frame that starts with no PNG or JPEG
signature and holds 3 n^2 bytes as a raw n x n RGB frame.
"""

from __future__ import annotations

import io
import math
import os
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

# --------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven, + the TFRecord mask
# --------------------------------------------------------------------------


def _make_crc32c_table() -> List[int]:
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


_CRC_TABLE = _make_crc32c_table()


def crc32c(data: bytes, crc: int = 0) -> int:
    crc ^= 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


# --------------------------------------------------------------------------
# TFRecord framing
# --------------------------------------------------------------------------


def read_tfrecords(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw record payloads from one TFRecord file.

    The 8-byte length header's CRC is always checked (cheap, catches
    framing corruption); the payload CRC only under verify_crc (pure-python
    CRC over megabytes is slow and TFDS shards are checksummed upstream).
    """
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise IOError(f"{path}: truncated record header")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if masked_crc32c(header[:8]) != len_crc:
                raise IOError(f"{path}: length CRC mismatch")
            data = f.read(length)
            crc = f.read(4)
            if len(data) < length or len(crc) < 4:
                raise IOError(f"{path}: truncated record payload")
            (data_crc,) = struct.unpack("<I", crc)
            if verify_crc and masked_crc32c(data) != data_crc:
                raise IOError(f"{path}: payload CRC mismatch")
            yield data


def write_tfrecord(f, payload: bytes) -> None:
    header = struct.pack("<Q", len(payload))
    f.write(header)
    f.write(struct.pack("<I", masked_crc32c(header)))
    f.write(payload)
    f.write(struct.pack("<I", masked_crc32c(payload)))


# --------------------------------------------------------------------------
# Minimal protobuf wire-format codec for tf.train.Example
# --------------------------------------------------------------------------
#
# message Example  { Features features = 1; }
# message Features { map<string, Feature> feature = 1; }
# message Feature  { oneof { BytesList bytes_list = 1;
#                            FloatList float_list = 2;
#                            Int64List int64_list = 3; } }
# message BytesList { repeated bytes value = 1; }
# message FloatList { repeated float value = 1 [packed]; }
# message Int64List { repeated int64 value = 1 [packed]; }


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator:
    """Yield (field_number, wire_type, value_or_span) over a message."""
    pos, n = 0, len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:      # varint
            val, pos = _read_varint(buf, pos)
            yield fnum, wtype, val
        elif wtype == 1:    # 64-bit
            yield fnum, wtype, buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:    # length-delimited
            ln, pos = _read_varint(buf, pos)
            yield fnum, wtype, buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:    # 32-bit
            yield fnum, wtype, buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")


def _parse_feature(buf: bytes):
    for fnum, wtype, val in _fields(buf):
        if fnum == 1:       # BytesList
            return [v for n, w, v in _fields(val) if n == 1]
        if fnum == 2:       # FloatList
            floats: List[np.ndarray] = []
            for n, w, v in _fields(val):
                if n != 1:
                    continue
                if w == 2:  # packed
                    floats.append(np.frombuffer(v, "<f4"))
                else:       # unpacked 32-bit
                    floats.append(np.frombuffer(v, "<f4"))
            return (np.concatenate(floats) if floats
                    else np.zeros((0,), np.float32))
        if fnum == 3:       # Int64List
            ints: List[int] = []
            for n, w, v in _fields(val):
                if n != 1:
                    continue
                if w == 2:  # packed varints
                    p = 0
                    while p < len(v):
                        x, p = _read_varint(v, p)
                        ints.append(x - (1 << 64) if x >= (1 << 63) else x)
                else:
                    ints.append(v - (1 << 64) if v >= (1 << 63) else v)
            return np.asarray(ints, np.int64)
    return None


def parse_example(payload: bytes) -> Dict[str, object]:
    """tf.train.Example bytes -> {key: list[bytes] | float32[] | int64[]}."""
    out: Dict[str, object] = {}
    for fnum, _, features_buf in _fields(payload):
        if fnum != 1:
            continue
        for n, _, entry in _fields(features_buf):
            if n != 1:
                continue
            key, feat = None, None
            for en, _, ev in _fields(entry):
                if en == 1:
                    key = ev.decode("utf-8")
                elif en == 2:
                    feat = _parse_feature(ev)
            if key is not None:
                out[key] = feat
    return out


def _encode_varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fnum: int, wtype: int) -> bytes:
    return _encode_varint(fnum << 3 | wtype)


def _len_delim(fnum: int, payload: bytes) -> bytes:
    return _tag(fnum, 2) + _encode_varint(len(payload)) + payload


def encode_example(features: Dict[str, object]) -> bytes:
    """{key: list[bytes] | float array | int array} -> tf.train.Example."""
    entries = b""
    for key, val in features.items():
        if isinstance(val, (list, tuple)) and (not val or
                                               isinstance(val[0], bytes)):
            inner = b"".join(_len_delim(1, v) for v in val)
            feat = _len_delim(1, inner)                       # bytes_list
        else:
            arr = np.asarray(val)
            if np.issubdtype(arr.dtype, np.floating):
                packed = arr.astype("<f4").ravel().tobytes()
                feat = _len_delim(2, _len_delim(1, packed))   # float_list
            else:
                packed = b"".join(
                    _encode_varint(int(x) & (1 << 64) - 1)
                    for x in arr.ravel())
                feat = _len_delim(3, _len_delim(1, packed))   # int64_list
        entry = _len_delim(1, key.encode("utf-8")) + _len_delim(2, feat)
        entries += _len_delim(1, entry)
    return _len_delim(1, entries)


# --------------------------------------------------------------------------
# RLDS episode decoding
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RldsSpec:
    """Key layout of one RLDS dataset (bridge_dataset defaults)."""
    image_key: str = "steps/observation/image_0"
    state_key: str = "steps/observation/state"
    action_key: str = "steps/action"
    instruction_key: str = "steps/language_instruction"
    # raw (unencoded) image fallback shape; None => PIL-decode JPEG/PNG
    raw_image_hw: Optional[tuple] = None


_ENCODED = (b"\x89PNG\r\n\x1a\n", b"\xff\xd8\xff")


def _raw_square_side(data: bytes) -> Optional[int]:
    """n when `data` is no PNG or JPEG and holds exactly 3 n^2 bytes."""
    if data.startswith(_ENCODED):
        return None
    n = math.isqrt(len(data) // 3)
    return n if n > 0 and 3 * n * n == len(data) else None


def _decode_image(data: bytes, spec: RldsSpec) -> np.ndarray:
    if spec.raw_image_hw is not None:
        h, w = spec.raw_image_hw
        if len(data) == h * w * 3:
            return np.frombuffer(data, np.uint8).reshape(h, w, 3)
    else:
        n = _raw_square_side(data)
        if n is not None:
            return np.frombuffer(data, np.uint8).reshape(n, n, 3)
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def decode_episode(example: Dict[str, object],
                   spec: RldsSpec = RldsSpec()) -> Dict[str, object]:
    """Flattened Example -> pipeline Trajectory (images/states/actions/task)."""
    imgs = example[spec.image_key]
    t = len(imgs)
    images = np.stack([_decode_image(d, spec) for d in imgs])
    actions = np.asarray(example[spec.action_key],
                         np.float32).reshape(t, -1)
    states = np.asarray(example[spec.state_key], np.float32).reshape(t, -1)
    instr = example.get(spec.instruction_key) or [b""]
    task = instr[0].decode("utf-8")
    return {"images": images, "states": states, "actions": actions,
            "task": task}


def shard_files(path: str) -> List[str]:
    """Expand a directory / file / tfrecord-NNNNN-of-MMMMM pattern."""
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if ".tfrecord" in f)
    return [path]


class RldsShardDataset:
    """Streaming episode iterator over RLDS TFRecord shards.

    Yields pipeline Trajectory dicts; plug into
    data.pipeline.StreamingFrameDataset for chunking, paraphrase and
    interleave. Iteration order is the shard order (shuffling happens
    downstream in interleave's shuffle buffer)."""

    def __init__(self, path: Union[str, Sequence[str]],
                 spec: RldsSpec = RldsSpec(), verify_crc: bool = False):
        self.files = (shard_files(path) if isinstance(path, str)
                      else list(path))
        if not self.files:
            raise FileNotFoundError(f"no .tfrecord shards under {path!r}")
        self.spec = spec
        self.verify_crc = verify_crc

    def __iter__(self) -> Iterator[Dict[str, object]]:
        for f in self.files:
            for payload in read_tfrecords(f, self.verify_crc):
                yield decode_episode(parse_example(payload), self.spec)

    def episodes(self, limit: Optional[int] = None) -> List[Dict]:
        out = []
        for ep in self:
            out.append(ep)
            if limit is not None and len(out) >= limit:
                break
        return out


def write_rlds_shard(path: str, episodes: Sequence[Dict[str, object]],
                     spec: RldsSpec = RldsSpec(),
                     image_format: str = "png") -> None:
    """Write pipeline Trajectories as one RLDS TFRecord shard (fixtures,
    dataset export). image_format: png | jpeg | raw."""
    if image_format != "raw":
        from PIL import Image
    with open(path, "wb") as f:
        for ep in episodes:
            imgs = []
            for frame in np.asarray(ep["images"], np.uint8):
                if image_format == "raw":
                    imgs.append(frame.tobytes())
                else:
                    buf = io.BytesIO()
                    Image.fromarray(frame).save(buf, format=image_format)
                    imgs.append(buf.getvalue())
            t = len(imgs)
            features = {
                spec.image_key: imgs,
                spec.state_key: np.asarray(ep["states"], np.float32),
                spec.action_key: np.asarray(ep["actions"], np.float32),
                spec.instruction_key:
                    [str(ep.get("task", "")).encode("utf-8")] * t,
            }
            write_tfrecord(f, encode_example(features))
