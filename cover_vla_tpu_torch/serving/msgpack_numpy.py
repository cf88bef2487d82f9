"""msgpack codec with numpy array support.

The port's own copy of the reference package's codec, wire-compatible
with it and with the policy-server-client msgpack-numpy codec: ndarrays
are encoded as dict payloads carrying dtype, shape and raw bytes; numpy
scalars pass as Python scalars. The same object packs to the same bytes
in both packages. `msgpack` is imported on first use, so the serving
package imports without it.
"""

from __future__ import annotations

from typing import Any

import numpy as np


def _encode(obj: Any):
    if isinstance(obj, np.ndarray):
        return {b"__ndarray__": True,
                b"data": obj.tobytes(),
                b"dtype": obj.dtype.str,
                b"shape": list(obj.shape)}
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _decode(obj: Any):
    if isinstance(obj, dict) and (b"__ndarray__" in obj or "__ndarray__" in obj):
        get = (lambda k: obj.get(k.encode()) if obj.get(k.encode()) is not None
               else obj.get(k))
        return np.frombuffer(get("data"), dtype=np.dtype(get("dtype"))
                             ).reshape(get("shape"))
    return obj


def packb(obj: Any) -> bytes:
    import msgpack
    return msgpack.packb(obj, default=_encode, use_bin_type=True)


def unpackb(data: bytes) -> Any:
    import msgpack
    return msgpack.unpackb(data, object_hook=_decode, raw=False,
                           strict_map_key=False)
