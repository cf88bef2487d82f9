"""Websocket policy server/client (process-split serving).

The reference RPC surface: msgpack-numpy frames; a metadata handshake on
connect; verbs `infer` / `reset` / `switch_model`; on an internal error
the server sends a traceback frame and closes. The client retries until
the server is up. Frames are byte-compatible with the reference package's
server and client, so either side may be the other package.

The policy process holds the GPU; the env/eval process talks to it over
the socket. `websockets` and `msgpack` are imported inside the transport
only: `WebsocketPolicyServer.dispatch`, the verb dispatch, runs without
either.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time
import traceback
from typing import Any, Dict, Optional, Protocol

from cover_vla_tpu_torch.serving import msgpack_numpy as mpn

logger = logging.getLogger(__name__)


class BasePolicy(Protocol):
    def infer(self, obs: Dict[str, Any]) -> Dict[str, Any]: ...
    def reset(self) -> None: ...
    def switch_model(self, path: str) -> None: ...


class WebsocketPolicyServer:
    """Serve a policy over a websocket (one request -> one response)."""

    def __init__(self, policy: BasePolicy, host: str = "0.0.0.0",
                 port: int = 8000, metadata: Optional[Dict] = None):
        self.policy = policy
        self.host = host
        self.port = port
        self.metadata = metadata or {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._done: Optional[asyncio.Future] = None
        self._thread: Optional[threading.Thread] = None

    def dispatch(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """One decoded request -> its response: the verb dispatch."""
        verb = req.get("type", "infer")
        if verb == "reset":
            self.policy.reset()
            return {"status": "ok"}
        if verb == "switch_model":
            self.policy.switch_model(req.get("path", ""))
            return {"status": "ok"}
        return self.policy.infer(req.get("obs", req))

    async def _handler(self, websocket):
        await websocket.send(mpn.packb(self.metadata))
        async for message in websocket:
            try:
                await websocket.send(mpn.packb(self.dispatch(
                    mpn.unpackb(message))))
            except Exception:
                # the connection's boundary: a traceback frame, then close
                await websocket.send(mpn.packb(
                    {"error": traceback.format_exc()}))
                await websocket.close()
                return

    async def _serve(self, ready: threading.Event):
        import websockets.asyncio.server as ws_server
        async with ws_server.serve(self._handler, self.host, self.port,
                                   max_size=None):
            self._loop = asyncio.get_running_loop()
            self._done = self._loop.create_future()
            ready.set()
            await self._done

    def serve_forever(self):
        asyncio.run(self._serve(threading.Event()))

    def serve_in_thread(self) -> threading.Thread:
        ready = threading.Event()
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self._serve(ready)), daemon=True)
        self._thread.start()
        if not ready.wait(timeout=10):
            raise RuntimeError(f"server on {self.host}:{self.port} did not "
                               "start within 10 s")
        return self._thread

    def stop(self, timeout: float = 10.0) -> None:
        """End a server started by `serve_in_thread` and join its thread."""
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._done.set_result, None)
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise RuntimeError("server thread did not stop")


class WebsocketPolicyClient:
    """Blocking client; retries until the server is reachable."""

    def __init__(self, host: str = "localhost", port: int = 8000,
                 retry_interval_s: float = 5.0, max_retries: int = 60):
        self.uri = f"ws://{host}:{port}"
        self.retry_interval_s = retry_interval_s
        self.max_retries = max_retries
        self._conn = None
        self._loop = asyncio.new_event_loop()
        self.metadata = self._connect()

    def _connect(self):
        import websockets.asyncio.client as ws_client
        for _ in range(self.max_retries):
            try:
                self._conn = self._loop.run_until_complete(
                    ws_client.connect(self.uri, max_size=None))
                return mpn.unpackb(self._loop.run_until_complete(
                    self._conn.recv()))
            except OSError:       # ConnectionRefusedError among them
                logger.info("server not up, retrying in %.1fs",
                            self.retry_interval_s)
                time.sleep(self.retry_interval_s)
        raise ConnectionError(f"could not reach {self.uri}")

    def _call(self, payload: Dict) -> Dict:
        self._loop.run_until_complete(self._conn.send(mpn.packb(payload)))
        resp = mpn.unpackb(self._loop.run_until_complete(self._conn.recv()))
        if isinstance(resp, dict) and "error" in resp:
            raise RuntimeError(f"server error:\n{resp['error']}")
        return resp

    def infer(self, obs: Dict) -> Dict:
        return self._call({"type": "infer", "obs": obs})

    def reset(self) -> None:
        self._call({"type": "reset"})

    def switch_model(self, path: str) -> None:
        self._call({"type": "switch_model", "path": path})

    def close(self):
        if self._conn is not None:
            self._loop.run_until_complete(self._conn.close())
        self._loop.close()
