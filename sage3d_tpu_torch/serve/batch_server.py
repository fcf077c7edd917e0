"""Micro-batching policy server: concurrent clients, one batched device call.

PyTorch counterpart of ``sage3d_tpu/serve/batch_server.py``. The reference's
servers handle ONE client at a time on a blocking accept loop
(mllm_server.py:416-469) — fine for a single evaluation env, not for serving
a fleet. This server accepts many connections concurrently and BATCHES their
requests through one call of the policy: requests that arrive within
``max_wait_s`` (or up to ``max_batch``) ride the same device launches, so
per-call fixed costs (host dispatch, copies, small-op overhead) amortize
across clients.

The JAX module pads every batch to ``max_batch`` so that it compiles once;
eager PyTorch compiles nothing, so ``from_torch_policy`` runs each batch at
its own size. Each request's answer is the same either way.

Wire protocol unchanged (8-byte BE length + JSON, base64 JPEG frames): every
client of the reference servers (serve/client.py == ModularVLMClient) works
against this server as-is.
"""

from __future__ import annotations

import queue
import socket
import threading
import time
from typing import Callable, List, Optional

import numpy as np

from .protocol import decode_image_b64, recv_framed, send_framed


class _Pending:
    __slots__ = ("frames", "instruction", "event", "reply")

    def __init__(self, frames, instruction):
        self.frames = frames
        self.instruction = instruction
        self.event = threading.Event()
        self.reply: Optional[str] = None


class BatchPolicyServer:
    """Serve ``batch_fn`` — (B, T, H, W, 3) float32 -> list of B action
    strings — with micro-batching across concurrent socket clients.

    ``batch_fn`` is typically a batched policy + argmax decode;
    `from_torch_policy` builds one from serve/torch_policy.py parts. Single
    requests are NOT delayed when the queue is empty beyond ``max_wait_s``.
    """

    def __init__(self, batch_fn: Callable[[np.ndarray], List[str]],
                 height: int, width: int, frames: int,
                 host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 8, max_wait_s: float = 0.01,
                 verbose: bool = False):
        self.batch_fn = batch_fn
        self.height = height
        self.width = width
        self.frames = frames
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.verbose = verbose
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        self._threads: List[threading.Thread] = []
        self.stats = {"requests": 0, "batches": 0, "max_batch_seen": 0}
        self._stats_lock = threading.Lock()   # handlers count concurrently

    # -- frame prep (shared contract: serve/torch_policy.prep_frames) -------
    def _prep(self, images: List) -> np.ndarray:
        from .torch_policy import prep_frames
        return prep_frames(images, self.height, self.width, self.frames)

    # -- batcher ------------------------------------------------------------
    def _batcher(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.time() + self.max_wait_s
            while len(batch) < self.max_batch:
                remain = deadline - time.time()
                if remain <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remain))
                except queue.Empty:
                    break
            stacked = np.stack([p.frames for p in batch])
            try:
                actions = self.batch_fn(stacked)
            except Exception as e:                     # noqa: BLE001
                actions = ["MOVE_FORWARD"] * len(batch)
                if self.verbose:
                    print(f"[BATCH_SERVER] batch_fn failed: {e}")
            self.stats["batches"] += 1
            self.stats["max_batch_seen"] = max(self.stats["max_batch_seen"],
                                               len(batch))
            for p, a in zip(batch, actions):
                p.reply = a
                p.event.set()

    # -- per-connection handler --------------------------------------------
    def _handle(self, conn: socket.socket) -> None:
        try:
            conn.settimeout(120.0)
            request = recv_framed(conn)
            if request.get("action") == "reset":
                send_framed(conn, {"result": "reset_ok"})
                return
            images = [decode_image_b64(b) for b in request.get("images", [])]
            instruction = request.get("query", request.get("instruction", ""))
            p = _Pending(self._prep(images), instruction)
            self._queue.put(p)
            p.event.wait(timeout=120.0)
            with self._stats_lock:
                self.stats["requests"] += 1
            send_framed(conn, {"result": p.reply or "MOVE_FORWARD"})
        except Exception as e:                         # noqa: BLE001
            if self.verbose:
                print(f"[BATCH_SERVER] request failed: {e}")
        finally:
            conn.close()

    def _serve(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            t.start()

    def start(self) -> "BatchPolicyServer":
        for target in (self._batcher, self._serve):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        for t in self._threads:
            t.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


def from_torch_policy(params=None, seed: int = 0, height: int = 96,
                      width: int = 128, frames: int = 4, device=None,
                      **server_kw) -> BatchPolicyServer:
    """BatchPolicyServer over the serve/torch_policy.py CNN on ``device``
    (None: the card): one batched ``CNNPolicy`` call per micro-batch, at
    the batch's own size."""
    import torch

    from ..renderer.scene import resolve_device
    from .torch_policy import ACTIONS, CNNPolicy, init_cnn_policy

    dev = resolve_device(device)
    if params is None:
        params = init_cnn_policy(height, width, frames,
                                 generator=torch.Generator().manual_seed(seed),
                                 device=dev)
    model = CNNPolicy({k: v.to(dev) for k, v in params.items()})

    @torch.inference_mode()
    def batch_fn(stacked: np.ndarray) -> List[str]:
        idx = torch.argmax(model(torch.from_numpy(stacked).to(dev)), dim=-1)
        return [ACTIONS[i] for i in idx.tolist()]

    return BatchPolicyServer(batch_fn, height, width, frames, **server_kw)
