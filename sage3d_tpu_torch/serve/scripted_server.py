"""Scripted policy server: a wire-compatible stand-in for the VLM servers.

The reference's closed-loop stack requires a GPU model server (mllm_server.py,
navila_server.py, navid_server.py); its protocol is length-prefixed JSON over a
socket with the constrained 4-action vocabulary MOVE_FORWARD / TURN_LEFT /
TURN_RIGHT / STOP (mllm_server.py:41-66 prompt template, :89-112 action
extraction). This server speaks the same protocol but answers from a script or
a callback, giving the benchmark a deterministic, model-free policy endpoint —
the fake-backend the reference never had (SURVEY.md section 4).

Also usable as a host for real JAX policies: pass ``policy_fn`` that maps the
decoded frames + instruction to an action string.
"""

from __future__ import annotations

import itertools
import socket
import threading
from typing import Callable, Iterable, Optional

from .protocol import recv_framed, send_framed

ACTIONS = ("MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT", "STOP")


class ScriptedPolicyServer:
    """Socket policy server with a scripted or programmatic policy.

    Args:
      script: iterable of action strings, cycled if finite list (e.g.
        ["MOVE_FORWARD", "MOVE_FORWARD", "TURN_LEFT"]); ignored if policy_fn.
      policy_fn: callable(images_b64, instruction) -> action string.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 script: Optional[Iterable[str]] = None,
                 policy_fn: Optional[Callable] = None):
        self.host = host
        self._policy_fn = policy_fn
        self._script = itertools.cycle(list(script)) if script else \
            itertools.cycle(["MOVE_FORWARD"])
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(8)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.request_count = 0

    def _answer(self, request: dict) -> dict:
        if isinstance(request, dict) and request.get("action") == "reset":
            # NaVid-style stateful reset message (navid_server.py:452-454)
            return {"result": "reset_ok"}
        images = request.get("images", []) if isinstance(request, dict) else []
        query = request.get("query", request.get("instruction", "")) \
            if isinstance(request, dict) else ""
        if self._policy_fn is not None:
            action = self._policy_fn(images, query)
        else:
            action = next(self._script)
        self.request_count += 1
        return {"result": action}

    def _serve_loop(self):
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            try:
                conn.settimeout(10.0)
                request = recv_framed(conn)
                send_framed(conn, self._answer(request))
            except Exception:
                pass
            finally:
                conn.close()

    def start(self) -> "ScriptedPolicyServer":
        self._thread = threading.Thread(target=self._serve_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        if self._thread:
            self._thread.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
