"""Wire protocols for policy serving: length-prefixed-JSON sockets and HTTP.

Wire-compatible with the reference's servers so existing NaVILA/NaVid/MLLM
deployments interoperate unchanged:

  * Socket framing: 8-byte big-endian length prefix + UTF-8 JSON, one
    request/response per connection (vlm_client_modular.py:440-491,
    mllm_server.py:416-469).
  * Images: base64-encoded JPEG in the JSON body.
  * HTTP: POST /vln_step {images, instruction, current_yaw} -> {result};
    POST /nogoal_step multipart JPEG + x10000-uint16-PNG depth -> {trajectory};
    POST /navigator_reset {intrinsic, stop_threshold, batch_size}
    (vlm_client_modular.py:324-427, 558-584).
"""

from __future__ import annotations

import base64
import io
import json
import socket
from typing import Any, Dict, List

import numpy as np

DEPTH_SCALE = 10000.0
DEPTH_CLIP_M = 6.5


def encode_image_b64(img) -> str:
    """PIL image or HxWx3 uint8 array -> base64 JPEG string."""
    from PIL import Image
    if not hasattr(img, "save"):
        img = Image.fromarray(np.asarray(img).astype(np.uint8))
    buf = io.BytesIO()
    img.convert("RGB").save(buf, format="JPEG")
    return base64.b64encode(buf.getvalue()).decode()


def decode_image_b64(data: str):
    from PIL import Image
    return Image.open(io.BytesIO(base64.b64decode(data))).convert("RGB")


def encode_depth_png(depth_m: np.ndarray) -> bytes:
    """Depth meters -> 16-bit PNG at x10000 scale, clipped to 6.5 m
    (vlm_client_modular.py:355-356)."""
    from PIL import Image
    clamped = np.clip(depth_m.astype(np.float32), 0.0, DEPTH_CLIP_M)
    enc = (clamped * DEPTH_SCALE).astype(np.uint16)
    buf = io.BytesIO()
    Image.fromarray(enc).save(buf, format="PNG")
    return buf.getvalue()


def decode_depth_png(data: bytes) -> np.ndarray:
    from PIL import Image
    arr = np.asarray(Image.open(io.BytesIO(data)))
    return arr.astype(np.float32) / DEPTH_SCALE


def send_framed(sock: socket.socket, payload: Dict[str, Any]) -> None:
    data = json.dumps(payload).encode("utf-8")
    sock.sendall(len(data).to_bytes(8, "big"))
    sock.sendall(data)


def recv_framed(sock: socket.socket) -> Dict[str, Any]:
    size_data = b""
    while len(size_data) < 8:
        chunk = sock.recv(8 - len(size_data))
        if not chunk:
            raise ConnectionError("socket closed while reading frame size")
        size_data += chunk
    size = int.from_bytes(size_data, "big")
    body = b""
    while len(body) < size:
        packet = sock.recv(min(65536, size - len(body)))
        if not packet:
            raise ConnectionError("socket closed mid-frame")
        body += packet
    return json.loads(body.decode("utf-8"))


def socket_request(host: str, port: int, payload: Dict[str, Any],
                   timeout: float = 60.0) -> Any:
    """One framed request/response round trip (client side)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.settimeout(timeout)
    sock.connect((host, port))
    try:
        send_framed(sock, payload)
        return recv_framed(sock)
    finally:
        sock.close()
