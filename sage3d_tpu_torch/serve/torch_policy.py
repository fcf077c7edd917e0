"""A frame-history CNN navigation policy on the card, served over the
reference wire protocol.

PyTorch counterpart of ``sage3d_tpu/serve/jax_policy.py``. The reference's
policy models are all external servers; the framework keeps their socket
protocol at the edge (``serve/mllm_server.py``) and can also host a policy
itself: a small CNN whose frame history is stacked on channels, behind the
same 8-byte-BE-length + JSON socket server, so the benchmark client
(``serve/client.py``) drives it unchanged.

The computation is the JAX module's, step for step:

  * frames (T, H, W, 3) in [0, 1] become one (T*3)-channel image, channel
    ``t*3 + c`` (the JAX ``transpose(1, 2, 0, 3).reshape(h, w, t*3)``);
  * three strided 3x3 convolutions with XLA's ``padding="SAME"`` at stride
    2, which pads ``max((ceil(n/2) - 1) * 2 + 3 - n, 0)`` in all, the
    smaller half before (on even sizes 0 before and 1 after, which is not
    ``padding=1``);
  * the activation flattened in (h, w, c) order, as the JAX module's NHWC
    reshape does, then two dense layers.

Parameters are a dict of tensors in PyTorch layouts: ``conv{i}_w`` OIHW,
``fc_w`` (hidden, flat) with its columns in (h, w, c) order, ``head_w``
(4, hidden). ``cnn_params_from_jax`` carries the JAX module's parameters
across. On the card cuDNN may run the convolutions in TF32
(``torch.backends.cudnn.allow_tf32``, on by default), so logits there differ
from the CPU's in about the third decimal of their largest; nothing here
changes that flag.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..renderer.scene import resolve_device

ACTIONS = ("MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT", "STOP")


def _same_out(n: int) -> int:
    """Output size of a stride-2 ``SAME`` convolution."""
    return -(-n // 2)


def _same_pad(n: int) -> tuple:
    """(before, after) padding of XLA's ``SAME`` for a 3-wide window at
    stride 2 on a side of ``n``."""
    total = max((_same_out(n) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


def init_cnn_policy(height: int = 96, width: int = 128, frames: int = 4,
                    channels: Sequence[int] = (16, 32, 64),
                    hidden: int = 128,
                    generator: Optional[torch.Generator] = None,
                    device=None) -> Dict[str, torch.Tensor]:
    """He-initialized parameters for ``cnn_policy_apply``, drawn on the CPU
    from ``generator`` (so one seed gives the same weights on every device)
    and moved to ``device`` (None: the card).

    Input: (frames, height, width, 3) float32 in [0, 1]. The flattened size
    follows the ``SAME`` convolutions' output sizes, ``ceil(n / 2)`` a layer
    (the JAX initializer's ``n // 2**layers`` agrees where ``n`` is a
    multiple of ``2**layers``)."""
    dev = resolve_device(device)
    g = generator if generator is not None else torch.Generator().manual_seed(0)

    def normal(*shape, fan_in):
        return torch.randn(shape, generator=g) * math.sqrt(2.0 / fan_in)

    params: Dict[str, torch.Tensor] = {}
    cin, h, w = frames * 3, height, width
    for i, cout in enumerate(channels):
        params[f"conv{i}_w"] = normal(cout, cin, 3, 3, fan_in=9 * cin)
        params[f"conv{i}_b"] = torch.zeros(cout)
        cin, h, w = cout, _same_out(h), _same_out(w)
    flat = h * w * cin
    params["fc_w"] = normal(hidden, flat, fan_in=flat)
    params["fc_b"] = torch.zeros(hidden)
    params["head_w"] = normal(len(ACTIONS), hidden, fan_in=hidden)
    params["head_b"] = torch.zeros(len(ACTIONS))
    return {k: v.to(dev) for k, v in params.items()}


def cnn_params_from_jax(params: Dict[str, np.ndarray],
                        device=None) -> Dict[str, torch.Tensor]:
    """The JAX module's parameters (``init_cnn_policy`` there, as numpy) in
    this module's layouts on ``device`` (None: the card): conv weights HWIO
    -> OIHW, dense weights (in, out) -> (out, in). ``fc_w``'s rows are
    already in the (h, w, c) order this module flattens in."""
    dev = resolve_device(device)
    out = {}
    for k, v in params.items():
        t = torch.as_tensor(np.array(v, np.float32))
        if k.startswith("conv") and k.endswith("_w"):
            t = t.permute(3, 2, 0, 1)
        elif k in ("fc_w", "head_w"):
            t = t.t()
        out[k] = t.contiguous().to(dev)
    return out


def _apply_batch(params: Dict[str, torch.Tensor],
                 frames: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 3) float32 frames -> (B, 4) action logits."""
    b, t, h, w, _ = frames.shape
    x = frames.permute(0, 1, 4, 2, 3).reshape(b, t * 3, h, w)
    i = 0
    while f"conv{i}_w" in params:
        ph, pw = _same_pad(x.shape[2]), _same_pad(x.shape[3])
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        x = F.relu(F.conv2d(x, params[f"conv{i}_w"], params[f"conv{i}_b"],
                            stride=2))
        i += 1
    x = x.permute(0, 2, 3, 1).reshape(b, -1)       # (h, w, c), as NHWC
    x = F.relu(F.linear(x, params["fc_w"], params["fc_b"]))
    return F.linear(x, params["head_w"], params["head_b"])


def cnn_policy_apply(params: Dict[str, torch.Tensor],
                     frames: torch.Tensor) -> torch.Tensor:
    """(T, H, W, 3) float32 frames -> (4,) action logits."""
    return _apply_batch(params, frames[None])[0]


class CNNPolicy(torch.nn.Module):
    """``cnn_policy_apply`` as a module over a batch: (B, T, H, W, 3) ->
    (B, 4) logits. Holds ``params`` as its parameters."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        super().__init__()
        self.params = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(v, requires_grad=False)
             for k, v in params.items()})

    def forward(self, frames: torch.Tensor) -> torch.Tensor:
        return _apply_batch(dict(self.params), frames)


def prep_frames(images: List, height: int, width: int,
                frames: int) -> np.ndarray:
    """Normalize a frame history to (frames, height, width, 3) float32 in
    [0,1]: keep the most recent ``frames``, front-pad by repeating the first
    (the 8-frame sliding-buffer contract, vlm_client_modular.py:54-82).
    Single source of truth for every in-framework policy server."""
    from PIL import Image
    imgs = list(images[-frames:]) if images else []
    if not imgs:
        imgs = [Image.new("RGB", (width, height))]
    imgs = [imgs[0]] * (frames - len(imgs)) + imgs
    arrs = []
    for im in imgs:
        if not isinstance(im, Image.Image):
            im = Image.fromarray(np.asarray(im))
        im = im.convert("RGB").resize((width, height))
        arrs.append(np.asarray(im, np.float32) / 255.0)
    return np.stack(arrs)


class TorchPolicyAdapter:
    """MLLMAdapter-compatible wrapper: decode frames, run the policy on its
    device, emit the constrained action word (the MLLM wire contract)."""

    def __init__(self, params, apply_fn: Callable = cnn_policy_apply,
                 height: int = 96, width: int = 128, frames: int = 4,
                 device=None):
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.apply_fn = apply_fn
        self.height = height
        self.width = width
        self.frames = frames

    def _prep(self, images: List) -> torch.Tensor:
        return torch.from_numpy(prep_frames(
            images, self.height, self.width, self.frames)).to(self.device)

    @torch.inference_mode()
    def generate_response(self, images: List, instruction: str) -> str:
        logits = self.apply_fn(self.params, self._prep(images))
        return ACTIONS[int(torch.argmax(logits))]

    def extract_action(self, text: str) -> str:
        return text  # already a canonical action word


def make_torch_policy_server(host: str = "127.0.0.1", port: int = 9701,
                             params=None, seed: int = 0,
                             height: int = 96, width: int = 128,
                             frames: int = 4,
                             apply_fn: Callable = cnn_policy_apply,
                             device=None):
    """MLLMServer hosting the CNN policy on ``device`` (None: the card),
    random-initialized from ``seed`` unless ``params`` are given."""
    from .mllm_server import MLLMServer
    if params is None:
        params = init_cnn_policy(height, width, frames,
                                 generator=torch.Generator().manual_seed(seed),
                                 device=device)
    adapter = TorchPolicyAdapter(params, apply_fn, height, width, frames,
                                 device=device)
    return MLLMServer(adapter, host=host, port=port)
