"""Inputs of K6's gates (the capsule query, ``csrc/capsule.cu``): an
adversarial room and capsule positions, shared by
``tests/test_torch_capsule_kernel.py``, ``tests/test_torch_gpu.py`` and
``chip_smoke.py``'s phase 9a."""

import numpy as np
import torch

from sage3d_tpu_torch.renderer.scene import GaussianScene

# The adversarial Gaussians, around the first four capsules of
# ``capsules``: (mean xyz, scales xyz, opacity logit, semantic id). Each
# special Gaussian is far larger than the room's (scales 0.6 against at
# most 0.25), so it decides its capsule's minimum.
#   A (0.5, 0.5): three exact copies (ids 901-903), the first at index 0;
#   B (-1, 2): two Gaussians mirrored about the axis, bitwise equal
#     clearances; the one listed first (912) wins;
#   C (2, -1.5): a needle 6 m away along +y with a 4 m scale, which still
#     touches the capsule (Mahalanobis distance 1.5) and wins;
#   D (-2.5, -2): the opacity threshold's boundary: logit -1e-6 (opacity
#     below 0.5: not solid, though nearest), -1e-9 (0.5 after rounding:
#     solid, the winner) and 0 (exactly 0.5: solid).
SPECIAL_XY = ((0.5, 0.5), (-1.0, 2.0), (2.0, -1.5), (-2.5, -2.0))
_BIG, _NEEDLE = (0.6, 0.6, 0.6), (0.05, 4.0, 0.05)
_HEAD = [((0.55, 0.5, 0.4), _BIG, 4.0, 901)]
_TAIL = [((0.55, 0.5, 0.4), _BIG, 4.0, 902),
         ((-0.75, 2.0, 0.4), _BIG, 4.0, 912),
         ((-1.25, 2.0, 0.4), _BIG, 4.0, 911),
         ((2.0, 4.5, 0.4), _NEEDLE, 4.0, 921),
         ((-2.4, -2.0, 0.4), _BIG, -1e-6, 931),
         ((-2.62, -2.0, 0.4), _BIG, -1e-9, 933),
         ((-2.36, -2.0, 0.4), _BIG, 0.0, 932),
         ((0.55, 0.5, 0.4), _BIG, 4.0, 903)]


def _rows(specs, sh_shape):
    return {"means": np.array([s[0] for s in specs], np.float32),
            "log_scales": np.log(np.array([s[1] for s in specs], np.float32)),
            "quats": np.tile(np.array([1, 0, 0, 0], np.float32),
                             (len(specs), 1)),
            "opacity_logits": np.array([s[2] for s in specs], np.float32),
            "sh": np.zeros((len(specs),) + sh_shape, np.float32),
            "semantic_ids": np.array([s[3] for s in specs], np.int32)}


def adversarial_room(base):
    """``base`` (a port ``GaussianScene``) with the adversarial Gaussians
    above: one before its first row and the rest after its last, on its
    device. Returns the new scene."""
    head, tail = (_rows(specs, tuple(base.sh.shape[1:]))
                  for specs in (_HEAD, _TAIL))
    return GaussianScene(*(
        torch.cat([torch.from_numpy(head[name]).to(t), t,
                   torch.from_numpy(tail[name]).to(t)])
        for name, t in zip(base._fields, base)))


def capsules(b: int, seed: int = 5) -> np.ndarray:
    """(b, 2) capsule positions: ``SPECIAL_XY`` first, then uniform draws
    inside the walls from ``np.random.default_rng(seed)``."""
    rest = np.random.default_rng(seed).uniform(-4.2, 4.2, (max(b - 4, 0), 2))
    return np.concatenate([np.array(SPECIAL_XY), rest])[:b].astype(np.float32)
