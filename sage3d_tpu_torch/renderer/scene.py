"""Gaussian scene representation: struct-of-arrays, PLY ingest, synthetic scenes.

PyTorch counterpart of ``sage3d_tpu/renderer/scene.py``. A scene is a
``NamedTuple`` of tensors on one device; the parameterization is the 3DGS
training space (log scales, unnormalized quaternions, opacity logits, SH
coefficients) so scenes carry across from the JAX package unchanged
(``scene_from_numpy``).

Entry points take ``device=None``, which means the card (``"cuda"``); they
raise when there is no card and the caller did not ask for the CPU.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when a CUDA device is asked for and
    there is none: nothing here falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


class GaussianScene(NamedTuple):
    """Struct-of-arrays 3DGS scene.

      * ``means``: (N, 3) float32 centers.
      * ``log_scales``: (N, 3) per-axis log of the ellipsoid scales (meters).
      * ``quats``: (N, 4) unnormalized (w, x, y, z) rotations.
      * ``opacity_logits``: (N,) pre-sigmoid opacities.
      * ``sh``: (N, K, 3) spherical-harmonic coefficients, K = (deg+1)^2.
      * ``semantic_ids``: (N,) int32 object-instance IDs (-1 = unlabeled).
    """

    means: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacity_logits: torch.Tensor
    sh: torch.Tensor
    semantic_ids: torch.Tensor

    @property
    def num_gaussians(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round(self.sh.shape[1] ** 0.5)) - 1

    @property
    def scales(self) -> torch.Tensor:
        return torch.exp(self.log_scales)

    @property
    def opacities(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity_logits)

    @property
    def device(self) -> torch.device:
        return self.means.device


SCENE_FIELDS = GaussianScene._fields


def scene_from_numpy(arrays: dict, device=None) -> GaussianScene:
    """Build a scene from the six JAX ``GaussianScene`` fields as numpy arrays
    (float32, and int32 for ``semantic_ids``)."""
    dev = resolve_device(device)
    out = {}
    for name in SCENE_FIELDS:
        dtype = np.int32 if name == "semantic_ids" else np.float32
        out[name] = torch.from_numpy(np.array(arrays[name], dtype=dtype)).to(dev)
    return GaussianScene(**out)


def scene_to_numpy(scene: GaussianScene) -> dict:
    return {name: getattr(scene, name).detach().cpu().numpy()
            for name in SCENE_FIELDS}


def make_scene(means, scales, quats, opacities, colors=None, sh=None,
               semantic_ids=None, sh_degree: int = 0,
               device=None) -> GaussianScene:
    """Build a GaussianScene from physical-space parameters.

    ``colors`` are linear RGB in [0, 1] mapped to the SH DC term; alternatively
    pass a full ``sh`` array. ``opacities`` in (0, 1) are converted to logits.
    """
    dev = resolve_device(device)
    means = np.asarray(means, np.float32)
    n = means.shape[0]
    if sh is None:
        k = (sh_degree + 1) ** 2
        sh = np.zeros((n, k, 3), np.float32)
        if colors is not None:
            sh[:, 0, :] = (np.asarray(colors, np.float32) - 0.5) / SH_C0
    op = np.clip(np.asarray(opacities, np.float32), 1e-5, 1.0 - 1e-5)
    sem = (np.asarray(semantic_ids, np.int32) if semantic_ids is not None
           else np.full((n,), -1, np.int32))

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype).to(dev)

    return GaussianScene(
        means=t(means),
        log_scales=torch.log(t(np.asarray(scales, np.float32))),
        quats=t(np.asarray(quats, np.float32)),
        opacity_logits=t(np.log(op / (1.0 - op))),
        sh=t(np.asarray(sh, np.float32)),
        semantic_ids=t(sem, torch.int32),
    )


def importance_subset(scene: GaussianScene, max_gaussians: int) -> GaussianScene:
    """Top-``max_gaussians`` importance LOD of a scene: opacity x ellipsoid
    surface area, ties kept in index order (a stable sort)."""
    k = min(max_gaussians, scene.num_gaussians)
    s = torch.exp(scene.log_scales)
    area = s[:, 0] * s[:, 1] + s[:, 0] * s[:, 2] + s[:, 1] * s[:, 2]
    score = torch.sigmoid(scene.opacity_logits) * area
    idx = torch.argsort(-score, stable=True)[:k]
    return GaussianScene(*(x[idx] for x in scene))


# ---------------------------------------------------------------------------
# PLY ingest (standard INRIA 3DGS .ply layout)
# ---------------------------------------------------------------------------

_PLY_DTYPES = {
    "float": np.float32, "float32": np.float32, "double": np.float64,
    "uchar": np.uint8, "uint8": np.uint8, "int": np.int32, "uint": np.uint32,
    "short": np.int16, "ushort": np.uint16, "char": np.int8,
}


def _parse_ply_header(f):
    line = f.readline().decode("ascii").strip()
    if line != "ply":
        raise ValueError("not a PLY file")
    fmt = None
    n_vertices = 0
    props = []
    while True:
        line = f.readline().decode("ascii").strip()
        if line.startswith("format"):
            fmt = line.split()[1]
        elif line.startswith("element vertex"):
            n_vertices = int(line.split()[2])
        elif line.startswith("element"):
            raise ValueError(f"unsupported PLY element: {line}")
        elif line.startswith("property"):
            _, dtype, name = line.split()
            props.append((name, _PLY_DTYPES[dtype]))
        elif line == "end_header":
            break
    return fmt, n_vertices, props


def load_ply(path, max_sh_degree: int = 3, semantic_ids=None,
             device=None) -> GaussianScene:
    """Load a standard 3DGS PLY (x/y/z, f_dc_*, f_rest_*, opacity, scale_*,
    rot_*). ``rot_*`` is (w, x, y, z); scales and opacities are already in
    log/logit space. A PlayCanvas compressed 3DGS PLY (InteriorGS's
    ``3dgs_compressed.ply``) is recognised by its header and decoded by
    ``utils/plyio_native.load_compressed_ply``."""
    path = Path(path)
    head = b""
    with open(path, "rb") as f:
        while b"end_header" not in head and len(head) < (1 << 20):
            chunk = f.read(8192)
            if not chunk:
                break
            head += chunk
    if b"packed_position" in head.split(b"end_header")[0]:
        from ..utils.plyio_native import load_compressed_ply
        scene = load_compressed_ply(path, device=device)
        if semantic_ids is not None:
            scene = scene._replace(semantic_ids=torch.as_tensor(
                np.asarray(semantic_ids), dtype=torch.int32,
                device=scene.means.device))
        return scene
    with open(path, "rb") as f:
        fmt, n, props = _parse_ply_header(f)
        if fmt not in ("binary_little_endian",):
            raise ValueError(f"unsupported PLY format: {fmt}")
        rec = np.dtype([(name, dt) for name, dt in props])
        data = np.frombuffer(f.read(rec.itemsize * n), dtype=rec, count=n)

    names = {name for name, _ in props}
    means = np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float32)
    f_dc = np.stack([data[f"f_dc_{i}"] for i in range(3)], axis=1).astype(np.float32)
    n_rest = len([p for p in names if p.startswith("f_rest_")])
    k = min((max_sh_degree + 1) ** 2, 1 + n_rest // 3)
    sh = np.zeros((n, k, 3), np.float32)
    sh[:, 0, :] = f_dc
    if k > 1:
        # INRIA layout: f_rest is (3, K-1) flattened channel-major.
        rest = np.stack([data[f"f_rest_{i}"] for i in range(n_rest)], axis=1)
        rest = rest.reshape(n, 3, n_rest // 3)
        sh[:, 1:, :] = np.transpose(rest[:, :, : k - 1], (0, 2, 1))
    if semantic_ids is None and "semantic_id" in names:
        semantic_ids = data["semantic_id"]
    return scene_from_numpy({
        "means": means,
        "log_scales": np.stack([data[f"scale_{i}"] for i in range(3)], axis=1),
        "quats": np.stack([data[f"rot_{i}"] for i in range(4)], axis=1),
        "opacity_logits": data["opacity"],
        "sh": sh,
        "semantic_ids": (semantic_ids if semantic_ids is not None
                         else np.full((n,), -1, np.int32)),
    }, device=device)


def save_ply(scene: GaussianScene, path) -> None:
    """Write a GaussianScene back to the standard 3DGS PLY layout."""
    arr = scene_to_numpy(scene)
    n = scene.num_gaussians
    k = arr["sh"].shape[1]
    names = (["x", "y", "z"] + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(3 * (k - 1))]
             + ["opacity"] + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)] + ["semantic_id"])
    rec = np.dtype([(nm, np.int32 if nm == "semantic_id" else np.float32)
                    for nm in names])
    out = np.empty(n, rec)
    for i, ax in enumerate("xyz"):
        out[ax] = arr["means"][:, i]
    for i in range(3):
        out[f"f_dc_{i}"] = arr["sh"][:, 0, i]
    rest = np.transpose(arr["sh"][:, 1:, :], (0, 2, 1)).reshape(n, -1)
    for i in range(3 * (k - 1)):
        out[f"f_rest_{i}"] = rest[:, i]
    out["opacity"] = arr["opacity_logits"]
    for i in range(3):
        out[f"scale_{i}"] = arr["log_scales"][:, i]
    for i in range(4):
        out[f"rot_{i}"] = arr["quats"][:, i]
    out["semantic_id"] = arr["semantic_ids"]

    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for nm in names:
            dt = "int" if nm == "semantic_id" else "float"
            f.write(f"property {dt} {nm}\n".encode())
        f.write(b"end_header\n")
        f.write(out.tobytes())


def attach_semantic_ids_from_labels(scene: GaussianScene,
                                    labels_json) -> GaussianScene:
    """Assign each Gaussian the instance ID of the labels.json AABB containing
    it. Gaussians outside every bbox keep -1; ties go to the smallest box."""
    if isinstance(labels_json, (str, Path)):
        with open(labels_json) as f:
            labels = json.load(f)
    else:
        labels = labels_json

    boxes = []   # (id, min_xyz, max_xyz, volume)
    for key, rec in labels.items():
        try:
            inst_id = int(str(key).split("_")[-1])
        except ValueError:
            continue
        bbox = rec.get("bbox") if isinstance(rec, dict) else rec
        lo = np.asarray(bbox[0], np.float32)
        hi = np.asarray(bbox[1], np.float32)
        boxes.append((inst_id, lo, hi, float(np.prod(np.maximum(hi - lo, 1e-6)))))
    if not boxes:
        return scene

    boxes.sort(key=lambda b: -b[3])  # large first so small boxes overwrite
    means = scene.means.detach().cpu().numpy()
    ids = np.full(means.shape[0], -1, np.int32)
    for inst_id, lo, hi, _ in boxes:
        inside = np.all((means >= lo) & (means <= hi), axis=1)
        ids[inside] = inst_id
    return scene._replace(semantic_ids=torch.from_numpy(ids).to(scene.device))


# ---------------------------------------------------------------------------
# Synthetic scenes (test fixtures & benchmarks)
# ---------------------------------------------------------------------------

def synthetic_room(num_gaussians: int = 2000, seed: int = 0, extent: float = 5.0,
                   sh_degree: int = 0, num_objects: int = 8,
                   device=None) -> GaussianScene:
    """A random 'room': floor/wall slabs plus object blobs with semantic IDs.

    Drawn with ``np.random.default_rng(seed)`` in the same order as the JAX
    package, so the arrays are the same numbers.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = num_gaussians

    n_struct = n // 4
    n_obj = n - n_struct

    # structural splats: floor + 4 walls (semantic id 0 = "wall"-like)
    sp = rng.uniform(-extent, extent, size=(n_struct, 3)).astype(np.float32)
    which = rng.integers(0, 5, size=n_struct)
    sp[which == 0, 2] = np.abs(rng.normal(0, 0.02, (which == 0).sum()))
    sp[which == 1, 0] = -extent
    sp[which == 2, 0] = extent
    sp[which == 3, 1] = -extent
    sp[which == 4, 1] = extent
    sp[which > 0, 2] = rng.uniform(0, 3.0, (which > 0).sum())
    struct_scales = rng.uniform(0.05, 0.25, size=(n_struct, 3)).astype(np.float32)

    # object blobs
    centers = rng.uniform(-extent * 0.7, extent * 0.7,
                          size=(num_objects, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(0.2, 1.5, num_objects)
    obj_of = rng.integers(0, num_objects, size=n_obj)
    op_ = centers[obj_of] + rng.normal(0, 0.3, size=(n_obj, 3)).astype(np.float32)
    obj_scales = rng.uniform(0.02, 0.15, size=(n_obj, 3)).astype(np.float32)

    means = np.concatenate([sp, op_], axis=0)
    scales = np.concatenate([struct_scales, obj_scales], axis=0)
    sem = np.concatenate([np.zeros(n_struct, np.int32),
                          (obj_of + 1).astype(np.int32)])

    u = rng.uniform(size=(n, 3))
    quats = np.stack([
        np.sqrt(1 - u[:, 0]) * np.sin(2 * np.pi * u[:, 1]),
        np.sqrt(1 - u[:, 0]) * np.cos(2 * np.pi * u[:, 1]),
        np.sqrt(u[:, 0]) * np.sin(2 * np.pi * u[:, 2]),
        np.sqrt(u[:, 0]) * np.cos(2 * np.pi * u[:, 2]),
    ], axis=1).astype(np.float32)  # uniform quaternions, (w,x,y,z) after roll
    quats = np.roll(quats, 1, axis=1)

    opacities = rng.uniform(0.3, 0.95, size=n).astype(np.float32)
    colors = rng.uniform(0.05, 0.95, size=(n, 3)).astype(np.float32)

    sh = None
    if sh_degree > 0:
        sh = np.zeros((n, (sh_degree + 1) ** 2, 3), np.float32)
        sh[:, 0, :] = (colors - 0.5) / SH_C0
        sh[:, 1:, :] = rng.normal(0, 0.02, sh[:, 1:, :].shape)
    return make_scene(means, scales, quats, opacities, colors=colors, sh=sh,
                      semantic_ids=sem, sh_degree=sh_degree, device=dev)
