"""Native-accelerated PLY IO: compressed-3DGS decoding + fast column extraction.

The port's counterpart of ``sage3d_tpu/utils/plyio_native.py``: ctypes
bindings over the host C++ decoder ``native/compressed_ply.cpp``, which
replaces the reference's external splat-transform step (README.md:194-243):
InteriorGS's 3dgs_compressed.ply decodes directly into a GaussianScene. A
pure-Python decoder of the same format is the correctness oracle for the
native path.

The library is built at first use from the checkout's source with ``g++`` and
the flags of ``native/Makefile`` into ``build/native/`` (under a name that
carries a hash of the source and flags), never into ``native/``, and the
committed ``native/libsage3d_native.so`` (built for another host) is not
loaded. Where the compiler has no OpenMP runtime (no ``libgomp``), the same
source is built without ``-fopenmp``: its ``omp`` pragmas are its only use of
OpenMP, so the decoder then runs serially and gives the same values
(``native_flags()`` says which flags the loaded library was built with).
``use_native=None`` takes the native decoder when it builds and the Python
one otherwise (``native_available()`` says which); ``use_native=True`` raises
the build's error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "compressed_ply.cpp"
BUILD_DIR = _REPO / "build" / "native"
# native/Makefile's CXXFLAGS, plus -shared as its link line adds
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17",
            "-Wall", "-shared")
SERIAL_CXXFLAGS = tuple(f for f in CXXFLAGS if f != "-fopenmp")

_lib: Optional[ctypes.CDLL] = None
_flags: Optional[tuple] = None
_error: Optional[str] = None
_lock = threading.Lock()

SH_C0 = 0.28209479177387814
_SQRT2_INV = 0.7071067811865475


def library_path(flags: tuple = CXXFLAGS) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"libsage3d_native-{digest[:12]}.so"


def _built(flags: tuple) -> Path:
    """The library built with ``flags``, compiled now if it is not there."""
    out = library_path(flags)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"(rc={proc.returncode}): {proc.stderr[-2000:]}")
    os.replace(tmp, out)
    return out


def load_native() -> ctypes.CDLL:
    """The native library, built on first use (with OpenMP, else serially);
    raises the build's error."""
    global _lib, _flags, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        errors = []
        for flags in (CXXFLAGS, SERIAL_CXXFLAGS):
            try:
                lib = ctypes.CDLL(str(_built(flags)))
                break
            except (OSError, subprocess.SubprocessError, RuntimeError) as e:
                errors.append(str(e))
        else:
            _error = "native PLY decoder unavailable: " + " | ".join(errors)
            raise RuntimeError(_error)
        lib.sage3d_decode_compressed_ply.restype = ctypes.c_int
        lib.sage3d_decode_compressed_ply.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float)]
        lib.sage3d_decode_sh_bands.restype = ctypes.c_int
        lib.sage3d_decode_sh_bands.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        lib.sage3d_extract_columns.restype = ctypes.c_int
        lib.sage3d_extract_columns.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float)]
        _lib, _flags = lib, flags
        return lib


def _native(use_native: Optional[bool]) -> Optional[ctypes.CDLL]:
    """The library for ``use_native`` None (if it builds) or True (raises
    if it does not); None for False."""
    if use_native is False:
        return None
    try:
        return load_native()
    except RuntimeError:
        if use_native:
            raise
        return None


def native_available() -> bool:
    return _native(None) is not None


def native_flags() -> Optional[tuple]:
    """The compiler flags of the loaded library (None: not loaded)."""
    return _flags


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def decode_compressed(chunk_data: np.ndarray, packed: np.ndarray,
                      use_native: Optional[bool] = None):
    """Decode compressed chunks+vertices into SoA arrays.

    Args:
      chunk_data: (n_chunks, 12|18) float32 min/max ranges.
      packed: (n, 4) uint32 packed vertices.
      use_native: force native/python path (None = native if it builds).

    Returns dict of numpy arrays: means (n,3), log_scales (n,3), quats (n,4)
    (w,x,y,z), opacity_logits (n,), sh_dc (n,3).
    """
    chunk_data = np.ascontiguousarray(chunk_data, np.float32)
    packed = np.ascontiguousarray(packed, np.uint32)
    n = packed.shape[0]
    lib = _native(use_native)
    if lib is not None:
        means = np.empty((n, 3), np.float32)
        log_scales = np.empty((n, 3), np.float32)
        quats = np.empty((n, 4), np.float32)
        opacity = np.empty((n,), np.float32)
        sh_dc = np.empty((n, 3), np.float32)
        rc = lib.sage3d_decode_compressed_ply(
            _fptr(chunk_data), chunk_data.shape[0], chunk_data.shape[1],
            packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n,
            _fptr(means), _fptr(log_scales), _fptr(quats), _fptr(opacity),
            _fptr(sh_dc))
        if rc != 0:
            raise RuntimeError(f"native decode failed: rc={rc}")
        return {"means": means, "log_scales": log_scales, "quats": quats,
                "opacity_logits": opacity, "sh_dc": sh_dc}
    return _decode_compressed_python(chunk_data, packed)


def _unorm(v: np.ndarray, bits: int) -> np.ndarray:
    t = (1 << bits) - 1
    return (v & t).astype(np.float32) / t


def _decode_compressed_python(chunk_data: np.ndarray, packed: np.ndarray):
    """Pure-numpy decoder (correctness oracle for the native path)."""
    n = packed.shape[0]
    ci = np.minimum(np.arange(n) // 256, chunk_data.shape[0] - 1)
    c = chunk_data[ci]
    has_color = chunk_data.shape[1] == 18

    p, r, s, col = (packed[:, 0], packed[:, 1], packed[:, 2], packed[:, 3])
    means = np.stack([
        c[:, 0] + (c[:, 3] - c[:, 0]) * _unorm(p >> 21, 11),
        c[:, 1] + (c[:, 4] - c[:, 1]) * _unorm(p >> 11, 10),
        c[:, 2] + (c[:, 5] - c[:, 2]) * _unorm(p, 11)], axis=1)
    log_scales = np.stack([
        c[:, 6] + (c[:, 9] - c[:, 6]) * _unorm(s >> 21, 11),
        c[:, 7] + (c[:, 10] - c[:, 7]) * _unorm(s >> 11, 10),
        c[:, 8] + (c[:, 11] - c[:, 8]) * _unorm(s, 11)], axis=1)

    largest = (r >> 30).astype(np.int32)
    a = (_unorm(r >> 20, 10) - 0.5) * 2.0 * _SQRT2_INV
    b = (_unorm(r >> 10, 10) - 0.5) * 2.0 * _SQRT2_INV
    d = (_unorm(r, 10) - 0.5) * 2.0 * _SQRT2_INV
    m = np.sqrt(np.maximum(0.0, 1.0 - (a * a + b * b + d * d)))
    comps = np.stack([a, b, d], axis=1)
    xyzw = np.empty((n, 4), np.float32)
    for k in range(4):
        mask = largest == k
        rest = np.delete(np.arange(4), k)
        xyzw[mask, k] = m[mask]
        xyzw[mask[:, None] & np.isin(np.arange(4), rest)[None, :]] = \
            comps[mask].reshape(-1)
    quats = np.stack([xyzw[:, 3], xyzw[:, 0], xyzw[:, 1], xyzw[:, 2]], axis=1)

    cr = _unorm(col >> 24, 8)
    cg = _unorm(col >> 16, 8)
    cb = _unorm(col >> 8, 8)
    ca = _unorm(col, 8)
    if has_color:
        cr = c[:, 12] + (c[:, 15] - c[:, 12]) * cr
        cg = c[:, 13] + (c[:, 16] - c[:, 13]) * cg
        cb = c[:, 14] + (c[:, 17] - c[:, 14]) * cb
    sh_dc = np.stack([(cr - 0.5) / SH_C0, (cg - 0.5) / SH_C0,
                      (cb - 0.5) / SH_C0], axis=1).astype(np.float32)
    ca = np.clip(ca, 1e-6, 1 - 1e-6)
    opacity = np.log(ca / (1 - ca)).astype(np.float32)
    return {"means": means.astype(np.float32),
            "log_scales": log_scales.astype(np.float32),
            "quats": quats.astype(np.float32),
            "opacity_logits": opacity, "sh_dc": sh_dc}


def decode_sh_bands(rest_u8: np.ndarray,
                    use_native: Optional[bool] = None) -> np.ndarray:
    """Dequantize compressed SH rest bands: (n, n_rest) uint8 -> float32.

    PlayCanvas/SuperSplat compressed-ply convention: byte -> (b/255)*8 - 4
    (uniform [-4, 4) quantization, channel-major f_rest layout); newer
    compressed InteriorGS files carry them as an optional `sh` element.
    """
    rest_u8 = np.ascontiguousarray(rest_u8, np.uint8)
    n, n_rest = rest_u8.shape
    lib = _native(use_native)
    if lib is not None:
        out = np.empty((n, n_rest), np.float32)
        rc = lib.sage3d_decode_sh_bands(
            rest_u8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
            n_rest, _fptr(out))
        if rc != 0:
            raise RuntimeError(f"native sh decode failed: rc={rc}")
        return out
    return rest_u8.astype(np.float32) * (8.0 / 255.0) - 4.0


def read_compressed_ply(path, use_native: Optional[bool] = None) -> dict:
    """Decode a PlayCanvas compressed 3DGS PLY into the scene's six fields
    as numpy arrays (``semantic_ids`` all -1)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a PLY file")
        elements = []  # (name, count, [(prop, dtype)])
        cur = None
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element"):
                _, name, count = line.split()
                cur = (name, int(count), [])
                elements.append(cur)
            elif line.startswith("property"):
                _, dtype, pname = line.split()
                cur[2].append((pname, dtype))
            elif line == "end_header":
                break
        blobs = {}
        _DT = {"uint": np.uint32, "uint32": np.uint32, "int": np.int32,
               "int32": np.int32, "uchar": np.uint8, "uint8": np.uint8,
               "float": np.float32, "float32": np.float32}
        for name, count, props in elements:
            dt = np.dtype([(p, _DT.get(t, np.float32)) for p, t in props])
            blobs[name] = np.frombuffer(f.read(dt.itemsize * count), dtype=dt,
                                        count=count)

    chunks = blobs["chunk"]
    chunk_data = np.stack([chunks[name] for name in chunks.dtype.names],
                          axis=1).astype(np.float32)
    verts = blobs["vertex"]
    packed = np.stack([verts["packed_position"], verts["packed_rotation"],
                       verts["packed_scale"], verts["packed_color"]],
                      axis=1).astype(np.uint32)
    dec = decode_compressed(chunk_data, packed, use_native=use_native)
    n = packed.shape[0]
    # Optional SH rest bands (newer compressed files): element `sh` with
    # uint8 f_rest_* properties, channel-major like uncompressed PLY.
    if "sh" in blobs and len(blobs["sh"].dtype.names) >= 3:
        names = [p for p in blobs["sh"].dtype.names
                 if p.startswith("f_rest_")]
        names.sort(key=lambda p: int(p.split("_")[-1]))
        rest_u8 = np.stack([blobs["sh"][p] for p in names], axis=1)
        rest = decode_sh_bands(rest_u8, use_native=use_native)   # (n, 3*B)
        b = rest.shape[1] // 3
        sh = np.zeros((n, 1 + b, 3), np.float32)
        sh[:, 0, :] = dec["sh_dc"]
        sh[:, 1:, :] = np.transpose(rest.reshape(n, 3, b), (0, 2, 1))
    else:
        sh = np.zeros((n, 1, 3), np.float32)
        sh[:, 0, :] = dec["sh_dc"]
    return {"means": dec["means"], "log_scales": dec["log_scales"],
            "quats": dec["quats"], "opacity_logits": dec["opacity_logits"],
            "sh": sh, "semantic_ids": np.full((n,), -1, np.int32)}


def load_compressed_ply(path, use_native: Optional[bool] = None,
                        device=None):
    """Load a PlayCanvas compressed 3DGS PLY into a GaussianScene on
    ``device`` (None: the card)."""
    from ..renderer.scene import scene_from_numpy
    return scene_from_numpy(read_compressed_ply(path, use_native),
                            device=device)


def extract_columns_native(blob: np.ndarray, n: int, stride: int,
                           offsets) -> Optional[np.ndarray]:
    """Strided float32 column gather via the native library (None = no lib)."""
    lib = _native(None)
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, np.int64)
    out = np.empty((len(offsets), n), np.float32)
    rc = lib.sage3d_extract_columns(
        blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, stride,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(offsets), _fptr(out))
    if rc != 0:
        return None
    return out
