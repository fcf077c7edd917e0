"""Structural validator for PlayCanvas compressed 3DGS PLY files.

The port's copy of ``sage3d_tpu/utils/ply_validate.py``, on the port's
decoder (``utils/plyio_native.py`` + ``native/compressed_ply.cpp``). It is
the audit tool for a REAL InteriorGS `3dgs_compressed.ply` (written by
PlayCanvas splat-transform, reference README.md:194-243):

    python -m sage3d_tpu_torch.cli validate-ply /path/to/3dgs_compressed.ply

It checks every format assumption the decoder makes — header schema, chunk
arithmetic, bound ordering, decoded-value sanity, quaternion normalization
within quantization error — and cross-checks the native C++ decoder against
the independent pure-numpy oracle on the real bytes. Each check records WHICH
assumption it pins down; docs/PARITY.md lists the two conventions that cannot
be distinguished by self-round-trip (rotation component order, SH rest
quantization scale) and are resolved by the value-sanity checks here. The
last check loads the file into a scene on ``device`` (None: the card).
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np

# The header schema splat-transform writes (order matters: properties are
# consumed positionally by column index in some readers).
CHUNK_PROPS_12 = [
    "min_x", "min_y", "min_z", "max_x", "max_y", "max_z",
    "min_scale_x", "min_scale_y", "min_scale_z",
    "max_scale_x", "max_scale_y", "max_scale_z"]
CHUNK_PROPS_18 = CHUNK_PROPS_12 + [
    "min_r", "min_g", "min_b", "max_r", "max_g", "max_b"]
VERTEX_PROPS = ["packed_position", "packed_rotation", "packed_scale",
                "packed_color"]
SPLATS_PER_CHUNK = 256


def _read_header(f) -> List[tuple]:
    if f.readline().strip() != b"ply":
        raise ValueError("not a PLY file (magic)")
    elements, cur = [], None
    fmt = None
    while True:
        line = f.readline().decode("ascii", "replace").strip()
        if line.startswith("format"):
            fmt = line
        elif line.startswith("element"):
            _, name, count = line.split()
            cur = (name, int(count), [])
            elements.append(cur)
        elif line.startswith("property"):
            parts = line.split()
            if len(parts) == 3 and cur is not None:
                _, dtype, pname = parts
                cur[2].append((pname, dtype))
            else:
                # `property list ...` (standard uncompressed PLY) or other
                # non-scalar forms: record as a failing schema entry instead
                # of raising — validate_compressed_ply's contract is
                # "failures are data" (ADVICE r4).
                if cur is not None:
                    cur[2].append((line, "<unsupported>"))
        elif line == "end_header":
            break
        elif line == "":
            raise ValueError("EOF before end_header")
    if fmt is None or "binary_little_endian" not in fmt:
        raise ValueError(f"expected binary_little_endian, got: {fmt}")
    return elements


def validate_compressed_ply(path, max_report: int = 8,
                            device=None) -> Dict:
    """Validate ``path`` against every decoder assumption. Returns a report
    dict with per-check pass/fail; raises nothing (failures are data)."""
    from .plyio_native import (decode_compressed, load_compressed_ply,
                               native_available)

    checks: List[Dict] = []

    def check(name, ok, detail=""):
        checks.append({"check": name, "ok": bool(ok),
                       "detail": str(detail)[:300]})

    with open(path, "rb") as f:
        elements = _read_header(f)
        names = [e[0] for e in elements]
        check("header.elements", names[:2] == ["chunk", "vertex"],
              f"element order: {names}")
        by_name = {e[0]: e for e in elements}
        if "chunk" not in by_name or "vertex" not in by_name:
            # a standard (uncompressed) PLY: no chunk element at all. Report
            # the failure instead of KeyError-ing (ADVICE r4).
            check("header.compressed_schema", False,
                  f"missing chunk/vertex elements; found {names}")
            return {"path": str(path), "ok": False, "checks": checks}

        # chunk element schema + 256-splat arithmetic
        _, n_chunks, cprops = by_name["chunk"]
        cnames = [p for p, _ in cprops]
        check("chunk.props",
              cnames in (CHUNK_PROPS_12, CHUNK_PROPS_18),
              f"{len(cnames)} props: {cnames[:6]}...")
        check("chunk.dtype", all(t in ("float", "float32")
                                 for _, t in cprops), cprops[:3])
        _, n_verts, vprops = by_name["vertex"]
        check("vertex.props", [p for p, _ in vprops] == VERTEX_PROPS,
              [p for p, _ in vprops])
        check("vertex.dtype", all(t in ("uint", "uint32") for _, t in vprops),
              vprops)
        check("chunk.count", n_chunks == -(-n_verts // SPLATS_PER_CHUNK),
              f"{n_chunks} chunks for {n_verts} verts")

        # read payloads
        cdt = np.dtype([(p, np.float32) for p, _ in cprops])
        chunks = np.frombuffer(f.read(cdt.itemsize * n_chunks), dtype=cdt,
                               count=n_chunks)
        vdt = np.dtype([(p, np.uint32) for p, _ in vprops])
        verts = np.frombuffer(f.read(vdt.itemsize * n_verts), dtype=vdt,
                              count=n_verts)
        sh_rest = None
        if "sh" in by_name:
            _, n_sh, sprops = by_name["sh"]
            check("sh.count", n_sh == n_verts, f"{n_sh} vs {n_verts}")
            check("sh.dtype", all(t in ("uchar", "uint8") for _, t in sprops),
                  sprops[:3])
            check("sh.band_arith", len(sprops) % 3 == 0 and
                  (len(sprops) // 3) in (3, 8, 15),
                  f"{len(sprops)} rest coeffs")
            sdt = np.dtype([(p, np.uint8) for p, _ in sprops])
            sh_rest = np.frombuffer(f.read(sdt.itemsize * n_sh), dtype=sdt,
                                    count=n_sh)
        trailing = f.read(1)
        check("payload.exact_size", trailing == b"",
              "trailing bytes after last element" if trailing else "exact")

    chunk_data = np.stack([chunks[p] for p, _ in cprops], 1).astype(np.float32)
    packed = np.stack([verts[p] for p in VERTEX_PROPS], 1).astype(np.uint32)

    # bound ordering: every chunk's min <= max on all 6(+3) ranges
    mins = chunk_data[:, [0, 1, 2, 6, 7, 8] + ([12, 13, 14] if chunk_data.shape[1] == 18 else [])]
    maxs = chunk_data[:, [3, 4, 5, 9, 10, 11] + ([15, 16, 17] if chunk_data.shape[1] == 18 else [])]
    check("chunk.bounds_ordered", bool(np.all(mins <= maxs + 1e-6)),
          f"violations: {int(np.sum(mins > maxs + 1e-6))}")

    # decode with BOTH implementations and cross-check on the real bytes
    dec_py = decode_compressed(chunk_data, packed, use_native=False)
    if native_available():
        dec_nat = decode_compressed(chunk_data, packed, use_native=True)
        worst = max(float(np.abs(dec_py[kk] - dec_nat[kk]).max())
                    for kk in dec_py)
        check("native_vs_python", worst < 1e-5, f"max abs diff {worst:.2e}")
    else:
        check("native_vs_python", False, "native library unavailable")

    # value sanity — these catch convention mismatches self-round-trips can't:
    # a wrong rotation component order yields non-unit or non-positive-largest
    # quats only at the packing side, but decoded quats must be unit within
    # 10-bit quantization error regardless; positions must fall inside their
    # chunk bounds; opacity logits must be finite.
    q = dec_py["quats"]
    qn = np.linalg.norm(q, axis=1)
    check("quats.unit", bool(np.all(np.abs(qn - 1.0) < 5e-3)),
          f"|q| range [{qn.min():.4f}, {qn.max():.4f}]")
    # largest-component convention: the component at the packed 2-bit index
    # (xyzw order k -> decoder's wxyz order (k+1)%4) must be >= every stored
    # component in magnitude (writers pick the true largest and flip its sign
    # positive; the three stored ones are therefore <= 1/sqrt(2) <= it). A
    # wrong component-order assumption in the decoder breaks this on REAL
    # files while self-round-trips still pass.
    kk = (packed[:, 1] >> 30).astype(np.int64)
    at_largest = q[np.arange(n_verts), (kk + 1) % 4]
    check("quats.largest_at_index",
          bool(np.all(at_largest >= np.abs(q).max(axis=1) - 5e-3))
          and bool(np.all(at_largest >= -1e-6)),
          f"min at-index value {at_largest.min():.4f}")
    m = dec_py["means"]
    ci = np.minimum(np.arange(n_verts) // SPLATS_PER_CHUNK, n_chunks - 1)
    lo, hi = chunk_data[ci, 0:3], chunk_data[ci, 3:6]
    check("means.in_chunk_bounds",
          bool(np.all((m >= lo - 1e-4) & (m <= hi + 1e-4))),
          f"violations: {int(np.sum((m < lo - 1e-4) | (m > hi + 1e-4)))}")
    check("opacity.finite", bool(np.all(np.isfinite(dec_py["opacity_logits"]))))
    ls = dec_py["log_scales"]
    check("scales.sane", bool(np.all((ls > -20) & (ls < 6))),
          f"log-scale range [{ls.min():.2f}, {ls.max():.2f}]")
    if sh_rest is not None:
        from .plyio_native import decode_sh_bands
        rest = decode_sh_bands(
            np.stack([sh_rest[p] for p in sh_rest.dtype.names], 1))
        check("sh.range", bool(np.all((rest >= -4.0 - 1e-5)
                                      & (rest <= 4.0 + 1e-5))),
              f"[{rest.min():.2f}, {rest.max():.2f}]")

    # full high-level load must succeed
    try:
        scene = load_compressed_ply(path, device=device)
        check("load_compressed_ply", True,
              f"{scene.num_gaussians} gaussians, sh K={scene.sh.shape[1]}")
    except Exception as e:  # noqa: BLE001 - report, don't crash the audit
        check("load_compressed_ply", False, repr(e))

    ok = all(c["ok"] for c in checks)
    return {"path": str(path), "ok": ok, "n_vertices": int(n_verts),
            "n_chunks": int(n_chunks), "checks": checks}


def main(argv=None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ply", help="path to 3dgs_compressed.ply")
    p.add_argument("--device", default="cuda",
                   help="where the final load puts the scene (cuda | cpu)")
    args = p.parse_args(argv)
    report = validate_compressed_ply(args.ply, device=args.device)
    print(json.dumps(report, indent=1))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
