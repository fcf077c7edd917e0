"""Segment sum of id-sorted rows, on the hand-written CUDA kernel K4.

PyTorch counterpart of ``sage3d_tpu/ops/segreduce.py``. The backward of the
tile compositor routes per-pair gradient rows back to the Gaussians: after a
sort groups the rows by Gaussian id, ``out[g] = Σ rows whose id is g``.

The kernel is ``csrc/segreduce.cu``: a warp per output id, lane ``l`` summing
the rows ``begin + l, begin + l + 32, ...`` of its segment in order, then an
xor butterfly over the 32 lane partials. Exact f32 (no tensor cores, so no
TF32) and deterministic (no atomics). ``segment_reduce_plain`` is its plain
PyTorch version, in the same order of additions; ``segment_reduce_sorted``
takes it only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from . import _build

MAX_PAYLOAD = 15   # payload channels a row may carry (the JAX kernel's NROWS-1)
LANES = 32         # lanes of a warp: the kernel's partial sums per segment


def _as_rows(payload: Union[torch.Tensor, Sequence[torch.Tensor]]) -> torch.Tensor:
    if isinstance(payload, torch.Tensor):
        return payload
    return torch.stack(list(payload), dim=1)


def segment_reduce_plain(gid_sorted: torch.Tensor, payload: torch.Tensor,
                         n_out: int, perm: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version of K4, in the kernel's order of additions: row
    ``r`` of a segment (``r`` counted from the segment's start) goes to lane
    ``r % 32`` as its ``r // 32``-th term, each lane sums its terms in that
    order, and the lanes are summed by halving (what the xor butterfly leaves
    in every lane), so the sums are the kernel's bit for bit. Terms 0 and 1
    of every lane go in one ``index_add_`` (two adds onto zero give the same
    bits in either order); later terms go one rank at a time, so atomics on
    the card cannot reorder them."""
    rows = payload if perm is None else payload[perm]
    dev = rows.device
    n_pay = rows.shape[1]
    ids = gid_sorted.long()
    ok = (ids >= 0) & (ids < n_out)
    ids_c = torch.clamp(ids, 0, max(n_out - 1, 0))
    rel = torch.arange(ids.shape[0], device=dev) - torch.searchsorted(ids, ids_c)
    key = ids_c * LANES + rel % LANES
    term = rel // LANES
    part = torch.zeros((n_out * LANES, n_pay), dtype=torch.float32, device=dev)
    first = ok & (term < 2)
    part.index_add_(0, key[first], rows[first])
    late = torch.nonzero(ok & (term >= 2)).squeeze(1)
    if late.numel():
        late = late[torch.argsort(term[late], stable=True)]
        pos = 0
        for n in torch.bincount(term[late] - 2).tolist():
            sel = late[pos:pos + n]
            part.index_add_(0, key[sel], rows[sel])
            pos += n
    v = part.view(n_out, LANES, n_pay)
    half = LANES // 2
    while half:
        v = v[:, :half] + v[:, half:2 * half]
        half //= 2
    return v[:, 0]


def segment_reduce_sorted(gid_sorted: torch.Tensor,
                          payload: Union[torch.Tensor, Sequence[torch.Tensor]],
                          n_out: int, perm: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Segment-sum payload rows grouped by ascending ``gid_sorted`` into
    ``(n_out, n_payload)`` float32. Ids outside ``[0, n_out)`` add nothing.

    ``gid_sorted`` (P,) int32, ascending. ``payload`` is a (P', n_payload)
    float32 tensor whose rows may be strided (a column slice of a wider
    buffer), or a sequence of (P',) tensors as the JAX function takes.
    ``perm`` (P,) int64, optional: row ``r`` of the sorted order is
    ``payload[perm[r]]`` (the indices ``torch.sort`` returned), so the rows
    are never gathered into a sorted copy; without it P' == P.

    A CPU tensor takes the plain version; a CUDA tensor launches
    ``csrc/segreduce.cu``."""
    rows = _as_rows(payload)
    if gid_sorted.dtype != torch.int32 or gid_sorted.dim() != 1:
        raise ValueError("gid_sorted must be 1-D int32")
    if rows.dim() != 2 or rows.dtype != torch.float32:
        raise ValueError("payload must be (P, n_payload) float32")
    if not 1 <= rows.shape[1] <= MAX_PAYLOAD:
        raise ValueError(f"payload must have 1..{MAX_PAYLOAD} channels")
    p = gid_sorted.shape[0]
    if perm is None:
        if rows.shape[0] != p:
            raise ValueError("payload rows and gid_sorted differ in length")
    elif perm.dtype != torch.int64 or perm.shape != (p,):
        raise ValueError("perm must be (P,) int64")
    tensors = [gid_sorted, rows] + ([perm] if perm is not None else [])
    if any(x.device != rows.device for x in tensors):
        raise ValueError("segment_reduce_sorted: inputs on different devices")
    if rows.device.type == "cpu":
        return segment_reduce_plain(gid_sorted, rows, n_out, perm)
    if rows.device.type != "cuda":
        raise ValueError(f"segment_reduce_sorted: unsupported device {rows.device}")
    if rows.stride(1) != 1 or not gid_sorted.is_contiguous() or (
            perm is not None and not perm.is_contiguous()):
        raise ValueError("segment_reduce_sorted: ids, perm and each payload "
                         "row must be contiguous")
    if max(p, n_out) >= 2**31:
        raise ValueError("segment_reduce_sorted: sizes must fit int32")
    n_pay = rows.shape[1]
    out = torch.empty((n_out, n_pay), dtype=torch.float32, device=rows.device)
    bounds = torch.zeros((2, n_out), dtype=torch.int32, device=rows.device)
    lib = _build.load("segreduce")
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sage3d_segment_reduce(
            gid_sorted.data_ptr(), perm.data_ptr() if perm is not None else None,
            rows.data_ptr(), bounds[0].data_ptr(), bounds[1].data_ptr(),
            out.data_ptr(), p, rows.shape[0], rows.stride(0), n_pay, n_out,
            stream)
    _build.check(err, "segment_reduce_sorted")
    segment_reduce_sorted.launches += 1
    return out


segment_reduce_sorted.launches = 0
