"""Segment sum of id-sorted rows, on the hand-written CUDA kernel K4.

PyTorch counterpart of ``sage3d_tpu/ops/segreduce.py``. The backward of the
tile compositor routes per-pair gradient rows back to the Gaussians: after a
sort groups the rows by Gaussian id, ``out[g] = Σ rows whose id is g``.

The kernel is ``csrc/segreduce.cu``: one thread per sorted row; the first row
of each segment sums a segment of at most ``SHORT`` rows alone, serially in
row order, and a longer segment is summed by its warp, lane ``l`` adding the
rows ``begin + l, begin + l + 32, ...`` in order, then an xor butterfly over
the 32 lane partials. Exact f32 (no tensor cores, so no TF32) and
deterministic (no atomics). ``segment_reduce_plain`` is its plain PyTorch
version, in the same order of additions; ``segment_reduce_sorted`` takes it
only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from . import _build

MAX_PAYLOAD = 15   # payload channels a row may carry (the JAX kernel's NROWS-1)
LANES = 32         # lanes of a warp: the kernel's partial sums of a long segment
SHORT = 32         # the longest segment the kernel sums serially, in one thread


def _as_rows(payload: Union[torch.Tensor, Sequence[torch.Tensor]]) -> torch.Tensor:
    if isinstance(payload, torch.Tensor):
        return payload
    return torch.stack(list(payload), dim=1)


def segment_reduce_plain(gid_sorted: torch.Tensor, payload: torch.Tensor,
                         n_out: int, perm: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Plain PyTorch version of K4, in the kernel's order of additions, so
    the sums are the kernel's bit for bit. A segment of at most ``SHORT``
    rows is summed serially in row order, starting from zero. In a longer
    one, row ``r`` (counted from the segment's start) goes to lane
    ``r % 32`` as its ``r // 32``-th term, each lane sums its terms in that
    order from zero, and the lanes are summed by halving (what the xor
    butterfly leaves in every lane). Ids no row names are zero. Each rank of
    terms is one gather, add and scatter (its keys are distinct), with plain
    adds: float atomics on the card (``index_add_``) would flush subnormal
    sums to zero, where the kernel's adds keep them."""
    rows = payload if perm is None else payload[perm]
    dev = rows.device
    n_pay = rows.shape[1]
    ids = gid_sorted.long()
    ok = (ids >= 0) & (ids < n_out)
    ids_c = torch.clamp(ids, 0, max(n_out - 1, 0))
    first = torch.searchsorted(ids, ids_c)
    rel = torch.arange(ids.shape[0], device=dev) - first
    short = torch.searchsorted(ids, ids_c, right=True) - first <= SHORT
    key = ids_c * LANES + torch.where(short, 0, rel % LANES)
    term = torch.where(short, rel, rel // LANES)
    part = torch.zeros((n_out * LANES, n_pay), dtype=torch.float32, device=dev)
    live = torch.nonzero(ok).squeeze(1)
    if live.numel():
        live = live[torch.argsort(term[live], stable=True)]
        pos = 0
        for n in torch.bincount(term[live]).tolist():
            k = key[live[pos:pos + n]]
            part[k] = part[k] + rows[live[pos:pos + n]]
            pos += n
    v = part.view(n_out, LANES, n_pay)
    serial = v[:, 0]
    half = LANES // 2
    while half:
        v = v[:, :half] + v[:, half:2 * half]
        half //= 2
    is_long = torch.zeros((n_out,), dtype=torch.bool, device=dev)
    is_long[ids_c[ok & ~short]] = True
    return torch.where(is_long[:, None], v[:, 0], serial)


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
    dev = rows.device
    if gid_sorted.device != dev or (perm is not None and perm.device != dev):
        raise ValueError("segment_reduce_sorted: inputs on different devices")
    if dev.type == "cpu":
        return segment_reduce_plain(gid_sorted, rows, n_out, perm)
    if dev.type != "cuda":
        raise ValueError(f"segment_reduce_sorted: unsupported device {dev}")
    if rows.stride(1) != 1 or not gid_sorted.is_contiguous() or (
            perm is not None and not perm.is_contiguous()):
        raise ValueError("segment_reduce_sorted: ids, perm and each payload "
                         "row must be contiguous")
    if max(p, n_out) >= 2**31:
        raise ValueError("segment_reduce_sorted: sizes must fit int32")
    n_pay = rows.shape[1]
    out = torch.empty((n_out, n_pay), dtype=torch.float32, device=dev)
    err = _build.launch(
        _build.load("segreduce").sage3d_segment_reduce, dev,
        gid_sorted.data_ptr(), perm.data_ptr() if perm is not None else None,
        rows.data_ptr(), out.data_ptr(), p, rows.shape[0], rows.stride(0),
        n_pay, n_out)
    _build.check(err, "segment_reduce_sorted")
    segment_reduce_sorted.launches += 1
    return out


segment_reduce_sorted.launches = 0
