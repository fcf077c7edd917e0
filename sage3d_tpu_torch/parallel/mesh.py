"""Process meshes on ``torch.distributed``: the collectives of the sharded
render and the sharded train step.

PyTorch counterpart of ``sage3d_tpu/parallel/mesh.py``. The JAX package is
SPMD over a ``jax.sharding.Mesh`` of devices; here one process drives each
rank, and a ``Mesh`` is a grid over the ranks of the default process group:

  * axis "data": camera/episode batch parallelism (rows of the batch split
    across the axis);
  * axis "tile": image rows split into bands, and the Gaussian parameters
    and Adam moments split into row shards on the same axis (all-gathered
    for the render, gradients reduce-scattered back).

Ranks are laid out in row-major order over the shape: on a (data, tile)
mesh, rank ``d * n_tile + t`` sits at data index ``d`` and tile index ``t``.
Each axis has one ``dist.new_group`` per line of ranks along it; every rank
creates all of them in the same order, as ``torch.distributed`` requires.

Every collective of the port goes through the helpers below (``all_gather``,
``reduce_scatter``, ``all_reduce``, ``broadcast``), which count each call in
the mesh's ``CollectiveCounter`` by kind, axis, tag and bytes; ``audit.py``
reads it. With the recorder on (``utils/profiling.py``) each is also a span
``mesh.<kind>`` counting ``mesh.bytes`` and ``mesh.link_bytes``. A one-rank mesh needs no process group: its collectives are
identities that still count.

The transport is NCCL when every rank has a card of its own, else gloo
(ranks that share a card, or ranks on the CPU). gloo takes CUDA tensors for
every collective used here (all-gather, reduce-scatter, all-reduce,
broadcast; checked on the H100 machine's torch 2.11) and moves them through
the host itself, so no helper stages a tensor.

``spawn_mesh`` runs a function on every rank of a new mesh, one process per
rank (the ``spawn`` start method), and returns rank 0's result.
"""

from __future__ import annotations

import math
import multiprocessing.connection
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..renderer.scene import resolve_device
from ..utils.profiling import count as add_count, span

AXES = ("data", "tile")
TIMEOUT_S = 300.0       # a collective, a rendezvous, a spawned mesh


class CollectiveCounter:
    """The collectives a mesh issued: one record per call, with its kind,
    axis, tag, the bytes of its result on this rank, and (while ``timed``
    is set) its milliseconds, the device synchronized before and after it
    (so they include waiting for the slowest rank)."""

    def __init__(self):
        self.records: List[dict] = []
        self.timed = False

    def reset(self) -> None:
        self.records.clear()

    def counts(self, apart: Sequence[str] = ()) -> Dict[str, int]:
        """Calls by kind; those tagged with a tag in ``apart`` under
        ``<tag>_<kind>`` (``apart=("loss",)``: the loss's all-reduce as
        ``loss_all_reduce``)."""
        out: Dict[str, int] = {}
        for r in self.records:
            key = (f"{r['tag']}_{r['kind']}" if r["tag"] in apart
                   else r["kind"])
            out[key] = out.get(key, 0) + 1
        return out

    def summary(self, tag: Optional[str] = None) -> Dict[str, dict]:
        """The records (of ``tag``, or all) by kind: count, result bytes and
        milliseconds (None where not timed)."""
        out: Dict[str, dict] = {}
        for r in self.records:
            if tag is not None and r["tag"] != tag:
                continue
            k = out.setdefault(r["kind"], {"count": 0, "bytes": 0, "ms": 0.0})
            k["count"] += 1
            k["bytes"] += r["bytes"]
            k["ms"] = None if r["ms"] is None or k["ms"] is None \
                else k["ms"] + r["ms"]
        return out


class Mesh:
    """A grid over the ranks of the default process group (or over one
    rank without a group). ``shape`` maps axis names to sizes, in order."""

    def __init__(self, shape: Dict[str, int], rank: int, device: torch.device,
                 groups: Dict[Optional[str], object], transport: str):
        self.shape = dict(shape)
        self.rank = rank
        self.device = device
        self.transport = transport      # "none" (one rank), "gloo" or "nccl"
        self.counter = CollectiveCounter()
        self._groups = groups

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        sizes = list(self.shape.values())
        return int(np.unravel_index(self.rank, sizes)[
            self.axis_names.index(axis)])

    def axis_size(self, axis: Optional[str]) -> int:
        return self.size if axis is None else self.shape[axis]

    def group(self, axis: Optional[str]):
        """The process group of this rank's line along ``axis`` (None: every
        rank); None without a process group."""
        return self._groups.get(axis)

    def barrier(self) -> None:
        if self.transport == "nccl":
            dist.barrier(device_ids=[self.device.index])
        elif self.transport == "gloo":
            dist.barrier()

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"transport={self.transport})")


def _rank_device(rank: int, world_size: int, device) -> tuple:
    """(this rank's device, whether every rank has a card of its own)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev, False
    n_cards = torch.cuda.device_count()
    index = rank % n_cards if dev.index is None else dev.index
    return torch.device("cuda", index), world_size <= n_cards


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           backend: Optional[str] = None, device=None,
                           timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join the default process group as ``rank`` of ``world_size`` and
    return this rank's device (``device=None``: the card; rank r takes card
    r mod the card count).

    ``backend=None`` takes ``nccl`` when every rank has a card of its own
    and ``gloo`` when ranks share a card or run on the CPU; ``nccl`` asked
    for ranks that share a card raises (NCCL refuses two ranks on one
    device). Every collective of the group fails after ``timeout_s``."""
    dev, own_card = _rank_device(rank, world_size, device)
    chosen = backend or ("nccl" if own_card else "gloo")
    if chosen == "nccl" and not own_card:
        raise ValueError(
            f"nccl needs a card per rank: {world_size} ranks on "
            f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} "
            "card(s); use gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    why = ("a card per rank" if own_card else
           f"{world_size} ranks share {torch.cuda.device_count()} card(s)"
           if dev.type == "cuda" else "CPU ranks")
    print(f"[mesh] rank {rank}/{world_size}: {chosen} on {dev} ({why})",
          file=sys.stderr, flush=True)
    dist.init_process_group(chosen, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))
    return dev


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = AXES, device=None,
              timeout_s: float = TIMEOUT_S) -> Mesh:
    """A mesh over the default process group's ranks, or over this process
    alone when there is no group. Default shape: every rank on the last axis
    (``(1, world_size)``: band parallelism), as in the JAX package. Inside a
    group the shape must cover every rank; outside one it must be a single
    rank (``spawn_mesh`` starts the ranks of a larger one)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (world,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} for axes {tuple(axis_names)}")
    if math.prod(shape) != world:
        hint = ("; run it under spawn_mesh (or initialize_distributed in "
                "each process)") if world == 1 else ""
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks, the process group has {world}{hint}")
    dev, _ = _rank_device(rank, world, device)
    named = dict(zip(axis_names, shape))
    if not dist.is_initialized():
        return Mesh(named, 0, dev, {}, "none")
    ranks = np.arange(world).reshape(shape)
    groups: Dict[Optional[str], object] = {None: dist.group.WORLD}
    timeout = timedelta(seconds=timeout_s)
    for i, axis in enumerate(axis_names):
        lines = np.moveaxis(ranks, i, -1).reshape(-1, shape[i])
        for line in lines:      # every rank creates every group, in order
            g = dist.new_group([int(r) for r in line], timeout=timeout)
            if rank in line:
                groups[axis] = g
    return Mesh(named, rank, dev, groups, dist.get_backend())


# --- collectives ------------------------------------------------------------

def link_bytes(kind: str, n: int, result_bytes: int,
               receives: bool = True) -> int:
    """The least bytes that must enter a rank over its links for one
    collective among ``n`` ranks whose result on the rank is
    ``result_bytes``: an all-gather brings in the other ranks' (n - 1) / n
    of it, a reduce-scatter and an all-reduce at least the others' sum
    (the result's size), a broadcast its size where the rank is not the
    source. 0 on one rank."""
    if n <= 1 or not receives:
        return 0
    if kind == "all_gather":
        return result_bytes * (n - 1) // n
    return result_bytes


def _collective(mesh: Mesh, kind: str, axis: Optional[str], tag: str,
                call, result_bytes: int, receives: bool = True) -> None:
    """Run ``call(group)`` on ``axis``'s group (no group on a one-rank
    mesh) and count it: in the mesh's counter, and on the recorder as the
    span ``mesh.<kind>`` with the counters ``mesh.bytes`` (the result's
    bytes) and ``mesh.link_bytes`` (``link_bytes``)."""
    timed = mesh.counter.timed
    on_card = mesh.device.type == "cuda"
    if timed and on_card:
        torch.cuda.synchronize(mesh.device)
    n = mesh.axis_size(axis) if mesh.transport != "none" else 1
    with span(f"mesh.{kind}"):
        add_count("mesh.bytes", result_bytes)
        add_count("mesh.link_bytes",
                  link_bytes(kind, n, result_bytes, receives))
        t0 = time.perf_counter()
        call(mesh.group(axis))
        ms = None
        if timed:
            if on_card:
                torch.cuda.synchronize(mesh.device)
            ms = (time.perf_counter() - t0) * 1e3
    mesh.counter.records.append({"kind": kind, "axis": axis, "tag": tag,
                                 "bytes": result_bytes, "ms": ms})


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def gather_into(parts: List[torch.Tensor], x: torch.Tensor, mesh: Mesh,
                axis: Optional[str], tag: str = "") -> None:
    """``parts[r]`` receives the ``x`` of rank r along ``axis`` (in place)."""
    def call(group):
        if mesh.transport == "none":
            parts[0].copy_(x)
        else:
            dist.all_gather(parts, x, group=group)
    _collective(mesh, "all_gather", axis, tag, call,
                sum(_nbytes(p) for p in parts))


def all_gather(x: torch.Tensor, mesh: Mesh, axis: Optional[str],
               tag: str = "") -> torch.Tensor:
    """Every rank's ``x`` along ``axis`` concatenated on dim 0, in rank
    order (``jax.lax.all_gather(..., tiled=True)``). Not differentiable:
    ``train.all_gather_bucketed`` is."""
    n = mesh.axis_size(axis)
    out = x.new_empty((n,) + tuple(x.shape))
    gather_into(list(out.unbind(0)), x.contiguous(), mesh, axis, tag)
    return out.reshape((n * x.shape[0],) + tuple(x.shape[1:]))


def reduce_scatter_into(out: torch.Tensor, parts: List[torch.Tensor],
                        mesh: Mesh, axis: Optional[str],
                        tag: str = "") -> None:
    """``out`` receives the sum over the ranks along ``axis`` of their
    ``parts[i]``, i this rank's index (``jax.lax.psum_scatter``)."""
    def call(group):
        if mesh.transport == "none":
            out.copy_(parts[0])
        else:
            dist.reduce_scatter(out, parts, group=group)
    _collective(mesh, "reduce_scatter", axis, tag, call, _nbytes(out))


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: Optional[str],
               tag: str = "") -> torch.Tensor:
    """Sum ``x`` over the ranks along ``axis`` (None: every rank), in
    place; returns ``x``. Every rank receives the same bits."""
    def call(group):
        if mesh.transport != "none":
            dist.all_reduce(x, group=group)
    _collective(mesh, "all_reduce", axis, tag, call, _nbytes(x))
    return x


def broadcast(x: torch.Tensor, mesh: Mesh, src: int = 0,
              tag: str = "") -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank (in place); returns ``x``."""
    def call(group):
        if mesh.transport != "none":
            dist.broadcast(x, src, group=group)
    _collective(mesh, "broadcast", None, tag, call, _nbytes(x),
                receives=mesh.rank != src)
    return x


# --- batches and shards -----------------------------------------------------

def _map_tensors(fn, x):
    """``fn`` applied to ``x`` if it is a tensor, else to each tensor field
    of a NamedTuple (a Camera, a scene) or value of a dict."""
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_map_tensors(fn, v) for v in x])
    if isinstance(x, dict):
        return {k: _map_tensors(fn, v) for k, v in x.items()}
    return x


def shard_rows(x, mesh: Optional[Mesh], axis: str):
    """This rank's block of rows of a global tensor (or of each tensor of a
    Camera batch, a scene, a dict) split evenly over ``axis``: what the JAX
    package's ``P(axis)`` sharding gives a device. The identity where the
    axis has one rank or there is no mesh."""
    if mesh is None or mesh.shape[axis] == 1:
        return x
    n, i = mesh.shape[axis], mesh.axis_index(axis)

    def block(t):
        if t.dim() == 0 or t.shape[0] % n:
            raise ValueError(f"shard_rows: {tuple(t.shape)} rows do not "
                             f"split over {n} ranks of axis {axis!r}")
        s = t.shape[0] // n
        return t[i * s:(i + 1) * s]
    return _map_tensors(block, x)


def process_local_episodes(episodes: Sequence,
                           process_index: Optional[int] = None,
                           process_count: Optional[int] = None) -> list:
    """This process's slice of a global episode/scene list (round-robin).

    The multi-host replacement for the reference's ``hash(scene_id) %
    total_instances == instance_id`` process sharding: each process loads
    only its own episodes, and tensors built from them enter the mesh via
    ``global_batch_from_local``. The defaults are this rank and the world
    size (0 and 1 without a process group)."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    if process_count is None:
        process_count = dist.get_world_size() if dist.is_initialized() else 1
    return list(episodes[process_index::process_count])


def global_batch_from_local(mesh: Mesh, local, axis: str = "data"):
    """This rank's own rows of a batch sharded on ``axis``, on the mesh's
    device (a tensor, an array, or a NamedTuple of them such as a Camera
    batch). Each rank holds only its rows, as the addressable shard of the
    JAX package's global array; every rank along ``axis`` must hold the
    same count, which is checked with one gather of the counts."""
    if isinstance(local, np.ndarray):
        local = torch.from_numpy(np.ascontiguousarray(local))
    rows = []

    def to_device(t):
        rows.append(t.shape[0])
        return t.to(mesh.device)

    local = _map_tensors(to_device, local)
    count = torch.tensor(rows[:1], dtype=torch.int64, device=mesh.device)
    counts = all_gather(count, mesh, axis, tag="batch").tolist()
    if len(set(counts)) != 1:
        raise ValueError(f"global_batch_from_local: ranks along {axis!r} "
                         f"hold {counts} rows; they must hold the same count")
    return local


# --- spawning the ranks of a mesh -------------------------------------------

class _Array(NamedTuple):
    """A tensor crossing the process boundary, as numpy."""
    data: np.ndarray


def _pack(obj):
    if torch.is_tensor(obj):
        return _Array(obj.detach().cpu().numpy())
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_pack(v) for v in obj])
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    return obj


def _unpack(obj, device):
    if isinstance(obj, _Array):
        return torch.from_numpy(obj.data).to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_unpack(v, device) for v in obj])
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: _unpack(v, device) for k, v in obj.items()}
    return obj


def _rank_main(fn, shape, rank, world, init_method, backend, device,
               args_path, conn, log_path, timeout_s, threads) -> None:
    """One spawned rank: its arguments come from ``args_path``, its output
    goes to ``log_path``, its result (rank 0's) or its traceback goes back
    through ``conn``."""
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    os.dup2(fd, 1)
    os.dup2(fd, 2)
    os.close(fd)
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = initialize_distributed(init_method, world, rank, backend,
                                     device, timeout_s)
        mesh = make_mesh(shape, device=dev, timeout_s=timeout_s)
        with open(args_path, "rb") as f:
            args = pickle.load(f)       # written by spawn_mesh
        result = fn(*_unpack(args, dev), mesh=mesh)
        conn.send(("ok", _pack(result) if rank == 0 else None))
    except BaseException:       # reported to the parent, which raises it
        conn.send(("error", traceback.format_exc()))
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)             # peers may hang in a collective: no teardown
    dist.destroy_process_group()
    conn.close()


def _read(path: str) -> str:
    """A rank's output so far ('' before the rank opened it)."""
    try:
        with open(path, errors="replace") as f:
            return f.read()
    except FileNotFoundError:
        return ""


def spawn_mesh(fn, shape: Sequence[int], *args, device=None,
               backend: Optional[str] = None, timeout_s: float = TIMEOUT_S):
    """Run ``fn(*args, mesh=mesh)`` on every rank of a new mesh of ``shape``,
    one process per rank (``spawn`` start method, a ``file://`` rendezvous in
    a fresh temporary directory), and return rank 0's result.

    ``fn`` must be importable by the spawned processes (a module-level
    function or a ``functools.partial`` of one). Tensors in ``args`` and in
    the result cross the process boundary as numpy: each rank receives
    ``args`` on its own device, the caller receives the result on
    ``device`` (None: the card). ``backend`` as in
    ``initialize_distributed``. A rank that fails, or a mesh that has not
    finished after ``timeout_s``, stops every rank and raises with that
    rank's traceback and output; rank 0's output is written to this
    process's stdout after a run that succeeds."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    world = math.prod(shape)
    threads = 1 if dev.type == "cpu" else 0    # CPU ranks share the cores
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="sage3d_mesh_")
    init = f"file://{tmp}/rendezvous"
    # The arguments go through a file: a rank that dies while starting up
    # would leave a large write into its start-up pipe blocked for good.
    args_path = os.path.join(tmp, "args.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(_pack(args), f)
    procs, conns = [], []
    try:
        for rank in range(world):
            recv, send = ctx.Pipe(duplex=False)
            p = ctx.Process(
                target=_rank_main,
                args=(fn, shape, rank, world, init, backend, str(dev),
                      args_path, send, os.path.join(tmp, f"rank{rank}.log"),
                      timeout_s, threads))
            p.start()
            send.close()
            procs.append(p)
            conns.append(recv)
        results, failure = {}, None
        pending = set(range(world))
        deadline = time.monotonic() + timeout_s
        while pending and failure is None:
            # a rank that dies before it unpickles its pipe leaves it open:
            # its process's sentinel reports it
            ready = multiprocessing.connection.wait(
                [conns[r] for r in pending]
                + [procs[r].sentinel for r in pending],
                timeout=max(0.0, deadline - time.monotonic()))
            if not ready:
                failure = (min(pending), f"no result after {timeout_s:.0f} s")
            for rank in sorted(pending):
                if failure is not None:
                    break
                if conns[rank].poll():
                    pending.discard(rank)
                    try:
                        status, payload = conns[rank].recv()
                    except EOFError:
                        status, payload = "error", (
                            f"exited with code {procs[rank].exitcode} and "
                            "no result")
                    if status == "ok":
                        results[rank] = payload
                    else:
                        failure = (rank, payload)
                elif procs[rank].exitcode is not None:
                    failure = (rank, f"exited with code "
                               f"{procs[rank].exitcode} and no result")
        if failure is not None:
            for p in procs:
                p.kill()
            rank, what = failure
            tail = _read(os.path.join(tmp, f"rank{rank}.log"))[-4000:]
            raise RuntimeError(f"spawn_mesh {shape}: rank {rank} failed: "
                               f"{what}\n--- rank {rank} output ---\n{tail}")
        for p in procs:
            p.join(timeout=30)
        sys.stdout.write(_read(os.path.join(tmp, "rank0.log")))
        return _unpack(results[0], dev)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=5)
        shutil.rmtree(tmp, ignore_errors=True)
