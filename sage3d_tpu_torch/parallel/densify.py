"""Adaptive density control for 3DGS scene optimization (split/clone/prune).

PyTorch counterpart of ``sage3d_tpu/parallel/densify.py``. Classic 3DGS
training interleaves gradient steps with density control: Gaussians whose
positional gradients stay large are under-reconstructing and get CLONED
(small ones) or SPLIT (large ones); Gaussians whose opacity decays below a
floor are PRUNED. The design is the JAX module's:

  * FIXED CAPACITY: the parameter tensors are allocated once at capacity N.
    Dead slots are "parked" (opacity logit -> DEAD_LOGIT, means -> +1e6) so
    projection frustum-culls them; aliveness is derived from the opacity
    logit alone.
  * A round ranks split/clone candidates by their mean gradient score
    (descending) and free slots (index order), both with stable sorts, and
    writes candidate k into free slot k, for k below the number of
    candidates, of free slots and the per-round cap.
  * Optimizer moments of overwritten rows are zeroed.

What differs from the JAX module, because a PyTorch optimizer holds its
parameter tensors (``parallel/train.py``'s ``TrainState``):

  * ``densify_prune``, ``reset_opacity`` and ``zero_opacity_moments`` write
    into the SAME tensors, in place (returning new ones would orphan Adam's
    ``state[p]``). ``densify_prune`` zeroes ``exp_avg`` and ``exp_avg_sq``
    (every float row-shaped entry) of each parameter at the written rows and
    leaves Adam's ``step`` alone, as the JAX module keeps optax's count.
  * The number of new rows is read on the host once a round (one sync); the
    JAX module writes every row through ``mode="drop"`` scatters instead.
  * The split noise is drawn from a ``torch.Generator`` on the CPU, in one
    ``torch.randn((N, 3))`` call, and moved to the device, so one seed gives
    the same offspring on the card and on the CPU.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from ..ops.projection import quat_to_rotmat

DEAD_LOGIT = -20.0     # parked slots: sigmoid(-20) ~ 2e-9 -> culled
PARK_POS = 1.0e6       # parked means: far outside every frustum
SPLIT_SHRINK = 1.6     # classic 3DGS: split halves shrink scales by 1.6x


class DensifyConfig(NamedTuple):
    grad_threshold: float = 2e-4   # mean positional-grad norm that triggers
    split_scale: float = 0.05      # world-space scale above which split > clone
    prune_opacity: float = 0.005   # alpha floor; below -> prune
    max_new_fraction: float = 0.1  # cap on new Gaussians per round (of N)


class DensifyState(NamedTuple):
    grad_accum: torch.Tensor   # (N,) summed positional-gradient norms
    n_steps: int               # steps accumulated


def init_densify_state(n: int, device=None) -> DensifyState:
    from ..renderer.scene import resolve_device
    return DensifyState(grad_accum=torch.zeros(
        (n,), dtype=torch.float32, device=resolve_device(device)), n_steps=0)


def accumulate(state: DensifyState, mean_grads: torch.Tensor) -> DensifyState:
    """Fold one step's means-gradient (N, 3) into the running score."""
    norm = torch.linalg.vector_norm(mean_grads, dim=-1)
    return DensifyState(grad_accum=state.grad_accum + norm,
                        n_steps=state.n_steps + 1)


def alive_mask(opacity_logits: torch.Tensor) -> torch.Tensor:
    return opacity_logits > (DEAD_LOGIT + 1.0)


def _zero_moment_rows(opt_state, rows: torch.Tensor) -> None:
    """Zero the rows where ``rows`` (N,) is true in every float N-major
    entry of every parameter's optimizer state; scalars such as Adam's
    ``step`` stay."""
    n = rows.shape[0]
    for group in opt_state.param_groups:
        for p in group["params"]:
            for v in opt_state.state.get(p, {}).values():
                if (torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] == n
                        and v.is_floating_point()):
                    v.masked_fill_(rows.view((n,) + (1,) * (v.dim() - 1)),
                                   0.0)


@torch.no_grad()
def densify_prune(params: Dict[str, torch.Tensor], state: DensifyState,
                  generator: Optional[torch.Generator] = None,
                  config: DensifyConfig = DensifyConfig(),
                  opt_state: Optional[torch.optim.Optimizer] = None,
                  semantic_ids: Optional[torch.Tensor] = None):
    """One density-control round. Returns (params, state, opt_state,
    semantic_ids, info).

    ``params`` (means, log_scales, quats, opacity_logits, sh) and
    ``opt_state`` are written in place and returned; ``semantic_ids`` is
    returned as a new tensor; ``state`` is returned reset. ``info`` holds the
    round's counters as int tensors on the device: n_alive, n_pruned, n_new,
    n_split, n_clone. ``generator`` (a CPU ``torch.Generator``) draws the
    split noise."""
    ol = params["opacity_logits"]
    n, dev = ol.shape[0], ol.device
    alive = alive_mask(ol)
    prune = alive & (torch.sigmoid(ol) < config.prune_opacity)
    alive2 = alive & ~prune

    avg = state.grad_accum / float(max(state.n_steps, 1))
    cand = alive2 & (avg > config.grad_threshold)

    # Rank candidates by score (desc) and free slots (index order); the k-th
    # candidate is written into the k-th free slot.
    cand_order = torch.argsort(torch.where(cand, -avg, math.inf), stable=True)
    free = ~alive2
    free_order = torch.argsort(free.logical_not().to(torch.int32),
                               stable=True)
    m_max = max(int(config.max_new_fraction * n), 1)
    n_new_t = torch.clamp(torch.minimum(cand.sum(), free.sum()), max=m_max)
    n_new = int(n_new_t)                      # the round's one host sync
    src, dst = cand_order[:n_new], free_order[:n_new]

    eps = torch.randn((n, 3), generator=generator,
                      dtype=torch.float32)[:n_new].to(dev)
    scales = torch.exp(params["log_scales"])
    split_src = (torch.amax(scales, dim=-1) > config.split_scale)[src]
    # Split offspring sample from the source Gaussian N(mu, Sigma): rotate an
    # axis-aligned draw by the source orientation. Clones stay in place (the
    # optimizer separates them), matching the CUDA reference behavior.
    R = quat_to_rotmat(params["quats"][src])
    offset = torch.einsum("nij,nj->ni", R, eps * scales[src])
    new_means = params["means"][src] + torch.where(split_src[:, None],
                                                   offset, 0.0)
    shrink = torch.where(split_src[:, None],
                         torch.tensor(SPLIT_SHRINK, device=dev).log(), 0.0)
    new_logsc = params["log_scales"][src] - shrink

    written = torch.zeros_like(prune).index_fill_(0, dst, True)
    parked = prune & ~written
    params["means"].index_copy_(0, dst, new_means)
    params["log_scales"].index_copy_(0, dst, new_logsc)
    params["quats"].index_copy_(0, dst, params["quats"][src])
    params["sh"].index_copy_(0, dst, params["sh"][src])
    ol.index_copy_(0, dst, ol[src])
    # Split sources shrink too (the two halves replace the parent); a clone
    # source gets its own row back unchanged.
    params["log_scales"].index_copy_(0, src, new_logsc)
    # Park pruned slots that were not overwritten.
    ol.masked_fill_(parked, DEAD_LOGIT)
    params["means"].masked_fill_(parked[:, None], PARK_POS)

    if opt_state is not None:
        # the rows written: every dst and the split sources (src and dst
        # are disjoint: candidates are alive, free slots are not)
        rows = written.index_copy(0, src, split_src)
        _zero_moment_rows(opt_state, rows)
    if semantic_ids is not None:
        semantic_ids = semantic_ids.clone()
        semantic_ids.index_copy_(0, dst, semantic_ids[src])
        semantic_ids.masked_fill_(parked, -1)

    n_split = split_src.sum()
    info = {
        "n_alive": alive_mask(ol).sum(),
        "n_pruned": prune.sum(),
        "n_new": n_new_t,
        "n_split": n_split,
        "n_clone": n_new_t - n_split,
    }
    return params, init_densify_state(n, dev), opt_state, semantic_ids, info


@torch.no_grad()
def zero_opacity_moments(opt_state: torch.optim.Optimizer):
    """Zero the optimizer moments of the ``opacity_logits`` parameter, in
    place.

    Companion to `reset_opacity`: clamping the logits while Adam's first and
    second moments for them survive lets accumulated momentum push opacities
    straight back up after the reset; classic 3DGS zeroes the state too. The
    parameter is the one in the param group named ``opacity_logits``, as
    both ``make_optimizer`` and ``make_group_optimizer`` name their groups.
    Every float entry of its state with at least one dimension is zeroed;
    ``step`` stays (torch-3DGS resets exp_avg/exp_avg_sq and keeps it)."""
    groups = [g for g in opt_state.param_groups
              if g.get("name") == "opacity_logits"]
    if not groups:
        raise ValueError("the optimizer has no param group named "
                         "'opacity_logits'")
    for group in groups:
        for p in group["params"]:
            for v in opt_state.state.get(p, {}).values():
                if torch.is_tensor(v) and v.dim() >= 1 and \
                        v.is_floating_point():
                    v.zero_()
    return opt_state


@torch.no_grad()
def reset_opacity(params: Dict[str, torch.Tensor],
                  max_opacity: float = 0.01) -> Dict[str, torch.Tensor]:
    """Classic periodic opacity clamp: cap every LIVE Gaussian's opacity so
    pruning can reclaim floaters that stopped contributing. In place."""
    ol = params["opacity_logits"]
    cap = torch.tensor(max_opacity / (1.0 - max_opacity),
                       dtype=torch.float32, device=ol.device).log()
    ol.copy_(torch.where(alive_mask(ol), torch.minimum(ol, cap), ol))
    return params
