"""The port's adaptive density control against the JAX package's.

Counterparts of tests/test_densify.py (all but the tile-mesh run, which
needs the sharded train step), on the port's in-place design: the rows are
written into the tensors the torch Adam holds, whose moment rows are zeroed
there. ``densify_prune`` is held to the JAX function on the same inputs:
without splits every row, counter and parked slot is equal; with splits
everything but the offspring means is equal, and those equal the JAX
formula (``quat_to_rotmat`` and the einsum) on the port's own noise within
1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sage3d_tpu.ops.projection import quat_to_rotmat as jquat_to_rotmat
from sage3d_tpu.parallel import densify as jd
from sage3d_tpu_torch.parallel.densify import (DEAD_LOGIT, SPLIT_SHRINK,
                                               DensifyConfig, DensifyState,
                                               accumulate, alive_mask,
                                               densify_prune,
                                               init_densify_state,
                                               reset_opacity,
                                               zero_opacity_moments)

KEYS = ("means", "log_scales", "quats", "opacity_logits", "sh")


def make_params(n=16, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "means": torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32)),
        "log_scales": torch.full((n, 3), float(np.log(0.02)),
                                 dtype=torch.float32),
        "quats": torch.tensor([1.0, 0, 0, 0]).repeat(n, 1),
        "opacity_logits": torch.full((n,), 1.0),
        "sh": torch.from_numpy(rng.uniform(-1, 1, (n, 1, 3)).astype(np.float32)),
    }


def _state(n, grads):
    return accumulate(init_densify_state(n, device="cpu"), grads)


def test_prune_parks_low_opacity():
    p = make_params(8)
    p["opacity_logits"][3] = -12.0          # alpha ~ 6e-6
    out, _, _, _, info = densify_prune(p, _state(8, torch.zeros(8, 3)),
                                       torch.Generator().manual_seed(0))
    assert out is p                          # written in place
    assert int(info["n_pruned"]) == 1
    assert float(out["opacity_logits"][3]) == DEAD_LOGIT
    assert float(out["means"][3, 0]) > 1e5
    assert int(info["n_alive"]) == 7


def test_clone_into_free_slots():
    n = 8
    p = make_params(n)
    p["opacity_logits"][5:] = DEAD_LOGIT
    orig = {k: v.clone() for k, v in p.items()}
    g = torch.zeros(n, 3)
    g[0, 0] = 1.0
    out, st2, _, _, info = densify_prune(p, _state(n, g),
                                         torch.Generator().manual_seed(0))
    assert int(info["n_new"]) == 1 and int(info["n_clone"]) == 1
    assert int(info["n_alive"]) == 6
    assert torch.equal(out["means"][5], orig["means"][0])
    assert torch.equal(out["log_scales"][5], orig["log_scales"][0])
    assert float(out["opacity_logits"][5]) == float(orig["opacity_logits"][0])
    assert float(st2.grad_accum.sum()) == 0.0 and st2.n_steps == 0


def test_split_shrinks_both_halves():
    n = 8
    p = make_params(n)
    p["log_scales"][2] = float(np.log(0.2))
    p["opacity_logits"][6:] = DEAD_LOGIT
    orig_mean = p["means"][2].clone()
    g = torch.zeros(n, 3)
    g[2, 1] = 1.0
    out, _, _, _, info = densify_prune(p, _state(n, g),
                                       torch.Generator().manual_seed(1))
    assert int(info["n_split"]) == 1
    want = np.log(0.2) - np.log(SPLIT_SHRINK)
    np.testing.assert_allclose(out["log_scales"][2], want, rtol=1e-6)
    np.testing.assert_allclose(out["log_scales"][6], want, rtol=1e-6)
    assert float(torch.linalg.vector_norm(out["means"][6] - orig_mean)) > 1e-4


def test_capacity_and_budget_caps():
    n = 16
    p = make_params(n)
    p["opacity_logits"][8:] = DEAD_LOGIT
    shapes = {k: v.shape for k, v in p.items()}
    cfg = DensifyConfig(max_new_fraction=2 / n)
    out, _, _, _, info = densify_prune(p, _state(n, torch.ones(n, 3)),
                                       torch.Generator().manual_seed(0), cfg)
    assert int(info["n_new"]) == 2
    for k, v in out.items():
        assert v.shape == shapes[k]


def _adam_over(params, group_lrs=False):
    from sage3d_tpu_torch.parallel.train import (init_train_state,
                                                 make_group_optimizer,
                                                 make_optimizer)
    from sage3d_tpu_torch.renderer.scene import GaussianScene
    n = params["means"].shape[0]
    scene = GaussianScene(semantic_ids=torch.arange(n, dtype=torch.int32),
                          **params)
    opt = make_group_optimizer(2.0) if group_lrs else make_optimizer(1e-3)
    return init_train_state(scene, opt)


def _fill_moments(state, value=1.0):
    """One Adam step with unit gradients, then every moment set to
    ``value`` (the JAX test's ``opt_state + 1``)."""
    for p in state.params.values():
        p.grad = torch.ones_like(p)
    state.opt_state.step()
    for st in state.opt_state.state.values():
        st["exp_avg"].fill_(value)
        st["exp_avg_sq"].fill_(value)


def test_opt_state_rows_zeroed_and_semantic_copied():
    n = 8
    p = make_params(n)
    p["opacity_logits"][5:] = DEAD_LOGIT
    state = _adam_over(p)
    _fill_moments(state)
    opt = state.opt_state
    held = [g["params"][0] for g in opt.param_groups]
    steps = [opt.state[t]["step"].clone() for t in held]
    sem = torch.arange(n, dtype=torch.int32)
    g = torch.zeros(n, 3)
    g[1, 0] = 1.0
    out, _, opt2, sem2, info = densify_prune(
        state.params, _state(n, g), torch.Generator().manual_seed(0),
        opt_state=opt, semantic_ids=sem)
    assert int(info["n_new"]) == 1
    assert opt2 is opt
    assert [g["params"][0] for g in opt.param_groups] == held  # same leaves
    assert all(out[k] is state.params[k] for k in KEYS)
    mu = opt.state[state.params["means"]]["exp_avg"]
    nu = opt.state[state.params["sh"]]["exp_avg_sq"]
    assert float(mu[5].abs().max()) == 0.0      # overwritten slot zeroed
    assert float(nu[5].abs().max()) == 0.0
    assert float(mu[1].abs().max()) == 1.0      # clone source untouched
    assert float(mu[6].abs().max()) == 1.0
    assert all(torch.equal(opt.state[t]["step"], s)
               for t, s in zip(held, steps))    # Adam's step kept
    assert int(sem2[5]) == 1 and int(sem[5]) == 5
    # the optimizer steps on the written leaves afterwards
    before = state.params["means"].detach().clone()
    for t in state.params.values():
        t.grad = torch.ones_like(t)
    opt.step()
    assert not torch.equal(state.params["means"], before)


def test_split_zeroes_the_source_moments():
    n = 8
    p = make_params(n)
    p["log_scales"][2] = float(np.log(0.2))
    p["opacity_logits"][6:] = DEAD_LOGIT
    state = _adam_over(p)
    _fill_moments(state)
    g = torch.zeros(n, 3)
    g[2, 1] = 1.0
    densify_prune(state.params, _state(n, g), torch.Generator().manual_seed(0),
                  opt_state=state.opt_state)
    mu = state.opt_state.state[state.params["quats"]]["exp_avg"]
    assert float(mu[2].abs().max()) == 0.0 and float(mu[6].abs().max()) == 0.0
    assert float(mu[0].abs().min()) == 1.0


def test_reset_opacity_caps_live_only():
    p = make_params(6)
    p["opacity_logits"][4:] = DEAD_LOGIT
    ol = p["opacity_logits"]
    out = reset_opacity(p, max_opacity=0.01)
    assert out["opacity_logits"] is ol
    assert (torch.sigmoid(ol[:4]) <= 0.0101).all()
    assert float(ol[4]) == DEAD_LOGIT
    want = jd.reset_opacity({"opacity_logits": jnp.asarray(
        np.array([1.0, -3.0, -5.0, 0.0, DEAD_LOGIT, DEAD_LOGIT],
                 np.float32))})["opacity_logits"]
    got = reset_opacity({"opacity_logits": torch.tensor(
        [1.0, -3.0, -5.0, 0.0, DEAD_LOGIT, DEAD_LOGIT])})["opacity_logits"]
    assert np.array_equal(got.numpy(), np.array(want))


@pytest.mark.parametrize("group_lrs", [False, True])
def test_zero_opacity_moments(group_lrs):
    """Both optimizers of parallel/train.py: only the opacity logits'
    moments are zeroed, every other entry and the step stay."""
    from sage3d_tpu_torch.renderer.scene import synthetic_room
    from sage3d_tpu_torch.parallel.train import scene_params
    scene = synthetic_room(64, seed=0, device="cpu")
    state = _adam_over({k: v for k, v in scene_params(scene).items()},
                       group_lrs)
    for p in state.params.values():
        p.grad = torch.ones_like(p)
    state.opt_state.step()
    opt = state.opt_state
    before = {k: {n: v.clone() for n, v in opt.state[p].items()}
              for k, p in state.params.items()}
    assert opt.state[state.params["opacity_logits"]]["exp_avg"].abs().max() > 0
    assert zero_opacity_moments(opt) is opt
    for k, p in state.params.items():
        for name, v in opt.state[p].items():
            if k == "opacity_logits" and name != "step":
                assert float(v.abs().max()) == 0.0
            else:
                assert torch.equal(v, before[k][name])


def _jax_round(params, accum, n_steps, cfg, key=0, sem=None):
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jstate = jd.DensifyState(grad_accum=jnp.asarray(accum.numpy()),
                             n_steps=jnp.asarray(n_steps, jnp.int32))
    jcfg = jd.DensifyConfig(**cfg._asdict())
    out, _, _, jsem, info = jd.densify_prune(
        jparams, jstate, jax.random.PRNGKey(key), jcfg,
        semantic_ids=None if sem is None else jnp.asarray(sem.numpy()))
    return ({k: np.array(v) for k, v in out.items()},
            {k: int(v) for k, v in info.items()},
            None if jsem is None else np.array(jsem))


def _random_round_inputs(n=64, seed=0, big=0.3):
    """Live, pruned (low opacity), dead and high-gradient slots, some with
    scales above ``big``."""
    rng = np.random.default_rng(seed)
    ol = rng.uniform(-2, 3, n).astype(np.float32)
    ol[rng.random(n) < 0.15] = -7.0                 # prune (alpha < 0.005)
    ol[rng.random(n) < 0.25] = DEAD_LOGIT           # dead slots
    params = {
        "means": rng.uniform(-2, 2, (n, 3)).astype(np.float32),
        "log_scales": np.log(rng.uniform(0.01, 2 * big, (n, 3))).astype(
            np.float32),
        "quats": rng.standard_normal((n, 4)).astype(np.float32),
        "opacity_logits": ol,
        "sh": rng.standard_normal((n, 4, 3)).astype(np.float32),
    }
    accum = (rng.random(n) * 3e-3 * 3).astype(np.float32)
    accum[rng.random(n) < 0.3] = 0.0
    sem = rng.integers(-1, 9, n).astype(np.int32)
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            torch.from_numpy(accum), torch.from_numpy(sem))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_densify_prune_equals_jax_without_splits(seed):
    params, accum, sem = _random_round_inputs(seed=seed)
    cfg = DensifyConfig(split_scale=1e3, max_new_fraction=0.2)
    want, want_info, want_sem = _jax_round(params, accum, 3, cfg, sem=sem)
    out, _, _, got_sem, info = densify_prune(
        {k: v.clone() for k, v in params.items()},
        DensifyState(accum.clone(), 3), torch.Generator().manual_seed(seed),
        cfg, semantic_ids=sem)
    assert {k: int(v) for k, v in info.items()} == want_info
    assert want_info["n_new"] > 0 and want_info["n_pruned"] > 0
    for k in KEYS:
        assert np.array_equal(out[k].numpy(), want[k]), k
    assert np.array_equal(got_sem.numpy(), want_sem)


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_densify_prune_equals_jax_with_splits(seed):
    params, accum, sem = _random_round_inputs(seed=seed)
    n = accum.shape[0]
    cfg = DensifyConfig(split_scale=0.3, max_new_fraction=0.25)
    want, want_info, want_sem = _jax_round(params, accum, 2, cfg, sem=sem)
    out, _, _, got_sem, info = densify_prune(
        {k: v.clone() for k, v in params.items()},
        DensifyState(accum.clone(), 2), torch.Generator().manual_seed(7),
        cfg, semantic_ids=sem)
    assert {k: int(v) for k, v in info.items()} == want_info
    assert want_info["n_split"] > 0 and want_info["n_clone"] > 0
    assert np.array_equal(got_sem.numpy(), want_sem)

    # the rounds' ranks, as the JAX function forms them
    ol, avg = params["opacity_logits"].numpy(), accum.numpy() / 2.0
    alive = ol > DEAD_LOGIT + 1.0
    alive2 = alive & ~(1 / (1 + np.exp(-ol)) < cfg.prune_opacity)
    cand = alive2 & (avg > cfg.grad_threshold)
    src = np.argsort(np.where(cand, -avg, np.inf), kind="stable")
    dst = np.argsort(np.where(~alive2, 0, 1), kind="stable")
    k = want_info["n_new"]
    src, dst = src[:k], dst[:k]
    scales = np.exp(params["log_scales"].numpy())
    split = scales.max(-1)[src] > cfg.split_scale
    offspring = dst[split]

    for key in KEYS:
        got, exp = out[key].numpy(), want[key]
        if key == "means":
            keep = np.ones(n, bool)
            keep[offspring] = False
            assert np.array_equal(got[keep], exp[keep])
        else:
            assert np.array_equal(got, exp), key
    # the offspring: the JAX formula on the port's noise (one randn call
    # of (N, 3) from a generator with the same seed)
    eps = torch.randn((n, 3), generator=torch.Generator().manual_seed(7)
                      ).numpy()[:k][split]
    R = np.array(jquat_to_rotmat(jnp.asarray(
        params["quats"].numpy()[src[split]])))
    mu = params["means"].numpy()[src[split]] + np.array(jnp.einsum(
        "nij,nj->ni", jnp.asarray(R), jnp.asarray(eps * scales[src[split]])))
    np.testing.assert_allclose(out["means"].numpy()[offspring], mu,
                               rtol=0, atol=1e-6)


def test_alive_mask_and_accumulate_match_jax():
    ol = np.array([DEAD_LOGIT, DEAD_LOGIT + 1.0, DEAD_LOGIT + 1.01, 0.0],
                  np.float32)
    assert np.array_equal(alive_mask(torch.from_numpy(ol)).numpy(),
                          np.array(jd.alive_mask(jnp.asarray(ol))))
    g = np.random.default_rng(0).standard_normal((10, 3)).astype(np.float32)
    st = accumulate(accumulate(init_densify_state(10, device="cpu"),
                               torch.from_numpy(g)), torch.from_numpy(g))
    jst = jd.accumulate(jd.accumulate(jd.init_densify_state(10),
                                      jnp.asarray(g)), jnp.asarray(g))
    assert st.n_steps == int(jst.n_steps) == 2
    np.testing.assert_allclose(st.grad_accum.numpy(),
                               np.array(jst.grad_accum), rtol=1e-6)


def test_fit_scene_adaptive_grows_and_improves():
    from sage3d_tpu_torch.parallel.trainer import (AdaptiveConfig,
                                                   TrainerConfig,
                                                   fit_scene_adaptive,
                                                   make_orbit_targets)
    from sage3d_tpu_torch.renderer.scene import synthetic_room

    gt = synthetic_room(600, seed=3, device="cpu")
    cameras, targets = make_orbit_targets(gt, n_views=2, radius=4.0,
                                          width=64, height=64)
    init = synthetic_room(200, seed=9, device="cpu")
    fitted, history = fit_scene_adaptive(
        init, cameras, targets,
        TrainerConfig(steps=60, lr=5e-3, log_every=20,
                      pair_capacity=1 << 16, tile_capacity=512),
        AdaptiveConfig(densify_every=20, grad_threshold=1e-7,
                       max_new_fraction=0.25),
        capacity=400, verbose=False)
    assert fitted.num_gaussians >= 400
    rounds = [h for h in history if "n_alive" in h]
    assert rounds and rounds[-1]["n_alive"] > 200
    assert all({"n_new", "n_pruned", "n_split", "n_clone"} <= set(h)
               for h in rounds)
    assert history[-1]["mse"] < history[0]["mse"]
    # semantic ids follow the clones into the grown slots
    grown = alive_mask(fitted.opacity_logits[200:])
    assert bool((fitted.semantic_ids[200:][grown] != -1).any())


def test_fit_scene_adaptive_opacity_reset_group_lrs():
    from sage3d_tpu_torch.parallel.trainer import (AdaptiveConfig,
                                                   TrainerConfig,
                                                   fit_scene_adaptive,
                                                   make_orbit_targets)
    from sage3d_tpu_torch.renderer.scene import synthetic_room

    scene = synthetic_room(128, seed=1, device="cpu")
    cams, targets = make_orbit_targets(scene, n_views=2, radius=4.0,
                                       width=32, height=32)
    fitted, curve = fit_scene_adaptive(
        scene, cams, targets,
        config=TrainerConfig(steps=4, log_every=2, group_lrs=True,
                             pair_capacity=1 << 12, tile_capacity=256),
        adaptive=AdaptiveConfig(densify_every=0, opacity_reset_every=2),
        capacity=256, verbose=False)
    assert fitted.num_gaussians == 256 and len(curve) == 2
    assert np.isfinite([h["mse"] for h in curve]).all()


def test_fit_scene_adaptive_refuses_a_tile_mesh():
    """The sharded step is not ported: a mesh of two devices raises the
    train step's error before any step."""
    from sage3d_tpu_torch.parallel.trainer import (TrainerConfig,
                                                   fit_scene_adaptive,
                                                   make_orbit_targets)
    from sage3d_tpu_torch.renderer.scene import synthetic_room

    scene = synthetic_room(32, seed=1, device="cpu")
    cams, targets = make_orbit_targets(scene, n_views=1, width=16, height=16)
    with pytest.raises(NotImplementedError, match="sharded train step"):
        fit_scene_adaptive(scene, cams, targets,
                           TrainerConfig(steps=2, mesh_shape=(1, 2)),
                           capacity=64, verbose=False)


def test_with_capacity_matches_jax():
    from sage3d_tpu.parallel.trainer import with_capacity as jwith
    from sage3d_tpu.renderer.scene import synthetic_room as jroom
    from sage3d_tpu_torch.parallel.trainer import with_capacity
    from sage3d_tpu_torch.renderer.scene import scene_from_numpy
    js = jroom(50, seed=2)
    ts = scene_from_numpy({k: np.array(getattr(js, k)) for k in js._fields},
                          device="cpu")
    want, got = jwith(js, 80), with_capacity(ts, 80)
    for k in js._fields:
        assert np.array_equal(getattr(got, k).numpy(),
                              np.array(getattr(want, k))), k
    assert with_capacity(ts, 50) is ts
