"""The port's single-device training step, optimizer, chained steps,
checkpoints and ``fit_scene`` against the JAX package's, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sage3d_tpu.parallel import train as jtrain
from sage3d_tpu.parallel.mesh import make_mesh
from sage3d_tpu.parallel.trainer import make_orbit_targets as jorbit
from sage3d_tpu.renderer.scene import synthetic_room
from sage3d_tpu_torch.parallel import checkpoint as tckpt
from sage3d_tpu_torch.parallel import train as ttrain
from sage3d_tpu_torch.parallel import trainer as ttrainer
from sage3d_tpu_torch.renderer import camera as tcam
from sage3d_tpu_torch.renderer.scene import scene_from_numpy

PAIRS = {"torch": "xla", "cuda": "pallas"}
RENDER_KW = dict(pair_capacity=1 << 14, tile_capacity=256)
EPS = 1e-4      # Adam's eps in the comparison with the JAX step (see there)


def _cams_to_torch(jcams):
    n = jcams.position.shape[0]
    return tcam.stack_cameras([tcam.camera_from_numpy(
        {f: np.asarray(getattr(jcams, f))[i] for f in
         ("position", "cam_to_world", "fx", "fy", "cx", "cy")}
        | {"width": jcams.width, "height": jcams.height}, device="cpu")
        for i in range(n)])


@pytest.fixture(scope="module")
def fixture():
    """A 300-Gaussian room, its renders from two orbit cameras (48x48), and
    the start: the room with noise on opacity and colour."""
    gt = synthetic_room(300, seed=4)
    jcams, targets = jorbit(gt, n_views=2, radius=4.0, width=48, height=48)
    rng = np.random.default_rng(0)
    start = gt._replace(
        opacity_logits=gt.opacity_logits + rng.normal(
            0, 0.3, gt.opacity_logits.shape).astype(np.float32),
        sh=gt.sh + rng.normal(0, 0.1, gt.sh.shape).astype(np.float32))
    tstart = scene_from_numpy({f: np.asarray(getattr(start, f))
                               for f in start._fields}, device="cpu")
    return (start, jcams, targets, tstart, _cams_to_torch(jcams),
            torch.from_numpy(np.array(targets)))


def _record_grads():
    """An optax stage that passes the gradients on unchanged and keeps the
    last ones in its state."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


@pytest.mark.parametrize("backend", list(PAIRS))
def test_train_step_matches_jax(backend, fixture):
    start, jcams, jtargets, tstart, tcams, ttargets = fixture
    mesh = make_mesh((1, 1))
    # Adam divides by sqrt(v) + eps: at the default eps (1e-8) an entry whose
    # gradient is float noise (|g| ~ 1e-8 here, the two frameworks' sums
    # agreeing to ~1e-7 of the largest) moves by a noise-set fraction of its
    # rate. eps = 1e-4 keeps such entries near zero on both sides, while the
    # rest still move by about their rate, which the 1e-5 check then holds.
    # So that the check also covers gradient magnitudes, the first step's
    # gradients are held against the JAX step's own (recorded by the first
    # stage of its optimizer) at 5e-4 of each group's max, bench.py's gate
    # between backends: here the two frameworks' tiled blends differ by up to
    # 1.2e-4 in rgb (the tile-local quadratic cancels, so one ulp of a conic
    # or another order of its terms moves a pixel by ~1e-4), which moves a
    # few of the 900 ``means`` entries by ~4e-4 of the max.
    lrs = ttrain.make_group_optimizer(extent=4.0).group_lrs
    jopt = optax.chain(_record_grads(), optax.multi_transform(
        {k: optax.adam(lr, eps=EPS) for k, lr in lrs.items()},
        {k: k for k in lrs}))
    jstep, _ = jtrain.make_train_step(start, jcams, mesh, optimizer=jopt,
                                      backend=PAIRS[backend], **RENDER_KW)
    params = jtrain.scene_params(start)
    js = jtrain.TrainState(params, jopt.init(params), jnp.zeros((), jnp.int32))
    tstep, _ = ttrain.make_train_step(tstart, tcams, mesh=(1, 1),
                                      backend=backend, **RENDER_KW)
    ts = ttrain.init_train_state(tstart)
    ts = ts._replace(opt_state=torch.optim.Adam(
        [{"params": [ts.params[k]], "lr": lrs[k]} for k in ttrain.TRAINABLE],
        eps=EPS))
    with mesh:
        for i in range(3):
            js, jloss = jstep(js, jcams, jtargets)
            ts, tloss = tstep(ts, tcams, ttargets)
            assert abs(float(tloss) - float(jloss)) < 1e-5
            if i == 0:
                for k in ttrain.TRAINABLE:
                    want = np.asarray(js.opt_state[0][k])
                    scale = np.abs(want).max()
                    assert scale > 0, k
                    np.testing.assert_allclose(
                        ts.params[k].grad.numpy() / scale, want / scale,
                        atol=5e-4, err_msg=k)
    assert ts.step == 3
    for k in ttrain.TRAINABLE:
        got = ts.params[k].detach().numpy()
        diff = np.abs(got - np.asarray(js.params[k]))
        assert diff.max() < 1e-5, (k, diff.max())
        moved = np.abs(got - getattr(tstart, k).numpy()).max()
        assert moved > 0.5 * lrs[k], (k, moved)     # the step did move it


def test_group_optimizer_rates_differ_per_group():
    opt = ttrain.make_group_optimizer(extent=2.0)
    params = {k: torch.ones((4, 2), requires_grad=True) for k in ttrain.GROUP_LRS}
    adam = opt.init(params)
    for p in params.values():
        p.grad = torch.ones((4, 2))
    adam.step()
    # Adam's first step is ~ -lr * sign(grad); means scale with the extent
    got = {k: float(p.detach()[0, 0]) - 1.0 for k, p in params.items()}
    assert abs(got["opacity_logits"] + 5e-2) < 1e-5
    assert abs(got["means"] + 1.6e-4 * 2.0) < 1e-6
    assert abs(got["sh"] + 2.5e-3) < 1e-6
    assert [g["lr"] for g in adam.param_groups] == [
        ttrain.GROUP_LRS[k] * (2.0 if k == "means" else 1.0)
        for k in ttrain.GROUP_LRS]
    assert ttrain.make_optimizer(0.01).lr_of("sh") == 0.01


def _torch_setup(fixture):
    _, _, _, tstart, tcams, ttargets = fixture
    opt = ttrain.make_group_optimizer(extent=4.0)
    step, _ = ttrain.make_train_step(tstart, tcams, optimizer=opt,
                                     **RENDER_KW)
    return tstart, tcams, ttargets, opt, step


def test_chained_steps_match_sequential(fixture):
    tstart, tcams, ttargets, opt, step = _torch_setup(fixture)
    s_seq = ttrain.init_train_state(tstart, opt)
    for _ in range(3):
        s_seq, loss_seq = step(s_seq, tcams, ttargets)
    s_chn, loss_chn = ttrain.make_chained_steps(step, 3)(
        ttrain.init_train_state(tstart, opt), tcams, ttargets)
    assert float(loss_seq) == float(loss_chn) and s_chn.step == 3
    for k in ttrain.TRAINABLE:
        assert torch.equal(s_seq.params[k], s_chn.params[k])


def test_chained_adc_steps_match_sequential(fixture):
    tstart, tcams, ttargets, opt, step = _torch_setup(fixture)
    s_seq = ttrain.init_train_state(tstart, opt)
    acc = torch.zeros((tstart.num_gaussians,))
    for _ in range(3):
        s_seq, loss_seq, gnorm = step.adc(s_seq, tcams, ttargets)
        acc = acc + gnorm
    s_chn, acc_chn, loss_chn = ttrain.make_chained_adc_steps(step, 3)(
        ttrain.init_train_state(tstart, opt), tcams, ttargets)
    assert float(loss_seq) == float(loss_chn)
    assert torch.equal(acc, acc_chn) and float(acc.max()) > 0
    for k in ttrain.TRAINABLE:
        assert torch.equal(s_seq.params[k], s_chn.params[k])


def test_fit_scene_reduces_loss_and_resumes(tmp_path):
    gt = scene_from_numpy({f: np.asarray(getattr(g, f)) for g in
                           [synthetic_room(256, seed=31)] for f in g._fields},
                          device="cpu")
    cameras, targets = ttrainer.make_orbit_targets(gt, n_views=2, width=64,
                                                   height=64)
    assert targets.shape == (2, 64, 64, 3) and not targets.requires_grad
    rng = np.random.default_rng(0)
    noisy = gt._replace(
        opacity_logits=gt.opacity_logits + torch.from_numpy(
            rng.normal(0, 0.3, gt.opacity_logits.shape).astype(np.float32)),
        sh=gt.sh + torch.from_numpy(
            rng.normal(0, 0.1, gt.sh.shape).astype(np.float32)))
    ckpt = tmp_path / "ckpt"
    cfg = ttrainer.TrainerConfig(lr=5e-3, steps=12, log_every=4,
                                 checkpoint_dir=str(ckpt), checkpoint_every=6,
                                 pair_capacity=1 << 14, tile_capacity=512)
    fitted, history = ttrainer.fit_scene(noisy, cameras, targets, cfg,
                                         verbose=False)
    assert history[-1]["mse"] < history[0]["mse"]
    assert history[-1]["psnr"] == pytest.approx(
        ttrainer.psnr(history[-1]["mse"]))
    assert fitted.num_gaussians == gt.num_gaussians
    assert tckpt.latest_step(ckpt) == 12
    cfg2 = ttrainer.TrainerConfig(**{**cfg.__dict__, "steps": 16})
    _, history2 = ttrainer.fit_scene(noisy, cameras, targets, cfg2,
                                     verbose=False)
    assert history2[0]["step"] > 12      # resumed past the first run's steps
    assert tckpt.latest_step(ckpt) == 16


def test_checkpoint_round_trip_and_max_to_keep(tmp_path, fixture):
    tstart, tcams, ttargets, opt, step = _torch_setup(fixture)
    state = ttrain.init_train_state(tstart, opt)
    assert tckpt.restore_train_state(tmp_path, state) is None
    assert tckpt.latest_step(tmp_path / "absent") is None
    for _ in range(4):
        state, _ = step(state, tcams, ttargets)
        tckpt.save_train_state(tmp_path, state, max_to_keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000003.pt", "step_000000004.pt"]
    fresh = ttrain.init_train_state(tstart, opt)
    restored = tckpt.restore_train_state(tmp_path, fresh)
    assert restored.step == 4
    for k in ttrain.TRAINABLE:
        assert torch.equal(restored.params[k], state.params[k])
    # the optimizer moments came back too: the next steps agree
    a, loss_a = step(state, tcams, ttargets)
    b, loss_b = step(restored, tcams, ttargets)
    assert float(loss_a) == float(loss_b)
    for k in ttrain.TRAINABLE:
        assert torch.equal(a.params[k], b.params[k])


def test_pad_scene_to_matches_jax():
    js = synthetic_room(37, seed=2)
    ts = scene_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                          device="cpu")
    want = jtrain.pad_scene_to(js, 8)
    got = ttrain.pad_scene_to(ts, 8)
    assert got.num_gaussians == 40
    for f in js._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert ttrain.pad_scene_to(ts, 37) is ts


def test_mesh_of_two_raises(fixture):
    """A mesh of more than one rank runs one process per rank: outside a
    process group the shape raises, naming spawn_mesh; (1, 1) is the direct
    path."""
    tstart, tcams = fixture[3], fixture[4]
    for mesh in ((1, 2), (2, 1)):
        with pytest.raises(ValueError, match="spawn_mesh"):
            ttrain.make_train_step(tstart, tcams, mesh=mesh)
    ttrain.make_train_step(tstart, tcams, mesh=(1, 1))
