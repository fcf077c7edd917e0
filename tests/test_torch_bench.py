"""The port's measurement path on the CPU: ``benchmarks/bench.py``'s loss and
gradients against the JAX ``bench.py`` through the ``pallas`` backend, its
parity block, its scene, and the ``torch`` compositor's per-chunk
rematerialisation that the parity block's ``torch`` gradients need."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from sage3d_tpu.renderer import camera as jcam
from sage3d_tpu.renderer import render as jrender
from sage3d_tpu_torch.benchmarks import bench as tbench
from sage3d_tpu_torch.ops import composite_cuda as tcu
from sage3d_tpu_torch.ops import composite_torch as tct
from sage3d_tpu_torch.ops.binning import bin_gaussians
from sage3d_tpu_torch.ops.projection import project_gaussians
from sage3d_tpu_torch.renderer import camera as tcam
from sage3d_tpu_torch.renderer.scene import scene_from_numpy

W, H = 64, 48
GRAD_REL = 5e-4     # bench.py's gate for the f32 gradient


def _to_port(js):
    return scene_from_numpy({f: np.asarray(getattr(js, f)) for f in js._fields},
                            device="cpu")


@pytest.fixture(scope="module")
def cams():
    jc = jcam.make_camera(width=W, height=H, **tbench.CAMERA)
    return jc, tbench.bench_camera(W, H, device="cpu")


@pytest.fixture(scope="module", params=[0, 3], ids=["sh0", "sh3"])
def case(request, cams):
    """``bench.py``'s scene at 400 Gaussians (and its SH3 twin), carried to
    the port, with each side's ``autotune`` budgets."""
    js = jbench.make_bench_scene_device(400, sh_degree=request.param)
    ts = _to_port(js)
    jc, tc = cams
    jb = jbench.autotune(js, jc)
    tb = tbench.autotune(ts, tc)
    return request.param, js, ts, jb, tb


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_bench_budgets_match(case):
    _, _, _, jb, tb = case
    assert tb == jb


def test_bench_loss_gradients_match_jax(case, cams):
    """The bench loss (SH0) or the SH3 loss and their gradients through the
    ``cuda`` backend (plain versions here) against ``jax.grad`` through the
    JAX ``pallas`` backend (interpret mode)."""
    sh_degree, js, ts, jb, tb = case
    jc, tc = cams
    names = ("opacity_logits",) if sh_degree == 0 else ("opacity_logits", "sh")

    def jloss(p):
        out = jrender.render(js._replace(**p), jc, backend="pallas",
                             **jrender.budget_kwargs(jb))
        if sh_degree:
            return jnp.sum(out["rgb"] ** 2) * 1e-9
        return (jnp.sum(out["rgb"] ** 2) * 1e-9
                + jnp.sum(out["depth_acc"]) * 1e-12
                + jnp.sum(out["alpha"]) * 1e-12)

    want_loss, want = jax.value_and_grad(jloss)(
        {k: getattr(js, k) for k in names})
    leaves = {k: getattr(ts, k).clone().requires_grad_() for k in names}
    s = ts._replace(**leaves)
    loss = (tbench.sh3_loss(s, tc, tb) if sh_degree
            else tbench.bench_loss(s, tc, "cuda", tb))
    loss.backward()
    assert float(loss.detach()) > 0
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    for k in names:
        w = np.asarray(want[k])
        assert np.abs(w).max() > 0, k
        assert _rel(leaves[k].grad.numpy(), w) <= GRAD_REL, k


def test_parity_check_allclose_with_bench_keys(cams):
    js = jbench.make_bench_scene_device(400)
    ts = _to_port(js)
    jc, tc = cams
    want = jbench.parity_check(js, jc, jbench.autotune(js, jc))
    got = tbench.parity_check(ts, tc, tbench.autotune(ts, tc))
    assert set(got) == set(want)
    assert all(set(got[k]) == set(want[k]) for k in got
               if isinstance(got[k], dict))
    assert want["allclose"] is True and got["allclose"] is True
    assert got["overflow_pallas"] == got["overflow_xla"] == 0


def test_bench_step_timers(cams):
    """``bench_backend`` and ``bench_sh3`` on the CPU (plain versions, host
    clock): Mpix/s is W*H over the least step time, the median no less."""
    _, tc = cams
    s = tbench.make_bench_scene(400, device="cpu")
    s3 = tbench.make_bench_scene(400, sh_degree=3, device="cpu")
    for mpix, best, med in (
            tbench.bench_backend(s, tc, "cuda", tbench.autotune(s, tc),
                                 iters=1, grad_sort="bf16"),
            tbench.bench_backend(s, tc, "torch", tbench.autotune(s, tc),
                                 iters=1),
            tbench.bench_sh3(s3, tc, tbench.autotune(s3, tc), iters=1)):
        assert 0 < best <= med and np.isfinite(med)
        assert mpix == pytest.approx(W * H / best / 1e6)


def test_make_bench_scene_ranges_and_seeding():
    s = tbench.make_bench_scene(2000, seed=3, device="cpu")
    assert s.num_gaussians == 2000 and s.sh.shape == (2000, 1, 3)
    assert all(x.dtype == torch.float32 for x in s[:5])
    assert s.semantic_ids.dtype == torch.int32
    lo, hi = s.means.amin(0), s.means.amax(0)
    assert (lo >= torch.tensor([-5.0, -4.0, 0.0])).all()
    assert (hi <= torch.tensor([5.0, 4.0, 3.0])).all()
    assert (hi - lo > torch.tensor([9.0, 7.0, 2.5])).all()      # spans the box
    sc = torch.exp(s.log_scales)
    assert float(sc.min()) >= 0.01 - 1e-7 and float(sc.max()) <= 0.05 + 1e-7
    torch.testing.assert_close(torch.linalg.norm(s.quats, dim=1),
                               torch.ones(2000))
    op = torch.sigmoid(s.opacity_logits)
    assert float(op.min()) >= 0.2 - 1e-6 and float(op.max()) <= 0.9 + 1e-6
    col = s.sh[:, 0] * 0.28209479177387814 + 0.5
    assert float(col.min()) >= -1e-6 and float(col.max()) <= 1.0 + 1e-6
    assert int(s.semantic_ids.min()) == 0 and int(s.semantic_ids.max()) == 199
    same = tbench.make_bench_scene(2000, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(s, same))
    other = tbench.make_bench_scene(2000, seed=4, device="cpu")
    assert not torch.equal(s.means, other.means)
    sh3 = tbench.make_bench_scene(2000, seed=3, sh_degree=3, device="cpu")
    assert sh3.sh.shape == (2000, 16, 3)
    assert all(torch.equal(a, b) for a, b in zip(s[:4], sh3[:4]))
    assert torch.equal(sh3.semantic_ids, s.semantic_ids)
    assert torch.equal(sh3.sh[:, :1], s.sh)
    assert 0.08 < float(sh3.sh[:, 1:].std()) < 0.12


def _wall_frame():
    """A wall of opaque Gaussians filling a 64x64 view: 4 tiles of ~390
    pairs, so each tile takes 4 chunks."""
    rng = np.random.default_rng(3)
    n = 600
    means = np.array([0.0, 0.0, 1.0]) + rng.normal(0, 1, (n, 3)) * [1.0, 0.05, 1.0]
    op = rng.uniform(0.6, 0.95, n)
    sh = np.zeros((n, 1, 3))
    sh[:, 0, :] = (rng.uniform(0.1, 0.9, (n, 3)) - 0.5) / 0.28209479177387814
    scene = scene_from_numpy(dict(
        means=means, log_scales=np.log(np.full((n, 3), 0.3)),
        quats=np.tile([1.0, 0, 0, 0], (n, 1)),
        opacity_logits=np.log(op / (1 - op)), sh=sh,
        semantic_ids=np.arange(n) % 7), device="cpu")
    cam = tcam.make_camera([0.0, -2.0, 1.0], [0.0, 1.0, 0.0], 64, 64,
                           focal_mm=30.0, device="cpu")
    return scene, cam


def test_torch_compositor_rematerialises_each_chunk(monkeypatch):
    """Under grad, the bytes autograd saves for the ``torch`` compositor are
    each chunk's carry and gathered pair features, not its (tiles, 1024,
    128) matrices; the gradients are those of the computation without
    checkpoints."""
    scene, cam = _wall_frame()
    with torch.no_grad():
        proj = project_gaussians(scene, cam)
        bins = bin_gaussians(proj, cam.width, cam.height)
    fields = ("means2d", "conics", "opacities", "colors", "depths")
    wts = torch.from_numpy(np.random.default_rng(2).normal(
        size=(cam.height, cam.width, 3)).astype(np.float32))

    def run():
        saved = {}

        def pack(t):
            saved[(t.untyped_storage().data_ptr(), t.dtype)] = \
                t.untyped_storage().nbytes()
            return t

        leaves = {f: getattr(proj, f).clone().requires_grad_() for f in fields}
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = tct.composite_tiles(proj._replace(**leaves),
                                      scene.semantic_ids, bins, cam.width,
                                      cam.height)
        (torch.sum(out["rgb"] * wts) + 0.1 * torch.sum(out["depth_acc"])
         + 0.2 * torch.sum(out["alpha"]) - 0.3 * torch.sum(out["trans"])
         ).backward()
        return sum(saved.values()), {f: leaves[f].grad for f in fields}

    saved_remat, g_remat = run()
    monkeypatch.setattr(tct, "_run_chunk", lambda step, *args: step(*args))
    saved_plain, g_plain = run()

    n_tiles = bins.tiles_x * bins.tiles_y
    steps = -(-int(bins.tile_count.max()) // tcu.CHUNK)  # one batch of tiles
    assert steps >= 3
    carry = steps * n_tiles * tcu.NPIX * 8 * 4          # log_T, acc(5), best
    gathered = steps * n_tiles * tcu.CHUNK * 16 * 4     # per-pair inputs
    matrix = steps * n_tiles * tcu.NPIX * tcu.CHUNK * 4  # one (pix, chunk) f32
    assert saved_remat <= 1.25 * (carry + gathered), (saved_remat, carry)
    assert saved_plain >= matrix > 10 * saved_remat
    for f in fields:
        torch.testing.assert_close(g_remat[f], g_plain[f], rtol=1e-6,
                                   atol=1e-6 * float(g_plain[f].abs().max()))
