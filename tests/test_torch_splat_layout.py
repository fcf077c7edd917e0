"""The sharded train step's splat layout (``make_train_step(...,
gather="splats")``) against the parameter layout and the benchmark's plain
reference, on a 4-rank gloo mesh on the CPU; and the compositor's Gaussian
ids past 2^24 rows."""

import functools

import numpy as np
import pytest
import torch

import splat_layout_cases as cases
from perfbench.reference import render as rr
from perfbench.reference import train as rt
from sage3d_tpu_torch.ops import composite_cuda as tcu
from sage3d_tpu_torch.parallel import mesh as tmesh, train as ttrain
from sage3d_tpu_torch.renderer import camera as tcam
from sage3d_tpu_torch.renderer.scene import synthetic_room

TIMEOUT = 240           # the spawned mesh
RENDER_KW = dict(pair_capacity=1 << 14, tile_capacity=256)
N, W, H = 400, 64, 48   # the JAX tests' fixture size
STEPS = 3


@pytest.fixture(scope="module")
def layouts():
    """Three steps of each layout on a (1, 4) mesh from one start, the
    plain reference's three steps from the same start, and both audits."""
    scene = synthetic_room(N, seed=5, sh_degree=3, device="cpu")
    gen = torch.Generator().manual_seed(6)
    fields = {k: getattr(scene, k) for k in scene._fields}
    target = dict(fields)
    target["sh"] = fields["sh"].clone()
    target["sh"][:, 0] += 0.3 * torch.randn(fields["sh"][:, 0].shape,
                                            generator=gen)
    target["opacity_logits"] = fields["opacity_logits"] + 0.5 * torch.randn(
        fields["opacity_logits"].shape, generator=gen)
    cam = tcam.make_camera([0.0, -4.0, 1.2], [0.0, 1.0, -0.1], width=W,
                           height=H, device="cpu")
    ref_cam = rr.Cam(cam.position, cam.cam_to_world, float(cam.fx),
                     float(cam.fy), float(cam.cx), float(cam.cy), W, H)
    targets = rr.render(target, ref_cam)["rgb"][None]
    lrs = ttrain.make_group_optimizer(extent=5.0).group_lrs
    got = tmesh.spawn_mesh(
        functools.partial(cases.layouts_and_audit, n_steps=STEPS,
                          backend="torch", grad_buckets=4, **RENDER_KW),
        (1, 4), ttrain.pad_scene_to(scene, 16), tcam.stack_cameras([cam]),
        targets, ttrain.Optimizer(group_lrs=lrs), device="cpu",
        timeout_s=TIMEOUT)
    ref = rt.fit_steps(fields, target, [ref_cam] * STEPS, lrs)
    return got, ref, fields


def test_splat_layout_matches_the_parameter_layout(layouts):
    got = layouts[0]
    p, s = got["params"], got["splats"]
    assert s["losses"].shape == (4, STEPS)
    assert all(torch.equal(s["losses"][0], s["losses"][r]) for r in range(4))
    # apart by the band's rounding of the means and the sums' order: 1e-5
    # of the loss and 2e-5 of the largest gradient here, which Adam turns
    # into up to 3e-5 of a parameter by its third step
    np.testing.assert_allclose(s["losses"][0].numpy(), p["losses"][0].numpy(),
                               rtol=5e-5)
    for k in ttrain.TRAINABLE:
        scale = float(p["grads"][k].abs().max())
        assert scale > 0, k
        np.testing.assert_allclose(s["grads"][k].numpy() / scale,
                                   p["grads"][k].numpy() / scale, atol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(s["params"][k].numpy(),
                                   p["params"][k].numpy(), atol=1e-4,
                                   err_msg=k)
    # each step: the splats' values and metadata gathered in 4 buckets, their
    # gradients scattered back in 4, the data axis's 5 and the loss's 1
    assert s["counts"] == [{"all_gather": 8, "reduce_scatter": 4,
                            "all_reduce": 5, "loss_all_reduce": 1}] * STEPS


def test_splat_layout_matches_the_reference(layouts):
    got, ref, fields = layouts
    s = got["splats"]
    np.testing.assert_allclose(s["losses"][0].numpy(), ref["loss"],
                               rtol=1e-4)
    for k in ttrain.TRAINABLE:
        norm = float(torch.linalg.vector_norm(s["grads"][k][:N].double()))
        assert norm == pytest.approx(ref["grad"][k], rel=1e-3), k
        change = float(torch.linalg.vector_norm(
            (s["params"][k][:N] - fields[k]).double()))
        assert change == pytest.approx(ref["change"][k], rel=1e-3), k


def test_the_adc_step_runs_on_the_splat_layout(layouts):
    got = layouts[0]
    norms = torch.linalg.vector_norm(got["splats"]["grads"]["means"], dim=-1)
    torch.testing.assert_close(got["adc_gnorm"], norms)


def test_each_rank_projects_its_own_quarter(layouts):
    rows = layouts[0]["rows"]
    n = ttrain.pad_scene_to(synthetic_room(N, seed=5, device="cpu"),
                            16).num_gaussians
    assert rows["params"].tolist() == [float(n)] * 4
    assert rows["splats"].tolist() == [n / 4] * 4


def test_the_audit_counts_both_layouts(layouts):
    a = layouts[0]["audit"]
    assert a["params"]["written_collectives"]["all_gather"] == 20
    assert a["splats"]["written_collectives"] == {
        "all_gather": 8, "reduce_scatter": 4, "all_reduce": 5,
        "loss_all_reduce": 1}
    # 256 Gaussians x 2 cameras x 24 floats of splats (14 gathered, 10
    # scattered back) against 2 x 14 floats of parameters at SH degree 0,
    # each times 3/4 on the wire
    assert a["splats"]["comm_model"]["wire_bytes_per_step_per_device"] == \
        256 * 2 * 24 * 4 * 3 // 4
    assert a["params"]["comm_model"]["wire_bytes_per_step_per_device"] == \
        2 * 256 * 14 * 4 * 3 // 4


IDS = [0, 2**24 - 1, 2**24, 2**24 + 1, 2**31 - 2]


def test_gaussian_ids_round_trip_through_the_table_and_the_slots():
    ids = torch.tensor(IDS, dtype=torch.int64)
    lo, hi = tcu.gid_split(ids)
    assert lo.dtype == hi.dtype == torch.float32
    assert (hi.to(torch.int64) * 2**24 + lo.to(torch.int64)).tolist() == IDS
    # slot rows carrying them, the out-of-range id of a table of 2^31 - 2
    # rows after them, sort back into id order
    slots = tcu._slot_buffer(1, 2**31 - 2, "cpu")
    order = [4, 2, 0, 3, 1]
    for row, i in enumerate(order):
        slots[row, tcu.GID_COL] = lo[i]
        slots[row, tcu.SLOT_HI_COL] = hi[i]
    key = tcu.slot_ids(slots, 2**31 - 2)
    assert key.dtype == torch.int32
    assert key[:5].tolist() == [IDS[i] for i in order]
    assert bool((key[5:] == 2**31 - 2).all())
    ids_sorted, perm = torch.sort(key, stable=True)
    assert ids_sorted[:5].tolist() == sorted(IDS)
    assert perm[:5].tolist() == [order.index(i) for i in range(5)]


def test_tables_below_2_24_rows_keep_the_one_column_id():
    scene = synthetic_room(64, seed=1, device="cpu")
    cam = tcam.make_camera([0.0, -4.0, 1.2], [0.0, 1.0, -0.1], width=W,
                           height=H, device="cpu")
    from sage3d_tpu_torch.ops.projection import project_gaussians
    table = tcu.attribute_table(project_gaussians(scene, cam),
                                scene.semantic_ids)
    assert torch.equal(table[:, tcu.GID_COL], torch.arange(64.0))
    assert float(table[:, tcu.GID_HI_COL:].abs().max()) == 0.0
    slots = tcu._slot_buffer(2, 64, "cpu")
    assert bool((slots[:, tcu.GID_COL] == 64.0).all())
    assert float(slots[:, tcu.SLOT_HI_COL].abs().max()) == 0.0
    assert torch.equal(tcu.slot_ids(slots, 64), slots[:, tcu.GID_COL].int())
