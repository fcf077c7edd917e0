"""Rank functions of the splat layout's CPU tests, in a module the spawned
ranks import (a test module would load JAX into them)."""

from sage3d_tpu_torch.parallel import audit
from sage3d_tpu_torch.parallel.mesh import all_gather, shard_rows
from sage3d_tpu_torch.parallel.train import init_train_state, make_train_step


def layouts_and_audit(template, cameras, targets, optimizer, n_steps, mesh,
                      **step_kw):
    """Both layouts' steps from one start (``audit.compare_layouts``), the
    splat layout's ``adc`` step from that start (its means-gradient norms
    gathered over "tile") and both layouts' audits
    (``audit.audit_layouts``), from one mesh."""
    out = audit.compare_layouts(template, cameras, targets, optimizer,
                                n_steps, mesh, **step_kw)
    cams = shard_rows(cameras, mesh, "data")
    step, _ = make_train_step(template, cams, mesh, optimizer=optimizer,
                              gather="splats", **step_kw)
    _, _, gnorm = step.adc(init_train_state(template, optimizer, mesh), cams,
                           shard_rows(targets, mesh, "data"))
    out["adc_gnorm"] = all_gather(gnorm, mesh, "tile")
    out["audit"] = audit.audit_layouts(mesh, backend="torch")
    return out
