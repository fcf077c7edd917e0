"""The four-rank cell (``traffic/train_loop_mesh.py``) on the CPU at a tiny
size: its blocked reference against the plain one, a run end to end on
four gloo ranks, and a rank that dies stopping every rank."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, make_tiny

from perfbench.harness import port, site
from perfbench.reference import blocked as rb
from perfbench.reference import render as rr
from perfbench.reference import train as rt

CELL = "fit-40m-1152x864-mesh4"
TINY_SITE = {"num_gaussians": 4096, "width": 96, "height": 128, "views": 4,
             "extent_m": 4.0, "num_objects": 8}
TINY_MESH = {"warmup_steps": 4, "ref_block": 1000}
LRS = {"means": 6.4e-4, "log_scales": 5e-3, "quats": 1e-3,
       "opacity_logits": 5e-2, "sh": 2.5e-3}


def tiny_mesh_base(base):
    """``make_tiny``'s copy with the mesh cell at a size whose four bands
    each see the site."""
    make_tiny(base)
    cfg_path = base / "configs" / "grendel-rubble-40m-1152x864.json"
    cfg = json.loads(cfg_path.read_text())
    cfg.update(TINY_SITE)
    cfg_path.write_text(json.dumps(cfg))
    w_path = base / "workloads" / f"{CELL}.json"
    w = json.loads(w_path.read_text())
    w["params"].update(TINY_MESH)
    w_path.write_text(json.dumps(w))
    return base


@pytest.fixture(scope="module")
def small_site():
    f = site.site_fields(3000, 1, 10.0, 3, 8, 0, "cpu")
    target = site.jittered(f, 2, 0.3, 0.5)
    _, cams = port.cameras(site.drone_views(4, 10.0, 0), 64, 48, 18.2, "cpu",
                           program=False)
    return f, target, cams


def test_blocked_reference_is_the_plain_reference(small_site):
    # the same arithmetic; a block's products may round as its size has it
    f, target, cams = small_site
    want = rt.fit_steps(f, target, cams[:3], LRS)
    targets = [rb.render(target, c, block=700)["rgb"] for c in cams[:3]]
    got = rb.fit_steps(f, targets, cams[:3], LRS, block=700)
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    for k in ("grad", "change"):
        for g in rt.GROUPS:
            assert got[k][g] == pytest.approx(want[k][g], rel=1e-5), (k, g)


def test_a_frames_bands_count_its_pairs(small_site):
    f, _, cams = small_site
    whole = rr.render(f, cams[0], count=True)["counts"]
    bands = [rb.render(f, cams[0], block=700, band=(y0, 32),
                       count=True)["counts"] for y0 in (0, 32)]
    assert sum(b.pairs for b in bands) == whole.pairs > 0
    assert sum(b.hits for b in bands) == whole.hits


def test_the_cell_runs_on_four_cpu_ranks(tmp_path):
    from perfbench.harness import runner
    base = tiny_mesh_base(tmp_path)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = runner.run(CELL, 2**31 + 5, 0.5, False, time.perf_counter(),
                     device="cpu", base=base, bench=bench)
    assert out["correct"], out["compared"]
    assert out["metrics"]["train_mpix_s"]["value"] > 0
    assert out["device"]["count"] == 4


def _children(pid: int) -> list:
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as fh:
                    fields = fh.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == pid and fields[0] != "Z":
                out.append(int(d))
    return out


def test_a_rank_that_dies_stops_every_rank(tmp_path):
    """Rank 2 killed during set-up: rank 0 exits non-zero within 60 s and
    leaves no rank running."""
    base = tiny_mesh_base(tmp_path)
    code = ("import sys, time; sys.path.insert(0, %r); "
            "from perfbench.harness import runner; "
            "runner.run(%r, 7, 5.0, False, time.perf_counter(), "
            "device='cpu', base=__import__('pathlib').Path(%r))"
            % (str(ROOT), CELL, str(base)))
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT),
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 120
        kids = []
        while len(kids) < 3 and time.monotonic() < deadline:
            time.sleep(0.2)
            kids = _children(proc.pid)
        assert len(kids) == 3, kids
        time.sleep(3.0)
        os.kill(sorted(kids)[1], signal.SIGKILL)
        t0 = time.monotonic()
        rc = proc.wait(timeout=60)
        assert rc != 0 and time.monotonic() - t0 < 60
        time.sleep(2.0)
        alive = [k for k in kids if os.path.exists(f"/proc/{k}")
                 and open(f"/proc/{k}/stat").read().rsplit(")", 1)[1]
                 .split()[0] != "Z"]
        assert not alive, alive
    finally:
        if proc.poll() is None:
            proc.kill()
        for k in _children(proc.pid):
            os.kill(k, signal.SIGKILL)


def test_control_reference_runs_in_bfloat16(small_site):
    f, target, cams = small_site
    targets = [rb.render(target, c, block=700)["rgb"] for c in cams[:1]]
    low = rb.fit_steps(f, targets, cams[:1], LRS, dtype=torch.bfloat16,
                       block=700)
    want = rb.fit_steps(f, targets, cams[:1], LRS, block=700)
    assert low["loss"][0] != want["loss"][0]
