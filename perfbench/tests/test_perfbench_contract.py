"""BENCHMARK.json against the benchmark's contract, and the harness's
finding of every part by name."""

import json
import re

import pytest

from conftest import ROOT, make_tiny

from perfbench.harness import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p)
        assert (ROOT / p).is_dir()


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for e in BENCH["workloads"]:
        assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        assert e["chips"] in (1, 4)
    for e in BENCH["configs"]:
        assert all(NAME.match(k) for k in e["reduced"])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = registry.cell_metrics(BENCH, w["name"], "end_to_end")
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert registry.cell_metrics(BENCH, w["name"], "per_layer")


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell])
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("kind", ["configs", "workloads", "traffic",
                                  "metrics"])
def test_every_part_is_found_by_name(kind):
    if kind == "configs":
        for c in BENCH["configs"]:
            cfg = registry.config(c["name"])
            assert (ROOT / c["file"]).is_file()
            assert c["file"].startswith("perfbench/")
            assert cfg["reduced"] == c["reduced"]
    elif kind == "workloads":
        for w in BENCH["workloads"]:
            spec = registry.workload(w["name"])
            assert spec["config"] == w["config"]
            assert spec["traffic"] == w["traffic"]
            assert spec["chips"] == w["chips"] and spec["why"] == w["why"]
            assert set(spec["limits"]) and int(spec["trace_units"]) >= 1
    elif kind == "traffic":
        for w in BENCH["workloads"]:
            mod = registry.traffic(w["traffic"])
            assert callable(mod.setup) and callable(mod.control)
    else:
        for m in BENCH["per_layer"]:
            spec = registry.metric(m["name"])
            assert callable(spec["read"])
            assert spec["layer"] == m["layer"] and spec["unit"] == m["unit"]
            assert spec["better"] == m["better"]


def test_a_new_cell_is_data_only(tmp_path):
    """A throwaway cell file in another folder loads and runs its driver
    with no code edit."""
    base = make_tiny(tmp_path)
    w = json.loads((base / "workloads" / "render-8cam-1080p.json")
                   .read_text())
    w["params"]["batch"] = 3
    (base / "workloads" / "render-3cam-throwaway.json").write_text(
        json.dumps(w))
    e2e = [dict(m, workloads=m["workloads"] + ["render-3cam-throwaway"])
           if m["name"] == "render_frames_s" else m
           for m in BENCH["end_to_end"]]
    bench = dict(BENCH, end_to_end=e2e, workloads=BENCH["workloads"] + [
        {"name": "render-3cam-throwaway", "config": w["config"],
         "traffic": w["traffic"], "chips": 1, "why": "a test"}])
    from perfbench.harness import runner
    out = runner.run("render-3cam-throwaway", 5, 0.2, False, 0.0,
                     device="cpu", base=base, bench=bench)
    assert out["correct"] and out["metrics"]["render_frames_s"]["value"] > 0
    assert list(out)[-1] == "compared"
