"""Cells, configurations, traffic mixes and metrics are found by name, a
new cell is a new file, and BENCHMARK.json agrees with the files."""

import json
import re
import shutil

import pytest

from portbench import cells
from portbench.tests import smoke

REPO = cells.ROOT.parent
WORKLOADS = sorted(p.stem for p in (cells.ROOT / "workloads").glob("*.json"))
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _bench():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_loads_by_name(name):
    cell = cells.load_cell(name)
    assert cell["model"]["name"] == cell["config"]
    assert cells.load_job(cell["mix"]["job"]).Job


@pytest.mark.parametrize("name", cells.metric_names())
def test_metric_loads_by_name(name):
    mod = cells.load_metric(name)
    assert mod.LAYER and mod.UNIT and mod.MOVES
    assert mod.SOURCE in SOURCES
    assert callable(mod.read)


@pytest.mark.parametrize("bad", ["a b", "a/b", "../x", "", ".x", "-x",
                                 "café", "a,b", "x" * 65, "a\tb", "a\n"])
def test_a_name_outside_the_alphabet_is_refused(bad):
    with pytest.raises(ValueError):
        cells.load_cell(bad)


@pytest.mark.parametrize("good", ["a", "0.b-c_d", "x" * 64])
def test_names_inside_the_alphabet_pass(good):
    assert cells.check_name(good) == good


def test_a_new_cell_is_a_new_file(tmp_path, monkeypatch):
    """mamba2-370m on its SSD kernel path under the prefill mix: a
    configuration file and a workload file, no edit."""
    for d in ("configs", "workloads", "traffic", "metrics"):
        shutil.copytree(cells.ROOT / d, tmp_path / d)
    spec = cells.load_json("configs", "mamba2-370m-plainssd")
    spec["name"] = "mamba2-370m"
    spec.pop("ssm_impl")
    spec["assumed"].pop("ssm_impl")
    (tmp_path / "configs" / "mamba2-370m.json").write_text(json.dumps(spec))
    (tmp_path / "workloads" / "mamba2-370m.prefill.json").write_text(
        json.dumps({"config": "mamba2-370m", "traffic": "prefill_32x2048",
                    "chips": 1, "limits": {}}))
    monkeypatch.setattr(cells, "ROOT", tmp_path)
    res = smoke.run("mamba2-370m.prefill")
    assert res["metrics"]["serve_tokens_per_s"]["value"] > 0
    assert res["metrics"]["ttft_p95_ms"]["value"] > 0
    assert res["checks"]["trace_mismatch"]["value"] == 0
    assert res["checks"]["served_gap"]["value"] < 1e-3


def test_benchmark_json_keys_and_files():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        spec = cells.load_json("configs", c["name"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert spec["reduced"] == c["reduced"]
        assert spec["source"] == c["source"]
    for w in b["workloads"]:
        cell = cells.load_cell(w["name"])
        assert (cell["config"], cell["traffic"]) == (w["config"],
                                                     w["traffic"])
        assert w["chips"] == cell["chips"] == 1
        assert len(w["why"]) <= 200


def test_benchmark_json_metrics_match_their_readers():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    reported = {}
    for w in b["workloads"]:
        job = cells.load_job(cells.load_cell(w["name"])["mix"]["job"])
        reported[w["name"]] = set(job.Job.UNITS) | {"setup_s"}
        for name, unit in job.Job.UNITS.items():
            assert e2e[name]["unit"] == unit
    for name, m in e2e.items():
        cells_of = m.get("workloads", list(reported))
        assert all(name in reported[c] for c in cells_of)
    names = set()
    for m in b["per_layer"]:
        mod = cells.load_metric(m["name"])
        assert (m["layer"], m["unit"], m["moves"], m["source"]) == (
            mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE)
        assert all(mod.MOVES in reported[c] for c in m["workloads"])
        names.add(m["name"])
    assert names <= set(cells.metric_names())
    for m in b["per_layer"] + b["end_to_end"]:
        assert re.match(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$", m["name"])
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
