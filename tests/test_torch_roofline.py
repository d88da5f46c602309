"""The port's roofline report (``repro_torch.launch.roofline``) against
the JAX package's ``launch/roofline.py``.

* ``analytic_bytes_per_chip`` equals the reference's float for every
  configuration and shape at 256 ranks and 16-way model parallelism.
* ``StepCounter.bytes_accessed`` is exact on toys of known bytes.
* ``analyze_cell`` on a fake 256-rank group, for a dense, an SSM and a
  MoE smoke configuration: the extrapolated FLOPs and collective bytes
  equal a run of every layer; a negative per-layer delta is clamped at 0;
  the result carries the reference's keys.
* ``run_all``'s lines and ``report()``'s rows are the reference's, fed the
  same cells (the hint column names the H100's levers).
"""

import json
import os

import jax  # noqa: F401  (first, so that the flags below are restored)
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_config
from repro.launch import shapes as RSHAPES
from repro_torch.configs import all_arch_names, get_config, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RF
from repro_torch.launch import step_analysis as SA
from repro_torch.launch.shapes import SHAPES, ShapeSpec

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import roofline as RR      # noqa: E402  (sets XLA_FLAGS)
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

SMOKE_SHAPES = {"train_4k": ShapeSpec("train_4k", 64, 32, "train"),
                "prefill_32k": ShapeSpec("prefill_32k", 64, 32, "prefill"),
                "decode_32k": ShapeSpec("decode_32k", 64, 32, "decode")}


@pytest.fixture(scope="module", autouse=True)
def _no_world_left():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _smoke_cfg(arch):
    """The smoke configuration with three stacked layers; the MoE one
    with 16 routed experts, so that the expert-parallel branch runs on
    the 16 model ranks."""
    cfg = get_smoke_config(arch)
    if cfg.is_moe:
        cfg = cfg.replace(n_layers=cfg.first_k_dense + 3,
                          n_routed_experts=16)
    assert D.stacked_depth(cfg) == 3
    return cfg


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", all_arch_names())
def test_analytic_bytes_match_reference(arch, shape):
    got = RF.analytic_bytes_per_chip(get_config(arch), SHAPES[shape], 256,
                                     tp=16)
    want = RR.analytic_bytes_per_chip(jax_config(arch),
                                      RSHAPES.SHAPES[shape], 256, tp=16)
    assert got == want and got > 0


@pytest.mark.parametrize("fake", [False, True])
def test_bytes_accessed_is_exact_on_a_toy(fake):
    """A matmul reads (m, k) and (k, n) and writes (m, n); an add reads
    two (m, n) and writes one; a view moves nothing."""
    import contextlib
    m, k, n = 8, 16, 4
    with FakeTensorMode() if fake else contextlib.nullcontext():
        a = torch.ones(m, k)
        b = torch.ones(k, n)
        bias = torch.ones(m, n, dtype=torch.float32)
        c = SA.StepCounter()
        with c:
            y = (a @ b) + bias
            y.view(n, m)
    assert c.bytes_accessed == 4 * ((m * k + k * n + m * n)
                                    + 3 * m * n)
    assert c.flops == 2 * m * k * n


def test_roofline_terms_keep_the_dry_runs_keys():
    """Without ``analytic_bytes_per_chip`` the memory term is the dry
    run's; with it, the reference's analytic term; the op bytes stand
    beside both."""
    coll = {"total_bytes": 9e9, "cross_node_bytes": 0.0}
    base = SA.roofline_terms(1e12, 2e9, coll, 5e11, op_bytes=7e9)
    assert base["t_memory_s"] == 2e9 / SA.HBM_BW
    assert base["t_memory_op_s"] == 7e9 / SA.HBM_BW
    assert base["op_bytes_per_chip"] == 7e9
    ana = SA.roofline_terms(1e12, 2e9, coll, 5e11,
                            analytic_bytes_per_chip=4e9, op_bytes=7e9)
    assert ana["t_memory_s"] == 4e9 / SA.HBM_BW
    assert ana["hbm_bytes_per_chip"] == base["hbm_bytes_per_chip"] == 2e9
    assert ana["analytic_bytes_per_chip"] == 4e9


REF_KEYS = {"arch", "shape", "status", "mesh", "accum_steps",
            "per_layer_delta", "base_costs", "extrapolated", "roofline"}
TERM_KEYS = {"t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
             "model_flops_per_chip", "useful_flop_ratio",
             "roofline_fraction", "analytic_bytes_per_chip",
             "coll_bytes_per_chip", "op_bytes_per_chip", "t_memory_op_s"}


@pytest.mark.parametrize("shape", list(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-370m",
                                  "deepseek-moe-16b"])
def test_extrapolation_equals_full_depth(arch, shape):
    cfg = _smoke_cfg(arch)
    r = RF.analyze_cell(arch, shape, device="cpu", cfg=cfg,
                        shape=SMOKE_SHAPES[shape])
    full = D.run_cell(arch, shape, "single", device="cpu", cfg=cfg,
                      shape=SMOKE_SHAPES[shape], full_depth=True,
                      save=False)
    assert r["status"] == "ok" and full["status"] == "ok"
    assert REF_KEYS <= set(r) and TERM_KEYS <= set(r["roofline"])
    assert set(r["base_costs"]) >= {"flops", "bytes", "coll"}
    assert r["mesh"] == {"data": 16, "model": 16}
    assert r["accum_steps"] == D.accum_steps(cfg, SMOKE_SHAPES[shape])
    assert all(v >= 0 for v in r["per_layer_delta"].values())
    ext = r["extrapolated"]
    assert ext["flops"] == full["flops_per_chip"] > 0
    assert ext["coll"] == full["collectives"]["total_bytes"]
    assert ext["coll_cross_node"] == full["collectives"]["cross_node_bytes"]
    # the unfused op bytes of one run at full depth
    assert ext["bytes"] == full["roofline"]["op_bytes_per_chip"] > 0
    t = r["roofline"]
    assert t["t_memory_s"] == RF.analytic_bytes_per_chip(
        cfg, SMOKE_SHAPES[shape], 256, tp=16) / SA.HBM_BW
    assert t["t_memory_op_s"] == ext["bytes"] / SA.HBM_BW
    assert t["flops_per_chip"] == ext["flops"]
    assert "upper bound" in r["bytes_note"]


def test_extrapolate_clamps_a_negative_delta():
    c1 = {"flops": 10.0, "bytes": 50.0, "coll": 4.0}
    c2 = {"flops": 13.0, "bytes": 40.0, "coll": 4.0}
    assert RF.extrapolate(c1, c2, 5) == {"flops": 22.0, "bytes": 50.0,
                                         "coll": 4.0}
    want = {k: c1[k] + 4 * max(c2[k] - c1[k], 0.0) for k in c1}
    assert RF.extrapolate(c1, c2, 5) == want


def test_analyze_cell_clamps_when_the_second_depth_costs_less(monkeypatch):
    """Depth runs given in the wrong order make every delta negative: the
    extrapolation stays at the one-layer costs, as the reference's."""
    real = D.depth_runs

    def swapped(*a, **k):
        meta, runs = real(*a, **k)
        return meta, runs[::-1]
    monkeypatch.setattr(D, "depth_runs", swapped)
    cfg = _smoke_cfg("qwen1.5-0.5b")
    r = RF.analyze_cell("qwen1.5-0.5b", "train_4k", device="cpu", cfg=cfg,
                        shape=SMOKE_SHAPES["train_4k"])
    assert r["per_layer_delta"]["flops"] < 0
    assert r["extrapolated"] == r["base_costs"]


def test_skip_carries_the_reference_reason():
    r = RF.analyze_cell("qwen3-32b", "long_500k", device="cpu")
    want = RR.applicable(jax_config("qwen3-32b"), "long_500k")
    assert (r["status"], r["reason"]) == ("skip", want[1])
    assert set(r) == {"arch", "shape", "status", "reason"}


def _canned_cells():
    """One cell measured on the fake mesh and one skip, keyed by cell."""
    ok = RF.analyze_cell("mamba2-370m", "prefill_32k", device="cpu",
                         cfg=_smoke_cfg("mamba2-370m"),
                         shape=SMOKE_SHAPES["prefill_32k"])
    skip = RF.analyze_cell("qwen3-32b", "long_500k", device="cpu")
    return {("mamba2-370m", "prefill_32k"): ok,
            ("qwen3-32b", "long_500k"): skip}


def test_run_all_lines_and_report_rows_are_the_references(
        tmp_path, monkeypatch, capsys):
    cells = _canned_cells()
    archs = ["mamba2-370m", "qwen3-32b"]
    shapes = ["prefill_32k", "long_500k"]

    def canned(arch, shape_name, *a, **k):
        if (arch, shape_name) in cells:
            return json.loads(json.dumps(cells[(arch, shape_name)],
                                         default=str))
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "reason": "not in this test"}

    ours, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
    monkeypatch.setattr(RF, "analyze_cell", canned)
    monkeypatch.setattr(RF, "all_arch_names", lambda: archs)
    monkeypatch.setattr(RF, "SHAPES", {s: SHAPES[s] for s in shapes})
    monkeypatch.setattr(RR, "analyze_cell", canned)
    monkeypatch.setattr(RR, "all_arch_names", lambda: archs)
    monkeypatch.setattr(RR, "SHAPES", {s: SHAPES[s] for s in shapes})
    monkeypatch.setattr(RR, "ART", theirs)
    capsys.readouterr()
    RF.run_all(device="cpu", art=ours)
    port_lines = capsys.readouterr().out
    RR.run_all()
    ref_lines = capsys.readouterr().out
    assert port_lines == ref_lines
    assert port_lines.count("\n") == 4 and "SKIP" in port_lines
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))

    def strip_hint(table):
        return [r.rsplit("|", 2)[0] for r in table.splitlines()]
    port_table, ref_table = RF.report(ours), RR.report()
    assert strip_hint(port_table) == strip_hint(ref_table)
    rows = port_table.splitlines()[2:]
    assert len(rows) == 4
    ok_row = next(r for r in rows if r.startswith("| mamba2-370m | "
                                                  "prefill_32k"))
    bottleneck = cells[("mamba2-370m", "prefill_32k")]["roofline"][
        "bottleneck"]
    assert ok_row.endswith(f"| {RF.HINTS[bottleneck]} |")
    skip_row = next(r for r in rows if r.startswith("| qwen3-32b | "
                                                    "long_500k"))
    assert cells[("qwen3-32b", "long_500k")]["reason"][:60] in skip_row
    for hint in RF.HINTS.values():
        assert "MXU" not in hint and "ICI" not in hint
    # the CLI's report is the same table
    monkeypatch.setattr(RF, "ART", ours)
    assert RF.main(["--report"]) == 0
    assert capsys.readouterr().out == port_table + "\n"


def test_cli_prints_one_cell_as_json(capsys):
    assert RF.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                    "--device", "cpu", "--smoke"]) == 0
    r = json.loads(capsys.readouterr().out)
    assert r["status"] == "ok" and REF_KEYS <= set(r)
    assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                           "collective")
