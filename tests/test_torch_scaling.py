"""The paper's size evaluation (Figs 4-7, Table 4) on the port, on the CPU.

Every assertion of ``tests/test_scaling_invariants.py`` holds on the port's
``run_ranks`` and baselines, and the port's ``run_ranks`` returns the JAX
package's ``benchmarks.workloads.run_ranks`` dict exactly on the same
arguments: IOR and FLASH, independent and collective, flat and tree, and
every ``fit_mode`` on the ``numpy`` and ``torch`` backends.  Both packages
write their data files in one directory (the CST records the paths), and
runs with timestamps share one counter clock.  ``examples/
torch_constant_trace_scaling.py`` must print the reference's rows.
"""

import dataclasses
import functools
import os
import re
import subprocess
import sys
import time

import pytest

import repro.core.apis  # noqa: F401  (populate the reference registry)
import repro_torch.core.apis  # noqa: F401  (populate the port's registry)
from benchmarks import workloads as ref_wl
from repro.core import baselines as ref_bl
from repro.core.recorder import RecorderConfig as RefConfig
from repro_torch import workloads as port_wl
from repro_torch.core import baselines as port_bl
from repro_torch.core import encode_backend as eb
from repro_torch.core.recorder import RecorderConfig as PortConfig

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DATA = None


@pytest.fixture(scope="module", autouse=True)
def data_root(tmp_path_factory):
    """One data directory for every run of this file, so that cached
    reference results stay valid."""
    global _DATA
    _DATA = str(tmp_path_factory.mktemp("scaling"))
    yield
    _ref.cache_clear()


@pytest.fixture(autouse=True)
def numpy_default(monkeypatch):
    """The vectorized fit and the grammar packing follow the module
    default backend, which is ``cuda``: run them on NumPy."""
    monkeypatch.setattr(eb, "_default_backend", "numpy")


def _sub(name: str) -> str:
    d = os.path.join(_DATA, name)
    os.makedirs(d, exist_ok=True)
    return d


# -- every assertion of tests/test_scaling_invariants.py, on the port -------


def _ior(nprocs, n_calls, **cfg_kw):
    return port_wl.run_ranks(
        port_wl.ior_rank, nprocs,
        PortConfig(timestamps=False, encode_backend="numpy", **cfg_kw),
        n_calls=n_calls, data_dir=_sub("ior"))


def _flash(nprocs, iterations, **kw):
    return port_wl.run_ranks(
        port_wl.flash_rank, nprocs,
        PortConfig(timestamps=False, encode_backend="numpy"),
        data_dir=_sub("flash"), iterations=iterations, **kw)


def _fig4_intra_flat_in_calls():
    a = _ior(8, 32)["pattern_bytes"]
    b = _ior(8, 1024)["pattern_bytes"]
    assert abs(b - a) <= 4          # varint exponent growth only


def _fig4_no_intra_grows():
    a = _ior(8, 32, intra_patterns=False)["pattern_bytes"]
    b = _ior(8, 1024, intra_patterns=False)["pattern_bytes"]
    assert b > 8 * a


def _fig5_inter_flat_in_ranks():
    a = _ior(4, 128)["pattern_bytes"]
    b = _ior(64, 128)["pattern_bytes"]
    assert abs(b - a) <= 8


def _fig5_no_inter_linear_in_ranks():
    a = _ior(4, 128, inter_patterns=False)["pattern_bytes"]
    b = _ior(64, 128, inter_patterns=False)["pattern_bytes"]
    assert b > 10 * a


def _fig5_intra_off_inter_on_constant_but_larger():
    base = _ior(16, 128)["pattern_bytes"]
    a = _ior(4, 128, intra_patterns=False)["pattern_bytes"]
    b = _ior(64, 128, intra_patterns=False)["pattern_bytes"]
    assert abs(b - a) <= 0.05 * a
    assert a > base


def _fig6_weak_scaling_constant():
    a = _flash(8, 60)["pattern_bytes"]
    b = _flash(128, 60)["pattern_bytes"]
    assert abs(b - a) <= 16


def _fig6_iterations_growth_and_rolling_mitigation():
    grow_small = _flash(8, 80)["pattern_bytes"]
    grow_big = _flash(8, 320)["pattern_bytes"]
    roll_small = _flash(8, 80, rolling=True)["pattern_bytes"]
    roll_big = _flash(8, 320, rolling=True)["pattern_bytes"]
    assert grow_big > grow_small + 100   # new filenames -> new signatures
    assert abs(roll_big - roll_small) <= 8


def _fig7_collective_tracks_aggregators():
    small = _flash(64, 40, mode="collective", stripe=8)
    big = _flash(1024, 40, mode="collective", stripe=8)
    assert big["n_unique_cfgs"] >= small["n_unique_cfgs"]


def _table4_recorder_much_smaller_than_old():
    d = _sub("table4")
    rec = port_wl.run_ranks(port_wl.flash_rank, 8,
                            PortConfig(encode_backend="numpy"), data_dir=d,
                            iterations=60)
    old_total = 0
    for r in range(8):
        tool = port_bl.RecorderOld(r)
        port_wl.flash_rank(port_bl.ToolAdapter(tool, rank=r), r, 8,
                           data_dir=d, iterations=60)
        old_total += tool.nbytes
    assert old_total > 5 * rec["total_bytes"]


INVARIANTS = {f.__name__[1:]: f for f in (
    _fig4_intra_flat_in_calls, _fig4_no_intra_grows,
    _fig5_inter_flat_in_ranks, _fig5_no_inter_linear_in_ranks,
    _fig5_intra_off_inter_on_constant_but_larger,
    _fig6_weak_scaling_constant,
    _fig6_iterations_growth_and_rolling_mitigation,
    _fig7_collective_tracks_aggregators,
    _table4_recorder_much_smaller_than_old)}


@pytest.mark.parametrize("name", list(INVARIANTS))
def test_scaling_invariant_holds_on_the_port(name):
    INVARIANTS[name]()


# -- the port's run_ranks dict against the reference's ----------------------


class _CounterClock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        self.t += 2e-6
        return self.t


def _run(wl, config_cls, workload, nprocs, cfg_kw, wl_kw, topology,
         fit_mode, **extra):
    """One package's run_ranks, with a fresh counter clock when the ticks
    reach the sizes."""
    real = time.perf_counter
    if cfg_kw.get("timestamps", True):
        time.perf_counter = _CounterClock()
    try:
        return wl.run_ranks(getattr(wl, workload), nprocs,
                            config_cls(**cfg_kw, **extra), topology,
                            fit_mode, data_dir=_sub(workload), **wl_kw)
    finally:
        time.perf_counter = real


@functools.lru_cache(maxsize=None)
def _ref(workload, nprocs, cfg_items, wl_items, topology, fit_mode):
    return _run(ref_wl, RefConfig, workload, nprocs, dict(cfg_items),
                dict(wl_items), topology, fit_mode)


# (id, workload, nprocs, RecorderConfig kwargs, workload kwargs, topology)
PARITY = (
    ("ior-flat-4", "ior_rank", 4, {"timestamps": False},
     {"n_calls": 64}, "flat"),
    ("ior-tree-16", "ior_rank", 16, {"timestamps": False},
     {"n_calls": 64}, "tree"),
    ("ior-nointer-flat-8", "ior_rank", 8,
     {"timestamps": False, "inter_patterns": False}, {"n_calls": 64}, "flat"),
    ("ior-nointra-tree-8", "ior_rank", 8,
     {"timestamps": False, "intra_patterns": False}, {"n_calls": 64},
     "tree"),
    ("ior-ticks-flat-8", "ior_rank", 8, {}, {"n_calls": 100}, "flat"),
    ("flash-flat-4", "flash_rank", 4, {"timestamps": False},
     {"iterations": 60}, "flat"),
    ("flash-tree-16", "flash_rank", 16, {"timestamps": False},
     {"iterations": 60}, "tree"),
    ("flash-flat-64", "flash_rank", 64, {"timestamps": False},
     {"iterations": 60}, "flat"),
    ("flash-rolling-flat-8", "flash_rank", 8, {"timestamps": False},
     {"iterations": 80, "rolling": True}, "flat"),
    ("flash-ticks-tree-16", "flash_rank", 16, {},
     {"iterations": 40}, "tree"),
    ("collective-flat-64", "flash_rank", 64, {"timestamps": False},
     {"iterations": 40, "mode": "collective", "stripe": 8}, "flat"),
    ("collective-tree-16-ppn4", "flash_rank", 16, {"timestamps": False},
     {"iterations": 40, "mode": "collective", "stripe": 8, "ppn": 4},
     "tree"),
    ("collective-ticks-flat-32-ppn4", "flash_rank", 32, {},
     {"iterations": 40, "mode": "collective", "stripe": 8, "ppn": 4},
     "flat"),
)


def _parity(case, fit_mode, backend):
    _id, workload, nprocs, cfg_kw, wl_kw, topology = case
    want = _ref(workload, nprocs, tuple(sorted(cfg_kw.items())),
                tuple(sorted(wl_kw.items())), topology, fit_mode)
    got = _run(port_wl, PortConfig, workload, nprocs, cfg_kw, wl_kw,
               topology, fit_mode, encode_backend=backend)
    assert got == want
    return got


@pytest.mark.parametrize("case", PARITY, ids=[c[0] for c in PARITY])
def test_run_ranks_matches_reference(case):
    got = _parity(case, "vectorized", "numpy")
    assert got["n_records"] > 0 and got["pattern_bytes"] > 0


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("fit_mode", ["python", "vectorized"])
@pytest.mark.parametrize("case", [PARITY[0], PARITY[7], PARITY[12]],
                         ids=["ior-flat-4", "flash-flat-64",
                              "collective-ticks-flat-32-ppn4"])
def test_run_ranks_fit_modes_match_reference(case, fit_mode, backend,
                                              monkeypatch):
    monkeypatch.setattr(eb, "_default_backend", backend)
    got = _parity(case, fit_mode, backend)
    assert got["n_rank_patterns"] > 0


def test_flat_and_tree_give_the_same_sizes():
    case = dict(workload="flash_rank", nprocs=16, cfg_kw={},
                wl_kw={"iterations": 40, "mode": "collective", "ppn": 4})
    flat = _run(port_wl, PortConfig, topology="flat", fit_mode="vectorized",
                encode_backend="numpy", **case)
    tree = _run(port_wl, PortConfig, topology="tree", fit_mode="vectorized",
                encode_backend="numpy", **case)
    assert flat == tree


def test_parts_are_what_the_sizes_count():
    parts = {}
    got = port_wl.run_ranks(port_wl.ior_rank, 8,
                            PortConfig(encode_backend="numpy"), "flat",
                            parts=parts, n_calls=32, data_dir=_sub("ior"))
    assert got["cst_bytes"] == sum(len(e) + 2
                                   for e in parts["merged_entries"])
    assert got["cfg_bytes"] == sum(len(c) + 2 for c in parts["unique_cfgs"])
    assert got["total_bytes"] == (got["cst_bytes"] + got["cfg_bytes"]
                                  + 2 * len(parts["cfg_index"])
                                  + sum(map(len, parts["timestamps"])))
    assert len(parts["timestamps"]) == 8
    assert [rec.rank for rec in parts["recorders"]] == list(range(8))


@pytest.mark.parametrize("topology", ["flat", "tree"])
def test_recorded_calls_finalize_again_to_the_same_bytes(topology,
                                                         monkeypatch):
    """One run of the calls, finalized again on another backend and
    topology, gives the sizes and bytes of a fresh run there."""
    parts = {}
    first = port_wl.run_ranks(
        port_wl.flash_rank, 16, PortConfig(encode_backend="numpy"), "flat",
        parts=parts, iterations=40, data_dir=_sub("flash"))
    recs = parts["recorders"]
    monkeypatch.setattr(eb, "_default_backend", "torch")
    for rec in recs:
        rec.config = dataclasses.replace(rec.config, encode_backend="torch")
    again = {}
    got = port_wl.finalize_recorders(recs, topology, parts=again)
    assert got == first
    for key in ("merged_entries", "unique_cfgs", "cfg_index", "timestamps"):
        assert again[key] == parts[key]
    assert port_wl.finalize_recorders(recs, topology) == got


# -- the example, in a subprocess ------------------------------------------


def test_example_prints_the_reference_rows(tmp_path):
    data_root = str(tmp_path / "data")
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"))
    proc = subprocess.run(
        [sys.executable,
         os.path.join(_REPO, "examples", "torch_constant_trace_scaling.py"),
         "--ranks", "4,16", "--encode-backend", "numpy",
         "--data-root", data_root],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    rows = [tuple(int(x) for x in re.findall(r"\d+", line)[:4])
            for line in proc.stdout.splitlines()
            if re.match(r"\s*\d+\s+\d+\s+\d+ B", line)]
    want = []
    for nprocs in (4, 16):
        r = ref_wl.run_ranks(ref_wl.flash_rank, nprocs,
                             RefConfig(timestamps=False),
                             data_dir=data_root, iterations=60)
        old = 0
        for rank in range(nprocs):
            tool = ref_bl.RecorderOld(rank)
            ref_wl.flash_rank(ref_bl.ToolAdapter(tool, rank=rank), rank,
                              nprocs, data_dir=data_root, iterations=60)
            old += tool.nbytes
        want.append((nprocs, r["n_records"], r["pattern_bytes"], old))
    assert rows == want
    # constant in ranks, and the baseline grows with them
    assert abs(rows[1][2] - rows[0][2]) <= 16 and rows[1][3] > 3 * rows[0][3]


def test_example_needs_a_card_unless_a_host_backend_is_named():
    if eb.has_accelerator():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"))
    proc = subprocess.run(
        [sys.executable,
         os.path.join(_REPO, "examples", "torch_constant_trace_scaling.py"),
         "--ranks", "4"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 1 and "needs a CUDA card" in proc.stderr
    assert "ranks" not in proc.stdout
