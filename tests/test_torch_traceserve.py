"""The port's trace query service and its CLI against the JAX package's.

Over one root holding plain, finalized-streaming and live jobs written by
both packages, the port's ``TraceService`` must answer every family of
``QUERY_FAMILIES`` (and the league table, straggler, phase and anomaly
reports) with the reference service's values; the port's CLI must print
the reference CLI's JSON, in process and as ``python -m``; timing fields
(``staleness_s``, latency) are left out of every comparison.  A live job
costs the port's cache exactly one segment fold per committed epoch.
"""

import json
import os
import random
import subprocess
import sys

import pytest

import repro.core.apis  # noqa: F401  (populate the reference registry)
import repro_torch.core.apis  # noqa: F401  (populate the port's registry)
from repro.core import recorder as ref_recorder
from repro.core.specs import REGISTRY as REF_REGISTRY
from repro.launch import traceserve as ref_cli
from repro.traceserve import TraceService as RefService
from repro_torch.core import encode_backend as eb
from repro_torch.core import recorder as port_recorder
from repro_torch.core import trace_format as port_tf
from repro_torch.core.specs import REGISTRY as PORT_REGISTRY
from repro_torch.launch import traceserve as port_cli
from repro_torch.traceserve import QUERY_FAMILIES, TraceService

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIMING = {"staleness_s", "latency_s", "staleness_mean_s", "staleness_max_s"}


@pytest.fixture(autouse=True)
def cpu_default(monkeypatch):
    """Grammar and cfg_index packing follow the port's module default,
    which is ``cuda``: point it at the plain PyTorch versions."""
    monkeypatch.setattr(eb, "_default_backend", "torch")


def untimed(doc):
    """``doc`` with every timing field removed, at any depth."""
    if isinstance(doc, dict):
        return {k: untimed(v) for k, v in doc.items() if k not in _TIMING}
    if isinstance(doc, list):
        return [untimed(v) for v in doc]
    return doc


def job_calls(registry, seed, n_calls, rank=0, nranks=1):
    rng = random.Random(seed)
    fid = registry.id_of
    fd = f"fd-{rank}"
    calls = [(fid("open"), ("/data/f.bin", 2, 438), fd)]
    for i in range(n_calls):
        kind = rng.random()
        if kind < 0.6:
            off = rank * 4096 + i * nranks * 4096
            calls.append((fid("pwrite"), (fd, b"x" * 4096, off), 4096))
        elif kind < 0.8:
            calls.append((fid("lseek"), (fd, rank * 256 + i * 256, 0),
                          rank * 256 + i * 256))
        else:
            calls.append((fid("write"), (fd, b"z" * 128), 128))
    calls.append((fid("close"), (fd,), 0))
    return calls


def feed(rec, calls, t=0):
    for fid, args, ret in calls:
        rec.record(fid, args, ret, 0, t, t + 1)
        t += 2
    return t


def stream_job(rec_mod, registry, backend, d, seed, cuts, finalize):
    """One rank committing an epoch at every cut, then (optionally) a
    clean finalize."""
    calls = job_calls(registry, seed, cuts[-1])
    rec = rec_mod.Recorder(rank=0, config=rec_mod.RecorderConfig(
        trace_dir=d, encode_backend=backend))
    t = 0
    for a, b in zip(cuts, cuts[1:]):
        t = feed(rec, calls[a:b], t)
        rec.flush()
    if finalize:
        rec.finalize()
    return d


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    old = eb.default_backend()
    eb.set_default_backend("torch")       # as cpu_default, for this scope
    try:
        base = tmp_path_factory.mktemp("runs")
        stream_job(port_recorder, PORT_REGISTRY, "torch",
                   str(base / "port_live"), 1, [0, 30, 60, 90], False)
        stream_job(port_recorder, PORT_REGISTRY, "torch",
                   str(base / "port_done"), 2, [0, 40, 80], True)
        stream_job(ref_recorder, REF_REGISTRY, "numpy",
                   str(base / "ref_live"), 3, [0, 25, 70], False)
        rec = port_recorder.Recorder(rank=0, config=port_recorder.
                                     RecorderConfig(
                                         trace_dir=str(base / "port_plain"),
                                         encode_backend="torch"))
        feed(rec, job_calls(PORT_REGISTRY, 4, 50))
        rec.finalize()
        return str(base)
    finally:
        eb.set_default_backend(old)


JOBS = ("port_live", "port_done", "ref_live", "port_plain")


def _params(family):
    return {"bandwidth_bounds": {"t0": 0, "t1": 120},
            "overlap_ratio": {"t0": 10, "t1": 90}}.get(family, {})


def test_service_answers_every_family_like_reference(root):
    with TraceService(root, max_staleness_s=0.0) as port, \
            RefService(root, max_staleness_s=0.0) as ref:
        assert sorted(port.jobs()) == sorted(ref.jobs()) == sorted(JOBS)
        for job in JOBS:
            for family in QUERY_FAMILIES:
                got = port.query(job, family, _params(family)).to_dict()
                want = ref.query(job, family, _params(family)).to_dict()
                assert untimed(got) == untimed(want), (job, family)
            assert port.stragglers(job) == ref.stragglers(job)
            assert (untimed(port.phases(job).to_dict())
                    == untimed(ref.phases(job).to_dict()))
            assert (untimed(port.anomalies(job).to_dict())
                    == untimed(ref.anomalies(job).to_dict()))
        assert port.league_table() == ref.league_table()
        assert untimed(port.stats()) == untimed(ref.stats())


CLI_ARGS = (
    ["--list"],
    ["--league"],
    ["--job", "port_live", "--query", "io_summary"],
    ["--job", "ref_live", "--query", "digram_counts", "--top", "5"],
    ["--job", "port_done", "--query", "dfg", "--rank", "0"],
    ["--job", "port_live", "--query", "bandwidth_bounds", "--t0", "0",
     "--t1", "150"],
    ["--job", "port_plain", "--stragglers"],
    ["--job", "port_done", "--phases"],
    ["--job", "ref_live", "--anomalies"],
    ["--mode", "stitched", "--job", "port_done", "--query", "n_records"],
    ["--watch", "--iterations", "1"],
)


@pytest.mark.parametrize("args", CLI_ARGS, ids=lambda a: "_".join(a)[:40])
def test_cli_prints_reference_json(root, args, capsys):
    argv = ["--root", root, "--staleness", "0"] + args
    assert port_cli.main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert ref_cli.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert untimed(got) == untimed(want)


def test_cli_runs_as_a_module(root, capsys):
    argv = ["--root", root, "--job", "port_live", "--query", "io_summary"]
    env = dict(os.environ, PYTHONPATH=os.path.join(_REPO, "src"))
    proc = subprocess.run([sys.executable, "-m",
                           "repro_torch.launch.traceserve",
                           "--encode-backend", "torch"] + argv,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert ref_cli.main(argv) == 0
    assert (untimed(json.loads(proc.stdout))
            == untimed(json.loads(capsys.readouterr().out)))


def test_cli_needs_a_job(root, capsys):
    assert port_cli.main(["--root", root, "--query", "io_summary"]) == 2
    assert "--query needs --job" in capsys.readouterr().err


def test_one_fold_per_committed_epoch(tmp_path):
    """A live job queried after each committed epoch: the port's cache
    folds exactly one segment per epoch, never rebuilds, and every answer
    equals a fresh reference service's."""
    root = tmp_path / "runs"
    sd = str(root / "job")
    calls = job_calls(PORT_REGISTRY, 9, 120)
    rec = port_recorder.Recorder(rank=0, config=port_recorder.RecorderConfig(
        trace_dir=sd, encode_backend="torch"))
    t = feed(rec, calls[:20])
    rec.flush()
    with TraceService(str(root), max_staleness_s=0.0) as svc:
        svc.query("job", "io_summary")
        folds = svc.stats()["cache"]["segment_folds"]
        assert folds == 0
        for epoch, (a, b) in enumerate(zip(range(20, 120, 25),
                                           range(45, 145, 25)), start=2):
            t = feed(rec, calls[a:b], t)
            rec.flush()
            assert len(port_tf.read_manifest(sd)["segments"]) == epoch
            got = {f: svc.query("job", f, _params(f)).value
                   for f in QUERY_FAMILIES}
            stats = svc.stats()["cache"]
            assert stats["segment_folds"] == folds + 1
            assert stats["view_builds"] == 1
            folds += 1
            with RefService(str(root), max_staleness_s=0.0) as ref:
                want = {f: ref.query("job", f, _params(f)).value
                        for f in QUERY_FAMILIES}
            assert got == want
