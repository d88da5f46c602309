"""The durability path across processes: two 4-process worlds over
``TorchDistComm`` (the port, ``numpy`` backend), held against the JAX
package's ``ThreadComm`` run of the same calls.

Rank 1 is mute in the first flush (a seeded ``FaultPlan``), so epoch 0 is
committed degraded and rank 1's records ride epoch 1.  World A then
crashes: rank 0's commit of epoch 2 dies at ``pre-manifest`` (a
``SimulatedCrash``, a ``BaseException``), so the world ends in
``WorldError`` naming rank 0.  World B is the restarted job in the same
directory: it records epoch 2's and epoch 3's calls again and finalizes.
Epochs 0-1 of world A, and every segment and ``merged/`` of world B, must
be the reference's uninterrupted run's bytes, masks and counters.
"""

import os

import pytest

import _torch_dist_workers as workers
from _torch_pkgs import bin_files
from repro.core import comm as ref_comm
from repro.core import trace_format as ref_tf
from repro_torch.core import comm as port_comm
from repro_torch.core import encode_backend as eb
from repro_torch.core import trace_format as port_tf

DEADLINE_S = 90.0


def _segments_of(bins, names):
    return {p: b for p, b in bins.items() if p.split(os.sep)[0] in names}


def _segments(root, names):
    return _segments_of(bin_files(root), names)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The reference's uninterrupted ThreadComm run, then worlds A and B;
    what each left behind, read as soon as it ended."""
    base = tmp_path_factory.mktemp("durable")
    ref_dir, sd = str(base / "ref"), str(base / "procs")
    ref = ref_comm.run_thread_world(
        workers.NPROCS, lambda comm, rank: workers.durability_rank(
            comm, rank, "repro", ref_dir, "whole"))
    saved = eb.default_backend()
    eb.set_default_backend("numpy")
    try:
        with pytest.raises(port_comm.WorldError) as ei:
            port_comm.run_process_world(
                workers.NPROCS, workers.durability_rank,
                ("repro_torch", sd, "crash"), deadline_s=DEADLINE_S,
                workdir=str(base / "world_a"))
        crashed = {"error": ei.value, "manifest": port_tf.read_manifest(sd),
                   "bins": bin_files(sd),
                   "orphan": os.path.isdir(os.path.join(
                       sd, port_tf.segment_name(2)))}
        resumed = port_comm.run_process_world(
            workers.NPROCS, workers.durability_rank,
            ("repro_torch", sd, "resume"), deadline_s=DEADLINE_S,
            workdir=str(base / "world_b"))
    finally:
        eb.set_default_backend(saved)
    return ref_dir, ref, sd, crashed, resumed


def test_degraded_epoch_across_processes_matches_threadcomm(worlds):
    """World A's epochs 0 and 1: rank 1 mute in the first flush, so epoch
    0 carries ``ranks_present`` [0, 2, 3] and rank 1's records ride epoch
    1, as in the reference's ThreadComm run."""
    ref_dir, ref, _sd, crashed, _ = worlds
    assert [r[0] for r in ref] == [[0, 2, 3]] * workers.NPROCS
    assert [r[2] for r in ref] == [0, 1, 0, 0]      # rank 1 retried
    ref_m = ref_tf.read_manifest(ref_dir)
    m = crashed["manifest"]
    assert [e["epoch"] for e in m["segments"]] == [0, 1]
    for got, want in zip(m["segments"], ref_m["segments"]):
        assert got.get("ranks_present") == want.get("ranks_present")
        assert got["n_records"] == want["n_records"]
        got["crcs"].pop("metadata.json")
        assert got["crcs"] == {k: v for k, v in want["crcs"].items()
                               if k != "metadata.json"}
    assert m["segments"][0]["ranks_present"] == [0, 2, 3]
    first = [port_tf.segment_name(e) for e in (0, 1)]
    got = _segments_of(crashed["bins"], first)
    assert got and got == _segments(ref_dir, first)


def test_crash_then_resume_across_processes_matches_uninterrupted(worlds):
    """World A ends in ``WorldError`` naming rank 0 and leaves epoch 2 an
    orphan no manifest lists; world B resumes the two committed epochs,
    overwrites the orphan and finalizes: every segment and ``merged/``
    are the reference's uninterrupted run's."""
    ref_dir, _ref, sd, crashed, resumed = worlds
    assert 0 in crashed["error"].errors
    assert "SimulatedCrash" in crashed["error"].errors[0]
    assert "merged" not in crashed["manifest"] and crashed["orphan"]
    assert resumed[0][1] == 2                        # two epochs resumed
    got, want = bin_files(sd), bin_files(ref_dir)
    assert any(p.startswith("merged") for p in got)
    assert got == want
    m, m_ref = port_tf.read_manifest(sd), ref_tf.read_manifest(ref_dir)
    assert [e.get("ranks_present") for e in m["segments"]] == \
        [e.get("ranks_present") for e in m_ref["segments"]]
    assert [e["n_records"] for e in m["segments"]] == \
        [e["n_records"] for e in m_ref["segments"]]
