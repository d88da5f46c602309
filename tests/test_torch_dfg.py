"""The port's ``core/dfg.py`` and the view's DFG, phase and divergence
queries against the JAX package's.

- Every grammar walk of ``dfg`` (digrams, folds, episodes, phases,
  distances) gives the reference's value on grammars both packages'
  Sequitur induced from the same seeded stream.
- Over the reference benchmarks' synthetic rank-state shapes, finalized by
  each package, the port's ``TraceView.dfg``/``phases``/
  ``rank_divergence``/``digram_counts`` equal the reference's.
- A structurally odd rank is flagged the same way, a degraded epoch
  carries the same PARTIAL warning, and a live reader's refresh walks
  only the new segment's grammar, as in the reference.
"""

import random
import warnings

import pytest

import repro.core.apis  # noqa: F401  (populate the reference registry)
import repro_torch.core.apis  # noqa: F401  (populate the port's registry)
from benchmarks.workloads import synth_rank_states
from repro.core import dfg as ref_dfg
from repro.core import interprocess as ref_ip
from repro.core import reader as ref_reader
from repro.core import sequitur as ref_seq
from repro.core import trace_format as ref_tf
from repro.core.specs import REGISTRY as REF_REGISTRY
from repro_torch.core import comm as port_comm
from repro_torch.core import dfg as port_dfg
from repro_torch.core import encode_backend as eb
from repro_torch.core import faults as port_faults
from repro_torch.core import interprocess as port_ip
from repro_torch.core import reader as port_reader
from repro_torch.core import recorder as port_recorder
from repro_torch.core import sequitur as port_seq
from repro_torch.core import trace_format as port_tf
from repro_torch.core.specs import REGISTRY as PORT_REGISTRY

SHAPES = ["linear", "constant", "irregular", "nested", "multi", "mixed",
          "mixed_all"]


@pytest.fixture(autouse=True)
def cpu_default(monkeypatch):
    """Grammar and cfg_index packing follow the port's module default,
    which is ``cuda``: point it at the plain PyTorch versions."""
    monkeypatch.setattr(eb, "_default_backend", "torch")
    yield
    port_faults.uninstall()


def _stream(rng, alphabet, n_blocks=6):
    s = []
    for _ in range(rng.randrange(1, n_blocks)):
        block = [rng.randrange(alphabet) for _ in range(rng.randrange(1, 5))]
        s += block * rng.randrange(1, 12)
    return s


def _grammars(stream):
    """(port rules, reference rules) induced from ``stream``; the two
    serialized grammars must be the same bytes."""
    p, r = port_seq.Sequitur(), ref_seq.Sequitur()
    for t in stream:
        p.push(t)
        r.push(t)
    assert p.serialize() == r.serialize()
    return (port_seq.parse_grammar(p.serialize()),
            ref_seq.parse_grammar(r.serialize()))


@pytest.mark.parametrize("seed", range(12))
def test_grammar_walks_match_reference(seed):
    rng = random.Random(seed)
    s1, s2 = _stream(rng, 6), _stream(rng, 5)
    (p1, r1), (p2, r2) = _grammars(s1), _grammars(s2)
    name = "f{}".format
    pd, rd = port_dfg, ref_dfg
    assert pd.grammar_digrams(p1) == rd.grammar_digrams(r1)
    assert pd.stream_digrams(s1) == rd.stream_digrams(s1)
    eps = pd.grammar_episodes(p1, name)
    assert eps == rd.grammar_episodes(r1, name)
    ph = pd.phase_segments(eps)
    assert ph == rd.phase_segments(eps)
    assert pd.phase_report(ph) == rd.phase_report(ph)
    toff = 1000
    assert (pd.fold_digrams(pd.grammar_digrams(p1),
                            pd.grammar_digrams(p2), toff)
            == rd.fold_digrams(rd.grammar_digrams(r1),
                               rd.grammar_digrams(r2), toff))
    seg = pd.phase_segments(pd.grammar_episodes(
        p2, lambda t: name(t + toff)))
    assert (pd.fold_phases(ph, seg, len(s1))
            == rd.fold_phases(ph, seg, len(s1)))
    e1, e2 = pd.stream_digrams(s1), pd.stream_digrams(s2)
    assert pd.dfg_distance(e1, e2) == rd.dfg_distance(e1, e2)


def _synth_trace(ip, tf, registry, d, nranks, pattern):
    csts, cfgs = synth_rank_states(nranks, n_groups=4, n_calls=40,
                                   pattern=pattern, seed=11)
    merge, cfgres = ip.tree_finalize_ranks(csts, cfgs, registry)
    tf.write_trace(d, registry=registry, merged_cst=merge.merged_entries,
                   unique_cfgs=cfgres.unique_cfgs, cfg_index=cfgres.cfg_index,
                   rank_timestamps=[b""] * nranks, meta_extra={})
    return d


def _observability(view, nranks):
    out = {"dfg": view.dfg(), "divergence": view.rank_divergence(),
           "divergence_tight": view.rank_divergence(threshold=0.01),
           "digram_all": view.digram_counts(rank=None)}
    for r in range(nranks):
        out[r] = (view.dfg(r), view.phases(r), view.digram_counts(r))
    return out


@pytest.mark.parametrize("pattern", SHAPES)
def test_synth_shapes_match_reference(tmp_path, pattern):
    nranks = 5
    port_d = _synth_trace(port_ip, port_tf, PORT_REGISTRY,
                          str(tmp_path / "port"), nranks, pattern)
    ref_d = _synth_trace(ref_ip, ref_tf, REF_REGISTRY,
                         str(tmp_path / "ref"), nranks, pattern)
    for d in (port_d, ref_d):
        port = port_reader.TraceReader(d).view()
        ref = ref_reader.TraceReader(d).view()
        assert _observability(port, nranks) == _observability(ref, nranks)
        for r in list(range(nranks)) + [None]:
            want = ref.digram_counts(r)
            for b in ("python", "numpy", "torch"):
                assert port.digram_counts(r, backend=b) == want, (r, b)


def _divergent_world(registry, nranks, odd, n=40):
    fid = registry.id_of
    world = []
    for r in range(nranks):
        fd = f"fd-{r}"
        calls = [(fid("open"), ("/data/f.bin", 2, 438), fd)]
        for i in range(n):
            if r == odd:
                calls.append((fid("lseek"), (fd, 64 * i, 0), 64 * i))
                calls.append((fid("lseek"), (fd, 64 * i + 8, 0), 64 * i + 8))
                if i % 4 == 0:
                    calls.append((fid("pwrite"), (fd, b"x" * 64, 64 * i),
                                  64))
            else:
                off = r * 4096 + i * nranks * 4096
                calls.append((fid("pwrite"), (fd, b"x" * 4096, off), 4096))
        calls.append((fid("close"), (fd,), 0))
        world.append(calls)
    return world


def _feed(rec, calls, t=0):
    for fid, args, ret in calls:
        rec.record(fid, args, ret, 0, t, t + 1)
        t += 2
    return t


def test_divergent_rank_flagged_like_reference(tmp_path):
    nranks, odd = 6, 4
    d = str(tmp_path / "job")
    states = []
    for r, calls in enumerate(_divergent_world(PORT_REGISTRY, nranks, odd)):
        rec = port_recorder.Recorder(rank=r, config=port_recorder.
                                     RecorderConfig(encode_backend="torch"))
        _feed(rec, calls)
        states.append(rec.local_state())
    merge, cfgs = port_ip.finalize_ranks([s[0] for s in states],
                                         [s[1] for s in states],
                                         PORT_REGISTRY)
    port_tf.write_trace(d, registry=PORT_REGISTRY,
                        merged_cst=merge.merged_entries,
                        unique_cfgs=cfgs.unique_cfgs,
                        cfg_index=cfgs.cfg_index,
                        rank_timestamps=[s[2] for s in states],
                        meta_extra={})
    port = port_reader.TraceReader(d).view()
    rep = port.rank_divergence(threshold=0.25)
    assert rep["divergent"] == [odd]
    assert rep["majority_size"] == nranks - 1
    assert rep == ref_reader.TraceReader(d).view().rank_divergence(0.25)
    assert (_observability(port, nranks)
            == _observability(ref_reader.TraceReader(d).view(), nranks))


def test_degraded_epoch_warns_like_reference(tmp_path):
    sd = str(tmp_path / "job")
    nranks, dead = 4, 1
    world = _divergent_world(PORT_REGISTRY, nranks, odd=-1, n=16)

    def worker(comm, rank):
        rec = port_recorder.Recorder(rank=rank, config=port_recorder.
                                     RecorderConfig(trace_dir=sd,
                                                    flush_timeout_s=2.0,
                                                    encode_backend="torch"))
        t = _feed(rec, world[rank][:8])
        rec.flush(comm)
        comm.barrier()
        if rank == 0:
            port_faults.install(port_faults.FaultPlan(dead_ranks=(dead,)))
        comm.barrier()
        _feed(rec, world[rank][8:], t)
        rec.flush(comm)              # degraded commit without `dead`
        return None

    port_comm.run_thread_world(nranks, worker)
    port_faults.uninstall()
    with pytest.warns(RuntimeWarning, match="PARTIAL"):
        port = port_reader.TraceReader(sd, mode="stitched").view()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ref = ref_reader.TraceReader(sd, mode="stitched").view()
    assert port.dfg()["n_records"] == port.total_records()
    assert port.phases(dead)[-1]["end_record"] == port.n_records(dead)
    assert _observability(port, nranks) == _observability(ref, nranks)


def test_refresh_walks_only_the_new_segment(tmp_path, monkeypatch):
    """A live stitched reader folds each epoch with one grammar walk of
    the new segment only, and the folded answers equal a from-scratch
    reference read."""
    sd = str(tmp_path / "s")
    (calls,) = _divergent_world(PORT_REGISTRY, 1, odd=0, n=60)
    bounds = [0, 50, 100, len(calls)]
    rec = port_recorder.Recorder(rank=0, config=port_recorder.RecorderConfig(
        trace_dir=sd, encode_backend="torch"))
    t = _feed(rec, calls[:bounds[1]])
    rec.flush()
    reader = port_reader.TraceReader(sd, mode="stitched")
    view = reader.view()
    view.phases(0)
    view.digram_counts(0)
    walks = []
    real_gd, real_ge = port_dfg.grammar_digrams, port_dfg.grammar_episodes
    monkeypatch.setattr(port_dfg, "grammar_digrams",
                        lambda rules: (walks.append("d") or real_gd(rules)))
    monkeypatch.setattr(port_dfg, "grammar_episodes",
                        lambda rules, name_of: (walks.append("e") or
                                                real_ge(rules, name_of)))
    for i in range(1, len(bounds) - 1):
        t = _feed(rec, calls[bounds[i]:bounds[i + 1]], t)
        rec.flush()
        walks.clear()
        assert reader.refresh() == 1
        assert sorted(walks) == ["d", "e"]
        walks.clear()
        view = reader.view()
        ref = ref_reader.TraceReader(sd, mode="stitched").view()
        assert view.phases(0) == ref.phases(0)
        assert view.digram_counts(0) == ref.digram_counts(0)
        assert view.dfg(0) == ref.dfg(0)
        assert walks == []           # answered from the folded memos
