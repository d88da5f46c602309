"""The scenarios of ``tests/test_tree_finalize.py`` through both packages.

Each scenario is one function of a package namespace (``_torch_pkgs``):
it runs the reference's calls, asserts the reference test's own
properties inside that package, and returns what it computed (finalize
results, serialized states, trace bytes, reader rows).  The port, on its
``numpy`` and ``torch`` encode backends, must return exactly what the
reference returns on ``numpy``.  The hypothesis-driven reference tests
become fixed seeded cases here; every ``synth_rank_states`` pattern
appears, with rank counts that are not powers of 2.  The port's own
``synth_rank_states`` must give the reference's bytes for every pattern
at 1, 7 and 64 ranks.
"""

import os
import random

import pytest

from _torch_pkgs import BACKENDS, active, bin_files, parity, port

PATTERNS = ("linear", "constant", "irregular", "nested", "multi", "mixed",
            "mixed_all")
_both = parity()


def _finalized(res):
    m, c = res
    return (m.merged_entries, m.remaps, m.n_rank_patterns, c.unique_cfgs,
            c.cfg_index)


# -- synth_rank_states --------------------------------------------------------------


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nprocs", [1, 7, 64])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_synth_rank_states_matches_reference(pattern, nprocs, backend):
    def synth(P, pattern, nprocs):
        return P.synth(nprocs, pattern=pattern, seed=nprocs)
    csts, cfgs = _both("synth", synth, backend, pattern, nprocs)
    assert len(csts) == len(cfgs) == nprocs


# -- flat <-> tree byte identity ------------------------------------------------------


def _tree_matches_flat(P, nranks, pattern, n_groups, n_calls, seed):
    csts, cfgs = P.synth(nranks, n_groups=n_groups, n_calls=n_calls,
                         pattern=pattern, seed=seed)
    out = []
    for inter in (True, False):
        flat = _finalized(P.ip.finalize_ranks(
            csts, cfgs, P.REGISTRY, inter_patterns=inter, fit_mode="python"))
        assert _finalized(P.ip.finalize_ranks(
            csts, cfgs, P.REGISTRY, inter_patterns=inter,
            fit_mode="vectorized")) == flat
        assert _finalized(P.ip.tree_finalize_ranks(
            csts, cfgs, P.REGISTRY, inter_patterns=inter)) == flat
        out.append(flat)
    return out


TREE_CASES = [(1, "linear", 3, 5, 11), (2, "constant", 1, 1, 12),
              (5, "irregular", 4, 8, 13), (13, "mixed", 6, 3, 14),
              (31, "linear", 2, 8, 15), (64, "mixed", 5, 6, 16),
              (3, "nested", 4, 6, 17), (17, "multi", 3, 5, 18),
              (32, "mixed_all", 4, 6, 19), (9, "nested", 1, 1, 20)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", TREE_CASES, ids=lambda c: "-".join(map(
    str, c[:2])))
def test_tree_matches_flat_bytes(case, backend):
    _both("tree_flat", _tree_matches_flat, backend, *case)


def _partial_groups(P, nranks, n_groups, seed):
    rng = random.Random(seed)
    csts, cfgs = P.synth(nranks, n_groups=n_groups, n_calls=4,
                         pattern="mixed", seed=seed)
    csts = [list(c) for c in csts]
    cfgs = list(cfgs)
    for r in rng.sample(range(nranks), max(1, nranks // 4)):
        keep = rng.randrange(0, len(csts[r]))
        csts[r] = csts[r][:keep]
        g = P.Sequitur()
        for t in range(keep):
            g.push(t, rng.randrange(1, 4))
        cfgs[r] = g.serialize()
    flat = _finalized(P.ip.finalize_ranks(csts, cfgs, P.REGISTRY))
    assert _finalized(P.ip.tree_finalize_ranks(csts, cfgs, P.REGISTRY)) \
        == flat
    return flat


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", [(2, 1, 3), (7, 3, 5), (29, 5, 8),
                                  (48, 4, 9)], ids=str)
def test_tree_matches_flat_with_partial_groups(case, backend):
    _both("partial", _partial_groups, backend, *case)


def _order_invariance(P):
    csts, cfgs = P.synth(7, n_groups=3, n_calls=5, pattern="mixed", seed=3)
    leaves = [P.ip.make_rank_state(r, csts[r], cfgs[r], P.REGISTRY)
              for r in range(7)]
    tree = P.ip.tree_reduce_states([
        P.ip.make_rank_state(r, csts[r], cfgs[r], P.REGISTRY)
        for r in range(7)])
    fold = leaves[0]
    for s in leaves[1:]:
        fold = P.ip.merge_rank_states(fold, s)
    blob = P.ip.serialize_rank_state(tree)
    assert blob == P.ip.serialize_rank_state(fold)
    return blob


@pytest.mark.parametrize("backend", BACKENDS)
def test_tree_reduction_order_invariance(backend):
    _both("order", _order_invariance, backend)


def _nested_roundtrip(P, pattern, d):
    nprocs, n_groups, n_calls, chunk = 5, 2, 6, 512
    big = 1 << 24
    csts, cfgs = P.synth(nprocs, n_groups=n_groups, n_calls=n_calls,
                         pattern=pattern, chunk=chunk)
    merge, cfgres = P.ip.tree_finalize_ranks(csts, cfgs, P.REGISTRY)
    d = os.path.join(d, P.name + P.backend)
    P.tf.write_trace(d, registry=P.REGISTRY,
                     merged_cst=merge.merged_entries,
                     unique_cfgs=cfgres.unique_cfgs,
                     cfg_index=cfgres.cfg_index,
                     rank_timestamps=[b""] * nprocs, meta_extra={})
    reader = P.TraceReader(d)
    rows = []
    for r in range(nprocs):
        step = ((nprocs + r) * chunk if pattern == "nested"
                else nprocs * chunk)
        want = [r * chunk + g * big + i * step
                for g in range(n_groups) for i in range(n_calls)]
        recs = list(reader.iter_records(r, timestamps=False))
        assert [rec.arg("offset") for rec in recs] == want
        if pattern == "multi":
            assert [rec.ret for rec in recs] == want
        rows.append([repr((rec.func, rec.args, rec.ret)) for rec in recs])
    return bin_files(d), rows


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("pattern", ["nested", "multi"])
def test_synth_nested_roundtrips_through_reader(tmp_path, pattern, backend):
    _both("nested_rt", lambda P, p: _nested_roundtrip(P, p, str(tmp_path)),
          backend, pattern)


def _adjacent(P):
    csts, cfgs = P.synth(3, n_groups=1, n_calls=2)
    s0, _, s2 = (P.ip.make_rank_state(r, csts[r], cfgs[r], P.REGISTRY)
                 for r in range(3))
    with pytest.raises(ValueError) as ei:
        P.ip.merge_rank_states(s0, s2)
    return type(ei.value).__name__, str(ei.value)


@pytest.mark.parametrize("backend", BACKENDS)
def test_merge_requires_adjacent_blocks(backend):
    _both("adjacent", _adjacent, backend)


# -- state serialization --------------------------------------------------------------


def _roundtrip(P, nranks, pattern, seed):
    csts, cfgs = P.synth(nranks, n_groups=3, n_calls=6, pattern=pattern,
                         seed=seed)
    root = P.ip.tree_reduce_states([
        P.ip.make_rank_state(r, csts[r], cfgs[r], P.REGISTRY)
        for r in range(nranks)])
    blob = P.ip.serialize_rank_state(root)
    back = P.ip.deserialize_rank_state(blob)
    assert P.ip.serialize_rank_state(back) == blob
    a = _finalized(P.ip.materialize_state(root))
    assert _finalized(P.ip.materialize_state(back)) == a
    return blob, a


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", [(1, "linear", 1), (6, "constant", 2),
                                  (11, "irregular", 3), (16, "mixed", 4)],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_state_serialization_roundtrip(case, backend):
    blob, _ = _both("serial", _roundtrip, backend, *case)
    # each package reads the other's blob to the same state
    P = port(backend)
    with active(P):
        assert P.ip.serialize_rank_state(
            P.ip.deserialize_rank_state(blob)) == blob


def _merge_serialized(P):
    csts, cfgs = P.synth(4, n_groups=2, n_calls=5, seed=1)
    leaves = [P.ip.make_rank_state(r, csts[r], cfgs[r], P.REGISTRY)
              for r in range(4)]
    ser = P.ip.serialize_rank_state
    blob = P.ip.merge_serialized_states(
        P.ip.merge_serialized_states(ser(leaves[0]), ser(leaves[1])),
        P.ip.merge_serialized_states(ser(leaves[2]), ser(leaves[3])))
    assert blob == ser(P.ip.tree_reduce_states(leaves))
    return blob


@pytest.mark.parametrize("backend", BACKENDS)
def test_merge_serialized_states_matches_object_merge(backend):
    _both("merge_ser", _merge_serialized, backend)


# -- Comm.reduce_tree and the ThreadComm finalize ---------------------------------


def _reduce_tree_solo_and_generic(P):
    solo = P.comm.SoloComm().reduce_tree(b"x", lambda a, b: a + b)

    class ListComm(P.comm.Comm):
        rank, size = 0, 5

        def gather(self, obj, root=0):
            return [obj * (i + 1) for i in range(5)]

    return solo, ListComm().reduce_tree("x", lambda a, b: a + b)


@pytest.mark.parametrize("backend", BACKENDS)
def test_reduce_tree_solo_and_generic(backend):
    assert _both("reduce_generic", _reduce_tree_solo_and_generic,
                 backend) == (b"x", "x" * 15)


def _run_threaded(P, d, topology, nprocs=5, n_calls=24, chunk=512):
    trace_dir = os.path.join(d, f"{P.name}-{P.backend}-{topology}-{nprocs}")
    fid_seek = P.REGISTRY.id_of("lseek")
    fid_write = P.REGISTRY.id_of("write")

    def worker(comm, rank):
        rec = P.Recorder(rank=rank, config=P.cfg(finalize_topology=topology))
        fd = object()
        for i in range(n_calls):
            off = rank * chunk + i * nprocs * chunk
            rec.record(fid_seek, (fd, off, 0), off, 0, 2 * i, 2 * i + 1)
            rec.record(fid_write, (fd, b"x" * 64), 64, 0, 2 * i + 1,
                       2 * i + 2)
        return rec.finalize(comm, trace_dir=trace_dir)

    stats = P.comm.run_thread_world(nprocs, worker)
    assert stats[0] is not None and all(s is None for s in stats[1:])
    return trace_dir


def _tree_vs_flat_trace(P, d):
    t = bin_files(_run_threaded(P, d, "tree"))
    f = bin_files(_run_threaded(P, d, "flat"))
    for name in ("merged_cst.bin", "unique_cfgs.bin", "cfg_index.bin"):
        assert t[name] == f[name], name
    return t


@pytest.mark.parametrize("backend", BACKENDS)
def test_threadcomm_tree_trace_matches_flat(tmp_path, backend):
    _both("tc_tree_flat", lambda P: _tree_vs_flat_trace(P, str(tmp_path)),
          backend)


def _nonpow2(P, d, nprocs):
    td = _run_threaded(P, d, "tree", nprocs=nprocs)
    assert P.TraceReader(td).nranks == nprocs
    return bin_files(td)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("nprocs", [3, 6, 7])
def test_threadcomm_tree_nonpow2(tmp_path, nprocs, backend):
    _both("tc_nonpow2", lambda P, n: _nonpow2(P, str(tmp_path), n), backend,
          nprocs)


def _reader_roundtrip(P, d):
    nprocs, n_calls, chunk = 6, 30, 512
    td = _run_threaded(P, d, "tree", nprocs=nprocs, n_calls=n_calls,
                       chunk=chunk)
    reader = P.TraceReader(td)
    assert reader.nranks == nprocs and len(reader.unique_cfgs) == 1
    out = []
    for r in range(nprocs):
        offs = [rec.arg("offset") for rec in reader.iter_records(r)
                if rec.func == "lseek"]
        assert offs == [r * chunk + i * nprocs * chunk
                        for i in range(n_calls)]
        out.append(offs)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_reader_roundtrip_tree_finalized(tmp_path, backend):
    _both("reader_rt", lambda P: _reader_roundtrip(P, str(tmp_path)),
          backend)


def _env_topology(P, monkeypatch):
    monkeypatch.setenv("RECORDER_FINALIZE_TOPOLOGY", "flat")
    flat = P.RecorderConfig.from_env().finalize_topology
    monkeypatch.delenv("RECORDER_FINALIZE_TOPOLOGY")
    return flat, P.RecorderConfig.from_env().finalize_topology


@pytest.mark.parametrize("backend", BACKENDS)
def test_recorder_env_topology(monkeypatch, backend):
    assert _both("env_topo", lambda P: _env_topology(P, monkeypatch),
                 backend) == ("flat", "tree")


# -- vectorized fitting and batched intra-pattern encoding ------------------------


def _fit_columns(seed):
    rng = random.Random(seed)
    n = rng.randrange(3, 7)
    cols = []
    for _ in range(rng.randrange(0, 9)):
        kind = rng.random()
        if kind < 0.3:
            v = rng.randrange(-2 ** 40, 2 ** 40)
            cols.append([v] * n)
        elif kind < 0.6:
            b, s = rng.randrange(-2 ** 40, 2 ** 40), rng.randrange(-999, 999)
            cols.append([b + s * i for i in range(n)])
        else:
            cols.append([rng.randrange(-2 ** 40, 2 ** 40) for _ in range(n)])
    return cols


def _batch_fit(P, seed, bigint=False):
    cols = ([[1 << 70, (1 << 70) + 5, (1 << 70) + 10], [7, 7, 7]] if bigint
            else _fit_columns(seed))
    got = P.ip.batch_fit_columns(cols)
    assert got == [P.ip._fit_component(c) for c in cols]
    return [repr(g) for g in got]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", range(6))
def test_batch_fit_matches_scalar(seed, backend):
    _both("batch_fit", _batch_fit, backend, seed)


@pytest.mark.parametrize("backend", BACKENDS)
def test_batch_fit_bigint_fallback(backend):
    _both("batch_fit_big", _batch_fit, backend, 0, True)


def _encode_many(P, seed, arity):
    rng = random.Random(seed)
    vals = [rng.randrange(0, 2 ** 20) for _ in range(rng.randrange(0, 50))]
    rows = []
    i = 0
    while i < len(vals):
        if rng.random() < 0.5:
            a, n = rng.randrange(0, 4096), rng.randrange(1, 8)
            rows.extend(tuple(vals[i] + j * a + s for s in range(arity))
                        for j in range(n))
        else:
            rows.append(tuple(vals[i] + s for s in range(arity)))
        i += 1
    seq, bat = P.IntraPatternTracker(), P.IntraPatternTracker()
    out_seq = [seq.encode("k", r) for r in rows]
    out_bat = bat.encode_many("k", rows)
    assert out_seq == out_bat
    rs, rb = seq._runs.get("k"), bat._runs.get("k")
    assert (rs is None) == (rb is None)
    run = None
    if rs is not None:
        run = (rs.index, rs.base, rs.stride)
        assert run == (rb.index, rb.base, rb.stride)
    return repr(out_bat), run


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arity", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_encode_many_matches_sequential(seed, arity, backend):
    _both("encode_many", _encode_many, backend, seed, arity)


def _continues_run(P):
    seq, bat = P.IntraPatternTracker(), P.IntraPatternTracker()
    head = [(0,), (8,)]
    tail = [(16,), (24,), (99,), (100,)]
    for r in head:
        assert seq.encode("k", r) == bat.encode("k", r)
    out = bat.encode_many("k", tail)
    assert [seq.encode("k", r) for r in tail] == out
    return repr(out)


@pytest.mark.parametrize("backend", BACKENDS)
def test_encode_many_continues_existing_run(backend):
    _both("continues", _continues_run, backend)


# -- scaling: the merged state stays O(groups) --------------------------------------


def _constant_in_ranks(P):
    def root(n):
        return P.ip.tree_reduce_states(
            [P.ip.make_rank_state(r, *rc, P.REGISTRY) for r, rc in
             enumerate(zip(*P.synth(n, n_groups=4, n_calls=8)))])
    small, big = root(8), root(128)
    assert len(big.streams) == len(small.streams) == 1
    assert len(big.groups) == len(small.groups)
    a, b = (P.ip.serialize_rank_state(s) for s in (small, big))
    assert len(b) <= len(a) + 2 * (128 - 8) + 16
    return a, b


@pytest.mark.parametrize("backend", BACKENDS)
def test_tree_state_constant_in_ranks(backend):
    _both("constant_ranks", _constant_in_ranks, backend)


def _stream_cache(P, nranks, pattern, n_groups, n_calls, seed):
    csts, cfgs = P.synth(nranks, n_groups=n_groups, n_calls=n_calls,
                         pattern=pattern, seed=seed)
    state = P.ip.tree_reduce_states([
        P.ip.make_rank_state(r, csts[r], cfgs[r], P.REGISTRY)
        for r in range(nranks)])
    out = []
    for inter in (True, False):
        cached = _finalized(P.ip.materialize_state(
            state, inter_patterns=inter, cache_streams=True))
        assert cached == _finalized(P.ip.materialize_state(
            state, inter_patterns=inter, cache_streams=False))
        assert cached == _finalized(P.ip.finalize_ranks(
            csts, cfgs, P.REGISTRY, inter_patterns=inter))
        out.append(cached)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", [(2, "linear", 1, 1, 1),
                                  (5, "irregular", 3, 4, 2),
                                  (12, "mixed", 5, 6, 3),
                                  (24, "mixed_all", 4, 5, 4),
                                  (7, "constant", 2, 3, 5)],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_materialize_stream_cache_matches_uncached(case, backend):
    _both("stream_cache", _stream_cache, backend, *case)
