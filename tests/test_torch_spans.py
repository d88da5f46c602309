"""``repro_torch.spans`` and the port's spans at its layer boundaries.

Off, a span is the one shared no-op and nothing is kept.  On, spans nest
by thread, the ring drops its oldest entries and counts them, and
``collect()`` hands everything over once.  A Recorder's streaming job
gives its flush and finalize phases in order under their parents, and its
trace directory is byte-identical to the same job's with spans off.  The
Trainer's ``step_time_s`` and the engine's ``prefill_s`` are the times of
their spans.
"""

import os
import sys
import threading

import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get_smoke_config
from repro_torch.core import encode_backend as eb
from repro_torch.core.recorder import Recorder, RecorderConfig
from repro_torch.core.specs import REGISTRY
from repro_torch.data import SyntheticConfig, synthetic_batch
from repro_torch.optim import AdamWConfig
from repro_torch.serve import ServeEngine
from repro_torch.train.loop import Trainer, TrainerConfig

FLUSH_CHILDREN = ["flush.snapshot", "flush.reduce", "flush.encode_ts",
                  "flush.materialize", "flush.write", "flush.fold",
                  "flush.barrier"]


@pytest.fixture(autouse=True)
def spans_off(monkeypatch):
    """Every test starts and ends with spans off and nothing kept; the
    port's encode default points at NumPy (grammar packing follows it)."""
    monkeypatch.setattr(eb, "_default_backend", "numpy")
    spans.disable()
    spans.collect()
    yield
    spans.disable()
    spans.collect()


def _dur(r):
    return r.end_ns - r.start_ns


def _children(recs, parent):
    return sorted((r for r in recs if r.parent == parent.id),
                  key=lambda r: r.start_ns)


# -- the module -------------------------------------------------------------


def test_off_records_nothing_and_returns_the_shared_noop():
    a, b = spans.span("a", step=1), spans.span("b")
    assert a is b is spans.NOOP
    with a:
        spans.count("c", 5)
    with spans.timed("t") as t:
        pass
    assert t.end_ns >= t.start_ns and t.seconds >= 0
    assert spans.collect() == {"spans": [], "counters": {}, "dropped": 0}


def test_parents_and_threads():
    spans.enable()
    with spans.span("outer", step=3):
        with spans.span("inner"):
            pass

        def other():
            with spans.span("other"):
                pass
        th = threading.Thread(target=other)
        th.start()
        th.join(10)
        assert not th.is_alive()
    recs = spans.collect()["spans"]
    assert [r.name for r in recs] == ["inner", "other", "outer"]
    by = {r.name: r for r in recs}
    assert by["outer"].parent == 0 and by["outer"].attrs == {"step": 3}
    assert by["inner"].parent == by["outer"].id
    assert by["outer"].tid == by["inner"].tid == threading.get_ident()
    # the other thread's innermost open span is none of this thread's
    assert by["other"].parent == 0 and by["other"].tid != by["outer"].tid
    assert (by["outer"].start_ns <= by["inner"].start_ns
            <= by["inner"].end_ns <= by["outer"].end_ns)
    assert len({r.id for r in recs}) == 3


def test_ring_overflow_counts_drops():
    spans.enable()
    for i in range(spans.RING + 5):
        with spans.span("s", i=i):
            pass
    out = spans.collect()
    assert out["dropped"] == 5 and len(out["spans"]) == spans.RING
    assert out["spans"][0].attrs["i"] == 5
    assert out["spans"][-1].attrs["i"] == spans.RING + 4


def test_collect_clears():
    spans.enable()
    with spans.span("s"):
        spans.count("n")
        spans.count("n", 2)
    first = spans.collect()
    assert [r.name for r in first["spans"]] == ["s"]
    assert first["counters"] == {"n": 3}
    assert spans.collect() == {"spans": [], "counters": {}, "dropped": 0}


@pytest.mark.parametrize("on", [False, True])
def test_timed_keeps_its_time_and_records_only_when_on(on):
    if on:
        spans.enable()
    with spans.timed("t", k=1) as t:
        pass
    recs = spans.collect()["spans"]
    assert t.end_ns >= t.start_ns
    if on:
        assert [(r.name, r.start_ns, r.end_ns, r.attrs) for r in recs] == \
            [("t", t.start_ns, t.end_ns, {"k": 1})]
    else:
        assert recs == []


def test_counts_and_spans_from_many_threads_lose_nothing():
    """More threads than cores, a short switch interval: every count and
    every span of every thread is kept."""
    n_threads, n = 4 * (os.cpu_count() or 1) + 4, 400
    spans.enable()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with spans.span("w"):
                    spans.count("n")
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    out = spans.collect()
    assert out["counters"] == {"n": n_threads * n}
    assert len(out["spans"]) == n_threads * n and out["dropped"] == 0
    assert all(r.parent == 0 for r in out["spans"])


# -- the Recorder -----------------------------------------------------------


def _recorder_job(trace_dir, async_flush):
    """Deterministic calls and ticks: three flushes and a tail."""
    fid = {n: REGISTRY.id_of(n) for n in ("open", "pwrite", "lseek",
                                          "close")}
    rec = Recorder(config=RecorderConfig(trace_dir=trace_dir,
                                         encode_backend="numpy",
                                         async_flush=async_flush))
    t = 0
    rec.record(fid["open"], ("/data/f.bin", 2, 438), "fd", 0, t, t + 1)
    for epoch in range(4):
        for i in range(50):
            t += 2
            off = (epoch * 50 + i) * 4096
            rec.record(fid["lseek"], ("fd", off, 0), off, 0, t, t + 1)
            rec.record(fid["pwrite"], ("fd", b"x" * 64, off), 64, 0, t,
                       t + 1)
        if epoch < 3:
            rec.flush()
            rec.drain()
    rec.record(fid["close"], ("fd",), 0, 0, t + 2, t + 3)
    rec.finalize()
    return rec


def _files(root):
    out = {}
    for d, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(d, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("async_flush", [False, True])
def test_recorder_phases_nest_and_leave_the_trace_as_it_was(tmp_path,
                                                            async_flush):
    _recorder_job(str(tmp_path / "off"), async_flush)
    assert spans.collect()["spans"] == []
    spans.enable()
    _recorder_job(str(tmp_path / "on"), async_flush)
    out = spans.collect()
    recs = out["spans"]
    assert out["dropped"] == 0
    assert out["counters"]["recorder.record_calls"] == 402
    assert out["counters"]["recorder.record_ns"] > 0
    off, on = _files(str(tmp_path / "off")), _files(str(tmp_path / "on"))
    assert len(off) > 10 and on == off

    main = threading.get_ident()
    flushes = sorted((r for r in recs if r.name == "recorder.flush"),
                     key=lambda r: r.start_ns)
    assert [r.attrs for r in flushes] == [{"epoch": e} for e in range(3)]
    assert all(r.tid == main and r.parent == 0 for r in flushes)
    if async_flush:
        for f in flushes:
            assert [c.name for c in _children(recs, f)] == ["flush.snapshot"]
        commits = sorted((r for r in recs if r.name == "flush.commit"),
                         key=lambda r: r.start_ns)
        assert [r.attrs for r in commits] == [{"epoch": e} for e in range(3)]
        assert all(r.tid != main and r.parent == 0 for r in commits)
        committed = commits
    else:
        committed = flushes
    for c in committed:
        kids = _children(recs, c)
        names = [k.name for k in kids]
        assert names == (FLUSH_CHILDREN[1:] if async_flush
                         else FLUSH_CHILDREN)
        assert all(k.tid == c.tid for k in kids)
        assert sum(map(_dur, kids)) <= _dur(c)

    fin, = [r for r in recs if r.name == "recorder.finalize"]
    kids = _children(recs, fin)
    assert [k.name for k in kids] == ["finalize.drain", "finalize.tail_flush",
                                      "finalize.merged", "finalize.barrier"]
    assert sum(map(_dur, kids)) <= _dur(fin)
    tail = kids[1]
    tail_kids = _children(recs, tail)
    assert [k.name for k in tail_kids] == FLUSH_CHILDREN
    assert sum(map(_dur, tail_kids)) <= _dur(tail)


def test_one_shot_finalize_phases(tmp_path):
    spans.enable()
    rec = Recorder(config=RecorderConfig(trace_dir=str(tmp_path),
                                         encode_backend="numpy"))
    fid = REGISTRY.id_of("lseek")
    for i in range(20):
        rec.record(fid, ("fd", 512 * i, 0), 512 * i, 0, 2 * i, 2 * i + 1)
    rec.finalize()
    recs = spans.collect()["spans"]
    fin, = [r for r in recs if r.name == "recorder.finalize"]
    kids = _children(recs, fin)
    assert [k.name for k in kids] == [
        "finalize.local_state", "finalize.reduce", "finalize.merge",
        "finalize.write", "finalize.barrier"]
    assert sum(map(_dur, kids)) <= _dur(fin)
    assert not [r for r in recs if r.name.startswith("flush.")]


# -- the train step and the prefill -----------------------------------------


def test_step_time_is_the_train_step_span(tmp_path):
    cfg = get_smoke_config("qwen1.5-0.5b").replace(loss_chunk=0)
    data = SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=16,
                           batch_size=2, seed=0)
    tr = Trainer(cfg, TrainerConfig(num_steps=3, ckpt_dir=str(tmp_path),
                                    ckpt_every=0),
                 AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3),
                 data=lambda s: synthetic_batch(data, s), device="cpu")
    spans.enable()
    tr.run()
    recs = spans.collect()["spans"]
    steps = sorted((r for r in recs if r.name == "train.step"),
                   key=lambda r: r.start_ns)
    assert [r.attrs["step"] for r in steps] == [0, 1, 2]
    for r, m in zip(steps, tr.metrics_log):
        assert m["step_time_s"] == (r.end_ns - r.start_ns) * 1e-9
        kids = _children(recs, r)
        assert [k.name for k in kids] == [
            "train.data", "train.cast", "train.forward", "train.backward",
            "train.optimizer", "train.readback"]
        assert sum(map(_dur, kids)) <= _dur(r)


def test_prefill_time_is_its_spans():
    cfg = get_smoke_config("hymba-1.5b")
    eng = ServeEngine(cfg, None, max_seq=48, device="cpu")
    eng.params = eng.model.init_params(
        torch.Generator(device="cpu").manual_seed(0))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 21),
                                     generator=torch.Generator()
                                     .manual_seed(1)).int().numpy()}
    eng.generate(batch, 3)
    assert spans.collect()["spans"] == [] and eng.batches == 1
    spans.enable()
    eng.generate(batch, 3)
    recs = spans.collect()["spans"]
    gen, = [r for r in recs if r.name == "serve.generate"]
    assert gen.attrs == {"batch": 1} and gen.parent == 0
    kids = _children(recs, gen)
    assert [k.name for k in kids] == ["serve.prefill", "serve.seat",
                                      "serve.first_token", "serve.decode"]
    by = {k.name: k for k in kids}
    assert eng.stats["prefill_s"] == (by["serve.first_token"].end_ns
                                      - by["serve.prefill"].start_ns) * 1e-9
    assert eng.stats["decode_s"] == _dur(by["serve.decode"]) * 1e-9
    assert sum(map(_dur, kids)) <= _dur(gen)
