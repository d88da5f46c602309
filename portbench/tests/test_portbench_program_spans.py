"""The program's spans read against the device trace (``program_spans``):
the idle time of a hand-built trace put down to the right spans through
the two clock anchors, and refused when the anchors disagree; the readers
of the eight per-layer metrics; and a small CPU run of the prefill cell
with the program's spans on over its window only."""

import threading

import pytest

from portbench import program_spans as ps
from portbench.profiler import read_events
from portbench.tests import smoke
from repro_torch import spans
from repro_torch.spans import Record

PREFILL = "hymba-1.5b.prefill"
OFF_US = 1_700_000_123_456.25      # the trace's clock less the program's
A0, A1 = 5_000_000_000, 5_010_000_000   # the window's anchors, program ns
ANCHORS = [A0 - 100_000, A0, A1]   # after each synchronisation of the window
TID = 77


def _ev(cat, name, ts, dur):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace(drift_us=0.0):
    """Two synchronisations at the start, the first ending 2.6 ms before
    the second on the trace's clock but returning only 0.1 ms before it;
    the last 10 ms after the second, and the profiler's own 2 ms after
    that.  Busy 0-1, 1.5-4 and 6-9 ms after the second, so idle gaps at
    -2.6-0, 1-1.5, 4-6 and 9-12 ms (8.1 ms of a 14.6 ms window); the last
    anchor's sync ends ``drift_us`` off the second's clock."""
    w0 = A0 / 1e3 + OFF_US
    w1 = A1 / 1e3 + OFF_US + drift_us
    ev = [_ev("cuda_runtime", "cudaDeviceSynchronize", w0 - 2630, 30),
          _ev("cuda_runtime", "cudaDeviceSynchronize", w0 - 30, 30),
          _ev("cuda_runtime", "cudaLaunchKernel", w0 + 10, 5),
          _ev("cuda_runtime", "cudaDeviceSynchronize", w1 - 40, 40),
          _ev("cuda_runtime", "cudaDeviceSynchronize",
              A1 / 1e3 + OFF_US + 1990, 10)]
    for a, b in ((0, 1000), (1500, 4000), (6000, 9000)):
        ev.append(_ev("kernel", "k", w0 + a, b - a))
    ev.append(_ev("kernel", "outside", w0 - 3000, 100))
    return ev


def _rec(name, i, parent, t0_ms, t1_ms, tid=TID):
    return Record(name, i, parent, tid, A0 + round(t0_ms * 1e6),
                  A0 + round(t1_ms * 1e6), {"step": 0})


SPANS = [_rec("train.step", 1, 0, 0.5, 9.5),
         _rec("train.forward", 2, 1, 0.8, 5.0),
         _rec("train.optimizer", 3, 1, 5.0, 8.0),
         _rec("other.thread", 4, 0, 0.0, 10.0, tid=TID + 1)]


def test_clock_offset_from_the_two_anchors():
    off, drift = ps.clock_offset(_trace(120.0), ANCHORS)
    assert drift == pytest.approx(120.0)
    assert off == pytest.approx(OFF_US + 60.0)
    assert ps.clock_offset(_trace(), [A0, A1]) is None


def test_each_gap_goes_to_the_innermost_span():
    idle = ps.idle_by_span(_trace(), ANCHORS, SPANS, TID)
    assert idle["drift_us"] == pytest.approx(0.0, abs=1e-6)
    assert idle["window_s"] == pytest.approx(0.0146)
    assert idle["idle_s"] == pytest.approx(0.0081)
    want = {"train.forward": 0.0015, "train.optimizer": 0.0010,
            "train.step": 0.0005, ps.NO_SPAN: 0.0051}
    assert idle["by_span"].keys() == want.keys()
    for k, v in want.items():
        assert idle["by_span"][k] == pytest.approx(v, abs=1e-9)
    assert ps.top_idle(idle)[0] == ["train.forward", idle["by_span"][
        "train.forward"]]
    assert ps.top_idle(idle)[-1][0] == ps.NO_SPAN


def test_the_shares_add_up_to_the_idle_share():
    events = _trace()
    prof = read_events(events, 0.010)
    prof["idle_by_span"] = ps.idle_by_span(events, ANCHORS, SPANS, TID)
    ctx = {"profile": prof}
    got = {name: ps.METRICS[name][-1](ctx) for name in
           ("idle_forward.train", "idle_backward.train",
            "idle_optimizer.train", "idle_other.train")}
    assert got["idle_forward.train"] == pytest.approx(100 * 1.5 / 14.6)
    assert got["idle_backward.train"] == 0.0
    assert got["idle_optimizer.train"] == pytest.approx(100 * 1.0 / 14.6)
    assert got["idle_other.train"] == pytest.approx(100 * 5.6 / 14.6)
    device_idle = 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
    assert sum(got.values()) == pytest.approx(device_idle, abs=1e-9)


@pytest.mark.parametrize("drift_us,refused", [(150.0, False), (-150.0, False),
                                              (250.0, True), (-250.0, True)])
def test_anchors_that_disagree_are_refused(drift_us, refused):
    idle = ps.idle_by_span(_trace(drift_us), ANCHORS, SPANS, TID)
    assert (idle is None) == refused
    ctx = {"profile": {"idle_by_span": idle}}
    assert (ps.METRICS["idle_forward.train"][-1](ctx) is None) == refused


def test_innermost_nests_and_leaves_out_time_in_no_span():
    segs = ps.innermost(SPANS + [_rec("train.data", 5, 1, 0.6, 0.7),
                                 _rec("loose", 6, 0, 9.8, 9.9)], TID)
    assert [(n, round((b - a) / 1e6, 6)) for a, b, n in segs] == [
        ("train.step", 0.1), ("train.data", 0.1), ("train.step", 0.1),
        ("train.forward", 4.2), ("train.optimizer", 3.0),
        ("train.step", 1.5), ("loose", 0.1)]


def test_span_table_counts_self_time():
    rows = {r[0]: r for r in ps.span_table(SPANS)}
    assert rows["train.step"][1:] == pytest.approx([1, 9.0, 1.8])
    assert rows["train.forward"][1:] == pytest.approx([1, 4.2, 4.2])
    assert ps.span_table(SPANS)[0][0] == "other.thread"


def test_readers_find_nothing_without_the_programs_spans():
    """The parent's side: no spans, no counters, no attribution."""
    ctx = {"profile": {"busy_s": 1.0, "window_s": 2.0}, "spans": {},
           "counters": {}}
    assert all(m[-1](ctx) is None for m in ps.METRICS.values())


def test_metric_names_units_and_layers():
    assert len(ps.METRICS) == 8
    for name, (unit, layer, moves, source, _read) in ps.METRICS.items():
        assert name.endswith(".train") == (moves == "train_tokens_per_s")
        assert unit in ("%", "us", "ms") and layer and source in (
            "device_trace", "host_clock")


@pytest.fixture
def spans_over_the_window(monkeypatch):
    """The prefill job's window with the program's spans on over it
    alone, as a traced run would hold them."""
    from portbench.jobs import prefill
    got = {}
    real = prefill.Job.window

    def window(self):
        spans.enable()
        try:
            return real(self)
        finally:
            spans.disable()
            got.update(spans.collect())
            got["tid"] = threading.get_ident()
    monkeypatch.setattr(prefill.Job, "window", window)
    yield got
    spans.disable()
    spans.collect()


def test_a_traced_cpu_run_reports_the_serve_metrics(spans_over_the_window):
    res = smoke.run(PREFILL, trace=True)
    assert res["correct"], res["checks"]
    got = spans_over_the_window
    ctx = {"program_spans": got["spans"],
           "program_counters": got["counters"], "profile": {}}
    values = {name: ps.METRICS[name][-1](ctx) for name in (
        "record_us.serve", "flush_compress_ms.serve",
        "flush_write_ms.serve", "finalize_merge_ms.serve")}
    assert all(v is not None and v > 0 for v in values.values()), values
    # one record a prompt read, and nothing of the set-up's flush
    assert got["counters"]["recorder.record_calls"] == \
        res["work"]["requests"]
    names = {r.name for r in got["spans"]}
    assert {"serve.generate", "recorder.flush",
            "recorder.finalize"} <= names
    assert got["dropped"] == 0


def test_an_untraced_run_leaves_the_spans_off_and_empty():
    spans.collect()
    res = smoke.run(PREFILL, trace=False)
    assert res["correct"], res["checks"]
    assert spans.enabled is False
    assert spans.collect() == {"spans": [], "counters": {}, "dropped": 0}
