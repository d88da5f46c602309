"""The harness end to end on the CPU at the smoke sizes: sound runs come
out correct, and runs with the timed path broken underneath come out not
correct, once for each fault the cell can have.  (One card: no exchange
between chips to leave out.)"""

import os
import subprocess
import sys

import pytest

from portbench import cells
from portbench.tests import smoke

REPO = str(cells.ROOT.parent)
TRAIN, PREFILL = "mamba2-370m-plainssd.train", "hymba-1.5b.prefill"


@pytest.mark.parametrize("name", [TRAIN, PREFILL])
def test_a_sound_run_is_correct(name):
    res = smoke.run(name)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert res["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("name", [TRAIN, PREFILL])
def test_a_traced_run_reports_per_layer_metrics(name):
    res = smoke.run(name, trace=True)
    assert res["correct"], res["checks"]
    got = set(res["metrics"])
    suffix = ".train" if name == TRAIN else ".serve"
    assert {"flush_ms" + suffix, "finalize_ms" + suffix} <= got
    assert all(k.endswith(suffix) for k in got)
    assert "busy_s" in res["device"] and "breakdown" in res


def test_the_closed_loop_serves_full_batches_back_to_back():
    """Every batch is full, and a request waits about one batch: its
    client sends it when the token of its last one is on the host."""
    res = smoke.run(PREFILL, seconds=1.0)
    work, B = res["work"], smoke.MIX["prefill"]["batch"]
    assert work["requests"] == work["batches"] * B == res["attempted"]
    per_batch_ms = 1e3 * work["window_s"] / work["batches"]
    assert 0 < res["metrics"]["ttft_p95_ms"]["value"] < 3 * per_batch_ms


def test_a_seed_gives_the_same_requests():
    """Two runs of one seed read the same documents in the same order."""
    reads = []
    model, mix = smoke.overrides(PREFILL)
    for _ in range(2):
        from portbench import harness
        harness.run_cell(PREFILL, 4242424242424, 0.3, False, device="cpu",
                         model_override=model, mix_override=mix,
                         after_check=lambda run, job: reads.append(
                             list(job.reads)))
    n = min(map(len, reads))
    assert n >= 2 * mix["batch"] and reads[0][:n] == reads[1][:n]


def _wrap_step(monkeypatch, change):
    from repro_torch.train import loop
    real = loop.make_train_step

    def make(*a, **k):
        step = real(*a, **k)
        return lambda state, batch: change(step, state, batch)
    monkeypatch.setattr(loop, "make_train_step", make)


def test_a_step_that_returns_its_state_unchanged_is_caught(monkeypatch):
    _wrap_step(monkeypatch, lambda step, s, b: (s, step(s, b)[1]))
    assert not smoke.run(TRAIN)["correct"]


def test_half_the_batch_left_out_is_caught(monkeypatch):
    def half(step, s, b):
        return step(s, {k: v[: v.shape[0] // 2] for k, v in b.items()})
    _wrap_step(monkeypatch, half)
    res = smoke.run(TRAIN)
    assert not res["correct"], res["checks"]


def test_a_token_altered_where_it_is_produced_is_caught(monkeypatch):
    from repro_torch.serve import engine
    real = engine.ServeEngine.generate

    def generate(self, batch, n_new):
        out = real(self, batch, n_new)
        return (out + 1) % self.cfg.vocab_size
    monkeypatch.setattr(engine.ServeEngine, "generate", generate)
    res = smoke.run(PREFILL)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", [TRAIN, PREFILL])
def test_a_record_altered_in_the_trace_is_caught(name, monkeypatch):
    from repro_torch.core.apis import posix
    real = posix.pread
    calls = []

    def pread(fd, count, offset):
        calls.append(1)
        return real(fd, count, offset + (4 if len(calls) == 66 else 0))
    monkeypatch.setattr(posix, "pread", pread)
    res = smoke.run(name)
    assert res["checks"]["trace_mismatch"]["value"] > 0
    assert not res["correct"]


def test_the_control_departs_from_the_reference():
    """The control, the reference in float8 in the program's place, at the
    smoke size: it departs from the f32 reference where the program (f32
    at this size) does not, and the half-batch fault fails the cell's
    limits.  Its readings at the cell's own size, on the card, are in
    PERF.md."""
    from portbench.control import readings
    model, mix = smoke.overrides(TRAIN)
    out = readings(TRAIN, 77, 0.5, True, "cpu", model, mix)
    limits = cells.load_cell(TRAIN)["limits"]
    assert all(out["program"][k] <= v for k, v in limits.items())
    assert out["program"]["head_grad_err"] < 1e-4
    assert out["control"]["head_grad_err"] > 0.1
    assert out["control"]["loss_gap"] > 1e-3
    half = out["half_batch"]
    assert half["head_grad_err"] > limits["head_grad_err"]
    assert half["grad_gap_median"] > limits["grad_gap_median"]
    model, mix = smoke.overrides(PREFILL)
    out = readings(PREFILL, 77, 0.5, True, "cpu", model, mix)
    assert out["program"]["served_gap"] < 1e-4
    assert out["control"]["served_gap"] > 0.1


def test_the_planted_ssd_backward_fault_takes_effect():
    """``control.py --fault ssd_backward_fp8`` moves the blocks' first
    gradients (float8 in the SSD's backward) and not the head's, which no
    block's backward touches.  Whether a limit catches it at the cell's
    own size is read on the card (PERF.md)."""
    from portbench.control import readings
    model, mix = smoke.overrides(TRAIN)
    out = readings(TRAIN, 78, 0.5, False, "cpu", model, mix,
                   fault="ssd_backward_fp8")
    assert out["program"]["grad_rel_median"] > 1e-3
    assert out["program"]["head_grad_err"] < 1e-4
    sound = readings(TRAIN, 78, 0.5, False, "cpu", model, mix)
    assert sound["program"]["grad_rel_median"] < 1e-4
    assert len(sound["diagnostics"]["grad_rel_by_layer"]) == \
        model["n_layers"]


def test_the_harness_loads_no_jax():
    """In a fresh process: the harness's CPU path leaves no module named
    jax, jaxlib, flax or repro (top-level names compared whole)."""
    code = (
        "import sys; sys.path[:0] = ['.', 'src']\n"
        "from portbench.tests import smoke\n"
        "from portbench import harness\n"
        "res = smoke.run('mamba2-370m-plainssd.train', trace=True)\n"
        "res = smoke.run('hymba-1.5b.prefill')\n"
        "print(harness.banned_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'repro'}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-2:] == ["[]", "[]"]


def test_run_py_exits_without_a_card():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", TRAIN,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    if out.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_sound_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for name in (TRAIN, PREFILL):
        res = smoke.run(name, device="cuda")
        assert res["correct"], res["checks"]
