"""The plain reference against the port at the port's smoke sizes on the
CPU (f32): losses, gradients, prefill logits, AdamW, and the trace
decoder against the port's reader."""

import os

import pytest
import torch

from portbench import cells, weights
from portbench.jobs.train import flat
from portbench.reference import model as ref
from portbench.reference.adamw import AdamW
from portbench.reference.trace_decode import Handle, read_records
from portbench.tests import smoke

CONFIGS = ["mamba2-370m", "hymba-1.5b"]


def _config_of(arch: str) -> str:
    """The first configuration file, by name, of the port's ``arch``."""
    return next(n for n in sorted(p.stem for p in
                                  (cells.ROOT / "configs").glob("*.json"))
                if cells.load_json("configs", n)["arch"] == arch)


def _setup(name: str, seed: int = 3):
    from repro_torch.configs import get_config
    m = {**cells.load_json("configs", _config_of(name)), **smoke.MODEL[name]}
    fields = {k: v for k, v in m.items()
              if k in get_config(name).__dataclass_fields__ and k != "name"}
    cfg = get_config(name).replace(**fields)
    params = weights.make_params(m, seed, "cpu", torch.float32)
    return m, cfg, params


def _tokens(m, B, S, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, m["vocab_size"], (B, S + 1), generator=g)


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_match_the_port(name):
    from repro_torch.models import lm
    m, cfg, params = _setup(name)
    rows = _tokens(m, 2, 40)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in flat(params).items()}
    tree = weights.unflatten(leaves)
    loss, _ = lm.loss_fn(cfg, tree, {"tokens": rows[:, :-1],
                                     "labels": rows[:, 1:]})
    got = torch.autograd.grad(loss, list(leaves.values()))
    rleaves = {k: v.detach().clone().requires_grad_(True)
               for k, v in flat(params).items()}
    rloss = ref.loss(weights.unflatten(rleaves), m, rows[:, :-1],
                     rows[:, 1:], chunk=16)
    want = torch.autograd.grad(rloss, list(rleaves.values()))
    assert abs(float(loss.detach()) - float(rloss.detach())) \
        <= 1e-5 * abs(float(rloss.detach()))
    for (k, _), a, b in zip(leaves.items(), got, want):
        err = float((a - b).norm() / b.norm().clamp(min=1e-12))
        assert err < 1e-4, (k, err)


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_logits_match_the_port(name):
    from repro_torch.models import lm
    m, cfg, params = _setup(name)
    rows = _tokens(m, 3, 40)[:, :-1]
    with torch.no_grad():
        got, _ = lm.prefill(cfg, params, {"tokens": rows})
    want = ref.last_logits(params, m, rows)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_fp8_control_departs_from_f32():
    m, _, params = _setup("hymba-1.5b")
    rows = _tokens(m, 2, 24)[:, :-1]
    hi = ref.last_logits(params, m, rows)
    lo = ref.last_logits(params, m, rows, fp8=True)
    rel = float((hi - lo).norm() / hi.norm())
    assert 1e-3 < rel < 0.5


def test_adamw_matches_the_port():
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    m, _, params = _setup("mamba2-370m")
    opt = cells.load_json("traffic", "train_16x2048")["optimizer"]
    state = adamw_init(params)
    g = torch.Generator().manual_seed(9)
    grads = {k: torch.randn(v.shape, generator=g) * 0.3
             for k, v in flat(params).items()}
    leaves = {k: v.detach().clone() for k, v in flat(params).items()}
    adam = AdamW(opt, leaves)
    for _ in range(3):
        state, _ = adamw_update(AdamWConfig(**opt), state,
                                weights.unflatten(grads))
        adam.update(leaves, grads)
    for k, v in flat(state["master"]).items():
        torch.testing.assert_close(v, leaves[k], rtol=1e-6, atol=1e-7)


def test_trace_decoder_matches_the_port_reader(tmp_path):
    from repro_torch.core import encode_backend
    from repro_torch.core.apis import framework as frame, posix
    from repro_torch.core.reader import TraceReader
    from repro_torch.core.recorder import RecorderConfig, session
    encode_backend.set_default_backend("numpy")
    path = str(tmp_path / "data.bin")
    with open(path, "wb") as f:
        f.write(bytes(100000))
    tdir = str(tmp_path / "t")
    with session(RecorderConfig(trace_dir=tdir,
                                encode_backend="numpy")) as rec:
        fd = posix.open(path, os.O_RDONLY, 0o644)
        posix.stat(path)
        for i in range(23):
            frame.step(i)
            posix.pread(fd, 80, (i * 80) % 9000)
            frame.fetch_batch(i, 64)
            if i in (2, 11):
                posix.pread(fd, 80, 5 + i)
            if i % 5 == 4:
                rec.flush()
    mine = read_records(os.path.join(tdir, "merged"))

    def plain(v):
        return Handle(v.id) if type(v).__name__ == "Handle" else v
    theirs = [(r.func, tuple(plain(a) for a in r.args), plain(r.ret))
              for r in TraceReader(tdir).iter_records(0)]
    assert mine == theirs
    assert mine[3] == ("pread", (Handle(0), 80, 0), 80)
