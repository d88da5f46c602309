"""The port's checkpoint engine against the JAX package's, on the CPU.

The same train state -- the JAX package's AdamW state of a smoke model
after a seeded step, in its stacked layout, and a bfloat16 parameter tree
-- is written by both engines:

- ``arrays.bin`` byte-identical and the manifests equal, with one rank and
  with 4 ThreadComm ranks (each package's own ThreadComm);
- a checkpoint of either package restores in the other bit for bit
  (bfloat16 through its 16-bit patterns);
- a checkpoint of 4 writers restores on 1, 2 and 3 readers;
- ``.tmp`` debris is skipped, keep-k GC works, a corrupt shard is skipped
  in favour of the previous checkpoint;
- the train-state converters round-trip the stacked layout.
"""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_sharded as ref_restore
from repro.checkpoint import save_sharded as ref_save
from repro.configs import get_smoke_config as jax_smoke
from repro.core import comm as ref_comm
from repro.models import get_model as jax_model
from repro.optim import AdamWConfig as RefAdamW
from repro.optim import adamw_init as ref_init
from repro.optim import adamw_update as ref_update
from repro_torch.checkpoint import (CheckpointEngine, latest_step,
                                    restore_sharded, save_sharded)
from repro_torch.configs import get_smoke_config
from repro_torch.core import comm as port_comm
from repro_torch.models.convert import (params_from_numpy, params_to_numpy,
                                        state_from_numpy, state_shapes,
                                        state_to_numpy)

ARCH = "mamba2-370m"


def _ref_state(arch=ARCH, seed=0):
    """The JAX package's AdamW state after one step, as numpy."""
    cfg = jax_smoke(arch)
    params = jax_model(cfg).init_params(jax.random.PRNGKey(seed))
    state = ref_init(params)
    rs = np.random.RandomState(seed)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rs.randn(*p.shape).astype(np.float32)), params)
    state, _ = ref_update(RefAdamW(lr=1e-2, warmup_steps=0), state, grads)
    return jax.tree.map(np.asarray, state)


def _ref_bf16_params(arch="qwen1.5-0.5b", seed=1):
    cfg = jax_smoke(arch).replace(param_dtype="bfloat16", dtype="bfloat16")
    params = jax_model(cfg).init_params(jax.random.PRNGKey(seed))
    return cfg, jax.tree.map(np.asarray, params)


def _port_tree(kind):
    """(port tree to save, JAX-side numpy tree of the same values)."""
    if kind == "state":
        ref = _ref_state()
        cfg = get_smoke_config(ARCH)
        port = state_to_numpy(state_from_numpy(cfg, ref, "cpu"))
        return port, ref
    cfg, ref = _ref_bf16_params()
    port = params_to_numpy(params_from_numpy(cfg, ref, "cpu"))
    return port, ref


def _files(d):
    with open(os.path.join(d, "arrays.bin"), "rb") as f:
        data = f.read()
    with open(os.path.join(d, "manifest.json")) as f:
        return data, json.load(f)


def _same_leaves(got, want, prefix=""):
    """Bit-for-bit equality of a restored tree against numpy leaves."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), prefix
        for k in want:
            _same_leaves(got[k], want[k], f"{prefix}/{k}")
        return
    want = np.asarray(want)
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and want.dtype.name == "bfloat16"
        got = got.view(torch.int16).numpy()
        want = want.view(np.int16)
    assert got.dtype == want.dtype and got.shape == want.shape, prefix
    np.testing.assert_array_equal(got, want, err_msg=prefix)


@pytest.mark.parametrize("kind", ["state", "bf16"])
def test_one_rank_checkpoint_is_the_reference_byte_for_byte(tmp_path, kind):
    port, ref = _port_tree(kind)
    a = save_sharded(port, str(tmp_path / "port"), 3, meta={"next_step": 3})
    b = ref_save(ref, str(tmp_path / "ref"), 3, meta={"next_step": 3})
    (pa, pm), (ra, rm) = _files(a), _files(b)
    assert pa == ra
    assert pm == rm


def _four_rank_save(save, comm_mod, tree, d):
    def rank_fn(comm, rank):
        return save(tree, d, 5, rank=rank, nranks=4, comm=comm,
                    meta={"next_step": 5})
    comm_mod.run_thread_world(4, rank_fn)
    return os.path.join(d, "step_00000005")


@pytest.mark.parametrize("kind", ["state", "bf16"])
def test_four_rank_checkpoint_is_the_reference_byte_for_byte(tmp_path, kind):
    port, ref = _port_tree(kind)
    a = _four_rank_save(save_sharded, port_comm, port, str(tmp_path / "p"))
    b = _four_rank_save(ref_save, ref_comm, ref, str(tmp_path / "r"))
    (pa, pm), (ra, rm) = _files(a), _files(b)
    assert pm["nranks"] == 4 and len(pm["crcs"]) == 4
    assert pa == ra
    assert pm == rm


@pytest.mark.parametrize("kind", ["state", "bf16"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, kind):
    port, ref = _port_tree(kind)
    path = ref_save(ref, str(tmp_path), 7)
    got, manifest = restore_sharded(port, path)
    assert manifest["step"] == 7
    _same_leaves(got, ref)


@pytest.mark.parametrize("kind", ["state", "bf16"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, kind):
    port, ref = _port_tree(kind)
    path = save_sharded(port, str(tmp_path), 7)
    got, _ = ref_restore(ref, path)
    _same_leaves(jax.tree.map(np.asarray, got), ref)
    assert jax.tree.leaves(got)[0].dtype == jax.tree.leaves(ref)[0].dtype


def test_restore_is_elastic_n_to_m(tmp_path):
    port, ref = _port_tree("state")
    path = _four_rank_save(save_sharded, port_comm, port, str(tmp_path))
    for nr in (1, 2, 3):
        for r in range(nr):
            got, _ = restore_sharded(state_shapes(state_from_numpy(
                get_smoke_config(ARCH), ref, "cpu")), path, rank=r,
                nranks=nr)
            _same_leaves(got, ref)


def test_state_converters_round_trip():
    ref = _ref_state()
    cfg = get_smoke_config(ARCH)
    state = state_from_numpy(cfg, ref, "cpu")
    assert len(state["master"]["layers"]) == cfg.n_layers
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    _same_leaves(state_to_numpy(state), ref)
    shapes = state_shapes(state)
    for (name, s), (_, r) in zip(_named(shapes), _named(ref)):
        assert s.device.type == "meta" and tuple(s.shape) == r.shape, name


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _named(tree[k],
                                                       f"{prefix}{k}/")]
    return [(prefix, tree)]


def test_tmp_debris_is_skipped(tmp_path):
    eng = CheckpointEngine(str(tmp_path), keep=5)
    tree = {"a": np.arange(16, dtype=np.float32)}
    eng.save(tree, 4)
    os.makedirs(tmp_path / "step_00000009.tmp")
    (tmp_path / "step_00000009.tmp" / "arrays.bin").write_bytes(b"\0" * 8)
    assert latest_step(str(tmp_path)) == 4
    got, manifest = eng.restore_latest(tree)
    assert manifest["step"] == 4
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert latest_step(str(tmp_path / "missing")) is None


def test_keep_k_gc(tmp_path):
    eng = CheckpointEngine(str(tmp_path), keep=2)
    tree = {"a": np.arange(32, dtype=np.float32)}
    for s in (1, 2, 3, 4):
        eng.save(tree, s)
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(str(tmp_path))
                   if d.startswith("step_"))
    assert steps == [3, 4]


@pytest.mark.parametrize("async_save", [False, True])
def test_corrupt_checkpoint_detected_and_skipped(tmp_path, async_save):
    eng = CheckpointEngine(str(tmp_path), keep=5, async_save=async_save)
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8)}
    eng.save(tree, 1)
    eng.save({"w": tree["w"] * 2}, 2)
    eng.wait()
    p = os.path.join(str(tmp_path), "step_00000002", "arrays.bin")
    with open(p, "r+b") as f:
        f.seek(8)
        f.write(b"\xde\xad\xbe\xef")
    restored = eng.restore_latest({"w": torch.empty((8, 8),
                                                    device="meta")})
    assert restored is not None
    got, manifest = restored
    assert manifest["step"] == 1      # fell back to the older good ckpt
    np.testing.assert_array_equal(got["w"], tree["w"].numpy())


def test_async_save_snapshots_before_returning(tmp_path):
    """The async thread writes the values ``save`` was given, whatever
    happens to the tensors afterwards."""
    eng = CheckpointEngine(str(tmp_path), keep=2, async_save=True)
    w = torch.arange(4096, dtype=torch.float32)
    eng.save({"w": w}, 1)
    w.mul_(-1)                        # the next step, in place
    eng.wait()
    got, _ = restore_sharded({"w": w}, str(tmp_path / "step_00000001"))
    np.testing.assert_array_equal(got["w"], np.arange(4096,
                                                      dtype=np.float32))


def test_bf16_manifest_names_the_dtype(tmp_path):
    x = torch.tensor([1.0, -2.5, 3.0e-3], dtype=torch.bfloat16)
    path = save_sharded({"x": x}, str(tmp_path), 1)
    _, manifest = _files(path)
    assert manifest["arrays"][0]["dtype"] == "bfloat16"
    got, _ = ref_restore({"x": np.zeros(3, ml_dtypes.bfloat16)}, path)
    np.testing.assert_array_equal(np.asarray(got["x"], np.float32),
                                  x.float().numpy())
