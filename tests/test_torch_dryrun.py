"""The port's dry run (``repro_torch.launch.dryrun``) on a fake process
group, held against the JAX package's formulas and specs.

* ``applicable`` and ``model_flops_per_chip`` equal the reference's for
  every cell on both production meshes.
* The per-chip argument bytes that ``build_cell`` lays out on a fake
  256- or 512-rank group (``FakeTensorMode``: nothing is allocated) equal
  the bytes summed from the JAX package's specs for every cell, apart from
  two departures, listed with their bytes: the port's ZeRO-1 on per-layer
  leaves (``tests/test_torch_sharding.py``) and the encoder-decoder's
  decode cache, which holds the encoder length ``xlen`` (B int32,
  replicated) that the reference's does not.
* ``StepCounter`` counts FLOPs on the local shards and the peak of live
  storage bytes: toys of known count and peak give them exactly.
* ``run_cell`` on a fake 256-rank group on ``cpu`` gives ``ok`` for the
  smoke configurations of a dense, an SSM and the MoE architecture, with
  collectives of each expected kind in a train cell, and the depth
  extrapolation gives exactly the FLOPs and collective bytes of a run at
  full depth.
"""

import os

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_config
from repro.distributed import sharding as RSH
from repro.launch import shapes as RSHAPES
from repro.launch import steps as RS
from repro.models import get_model as jax_model
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import all_arch_names, get_config, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import step_analysis as SA
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.launch.steps import build_cell

from _torch_spec_ref import _jax_flat, _local_bytes, departure_bytes

_flags = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as RD        # noqa: E402  (sets XLA_FLAGS)
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags

ARCHS = all_arch_names()
MESH_SIZES = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(scope="module", autouse=True)
def _no_world_left():
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh", list(MESH_SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_applicable_and_model_flops_match_reference(arch, mesh):
    n = 256 if mesh == "single" else 512
    for name, shape in SHAPES.items():
        assert applicable(get_config(arch), name) == \
            RSHAPES.applicable(jax_config(arch), name)
        assert D.model_flops_per_chip(get_config(arch), shape, n) == \
            RD.model_flops_per_chip(jax_config(arch),
                                    RSHAPES.SHAPES[name], n)


# -- argument bytes --------------------------------------------------------------


def _ref_bytes(arch: str, shape_name: str, mesh: str) -> dict:
    """Per-chip bytes of the cell's arguments from the JAX package's specs
    on an AbstractMesh, by argument (and the decode cache's ``pos``)."""
    shp, names = MESH_SIZES[mesh]
    jm = jax.sharding.AbstractMesh(shp, names)
    sizes = dict(zip(names, shp))
    cfg = jax_config(arch)
    model = jax_model(cfg)
    ps = jax.eval_shape(lambda r: model.init_params(r),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    pspecs = RS.sanitize_tree(ps, RSH.tree_param_specs(ps), jm)
    shape = RSHAPES.SHAPES[shape_name]

    def tree_bytes(shapes, specs):
        sh, sp = _jax_flat(shapes), _jax_flat(specs)
        return sum(_local_bytes(l.shape, sp[n], sizes, l.dtype.itemsize)
                   for n, l in sh.items())

    if shape.kind == "train":
        st = jax.eval_shape(jax_adamw_init, ps)
        sts = RS.train_state_specs(st, pspecs, jm)
        b = RSHAPES.batch_specs(cfg, shape)
        return {"state": sum(tree_bytes(st[k], sts[k])
                             for k in ("master", "mu", "nu")) + 4,
                "batch": tree_bytes(b, RS.batch_pspecs(cfg, b, jm))}
    params = tree_bytes(ps, pspecs)
    if shape.kind == "prefill":
        b = RSHAPES.batch_specs(cfg, shape)
        return {"params": params,
                "batch": tree_bytes(b, RS.batch_pspecs(cfg, b, jm))}
    d = RSHAPES.decode_specs(cfg, shape)
    tok = _local_bytes(d["tokens"].shape,
                       (RS._dp_axes(jm, shape.global_batch), None), sizes, 4)
    return {"params": params,
            "cache": tree_bytes(d["cache"], RS.cache_pspecs(cfg, d["cache"],
                                                           jm)),
            "tokens": tok}


def _departure(arch: str, shape_name: str, mesh: str) -> int:
    """Bytes the port's arguments hold beyond the reference's: the
    encoder-decoder's ``xlen`` (B int32, replicated) in a decode cell, and
    in a train cell the ZeRO-1 leaves on the layer dim
    (``test_torch_sharding.py``: hymba's 50-head leaves stay whole a
    layer; mamba2's split the same bytes) for master, mu and nu."""
    shape = SHAPES[shape_name]
    if shape.kind == "decode" and get_config(arch).n_encoder_layers:
        return shape.global_batch * 4
    if shape.kind == "train":
        key = "16x16" if mesh == "single" else "2x16x16"
        return 3 * sum(p - r for r, p in departure_bytes(arch, key).values())
    return 0


#: per-chip bytes summed from the JAX package's specs on its (16, 16)
#: AbstractMesh (GB, 3 decimals): (train_4k state + batch, decode_32k
#: params + cache)
QUOTED = {"qwen3-32b": (1.537, 8.393), "llava-next-34b": (2.273, 8.329),
          "deepseek-moe-16b": (0.771, 5.819), "mamba2-370m": (0.021, 0.079)}


@pytest.mark.parametrize("mesh", list(MESH_SIZES))
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_match_reference(arch, mesh):
    shp, _ = MESH_SIZES[mesh]
    n = 1
    for s in shp:
        n *= s
    D.fake_world(n)
    pmesh = make_production_mesh(multi_pod=mesh == "multi",
                                 device_type="cpu")
    cfg = get_config(arch)
    got = {}
    for name, shape in SHAPES.items():
        if not applicable(cfg, name)[0]:
            continue
        with FakeTensorMode():
            _, _, meta = build_cell(cfg, shape, pmesh,
                                    accum_steps=D.accum_steps(cfg, shape))
        want = sum(_ref_bytes(arch, name, mesh).values())
        assert meta["arg_bytes"] == want + _departure(arch, name, mesh), name
        got[name] = meta["arg_bytes"]
    if mesh == "single" and arch in QUOTED:
        assert round(got["train_4k"] / 1e9, 3) == QUOTED[arch][0]
        assert round(got["decode_32k"] / 1e9, 3) == QUOTED[arch][1]


# -- FLOPs on the local shards ---------------------------------------------------------


@pytest.mark.parametrize("warm", [True, False])
def test_step_counter_counts_local_flops_exactly(warm):
    """x (16 r, 64) batch-sharded over 16 data ranks, w (64, 128) sharded
    on its columns over 16 model ranks: each chip multiplies (r, 64) by
    (64, 8), 2 * r * 64 * 8 FLOPs (the DTensor-level count would be
    2 * 16 r * 64 * 128).  The output's reduction to replicated is one
    all-gather of the chip's (r, 8) f32 block over the model axis.  Warm,
    the product runs once before it is counted; cold (shapes seen nowhere
    else), DTensor's sharding propagation runs it on global-shape fake
    tensors inside the counter, which must leave those out."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    r = 2 if warm else 3
    D.fake_world(256)
    mesh = make_production_mesh(device_type="cpu")
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(r, 64), mesh,
                               [Shard(0), Replicate()], run_check=False,
                               shape=(16 * r, 64), stride=(64, 1))
        w = DTensor.from_local(torch.empty(64, 8), mesh,
                               [Replicate(), Shard(1)], run_check=False,
                               shape=(64, 128), stride=(128, 1))
        if warm:
            (x @ w).redistribute(mesh, [Shard(0), Replicate()])
        c = SA.StepCounter()
        with c:
            y = x @ w
            y.redistribute(mesh, [Shard(0), Replicate()])
    assert c.flops == 2 * r * 64 * 8
    coll = c.collectives()
    assert coll["all-gather"] == {"count": 1, "bytes": r * 8 * 4,
                                  "cross_node_bytes": r * 8 * 4}
    assert coll["total_bytes"] == r * 8 * 4


@pytest.mark.parametrize("fake", [False, True])
def test_step_counter_peak_is_the_live_storage_bytes(fake):
    """The peak estimate counts each storage once (views and in-place ops
    add nothing), from the arguments given to ``track`` and each op's
    output until it is freed."""
    import contextlib
    with FakeTensorMode() if fake else contextlib.nullcontext():
        x = torch.zeros(1000)                        # 4,000 bytes
        c = SA.StepCounter()
        c.track([x, x[:10]])
        with c:
            a = x * 2                                # 8,000
            b = a.view(10, 100)
            b.add_(1)
            del a, b                                 # 4,000
            d = torch.zeros(3000)                    # 16,000: the peak
            del d                                    # 4,000
            f = torch.ones(500)                      # 6,000
    assert c.peak_bytes == 16000
    assert c.live_bytes == 6000
    del f


# -- whole cells on the fake mesh -------------------------------------------------------


SMOKE_SHAPES = {"train_4k": ShapeSpec("train_4k", 64, 32, "train"),
                "prefill_32k": ShapeSpec("prefill_32k", 64, 32, "prefill"),
                "decode_32k": ShapeSpec("decode_32k", 64, 32, "decode")}


@pytest.mark.parametrize("shape", list(SMOKE_SHAPES))
@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "mamba2-370m",
                                  "deepseek-moe-16b"])
def test_run_cell_on_fake_256_rank_mesh(arch, shape):
    """The MoE smoke configuration gets 16 routed experts, so that they
    divide the 16-rank model axis and the expert-parallel branch runs."""
    cfg = get_smoke_config(arch)
    if cfg.is_moe:
        cfg = cfg.replace(n_routed_experts=16)
    r = D.run_cell(arch, shape, "single", device="cpu", cfg=cfg,
                   shape=SMOKE_SHAPES[shape], save=False)
    assert r["status"] == "ok", r.get("traceback")
    assert r["n_chips"] == 256
    assert r["memory"]["argument_bytes"] > 0
    assert r["memory"]["peak_bytes_estimate"] > 0
    assert r["flops_per_chip"] > 0
    assert r["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    coll = r["collectives"]
    if shape == "train_4k":
        for kind in ("all-reduce", "all-gather", "reduce-scatter"):
            assert coll[kind]["count"] > 0 and coll[kind]["bytes"] > 0, kind
        if arch == "deepseek-moe-16b":
            assert coll["all-to-all"]["count"] > 0
    assert "OK" in D.format_result(r)
    assert set(r["departures"]) == set(D.layout_departures(
        cfg, SMOKE_SHAPES[shape], make_production_mesh(device_type="cpu")))
    for k in r["departures"]:
        assert f"[port layout: {k}]" in D.format_result(r)


def test_moe_decode_keeps_the_experts_sharded(monkeypatch):
    """Without expert parallelism (decode, S = 1) every rank of the fake
    (16, 16) mesh runs its 1 of the 16 experts on every token's slots; the
    experts' weights are not gathered."""
    from repro_torch.models import layers as TL
    seen = []
    ffn = TL._expert_ffn

    def spy(recv, wg, wu, wd):
        seen.append((recv.shape[0], wg.shape[0]))
        return ffn(recv, wg, wu, wd)
    monkeypatch.setattr(TL, "_expert_ffn", spy)
    cfg = get_smoke_config("deepseek-moe-16b").replace(n_routed_experts=16)
    D.fake_world(256)
    mesh = make_production_mesh(device_type="cpu")
    with FakeTensorMode():
        step, args, _ = build_cell(cfg, SMOKE_SHAPES["decode_32k"], mesh)
        step(*args)
    assert seen and set(seen) == {(1, 1)}


@pytest.mark.parametrize("arch,shape,want", [
    ("llava-next-34b", "train_4k", {"attention_gathers_sequence"}),
    ("hymba-1.5b", "prefill_32k", {"attention_gathers_sequence"}),
    ("hymba-1.5b", "decode_32k", set()),
    ("qwen3-32b", "train_4k", set()),
    ("mamba2-370m", "train_4k", set()),
    ("deepseek-moe-16b", "train_4k", set()),
    ("deepseek-moe-16b", "decode_32k", {"moe_gathers_tokens"}),
])
def test_layout_departures_name_the_ports_own_gathers(arch, shape, want):
    """A cell whose numbers include a gather of the port's layout says so
    (heads that do not divide the 16 model ranks; MoE without expert
    parallelism), in its JSON and on its line."""
    D.fake_world(256)
    mesh = make_production_mesh(device_type="cpu")
    got = D.layout_departures(get_config(arch), SHAPES[shape], mesh)
    assert set(got) == want


@pytest.mark.parametrize("arch,shape", [("qwen1.5-0.5b", "train_4k"),
                                        ("stablelm-1.6b", "decode_32k")])
def test_depth_extrapolation_is_exact(arch, shape):
    """Runs at 1 and 2 stacked layers, extrapolated to the smoke
    configuration's depth, give the FLOPs and collective bytes of a run of
    all its layers (every run is counted after a warm-up, so that no op
    of DTensor's sharding propagation is counted)."""
    depth = get_smoke_config(arch).n_layers
    shape_name, shape = shape, SMOKE_SHAPES[shape]
    a = D.run_cell(arch, shape_name, "single", device="cpu",
                   smoke=True, shape=shape, save=False)
    b = D.run_cell(arch, shape_name, "single", device="cpu",
                   smoke=True, shape=shape, full_depth=True, save=False)
    assert a["depths"] == [1, 2] and b["depths"] == [depth] and depth > 2
    assert a["flops_per_chip"] == b["flops_per_chip"]
    for kind in SA.KINDS:
        assert a["collectives"][kind]["bytes"] == \
            b["collectives"][kind]["bytes"], kind
    assert a["memory"]["argument_bytes"] == b["memory"]["argument_bytes"]


def test_skip_and_fail_lines(monkeypatch, capsys):
    r = D.run_cell("qwen3-32b", "long_500k", "single", device="cpu",
                   save=False)
    assert r["status"] == "skip"
    assert D.format_result(r).startswith("SKIP")
    assert RSHAPES.applicable(jax_config("qwen3-32b"), "long_500k")[1] \
        in D.format_result(r)

    def broken(*a, **k):
        raise RuntimeError("cell broke")
    monkeypatch.setattr(D, "analyze_cell", broken)
    bad = D.run_cell("qwen1.5-0.5b", "train_4k", "single", device="cpu",
                     smoke=True, save=False)
    assert bad["status"] == "fail" and "cell broke" in bad["error"]
    assert D.format_result(bad).startswith("FAIL")
    monkeypatch.setattr(D, "ARTIFACTS", str(os.path.join(
        os.environ.get("TMPDIR", "/tmp"), "repro-dryrun-test")))
    assert D.main(["--arch", "qwen1.5-0.5b", "--shape", "train_4k",
                   "--device", "cpu", "--smoke"]) == 1
    assert capsys.readouterr().out.startswith("FAIL")
