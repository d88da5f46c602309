"""The port's sharding specs against the JAX package's, leaf for leaf.

For every configuration at full size, on meshes of the JAX package's
shapes -- ``AbstractMesh`` (16, 16), (2, 16, 16), (2, 2) and (1, 2, 2)
there, the port's ``AbstractMesh`` of the same sizes here -- the sanitized
parameter specs, ``train_state_specs`` (master, mu, nu, step),
``batch_pspecs`` of the four shapes and ``cache_pspecs`` of ``decode_32k``
and ``long_500k`` (where they apply) are equal, every stacked leaf of the
reference compared with each layer of the port's list through
``distributed.sharding.unstack_spec``.

The one departure: the reference's ZeRO-1 puts "data" on the stacked
layer dim of a few small leaves (``zero1_spec`` picks the largest free
dim divisible by the data extent, and 48 or 32 layers beat a 32-wide
leaf); the port's per-layer leaf has no layer dim, so the rule picks among
the layer's own dims.  Those leaves are listed here exactly, with both
packages' per-chip bytes.  Property tests (hypothesis) hold
``param_sharding_rules``, ``zero1_spec``, ``sanitize_spec`` and
``_dp_axes`` to the reference on random names, shapes and meshes.
Specs are compared with each entry as a tuple of axis names (the
reference's ``PartitionSpec`` writes a one-axis tuple as the name).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from jax.sharding import AbstractMesh as JaxMesh
from jax.sharding import PartitionSpec as JaxP

from repro.configs import get_config as jax_config
from repro.distributed import sharding as RSH
from repro.launch import shapes as RSHAPES
from repro.launch import steps as RS
from repro.models import get_model as jax_model
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import all_arch_names, get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import shapes as SHAPES
from repro_torch.launch import steps as S

from _torch_spec_ref import (LAYER_DIM_ZERO, MESHES, _jax_flat,
                             _local_bytes, _n_layers, _port_at, compare_tree,
                             departure_bytes, norm, trees)

ARCHS = all_arch_names()

# -- the trees, leaf for leaf ---------------------------------------------------


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh_key):
    t = trees(arch, mesh_key)
    assert not compare_tree(t["r_pspecs"], t["p_pspecs"])


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_match_reference(arch, mesh_key):
    t = trees(arch, mesh_key)
    dep = LAYER_DIM_ZERO.get((mesh_key, arch), set())
    for k in ("master", "mu", "nu"):
        met = compare_tree(t["r_st"][k], t["p_st"][k], departures=dep)
        assert met == dep, (k, met)
    assert norm(t["r_st"]["step"]) == norm(t["p_st"]["step"]) == ()


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_layer_dim_zero_departure_bytes(arch, mesh_key):
    """The departure leaves, with both packages' per-chip bytes (f32
    master; mu and nu the same): the reference splits the stacked leaf's
    layer dim, the port each layer's own dim (the SSM heads) when the data
    extent divides it, else it keeps the layer's leaf whole -- mamba2's 32
    heads divide 16, hymba's 50 do not (6,000 bytes more a leaf on
    (16, 16))."""
    t = trees(arch, mesh_key)
    sizes = dict(zip(*reversed(MESHES[mesh_key])))
    dep = LAYER_DIM_ZERO.get((mesh_key, arch), set())
    got = departure_bytes(arch, mesh_key)
    assert set(got) == dep
    dp = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    rshape = {n: l.shape for n, l in _jax_flat(t["r_state"]["master"]
                                               ).items()}
    for name, (ref_b, port_b) in got.items():
        L, nh = rshape[name]
        assert ref_b == L // dp * nh * 4
        assert port_b == L * (nh // dp if nh % dp == 0 else nh) * 4
    if (mesh_key, arch) == ("16x16", "hymba-1.5b"):
        assert {n: p - r for n, (r, p) in got.items()} == {n: 6000
                                                           for n in dep}


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch, mesh_key):
    t = trees(arch, mesh_key)
    for sname, shape in RSHAPES.SHAPES.items():
        ok, _ = RSHAPES.applicable(t["cfg_j"], sname)
        assert (ok, _) == SHAPES.applicable(t["cfg"], sname)
        if not ok:
            continue
        if shape.kind != "decode":
            rb = RSHAPES.batch_specs(t["cfg_j"], shape)
            pb = SHAPES.batch_specs(t["cfg"], SHAPES.SHAPES[sname])
            assert {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                    for k, v in pb.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in rb.items()}
            rs = RS.batch_pspecs(t["cfg_j"], rb, t["jm"])
            ps = S.batch_pspecs(t["cfg"], pb, t["pm"])
            assert {k: norm(v) for k, v in ps.items()} == \
                {k: norm(v) for k, v in rs.items()}
            continue
        rd = RSHAPES.decode_specs(t["cfg_j"], shape)
        pd = SHAPES.decode_specs(t["cfg"], SHAPES.SHAPES[sname])
        assert tuple(pd["tokens"].shape) == tuple(rd["tokens"].shape)
        rc = RS.cache_pspecs(t["cfg_j"], rd["cache"], t["jm"])
        pc = S.cache_pspecs(t["cfg"], pd["cache"], t["pm"])
        compare_tree(rc, pc)
        # shapes and dtypes of the cache, leaf for leaf
        for name, leaf in _jax_flat(rd["cache"]).items():
            stacked = name.split("/", 1)[0] == "layers"
            n = _n_layers(pd["cache"], name) if stacked else 0
            for i in (range(n) if stacked else [None]):
                got = _port_at(pd["cache"], name, i)
                assert got.device.type == "meta"
                want = leaf.shape[1:] if stacked else leaf.shape
                assert tuple(got.shape) == tuple(want), name
                assert str(got.dtype).replace("torch.", "") == str(
                    leaf.dtype), name


# -- property tests against the reference ---------------------------------------

_LEAVES = ["embed", "lm_head", "dec_embed", "wq", "wk", "wv", "wkv",
           "w_gate", "w_up", "in_proj", "w_dkv", "w_kr", "w_uk", "w_uv",
           "w_q", "wo", "w_down", "out_proj", "router", "w_gate_e",
           "w_up_e", "w_down_e", "scale", "bias", "conv_w", "A_log"]
_PREFIX = ["", "layers/attn/", "layers/mlp/", "layers/moe/", "first_0/attn/",
           "enc_layers/attn/", "dec_layers/xattn/", "layers/ssm/"]

mesh_st = st.sampled_from(list(MESHES.values()))
dims = st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64,
                                 96, 6482]), min_size=0, max_size=4)


@settings(max_examples=200, deadline=None)
@given(prefix=st.sampled_from(_PREFIX), leaf=st.sampled_from(_LEAVES),
       shape=dims)
def test_param_sharding_rules_property(prefix, leaf, shape):
    name = prefix + leaf
    assert norm(SH.param_sharding_rules(name, tuple(shape))) == \
        norm(RSH.param_sharding_rules(name, tuple(shape)))


def _spec_st(ndim, axes):
    part = st.one_of(st.none(), st.sampled_from(axes),
                     st.sampled_from([("pod", "data"), ("data",)]))
    return st.lists(part, min_size=0, max_size=ndim)


@settings(max_examples=200, deadline=None)
@given(mesh=mesh_st, shape=dims, data=st.data())
def test_zero1_and_sanitize_property(mesh, shape, data):
    shp, names = mesh
    parts = data.draw(_spec_st(len(shape), list(names)))
    parts = [p if p is None or isinstance(p, str) or
             all(a in names for a in p) else None for p in parts]
    parts = [p if not isinstance(p, str) or p in names else None
             for p in parts]
    jm, pm = JaxMesh(shp, names), SH.AbstractMesh(shp, names)
    assert norm(S.zero1_spec(SH.P(*parts), tuple(shape), pm)) == \
        norm(RS.zero1_spec(JaxP(*parts), tuple(shape), jm))
    assert norm(S.sanitize_spec(SH.P(*parts), tuple(shape), pm)) == \
        norm(RS.sanitize_spec(JaxP(*parts), tuple(shape), jm))


@settings(max_examples=200, deadline=None)
@given(mesh=mesh_st, n=st.integers(1, 1024))
def test_dp_axes_property(mesh, n):
    shp, names = mesh
    got = S._dp_axes(SH.AbstractMesh(shp, names), n)
    want = RS._dp_axes(JaxMesh(shp, names), n)
    assert got == want


# -- placements --------------------------------------------------------------------


def test_to_placements_maps_axes_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    pm = SH.AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    assert SH.to_placements(SH.P(("pod", "data"), None, "model"), pm) == \
        [Shard(0), Shard(0), Shard(2)]
    assert SH.to_placements(SH.P(None, "data"), pm) == \
        [Replicate(), Shard(1), Replicate()]
    with pytest.raises(ValueError):
        SH.to_placements(SH.P(("data", "pod")), pm)
    assert SH.named(pm, None, "model") == (pm, [Replicate(), Replicate(),
                                                Shard(1)])


def test_unstack_spec_refuses_a_sharded_layer_dim():
    assert SH.unstack_spec((None, "model", None)) == SH.P("model", None)
    with pytest.raises(ValueError):
        SH.unstack_spec(("data", None))


def test_shard_is_identity_outside_a_mesh():
    import torch
    x = torch.arange(6.0).reshape(2, 3)
    assert SH.shard(x, "batch", "tp") is x
    with SH.mesh_context(SH.AbstractMesh((2, 2), ("data", "model"))):
        assert SH.shard(x, "batch", "tp") is x      # a plain tensor
        assert SH.axis_size("tp") == 2 and SH.axis_size("batch") == 2
        assert norm(SH.spec("batch", None, "tp")) == (("data",), (),
                                                      ("model",))
    assert SH.axis_size("tp") == 1 and SH.current_mesh() is None
