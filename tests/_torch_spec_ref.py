"""Shared helpers of ``tests/test_torch_sharding.py`` and
``tests/test_torch_dryrun.py``: the JAX package's sharding trees of a full
configuration on an ``AbstractMesh``, the port's on its own
``AbstractMesh`` of the same sizes, and their comparison leaf for leaf
(each stacked reference leaf against every layer of the port's list,
through ``distributed.sharding.unstack_spec``)."""

import jax
import jax.numpy as jnp
import torch
from jax.sharding import AbstractMesh as JaxMesh
from jax.sharding import PartitionSpec as JaxP

from repro.configs import get_config as jax_config
from repro.distributed import sharding as RSH
from repro.launch import steps as RS
from repro.models import get_model as jax_model
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as S

#: (mesh, arch) -> the master leaves on whose stacked layer dim the
#: reference's ZeRO-1 puts the data axes (mu and nu follow the master)
LAYER_DIM_ZERO = {
    ("16x16", "mamba2-370m"): {"layers/ssm/A_log", "layers/ssm/D",
                               "layers/ssm/dt_bias"},
    ("16x16", "hymba-1.5b"): {"layers/ssm/A_log", "layers/ssm/D",
                              "layers/ssm/dt_bias"},
    ("2x16x16", "hymba-1.5b"): {"layers/ssm/A_log", "layers/ssm/D",
                                "layers/ssm/dt_bias"},
    # what the debug meshes add (48 layers beat mamba2's 32 heads)
    ("2x2", "mamba2-370m"): {"layers/ssm/A_log", "layers/ssm/D",
                             "layers/ssm/dt_bias"},
    ("1x2x2", "mamba2-370m"): {"layers/ssm/A_log", "layers/ssm/D",
                               "layers/ssm/dt_bias"},
}


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x2x2": ((1, 2, 2), ("pod", "data", "model"))}


def norm(spec) -> tuple:
    """A spec as a tuple of axis tuples, trailing unsharded dims dropped."""
    out = [() if p is None else (tuple(p) if isinstance(p, tuple) else (p,))
           for p in spec]
    while out and out[-1] == ():
        out.pop()
    return tuple(out)


def _jax_flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JaxP))[0]
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", "")))
                     for p in path): leaf for path, leaf in flat}


def _port_at(tree, name: str, layer=None):
    parts = name.split("/")
    if layer is not None:
        parts.insert(1, str(layer))
    for p in parts:
        tree = tree[int(p)] if isinstance(tree, list) else tree[p]
    return tree


def _n_layers(port_tree, name: str) -> int:
    return len(port_tree[name.split("/", 1)[0]])


def compare_tree(ref_specs, port_specs, stacked_keys=SH.STACKED,
                 departures=frozenset()):
    """Every reference leaf against the port's (per layer for a stacked
    leaf); returns the names of the departures met."""
    met = set()
    for name, rspec in _jax_flat(ref_specs).items():
        if name.split("/", 1)[0] in stacked_keys and not name.startswith(
                "first"):
            n = _n_layers(port_specs, name)
            if norm(rspec)[:1] not in ((), ((),)):
                assert name in departures, (name, rspec)
                met.add(name)
                continue
            want = norm(SH.unstack_spec(tuple(rspec)))
            for i in range(n):
                assert norm(_port_at(port_specs, name, i)) == want, (name, i)
        else:
            assert norm(_port_at(port_specs, name)) == norm(rspec), name
    return met


# -- reference and port trees -------------------------------------------------


_CACHE = {}


def trees(arch: str, mesh_key: str):
    key = (arch, mesh_key)
    if key in _CACHE:
        return _CACHE[key]
    shape, names = MESHES[mesh_key]
    jm, pm = JaxMesh(shape, names), SH.AbstractMesh(shape, names)
    cfg_j = jax_config(arch)
    model = jax_model(cfg_j)
    ps = jax.eval_shape(lambda r: model.init_params(r),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
    r_pspecs = RS.sanitize_tree(ps, RSH.tree_param_specs(ps), jm)
    r_state = jax.eval_shape(jax_adamw_init, ps)
    r_st = RS.train_state_specs(r_state, r_pspecs, jm)

    cfg = get_config(arch)
    pshapes = S.param_shapes(cfg)
    p_pspecs = S.sanitize_tree(pshapes, SH.tree_param_specs(pshapes), pm)
    master = S.tree_map(lambda t, _: torch.empty(t.shape, device="meta",
                                                 dtype=torch.float32),
                        pshapes)
    p_state = {"master": master, "mu": master, "nu": master}
    p_st = S.train_state_specs(p_state, p_pspecs, pm)
    out = dict(jm=jm, pm=pm, cfg=cfg, cfg_j=cfg_j, ps=ps, r_pspecs=r_pspecs,
               r_state=r_state, r_st=r_st, pshapes=pshapes,
               p_pspecs=p_pspecs, p_state=p_state, p_st=p_st)
    _CACHE[key] = out
    return out


def _local_bytes(shape, spec, sizes, itemsize) -> int:
    n = 1
    for d, dim in enumerate(shape):
        part = spec[d] if d < len(spec) else None
        axes = () if part is None else (part if isinstance(part, tuple)
                                        else (part,))
        for a in axes:
            dim = -(-dim // sizes[a])
        n *= dim
    return n * itemsize




def departure_bytes(arch: str, mesh_key: str) -> dict:
    """name -> (reference, port) per-chip bytes of one f32 master leaf of
    ``LAYER_DIM_ZERO`` (mu and nu have the same)."""
    t = trees(arch, mesh_key)
    sizes = dict(zip(*reversed(MESHES[mesh_key])))
    rflat = _jax_flat(t["r_st"]["master"])
    rshape = {n: l.shape for n, l in _jax_flat(t["r_state"]["master"]
                                               ).items()}
    out = {}
    for name in LAYER_DIM_ZERO.get((mesh_key, arch), ()):
        ref_b = _local_bytes(rshape[name], rflat[name], sizes, 4)
        n = _n_layers(t["p_st"]["master"], name)
        port_b = sum(_local_bytes(tuple(_port_at(t["p_state"]["master"],
                                                 name, i).shape),
                                  _port_at(t["p_st"]["master"], name, i),
                                  sizes, 4) for i in range(n))
        out[name] = (ref_b, port_b)
    return out
