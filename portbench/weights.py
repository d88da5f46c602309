"""Seeded weights of a configuration, made by the benchmark on the device.

The tree has the layout the port's models take (``embed``, ``final_norm``,
``lm_head``, and ``layers``, a list of per-layer dicts); the values are the
benchmark's own.  Every normal leaf is a view of one ``torch.randn`` call
and every other leaf a view of one further buffer, so the whole tree takes
a few large calls on the card whatever the depth.  The same seed on the
same device gives the same values, so the reference, which runs after the
window, makes them again instead of keeping a copy.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

Path = Tuple[Any, ...]


def padded_vocab(model: Dict[str, Any]) -> int:
    return -(-model["vocab_size"] // 256) * 256


def ssm_dims(model: Dict[str, Any]) -> Tuple[int, int, int, int]:
    """(d_inner, ssm_state, ssm heads, ssm head dim)."""
    di = model["ssm_expand"] * model["d_model"]
    return di, model["ssm_state"], di // model["ssm_head_dim"], \
        model["ssm_head_dim"]


def leaf_specs(model: Dict[str, Any]) -> List[Tuple[Path, Tuple[int, ...],
                                                     str, float]]:
    """(path, shape, kind, scale) of every leaf; kind is ``normal`` (std
    ``scale``), ``ones``, ``zeros``, ``alog`` (log 1..n) or ``dtbias``."""
    d, V = model["d_model"], padded_vocab(model)
    out = [(("embed",), (V, d), "normal", 0.02),
           (("final_norm", "scale"), (d,), "ones", 0.0),
           (("lm_head",), (V, d), "normal", d ** -0.5)]
    family = model["family"]
    if family not in ("ssm", "hybrid"):
        raise ValueError(f"family {family!r}: the benchmark makes weights "
                         f"for 'ssm' and 'hybrid' configurations")
    for i in range(model["n_layers"]):
        L = ("layers", i)
        out.append((L + ("ln1", "scale"), (d,), "ones", 0.0))
        if family == "hybrid":
            H, KV, hd, ff = (model["n_heads"], model["n_kv_heads"],
                             model["head_dim"], model["d_ff"])
            for name, shape in (("wq", (d, H * hd)), ("wk", (d, KV * hd)),
                                ("wv", (d, KV * hd)), ("wo", (H * hd, d))):
                out.append((L + ("attn", name), shape, "normal",
                            shape[0] ** -0.5))
            out.append((L + ("ln2", "scale"), (d,), "ones", 0.0))
            for name, shape in (("w_up", (d, ff)), ("w_down", (ff, d)),
                                ("w_gate", (d, ff))):
                out.append((L + ("mlp", name), shape, "normal",
                            shape[0] ** -0.5))
        di, ns, nh, shd = ssm_dims(model)
        W, C = model["conv_width"], di + 2 * ns
        S = L + ("ssm",)
        out += [(S + ("in_proj",), (d, 2 * di + 2 * ns + nh), "normal",
                 d ** -0.5),
                (S + ("conv_w",), (W, C), "normal", W ** -0.5),
                (S + ("conv_b",), (C,), "zeros", 0.0),
                (S + ("A_log",), (nh,), "alog", 0.0),
                (S + ("D",), (nh,), "ones", 0.0),
                (S + ("dt_bias",), (nh,), "dtbias", 0.0),
                (S + ("gate_norm",), (shd,), "ones", 0.0),
                (S + ("out_proj",), (di, d), "normal", di ** -0.5)]
    return out


def _put(tree: Dict, path: Path, value: torch.Tensor) -> None:
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(k, int):
            while len(node) <= k:
                node.append({})
            node = node[k]
            continue
        if k not in node:
            node[k] = [] if isinstance(nxt, int) else {}
        node = node[k]
    node[path[-1]] = value


def make_params(model: Dict[str, Any], seed: int, device,
                matrix_dtype: torch.dtype) -> Dict[str, Any]:
    """The seeded tree: normal leaves (the matrices) in ``matrix_dtype``,
    the rest in f32, as the port holds them; a training master passes
    f32 for both."""
    specs = leaf_specs(model)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n_normal = sum(math.prod(s) for _, s, k, _ in specs if k == "normal")
    n_small = sum(math.prod(s) for _, s, k, _ in specs if k != "normal")
    normal = torch.randn(n_normal, generator=gen, device=device,
                         dtype=matrix_dtype)
    small = torch.rand(n_small, generator=gen, device=device,
                       dtype=torch.float32)
    lo, hi = math.log(1e-3), math.log(0.1)
    tree: Dict[str, Any] = {}
    a = b = 0
    with torch.no_grad():
        for path, shape, kind, scale in specs:
            n = math.prod(shape)
            if kind == "normal":
                leaf = normal[a:a + n].view(shape)
                leaf.mul_(scale)
                a += n
            else:
                leaf = small[b:b + n].view(shape)
                b += n
                if kind == "ones":
                    leaf.fill_(1.0)
                elif kind == "zeros":
                    leaf.zero_()
                elif kind == "alog":
                    leaf.copy_(torch.log(torch.arange(
                        1, n + 1, device=device, dtype=torch.float32)))
                elif kind == "dtbias":   # softplus(dt_bias) in [1e-3, 1e-1]
                    leaf.copy_(torch.log(torch.expm1(torch.exp(
                        leaf * (hi - lo) + lo))))
                else:
                    raise ValueError(f"unknown leaf kind {kind!r}")
            _put(tree, path, leaf)
    return tree


def unflatten(leaves: Dict[str, Any]) -> Dict[str, Any]:
    """The tree of dotted names (``layers.3.ssm.in_proj``) back in the
    port's layout."""
    tree: Dict[str, Any] = {}
    for name, leaf in leaves.items():
        _put(tree, tuple(int(k) if k.isdigit() else k
                         for k in name.split(".")), leaf)
    return tree

