"""Error-feedback int8 gradient compression (the JAX package's
``optim/compress.py``).

``ef_int8_compress(g, err)`` quantizes ``g + err`` to int8 and returns
(q, scale, new_err) with new_err = input - dequant(q); the quantization
noise is fed back into the next step, so it is unbiased over steps.
``compressed_psum_tree`` sums a tree of gradients over a process group
(the pods) on int8 payloads: one shared scale a leaf (an all-reduce MAX
of its amax), the int8 values summed in int32, the sum divided by the
group's size.  It uses functional collectives, so it runs on a real group
and on the dry run's fake one alike.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..distributed.sharding import all_reduce
from ..models.convert import tree_map


def ef_int8_compress(g: torch.Tensor, err: torch.Tensor,
                     scale: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize (g + err) to int8 on a scale of max|x| / 127, or on
    ``scale`` when it is given (ranks that sum their payloads share one
    scale).  Returns (q_int8, scale, new_err)."""
    x = g.to(torch.float32) + err
    if scale is None:
        amax = torch.max(torch.abs(x))
        scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, x - deq


def ef_int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_psum_tree(grads, err_tree, group) -> Tuple[Any, Any]:
    """Quantize and sum every leaf of ``grads`` over ``group`` (the JAX
    package's ``compressed_psum_tree`` over a pod axis): returns (the mean
    over the group of the dequantized leaves, in each leaf's dtype, and the
    new error-feedback tree).

    Per leaf: x = g + err in f32; a scale shared by the group,
    max(all-reduce MAX of max|x|, 1e-12) / 127 (int8 payloads are
    summable only on a common scale); q = int8 of x on that scale; the
    int8 payloads summed in int32 (no overflow across ranks); times the
    scale, divided by the group's size."""
    import torch.distributed as dist
    n = dist.get_world_size(group)

    def one(g, err, _):
        x = g.to(torch.float32) + err
        amax = all_reduce(torch.max(torch.abs(x)), "max", group)
        scale = torch.clamp(amax, min=1e-12) / 127.0
        q, _, new_err = ef_int8_compress(g, err, scale=scale)
        qsum = all_reduce(q.to(torch.int32), "sum", group)
        avg = qsum.to(torch.float32) * scale / n
        return avg.to(g.dtype), new_err

    outs = tree_map(one, grads, err_tree)
    return (tree_map(lambda o, _: o[0], outs),
            tree_map(lambda o, _: o[1], outs))
