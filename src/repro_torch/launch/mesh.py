"""Production meshes of the port.

Defined as functions, not module constants, so importing this module
touches no process group.  Each builds a
``torch.distributed.device_mesh.DeviceMesh`` with the JAX package's axis
names over the ranks of the process group the caller has set up: a real
one (NCCL on the cards, gloo on CPU hosts) or the fake group of the dry
run (``launch/dryrun.py``).  The single-pod mesh is 16 x 16 = 256 GPUs
(32 nodes of 8 H100s); the multi-pod mesh adds a leading "pod" axis
(2 x 16 x 16 = 512 GPUs).  Axis roles:

  pod    outer data parallelism (+ compressed cross-pod gradient reduce)
  data   data parallelism within a pod
  model  tensor / expert / sequence parallelism
"""

from __future__ import annotations

from typing import Tuple

import torch


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def debug_shape(data: int = 2, model: int = 2, pod: int = 0
                ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    if pod:
        return (pod, data, model), ("pod", "data", "model")
    return (data, model), ("data", "model")


def _device_mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    import torch.distributed as dist
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {n} ranks; "
            f"initialize one first (world size "
            f"{dist.get_world_size() if dist.is_initialized() else 0})")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    return _device_mesh(device_type, *production_shape(multi_pod))


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0,
                    device_type="cuda"):
    """Small mesh for tests (a gloo world of data * model * pod ranks)."""
    return _device_mesh(device_type, *debug_shape(data, model, pod))

