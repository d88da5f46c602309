"""Per-chip analysis of one sharded step: collectives, FLOPs, memory and
roofline terms (the port's counterpart of the JAX package's
``launch/hlo_analysis.py``).

There is no partitioned HLO to read, so the step is run -- under
``FakeTensorMode`` on a fake process group in the dry run, or for real --
inside :class:`StepCounter`, a ``TorchDispatchMode`` that defers every
DTensor-level op to DTensor (returning ``NotImplemented``, as
``CommDebugMode`` does) and so sees the ops DTensor runs on the local
shards:

  * **FLOPs** are counted on those local ops (``torch.utils.flop_counter``'s
    formulas, plus the port's kernels below), so they are per chip;
  * **collectives** are the functional collectives among them (DTensor's
    redistributions, the model's own all-to-alls and all-reduces), counted
    per kind with their input bytes -- per-chip bytes put on the wire --
    and whether their group spans more than one node of 8 GPUs;
  * **bytes accessed** sum, for every op counted, the bytes of its tensor
    inputs and outputs on the local shards (a view aliases its input and
    moves none; an op that returns no tensor, such as ``prim.device``,
    moves none).  With no fusion this is an upper bound of what the step
    moves through HBM -- the counterpart of the reference's
    ``cost_analysis()`` "bytes accessed" on its CPU backend, which is an
    upper bound too;
  * **memory**: the per-chip argument bytes come from the local shapes;
    the peak is an estimate: the most bytes that the storages of the
    arguments' local shards and of the local ops' outputs held at once
    (each storage counted once, from its first op until it is freed; no
    allocator rounding, fragmentation or workspace), plus, while a call of
    the SSD scan's backward kernel runs, the scratch its wrapper allocates
    for the call (the operator's fake version allocates nothing that the
    counter could see).

DTensor's sharding propagation runs an (op, shapes, placements) it has not
cached on global-shape fake tensors (``ShardingPropagator.
_propagate_tensor_meta_non_cached``; some ops it never caches, e.g.
``cat`` in torch 2.11, whose global fake tensors ran to 64 GiB at
qwen3-32b's ``prefill_32k``), and the strategy of an op it has no rule
for through the op's decomposition (``propagate_op_sharding_non_cached``;
e.g. ``softplus_backward``'s elementwise ops).  The counter leaves out
every op that runs inside either method, so a step's first run counts as
its later ones
(``tests/test_torch_dryrun.py`` holds a cold and a warm product to the
same count).  Under a fake mode a
collective's ``wait_tensor`` returns its input, as the real one does (its
fake version makes a new tensor).

Roofline terms use the published figures of one H100 SXM (dense bf16
989 TFLOP/s, HBM3 3.35 TB/s), NVLink 450 GB/s a direction between the 8
GPUs of a node, and 50 GB/s a GPU across nodes (one 400 Gb/s NIC a GPU,
as in a DGX H100).
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, Iterable, Optional

import torch
from torch._guards import active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

PEAK_FLOPS = 989e12        # bf16 dense, one H100 SXM
HBM_BW = 3.35e12           # bytes/s, one H100 SXM
NVLINK_BW = 450e9          # bytes/s a direction, within a node of 8 GPUs
NET_BW = 50e9              # bytes/s a GPU across nodes (400 Gb/s NIC)
GPUS_PER_NODE = 8

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all")
_KIND_OF = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def flash_attention_flops(q, k, v, causal: bool, window: int, *_, **__
                          ) -> int:
    """QK^T and PV: 4 B H Sq Skv D multiply-adds counted as 2 FLOPs each,
    over the (query, key) pairs the masks leave (causal: half the square;
    a window w: at most w keys a query)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    pairs = Sq * Skv
    if causal and Sq == Skv:
        pairs = Sq * (Sq + 1) // 2
    if window:
        pairs = min(pairs, Sq * window)
    return 4 * B * H * D * pairs


def ssd_scan_flops(x, b, c, dt, da, **_) -> int:
    """The chunked SSD's products a (batch, chunk, head): C B^T and its
    masked product with x (2 Q^2 ns + 2 Q^2 hd), the chunk state
    (2 Q ns hd), the inter-chunk output (2 Q ns hd)."""
    B, nc, Q, nh, hd = x.shape
    ns = b.shape[-1]
    return B * nc * nh * (2 * Q * Q * ns + 2 * Q * Q * hd + 4 * Q * ns * hd)


def ssd_scan_bwd_flops(x, b, c, dt, da, *_, **__) -> int:
    """The chunk scan's gradient: twice the forward's products (the
    chunk states the backward kernel recomputes are not counted)."""
    return 2 * ssd_scan_flops(x, b, c, dt, da)


def ssd_scan_bwd_scratch(x, b, c, dt, da, *_, **__) -> int:
    """Bytes that a call of the chunk scan's backward kernel takes beside
    its inputs and outputs: the f32 scratch and the groups' entering
    states of ``bwd_scratch_plan``, and the state's gradient carried from
    group to group."""
    from ..kernels.ssd_scan.ops import bwd_scratch_plan
    B, nc, Q, nh, hd = x.shape
    ns = b.shape[-1]
    _, nbytes, bbytes = bwd_scratch_plan(B, nc, Q, nh, hd, ns)
    return nbytes + bbytes + 4 * B * nh * ns * hd


def _kernel_flops() -> Dict[Any, Any]:
    ops = torch.ops.repro_torch
    return {ops.flash_attention: flash_attention_flops,
            ops.chunked_attention: flash_attention_flops,
            ops.ssd_scan: ssd_scan_flops,
            ops.ssd_scan_bwd: ssd_scan_bwd_flops}


#: the methods of DTensor's ``ShardingPropagator`` whose ops the counter
#: leaves out: the output metadata of an (op, shapes, placements) it has
#: not cached, and the strategy of an op it propagates through its
#: decomposition (both run on global-shape fake tensors)
_PROPAGATION = ("_propagate_tensor_meta_non_cached",
                "propagate_op_sharding_non_cached")


def _group_spans_nodes(group_name: str) -> bool:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    ranks = dist.get_process_group_ranks(_resolve_process_group(group_name))
    return len({r // GPUS_PER_NODE for r in ranks}) > 1


class StepCounter(TorchDispatchMode):
    """Counts per-chip FLOPs, bytes accessed, collectives and the peak of
    live storage bytes of what runs inside it (see the module docstring); ``track``
    adds the storages of tensors that exist before it (the arguments)."""

    def __init__(self):
        super().__init__()
        # make sure the kernels' operators are registered
        from ..kernels.flash_attention import ops as _fa    # noqa: F401
        from ..kernels.ssd_scan import ops as _ssd          # noqa: F401
        from ..models import layers as _layers              # noqa: F401
        self.flops = 0
        self.bytes_accessed = 0
        self.flops_by_op: Dict[str, int] = {}
        self.coll = {k: {"count": 0, "bytes": 0, "cross_node_bytes": 0}
                     for k in KINDS}
        self._kernels = _kernel_flops()
        self._scratch = {torch.ops.repro_torch.ssd_scan_bwd:
                         ssd_scan_bwd_scratch}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages = WeakIdKeyDictionary()

    def track(self, tensors: Iterable[torch.Tensor]) -> None:
        """Count the storages of ``tensors`` as live from now on."""
        for t in tensors:
            self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as prop
        self._propagating = 0
        self._saved = []
        for name in _PROPAGATION:
            real = getattr(prop, name, None)
            if real is None:
                continue

            def propagating(sp, op_schema, _real=real):
                self._propagating += 1
                try:
                    return _real(sp, op_schema)
                finally:
                    self._propagating -= 1
            self._saved.append((name, real))
            setattr(prop, name, propagating)
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as prop
        for name, real in self._saved:
            setattr(prop, name, real)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor desugar to local ops
        if func is torch.ops._c10d_functional.wait_tensor.default \
                and active_fake_mode():
            return args[0]
        out = func(*args, **kwargs)
        if self._propagating:
            return out                  # DTensor's sharding propagation
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._hold(t)
        packet = func._overloadpacket
        if packet in self._scratch:
            self.peak_bytes = max(self.peak_bytes, self.live_bytes
                                  + self._scratch[packet](*args, **kwargs))
        if outs and not func.is_view:
            ins = [t for t in tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes_accessed += sum(t.numel() * t.element_size()
                                       for t in ins + outs)
        n = 0
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
        elif packet in self._kernels:
            n = self._kernels[packet](*args, **kwargs)
        if n:
            self.flops += int(n)
            name = str(packet)
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + int(n)
        ns = getattr(packet, "_qualified_op_name", "")
        if "c10d_functional" in ns:
            kind = _KIND_OF.get(ns.rsplit("::", 1)[-1].replace(
                "_autograd", ""))
            if kind is not None:
                t = args[0]
                ts = t if isinstance(t, (list, tuple)) else [t]
                nbytes = sum(x.numel() * x.element_size() for x in ts)
                group = args[-1] if isinstance(args[-1], str) \
                    else kwargs.get("group_name")
                c = self.coll[kind]
                c["count"] += 1
                c["bytes"] += nbytes
                if group is not None and _group_spans_nodes(group):
                    c["cross_node_bytes"] += nbytes
        return out

    def collectives(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {k: dict(v) for k, v in self.coll.items()}
        out["total_bytes"] = sum(v["bytes"] for v in self.coll.values())
        out["cross_node_bytes"] = sum(v["cross_node_bytes"]
                                      for v in self.coll.values())
        return out


def roofline_terms(flops: float, hbm_bytes: float, coll: Dict[str, Any],
                   model_flops_per_chip: float = 0.0,
                   analytic_bytes_per_chip: float = 0.0,
                   op_bytes: float = 0.0) -> Dict[str, Any]:
    """Three roofline terms in seconds from per-chip quantities: compute
    (FLOPs over the bf16 peak), memory (``hbm_bytes`` -- what the step must
    move: arguments read once and written back where the step updates
    them -- over HBM bandwidth) and collectives (each collective's bytes
    over NVLink within a node, over the network where its group spans
    nodes).  Where ``analytic_bytes_per_chip`` is given (the roofline
    report's traffic model) the memory term and the bottleneck use it
    instead.  ``op_bytes`` (``StepCounter.bytes_accessed``, an unfused
    upper bound) gives ``t_memory_op_s`` beside them, as the reference's
    "bytes accessed" gives its ``t_memory_hlo_s``."""
    t_compute = flops / PEAK_FLOPS
    t_memory = (analytic_bytes_per_chip if analytic_bytes_per_chip
                else hbm_bytes) / HBM_BW
    cross = float(coll.get("cross_node_bytes", 0))
    t_coll = (float(coll.get("total_bytes", 0)) - cross) / NVLINK_BW \
        + cross / NET_BW
    dom = max((t_compute, "compute"), (t_memory, "memory"),
              (t_coll, "collective"))[1]
    out: Dict[str, Any] = {
        "flops_per_chip": float(flops), "hbm_bytes_per_chip": float(hbm_bytes),
        "coll_bytes_per_chip": float(coll.get("total_bytes", 0)),
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "bottleneck": dom,
        "analytic_bytes_per_chip": float(analytic_bytes_per_chip),
        "op_bytes_per_chip": float(op_bytes),
        "t_memory_op_s": op_bytes / HBM_BW}
    if model_flops_per_chip:
        out["model_flops_per_chip"] = model_flops_per_chip
        out["useful_flop_ratio"] = model_flops_per_chip / flops if flops \
            else 0.0
        tot = max(t_compute, t_memory, t_coll)
        out["roofline_fraction"] = (model_flops_per_chip / PEAK_FLOPS / tot
                                    if tot else 0.0)
    return out


def analyze(step, args, meta: Dict[str, Any],
            model_flops_per_chip: float = 0.0,
            hbm_bytes: Optional[float] = None) -> Dict[str, Any]:
    """Run ``step(*args)`` inside a :class:`StepCounter`; returns the
    collectives, FLOPs, memory and roofline terms of one chip (rank 0)."""
    from ..models.convert import flat_params
    from ..distributed.sharding import is_dtensor
    locals_ = []
    for a in args:
        tree = a if isinstance(a, dict) else {"x": a}
        for t in flat_params(tree).values():
            locals_.append(t.to_local() if is_dtensor(t) else t)
    counter = StepCounter()
    counter.track(locals_)
    with counter:
        step(*args)
    mem = {"peak_bytes_estimate": counter.peak_bytes,
           "argument_bytes": int(meta["arg_bytes"])}
    coll = counter.collectives()
    terms = roofline_terms(counter.flops, hbm_bytes if hbm_bytes is not None
                           else meta["arg_bytes"], coll,
                           model_flops_per_chip,
                           op_bytes=counter.bytes_accessed)
    return {"memory": mem, "collectives": coll, "flops": counter.flops,
            "bytes_accessed": counter.bytes_accessed,
            "flops_by_op": counter.flops_by_op, "roofline": terms}
