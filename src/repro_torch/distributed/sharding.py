"""Sharding of the port: logical-axis constraints over a DTensor mesh, the
parameter-sharding rules, and the cross-process byte transport of its
multi-process ``Comm``.

Counterpart of the JAX package's ``distributed/sharding.py``.

**Sharding.**  Models are written against *logical* axes ("batch", "seq",
"tp", "exp", ...).  :func:`mesh_context` records which physical axes the
current ``torch.distributed.device_mesh.DeviceMesh`` has (its named
dims); :func:`shard` redistributes a ``DTensor`` to the placements of the
logical spec and is an identity outside a mesh or on a plain tensor, so
the same model code runs

  * unsharded on one device (every test and serving path), and
  * as DTensors under the production meshes (the dry run on a fake
    process group, a real sharded step on the card).

Physical mapping:

  batch  -> ("pod", "data")     DP over pods x data axis
  tp     -> "model"             tensor parallel / expert parallel / seq shard

A spec (:class:`PartitionSpec`, ``P``) is a tuple with one entry a tensor
dim: None, an axis name, or a tuple of axis names, as the JAX package's
``PartitionSpec``; :func:`to_placements` maps it onto DTensor placements.
The port keeps per-layer lists where the JAX package stacks layers along a
leading axis, so its trees of specs are per layer: :func:`unstack_spec`
states the one mapping between the two.

**Transport.**  Where the reference moves payloads between jax host
processes with a collective permutation (``PpermuteByteTransport``,
``global_any``), :class:`StoreByteTransport` keeps them on the key-value
``Store`` of a ``torch.distributed`` group (a ``FileStore`` behind
``init_process_group(init_method="file://...")``, the ``TCPStore`` that
``torchrun`` sets up):

- a per-pair FIFO mailbox: message ``n`` from rank ``s`` to rank ``d`` on
  channel ``ch`` is the key ``<prefix>/<ch>/<s>-><d>/<n>``; the receiver
  waits for it by polling ``check``, then reads and deletes it.  A receive
  that times out has taken nothing, so a message that arrives later is the
  next receive's, as in a queue -- a posted gloo ``recv`` cannot be
  withdrawn;
- rounds (``barrier``, ``bcast``, ``any``) on counters and one value a
  round, numbered per transport, whose last rank out deletes their keys;
- ``sub(key)``: the same ranks under ``<prefix>/<key>``, with mailboxes and
  rounds of its own (the ``dup`` of a comm);
- a world-wide ``failed`` key: a rank that fails sets it (``mark_failed``),
  as does the launcher when a process dies, and every wait polls it, so
  waits on a dead peer end in an error instead of sitting out their
  timeout.

Payloads are host bytes (the Recorder ships serialized rank states); the
card never sees them.  :func:`dumps` pickles a payload and refuses a CUDA
tensor inside it.
"""

from __future__ import annotations

import io
import pickle
import threading
import time
import types
from contextlib import ExitStack, contextmanager
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

#: first and longest sleep between two polls of a waited-for key (seconds)
POLL_S = (0.0005, 0.02)
#: the key prefix of a world's mailboxes and rounds
PREFIX = "repro"


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj: Any) -> Any:
        if isinstance(obj, torch.Tensor) and obj.device.type != "cpu":
            raise TypeError(
                f"a {obj.device} tensor cannot travel between processes; "
                f"move it to the CPU first")
        return NotImplemented


def dumps(obj: Any) -> bytes:
    """Pickle ``obj`` for the wire; a CUDA tensor inside it raises
    TypeError."""
    buf = io.BytesIO()
    _Pickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


class StoreByteTransport:
    """Mailboxes and rounds between the ``size`` ranks sharing ``store``.

    Every rank must use the same ``prefix`` and run rounds in the same
    order.  Store calls are serialized by one lock per world, so a
    background thread on a ``sub`` transport and the foreground never use
    the store at once.
    """

    def __init__(self, store: Any, rank: int, size: int,
                 prefix: str = PREFIX, *, _world: Optional[Tuple] = None):
        self.store = store
        self.rank = rank
        self.size = size
        self.prefix = prefix
        # (failed key, store lock) shared with every sub-transport
        self._world = _world or (f"{prefix}/failed", threading.Lock())
        self._lock = threading.Lock()       # this transport's counters
        self._sent: Dict[Tuple[str, int], int] = {}
        self._taken: Dict[Tuple[str, int], int] = {}
        self._rounds: Dict[str, int] = {}

    def sub(self, key: str) -> "StoreByteTransport":
        """The same ranks on keys of their own under ``<prefix>/<key>``."""
        return StoreByteTransport(self.store, self.rank, self.size,
                                  f"{self.prefix}/{key}", _world=self._world)

    # -- the store, one call at a time --------------------------------------

    def _call(self, method: str, *args) -> Any:
        with self._world[1]:
            return getattr(self.store, method)(*args)

    def mark_failed(self, why: str) -> None:
        """Tell every rank's waits that a peer is gone."""
        self._call("set", self._world[0], why.encode())

    def failed(self) -> bool:
        return self._call("check", [self._world[0]])

    def wait(self, key: str, timeout: Optional[float], what: str) -> None:
        """Block until ``key`` exists.  Raises TimeoutError after
        ``timeout`` seconds (None: no limit) and RuntimeError once a peer
        has failed; polls back off from ``POLL_S[0]`` to ``POLL_S[1]``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        poll = POLL_S[0]
        while not self._call("check", [key]):
            if self.failed():
                raise RuntimeError(f"rank {self.rank}: peer failed while "
                                   f"{what}")
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(f"rank {self.rank}: timed out {what} "
                                   f"after {timeout:g}s")
            time.sleep(poll)
            poll = min(2 * poll, POLL_S[1])

    # -- mailboxes ----------------------------------------------------------

    def _box(self, channel: str, src: int, dst: int, n: int) -> str:
        return f"{self.prefix}/{channel}/{src}->{dst}/{n}"

    def put(self, channel: str, dst: int, blob: bytes) -> None:
        """Deliver ``blob`` to ``dst``'s mailbox from this rank; messages
        are numbered in the order they are delivered."""
        with self._lock:
            n = self._sent.get((channel, dst), 0)
            self._sent[(channel, dst)] = n + 1
            self._call("set", self._box(channel, self.rank, dst, n), blob)

    def take(self, channel: str, src: int, timeout: Optional[float]) -> bytes:
        """The next message from ``src`` on ``channel`` (see :meth:`wait`
        for the errors); on expiry nothing is consumed."""
        n = self._taken.get((channel, src), 0)
        key = self._box(channel, src, self.rank, n)
        self.wait(key, timeout, f"receiving from rank {src}")
        blob = self._call("get", key)
        self._call("delete_key", key)
        self._taken[(channel, src)] = n + 1
        return blob

    # -- rounds ---------------------------------------------------------------

    def _round(self, name: str) -> str:
        with self._lock:
            g = self._rounds.get(name, 0)
            self._rounds[name] = g + 1
        return f"{self.prefix}/{name}/{g}"

    def _arrive(self, key: str, what: str) -> None:
        """Count this rank in; the last one in opens the round."""
        if self._call("add", f"{key}/in", 1) == self.size:
            self._call("set", f"{key}/go", b"1")
        self.wait(f"{key}/go", None, what)

    def _leave(self, key: str, names: Tuple[str, ...]) -> None:
        """Count this rank out; the last one out deletes the round's keys."""
        if self._call("add", f"{key}/out", 1) == self.size:
            for name in names + ("out",):
                self._call("delete_key", f"{key}/{name}")

    def barrier(self) -> None:
        key = self._round("barrier")
        self._arrive(key, "at a barrier")
        self._leave(key, ("in", "go"))

    def bcast(self, blob: Optional[bytes], root: int) -> bytes:
        """``root``'s ``blob`` to every rank, stored once."""
        key = self._round("bcast")
        if self.rank == root:
            self._call("set", f"{key}/v", blob)
        else:
            self.wait(f"{key}/v", None, f"waiting for rank {root}'s "
                                        f"broadcast")
            blob = self._call("get", f"{key}/v")
        self._leave(key, ("v",))
        return blob

    def any(self, flag: bool) -> bool:
        """Boolean OR of every rank's ``flag``, on every rank."""
        key = self._round("any")
        if flag:
            self._call("add", f"{key}/yes", 1)
        self._arrive(key, "at a vote")
        verdict = self._call("add", f"{key}/yes", 0) > 0
        self._leave(key, ("yes", "in", "go"))
        return verdict


def global_any(flag: bool, transport: StoreByteTransport) -> bool:
    """Cross-process boolean OR (the flush-cadence vote); identity with one
    process."""
    if transport.size == 1:
        return bool(flag)
    return transport.any(bool(flag))


# ---------------------------------------------------------------------------
# logical-axis sharding over a DeviceMesh
# ---------------------------------------------------------------------------

#: the current mesh, process-wide: autograd runs a CUDA backward -- and
#: with it the recompute of a checkpointed block -- on a thread of its
#: own, which must see the mesh the forward saw
_state = types.SimpleNamespace(axes=(), mesh=None)

LOGICAL_TO_PHYSICAL: Dict[Optional[str], Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "tp": ("model",),
    "seq": ("model",),   # sequence sharding rides the model axis
    "exp": ("model",),   # expert parallelism rides the model axis
    None: (),
}


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), an axis name, or a tuple
    of axis names (the dim split over all of them, in mesh order)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


P = PartitionSpec


class AbstractMesh:
    """Axis names and extents without devices or a process group: what
    the spec functions read of a mesh (the JAX package's
    ``jax.sharding.AbstractMesh``)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        self.mesh_dim_names = tuple(axis_names)
        self.shape = tuple(int(n) for n in shape)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> extent, in mesh order, of a ``DeviceMesh`` or an
    :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def current_mesh_axes() -> Tuple[str, ...]:
    return _state.axes


def current_mesh():
    return _state.mesh


@contextmanager
def mesh_context(mesh):
    """Enter a mesh (for the whole process, see ``_state``): logical
    sharding resolves against its named dims, and plain tensors that meet
    a DTensor count as replicated (``implicit_replication``).  ``None`` is
    a no-op."""
    if mesh is None:
        yield
        return
    prev = (current_mesh_axes(), current_mesh())
    _state.axes = tuple(mesh.mesh_dim_names)
    _state.mesh = mesh
    try:
        with ExitStack() as stack:
            if not isinstance(mesh, AbstractMesh):
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                stack.enter_context(implicit_replication())
            yield
    finally:
        _state.axes, _state.mesh = prev


def _resolve(logical: Optional[str]) -> Optional[Tuple[str, ...]]:
    """Logical name -> tuple of available physical axes (None if none)."""
    axes = current_mesh_axes()
    if logical is None:
        return None
    phys = tuple(a for a in LOGICAL_TO_PHYSICAL.get(logical, (logical,))
                 if a in axes)
    return phys if phys else None


def spec(*logical: Optional[str]) -> P:
    return P(*(_resolve(l) for l in logical))


def axis_size(logical: str) -> int:
    """Product of the physical axis sizes behind a logical axis (1 if
    absent)."""
    mesh = current_mesh()
    if mesh is None:
        return 1
    shape = mesh_shape(mesh)
    n = 1
    for a in _resolve(logical) or ():
        n *= shape[a]
    return n


def _axes_of(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return tuple(part) if isinstance(part, tuple) else (part,)


def to_placements(spec_: Sequence, mesh) -> List:
    """DTensor placements of ``spec_`` on ``mesh``: ``Shard(d)`` on every
    mesh dim named in entry d, ``Replicate()`` on the others.  A dim over
    several axes (``("pod", "data")``) names them in mesh order, which is
    the order DTensor splits a dim sharded on several mesh dims."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, part in enumerate(spec_):
        axes = _axes_of(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {part!r} does not name its axes "
                             f"in mesh order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def named(mesh, *parts) -> Tuple[Any, List]:
    """(mesh, placements) of ``P(*parts)``: the JAX package's
    ``NamedSharding``."""
    return mesh, to_placements(P(*parts), mesh)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def logical_shard(x, spec_: Sequence):
    """Redistribute a DTensor ``x`` to ``spec_``; identity outside a mesh
    or on a plain tensor."""
    if not current_mesh_axes() or not is_dtensor(x):
        return x
    placements = to_placements(tuple(spec_) + (None,) * (x.dim()
                                                         - len(spec_)),
                               x.device_mesh)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def shard(x, *logical: Optional[str]):
    """Constrain ``x`` to the logical spec; identity outside a mesh or on a
    plain tensor."""
    if not current_mesh_axes() or not is_dtensor(x):
        return x
    return logical_shard(x, spec(*logical))


# ---------------------------------------------------------------------------
# parameter sharding rules
# ---------------------------------------------------------------------------

#: the keys whose per-layer leaves the JAX package stacks
STACKED = ("layers", "enc_layers", "dec_layers")


def param_sharding_rules(name: str, shape: Tuple[int, ...],
                         tp: str = "model") -> P:
    """Sharding spec for one parameter, by the JAX package's naming
    convention and in its stacked layout (``name`` "layers/attn/wq",
    ``shape`` with the leading layer dim).

    Layout rules (MaxText-style):
      embeddings       (vocab, d)        -> (tp, None)   vocab-sharded
      attn in-proj     (d, heads*hd)     -> (None, tp)   head-sharded
      attn out-proj    (heads*hd, d)     -> (tp, None)
      mlp in/gate      (d, ff)           -> (None, tp)
      mlp out          (ff, d)           -> (tp, None)
      experts          (E, d, ff)        -> (tp, None, None)  expert-sharded
      biases/norms/small vectors         -> replicated
    Stacked-layer params carry a leading layer axis (never sharded).
    """
    lead = 1 if name.split("/", 1)[0] in STACKED else 0
    ndim = len(shape) - lead

    def out(spec_parts):
        return P(*([None] * lead + list(spec_parts)))

    leaf = name.rsplit("/", 1)[-1]
    if ndim <= 1:
        return out([None] * ndim)  # norms, biases, scalars: replicated
    # expert-stacked weights: (E, d_in, d_out) -> shard experts over tp
    if leaf in ("w_gate_e", "w_up_e", "w_down_e") and ndim == 3:
        return out([tp, None, None])
    if leaf in ("embed", "lm_head", "dec_embed"):
        return out([tp, None])
    if leaf in ("wq", "wk", "wv", "wkv", "w_gate", "w_up", "in_proj",
                "w_dkv", "w_kr", "w_uk", "w_uv", "w_q"):
        return out([None] * (ndim - 1) + [tp])
    if leaf in ("wo", "w_down", "out_proj"):
        return out([tp] + [None] * (ndim - 1))
    return out([None] * ndim)       # router and the rest: replicated


def unstack_spec(stacked: Sequence) -> P:
    """The one mapping between the two layouts: the JAX package's spec of
    a stacked leaf, ``P(None, *rest)``, is ``P(*rest)`` on every layer of
    the port's list.  A stacked spec that shards the layer dim has no
    per-layer counterpart and raises."""
    if not len(stacked) or stacked[0] is not None:
        raise ValueError(f"stacked spec {stacked!r} shards the layer dim")
    return P(*stacked[1:])


def map_leaves(fn, tree, path: Tuple[str, ...] = ()):
    """``fn(path, leaf)`` over the port's trees (dicts and lists); the path
    holds dict keys and list indices as strings."""
    if isinstance(tree, dict):
        return {k: map_leaves(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_leaves(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def reference_name(path: Sequence[str]) -> Tuple[str, bool]:
    """(the JAX package's leaf name, whether the leaf is stacked there) of
    a port path: the list index under a stacked key is dropped
    ("layers/3/attn/wq" -> "layers/attn/wq")."""
    path = list(path)
    stacked = bool(path) and path[0] in STACKED
    if stacked:
        del path[1]
    return "/".join(path), stacked


def tree_param_specs(params, tp: str = "model"):
    """The port's parameter tree -> the same tree of per-layer specs:
    ``param_sharding_rules`` on the JAX package's name and stacked shape,
    through :func:`unstack_spec` for a per-layer leaf."""
    def one(path, leaf):
        name, stacked = reference_name(path)
        shape = tuple(leaf.shape)
        if stacked:
            return unstack_spec(param_sharding_rules(name, (1,) + shape, tp))
        return param_sharding_rules(name, shape, tp)
    return map_leaves(one, params)


# ---------------------------------------------------------------------------
# per-rank code on the local shards
# ---------------------------------------------------------------------------


def placements_of(spec_: Sequence, ndim: int, mesh) -> List:
    """:func:`to_placements` of ``spec_`` padded with None to ``ndim``."""
    return to_placements(tuple(spec_) + (None,) * (ndim - len(spec_)), mesh)


def batch_placements(t, mesh) -> List:
    """The placements of ``t``'s batch (dim 0) sharding alone: ``Shard(0)``
    on the data axes that shard it, ``Replicate()`` elsewhere (a plain
    tensor is replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    pls = t.placements if is_dtensor(t) else [Replicate()] * len(
        mesh.mesh_dim_names)
    return [Shard(0) if n in ("pod", "data") and isinstance(p, Shard)
            and p.dim == 0 else Replicate()
            for n, p in zip(mesh.mesh_dim_names, pls)]


def replicated(mesh) -> List:
    from torch.distributed.tensor import Replicate
    return [Replicate() for _ in mesh.mesh_dim_names]


def local_run(fn, args: Sequence, in_placements: Sequence, out_placements,
              mesh, reduces: Sequence[str] = ()):
    """``fn`` on every rank's local shards (``local_map``).

    Each tensor of ``args`` with an entry of ``in_placements`` is
    redistributed to those placements first (a plain tensor counts as
    replicated); an entry of None passes the argument as it is.  The
    outputs are DTensors of ``out_placements`` (a list of placements, or
    one list an output).  The gradient of an input replicated on a mesh
    dim over which an output is sharded, or over whose axis ``fn`` sums
    (``reduces``: the axes of its differentiable all-reduces), is a
    partial sum there (each rank differentiates its own part), so it is
    declared ``Partial``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    ins = []
    for a, pl in zip(args, in_placements):
        if pl is not None and not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, replicated(mesh), run_check=False)
        ins.append(a)
    outs = out_placements if isinstance(out_placements[0], (list, tuple)) \
        else [out_placements]
    split = {i for pl in outs if pl is not None
             for i, p in enumerate(pl) if not isinstance(p, Replicate)}
    split |= {list(mesh.mesh_dim_names).index(a) for a in reduces}
    grads = tuple(None if pl is None else tuple(
        Partial() if isinstance(p, Replicate) and i in split else p
        for i, p in enumerate(pl)) for pl in in_placements)
    return local_map(fn, out_placements=out_placements,
                     in_placements=tuple(None if pl is None else tuple(pl)
                                         for pl in in_placements),
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=True)(*ins)


class _AllReduceReplicated(torch.autograd.Function):
    """All-reduce whose result feeds the same computation on every rank of
    the group: the gradient of each rank's contribution is the upstream
    gradient itself (Megatron's reduce-from-model-parallel region)."""

    @staticmethod
    def forward(ctx, x, op: str, group):
        return all_reduce(x, op, group)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_reduce(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """Functional all-reduce (``"sum"``, ``"max"``, ...), waited for: it
    runs on a real group and on the dry run's fake one alike."""
    import torch.distributed._functional_collectives as funcol
    out = funcol.all_reduce(x, op, group)
    return out.wait() if isinstance(out, funcol.AsyncCollectiveTensor) \
        else out


def all_reduce_replicated(x: torch.Tensor, op: str, group) -> torch.Tensor:
    """:func:`all_reduce` whose result every rank of ``group`` uses alike,
    differentiable (the gradient passes through unchanged)."""
    return _AllReduceReplicated.apply(x, op, group)

