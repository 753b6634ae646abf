"""Explicit device-placement context threaded through the NGDB engine.

``ExecutionContext`` makes placement a value that flows models → executor →
trainer → launch, as in the JAX package (``DESIGN.md`` §Sharding):

* ``single_device()`` — the default everywhere; every helper is a no-op, so
  the single-device path is bit for bit what it was without a context.
* a mesh context — a ``ProcessMesh``: a ``torch.distributed`` ``DeviceMesh``
  over one process a device, laid out row-major over ``(pod, data, model)``
  as the reference's ``Mesh(np.asarray(devices).reshape(shape), axes)`` is,
  plus the *policy* mapping names and shapes to specs: parameters (and Adam
  moments) through ``sharding.param_spec``/``fsdp_param_spec`` under the
  chosen profile (``"2d"`` TP×FSDP or ``"fsdp"`` ZeRO-3), batch-like arrays
  over the data-parallel axes by ``sharding.batch_spec``.

The port shards by hand (ZeRO-3): each rank keeps only its shard of each
parameter and of both Adam moments (``shard``); a training step gathers the
sharded parameters into full tensors (``gather``), runs the encode and the
loss on its rows of the global batch (``batch_rows``), sums the gradients
over the batch axes (``reduce_batch``), keeps its shard of each and runs
Adam on the shards. A shard over a tuple of axes is indexed major-to-minor
in the tuple's order, as JAX lays out ``("data", "model")``.

The collectives run only on the main thread, in one fixed order on every
rank: a collective issued from the pipelined scheduler thread, or in another
order on one rank, hangs the group.
"""
from __future__ import annotations

import collections
import dataclasses
import datetime
import itertools
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import batch_spec, dp_axes, profile_spec

TIMEOUT = datetime.timedelta(seconds=300)


def _entry_axes(entry) -> Tuple[str, ...]:
    """The axes of one spec entry: None, a name, or a tuple of names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


class _Topology:
    """Coordinates and rank sets of a mesh laid out row-major over its axes
    (``(pod, data, model)`` order), shared by ``ProcessMesh`` and
    ``VirtualMesh``. Subclasses set ``shape``, ``axis_names``, ``size``,
    ``rank`` and ``_coords`` (rank -> {axis: coordinate})."""

    def _partition(self, axes: Sequence[str]) -> List[Tuple[int, ...]]:
        """The rank sets that vary over ``axes`` with the other coordinates
        fixed, each in ascending rank order."""
        keep = [i for i, a in enumerate(self.axis_names) if a not in axes]
        sets = collections.defaultdict(list)
        for r in range(self.size):
            c = self._coords[r]
            sets[tuple(c[self.axis_names[i]] for i in keep)].append(r)
        return [tuple(v) for _, v in sorted(sets.items())]

    def members(self, axes: Sequence[str]) -> Tuple[int, ...]:
        """The ranks that share this rank's coordinates off ``axes``."""
        key = tuple(axes)
        if key not in self._members:
            self._members[key] = next(m for m in self._partition(key) if self.rank in m)
        return self._members[key]

    def index(self, axes: Sequence[str], rank: Optional[int] = None) -> int:
        """``rank``'s block index over ``axes``, major-to-minor in their
        order (this rank's by default)."""
        c = self._coords[self.rank if rank is None else rank]
        i = 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i

    def ways(self, axes: Sequence[str]) -> int:
        return int(np.prod([self.shape[a] for a in axes])) if axes else 1

    def stats(self) -> Dict:
        return {"counts": dict(self.counts), "bytes": dict(self.bytes),
                "staged": self.staged}


class ProcessMesh(_Topology):
    """A ``DeviceMesh`` of ``shape`` (axis -> size, in ``(pod, data, model)``
    order) over the initialised default process group, with the rule tables'
    view of it (``.shape``, ``.axis_names``) and the collectives the port
    issues. One process group is made for every set of ranks that shares its
    coordinates off a subset of the axes (the default group where that is
    every rank; none where it is one rank: its collectives are the
    identity). ``counts``/``bytes`` count each op's calls and received bytes,
    ``staged`` the ops staged through host tensors under gloo.

    Gloo's point-to-point ops cannot take CUDA tensors (its TCP transport
    writes from the device pointer and aborts the process), so under the
    gloo backend only, ``exchange`` stages a CUDA tensor through a host copy
    and counts it in ``staged``. Gloo runs every collective here (all_reduce,
    all_gather, broadcast) on CUDA tensors itself; NCCL runs everything on
    the device, and nothing is staged."""

    def __init__(self, shape: Dict[str, int], device: torch.device,
                 timeout: datetime.timedelta = TIMEOUT):
        from torch.distributed.device_mesh import init_device_mesh

        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))
        self.device = device
        self.backend = dist.get_backend()
        self.rank = dist.get_rank()
        self.device_mesh = init_device_mesh(device.type, tuple(shape.values()),
                                            mesh_dim_names=self.axis_names)
        grid = self.device_mesh.mesh.cpu().numpy().reshape(tuple(shape.values()))
        self._coords = {r: dict(zip(self.axis_names,
                                    (int(i) for i in np.argwhere(grid == r)[0])))
                        for r in range(self.size)}
        self.coords = self._coords[self.rank]
        self.counts: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()
        self.staged = 0
        self._members: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
        # Every rank creates every group, in one order.
        self._groups: Dict[Tuple[int, ...], object] = {}
        for k in range(1, len(self.axis_names) + 1):
            for sub in itertools.combinations(self.axis_names, k):
                for members in self._partition(sub):
                    if members in self._groups:
                        continue
                    if len(members) == self.size:
                        self._groups[members] = dist.group.WORLD
                    elif len(members) == 1:
                        self._groups[members] = None
                    else:
                        self._groups[members] = dist.new_group(list(members),
                                                               timeout=timeout)

    # ---------------------------------------------------------- collectives
    def all_gather(self, t: torch.Tensor, axes: Sequence[str]) -> List[torch.Tensor]:
        """Every member's ``t`` over ``axes``, in ascending rank order."""
        members = self.members(axes)
        group = self._groups[members]
        self.counts["all_gather"] += 1
        self.bytes["all_gather"] += t.numel() * t.element_size() * len(members)
        if group is None:
            return [t]
        out = [torch.empty_like(t) for _ in members]
        dist.all_gather(out, t.contiguous(), group=group)
        return out

    def all_gather_tensor(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """``all_gather``'s pieces stacked: [members, *t.shape]."""
        return torch.stack(self.all_gather(t, axes))

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """``t`` summed in place over ``axes``."""
        members = self.members(axes)
        group = self._groups[members]
        self.counts["all_reduce"] += 1
        self.bytes["all_reduce"] += t.numel() * t.element_size()
        if group is not None:
            dist.all_reduce(t, group=group)
        return t

    def reduce_scatter(self, t: torch.Tensor, axes: Sequence[str], dim: int) -> torch.Tensor:
        """``t`` summed over ``axes``, of which this rank keeps its block
        (``index(axes)``) along ``dim``: 1/ways of it."""
        members = self.members(axes)
        group = self._groups[members]
        self.counts["reduce_scatter"] += 1
        self.bytes["reduce_scatter"] += t.numel() * t.element_size()
        if group is None:
            return t
        n = t.shape[dim] // len(members)
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((n,) + tuple(src.shape[1:]))
        # Blocks go to ranks in ascending rank order, as ``all_gather``'s
        # pieces come; reorder so rank r receives its block index(axes, r).
        order = [self.index(axes, r) for r in members]
        src = torch.cat([src[i * n:(i + 1) * n] for i in order])
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim)

    def broadcast(self, t: torch.Tensor, src: int, axes: Sequence[str]) -> torch.Tensor:
        """``t`` from global rank ``src`` to every member over ``axes``."""
        group = self._groups[self.members(axes)]
        self.counts["broadcast"] += 1
        self.bytes["broadcast"] += t.numel() * t.element_size()
        if group is not None:
            dist.broadcast(t, src=src, group=group)
        return t

    def _staged(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def exchange(self, send: Optional[torch.Tensor], dst: Optional[int],
                 recv: Optional[torch.Tensor], src: Optional[int]) -> None:
        """Send ``send`` to global rank ``dst`` and receive ``recv`` from
        ``src`` at once (either may be None), non-blocking on both sides so a
        chain of ranks cannot deadlock; returns when both are done. Under
        gloo a CUDA tensor goes through a host copy (``staged``)."""
        works, host = [], None
        if send is not None:
            self.counts["send"] += 1
            self.bytes["send"] += send.numel() * send.element_size()
            if self._staged(send):
                self.staged += 1
                send = send.cpu()
            works.append(dist.isend(send.contiguous(), dst=dst))
        if recv is not None:
            self.counts["recv"] += 1
            self.bytes["recv"] += recv.numel() * recv.element_size()
            if self._staged(recv):
                self.staged += 1
                host = torch.empty(recv.shape, dtype=recv.dtype)
            works.append(dist.irecv(recv if host is None else host, src=src))
        for w in works:
            w.wait()
        if host is not None:
            recv.copy_(host)

    def barrier(self) -> None:
        self.counts["barrier"] += 1
        if self.size > 1:
            dist.barrier()

HOST_RANKS = 8  # cards a host: hosts are contiguous blocks of ranks


class VirtualMesh(_Topology):
    """``ProcessMesh``'s interface for one ``rank`` of a mesh of ``shape``
    with no process group: the dry run's stand-in for a mesh larger than the
    machine (``launch/dryrun.py``). Its collectives move no data: each
    returns a tensor of the result's shape and dtype on the input's device
    (``all_gather`` the input and empty peers, ``all_reduce`` and
    ``broadcast`` the input, ``reduce_scatter`` the rank's block), and counts
    calls and bytes exactly as ``ProcessMesh`` does. ``log`` records every
    op: its name, axes, group size, result bytes, and whether the group
    spans hosts (contiguous blocks of ``HOST_RANKS`` ranks in row-major
    order), which ``launch.roofline.collective_stats`` prices."""

    backend = "virtual"

    def __init__(self, shape: Dict[str, int], rank: int = 0,
                 device: torch.device = torch.device("meta")):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.device = torch.device(device)
        grid = np.arange(self.size).reshape(tuple(shape.values()))
        self._coords = {r: dict(zip(self.axis_names, (int(i) for i in np.argwhere(grid == r)[0])))
                        for r in range(self.size)}
        self.coords = self._coords[rank]
        self.counts: collections.Counter = collections.Counter()
        self.bytes: collections.Counter = collections.Counter()
        self.staged = 0
        self.log: List[Dict] = []
        self._members: Dict[Tuple[str, ...], Tuple[int, ...]] = {}

    def _record(self, op: str, axes: Sequence[str], result_bytes: int) -> int:
        members = self.members(axes)
        self.log.append({"op": op, "axes": tuple(axes), "group": len(members),
                         "result_bytes": int(result_bytes),
                         "spans_hosts": len({r // HOST_RANKS for r in members}) > 1})
        return len(members)

    def all_gather(self, t: torch.Tensor, axes: Sequence[str]) -> List[torch.Tensor]:
        g = self._record("all_gather", axes, t.numel() * t.element_size() * len(self.members(axes)))
        self.counts["all_gather"] += 1
        self.bytes["all_gather"] += t.numel() * t.element_size() * g
        return [t] + [torch.empty_like(t) for _ in range(g - 1)]

    def all_gather_tensor(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        g = len(self.members(axes))
        self._record("all_gather", axes, t.numel() * t.element_size() * g)
        self.counts["all_gather"] += 1
        self.bytes["all_gather"] += t.numel() * t.element_size() * g
        return t.new_empty((g,) + tuple(t.shape))

    def all_reduce(self, t: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        self._record("all_reduce", axes, t.numel() * t.element_size())
        self.counts["all_reduce"] += 1
        self.bytes["all_reduce"] += t.numel() * t.element_size()
        return t

    def reduce_scatter(self, t: torch.Tensor, axes: Sequence[str], dim: int) -> torch.Tensor:
        g = len(self.members(axes))
        self._record("reduce_scatter", axes, t.numel() * t.element_size() // g)
        self.counts["reduce_scatter"] += 1
        self.bytes["reduce_scatter"] += t.numel() * t.element_size()
        if g == 1:
            return t
        n = t.shape[dim] // g
        return t.narrow(dim, self.index(axes) * n, n).contiguous()

    def broadcast(self, t: torch.Tensor, src: int, axes: Sequence[str]) -> torch.Tensor:
        self._record("broadcast", axes, t.numel() * t.element_size())
        self.counts["broadcast"] += 1
        self.bytes["broadcast"] += t.numel() * t.element_size()
        return t

    def exchange(self, send: Optional[torch.Tensor], dst: Optional[int],
                 recv: Optional[torch.Tensor], src: Optional[int]) -> None:
        for op, t in (("send", send), ("recv", recv)):
            if t is not None:
                self.log.append({"op": op, "axes": (), "group": 2,
                                 "result_bytes": t.numel() * t.element_size(),
                                 "spans_hosts": (self.rank // HOST_RANKS)
                                 != ((dst if op == "send" else src) // HOST_RANKS)})
                self.counts[op] += 1
                self.bytes[op] += t.numel() * t.element_size()

    def barrier(self) -> None:
        self.counts["barrier"] += 1


@dataclasses.dataclass(frozen=True)
class ExecutionContext:
    """Placement policy for one training run.

    ``mesh is None`` means single-device: every helper passes values through
    untouched. ``donate_params`` is the reference's donation policy, kept for
    its fields and ``describe()``; the port's trainer updates parameters and
    moments in place, which is what True means, and refuses False."""

    mesh: Optional[ProcessMesh] = None
    profile: str = "2d"        # "2d" (TP x FSDP) | "fsdp" (ZeRO-3, no TP)
    moe_mode: str = "tp"
    donate_params: bool = True

    # ------------------------------------------------------------- factories
    @classmethod
    def single_device(cls) -> "ExecutionContext":
        return cls(mesh=None)

    @classmethod
    def from_mesh(cls, mesh: ProcessMesh, profile: str = "2d", **kw) -> "ExecutionContext":
        if profile not in ("2d", "fsdp"):
            raise ValueError(f"profile must be 2d|fsdp, got {profile!r}")
        return cls(mesh=mesh, profile=profile, **kw)

    # ------------------------------------------------------------ properties
    @property
    def is_sharded(self) -> bool:
        return self.mesh is not None

    @property
    def n_devices(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    @property
    def dp_size(self) -> int:
        """Total data-parallel ways (product of the batch axes)."""
        if self.mesh is None:
            return 1
        return int(np.prod([self.mesh.shape[a] for a in dp_axes(self.mesh, self.profile)]))

    @property
    def rank(self) -> int:
        """This process's rank in the mesh (0 single-device)."""
        return self.mesh.rank if self.mesh is not None else 0

    @property
    def device(self) -> Optional[torch.device]:
        """This rank's device (None single-device)."""
        return self.mesh.device if self.mesh is not None else None

    def describe(self) -> str:
        if self.mesh is None:
            return "single-device"
        axes = ", ".join(f"{a}={self.mesh.shape[a]}" for a in self.mesh.axis_names)
        return f"mesh({axes}) profile={self.profile}"

    # ---------------------------------------------------------------- specs
    def param_spec(self, name: str, shape: Tuple[int, ...]) -> Tuple:
        if self.mesh is None:
            return ()
        return profile_spec(name, tuple(shape), self.mesh, self.profile, self.moe_mode)

    def batch_axes(self, n: int) -> Tuple[str, ...]:
        """The axes a batch of ``n`` rows is split over (``batch_spec``)."""
        if self.mesh is None:
            return ()
        spec = batch_spec((n,), self.mesh, self.profile)
        return _entry_axes(spec[0])

    # ------------------------------------------------------------ placement
    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``full`` under ``name``'s rule (``full``
        itself where the rule replicates it)."""
        if self.mesh is None:
            return full
        spec = self.param_spec(name, tuple(full.shape))
        out = full
        for d, entry in enumerate(spec):
            axes = _entry_axes(entry)
            if not axes:
                continue
            n = full.shape[d] // self.mesh.ways(axes)
            out = out.narrow(d, self.mesh.index(axes) * n, n)
        return full if out is full else out.contiguous().clone()

    def shard_tree(self, tree):
        """``shard`` of every leaf of a nested dict, each named by its key
        (an LM parameter tree's stacked leaves take their rule's trailing
        dims)."""
        return {k: self.shard_tree(v) if isinstance(v, dict) else self.shard(k, v)
                for k, v in tree.items()}

    def gather(self, name: str, local: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
        """The full tensor of ``shape`` from every rank's shard ``local``
        (``local`` itself where the rule replicates it). Collective."""
        if self.mesh is None:
            return local
        spec = self.param_spec(name, tuple(shape))
        dims = [(d, _entry_axes(e)) for d, e in enumerate(spec) if _entry_axes(e)]
        if not dims:
            return local
        axes = tuple(a for a in self.mesh.axis_names if any(a in ax for _, ax in dims))
        pieces = self.mesh.all_gather(local, axes)
        full = local.new_empty(tuple(shape))
        for rank, piece in zip(self.mesh.members(axes), pieces):
            view = full
            for d, ax in dims:
                n = local.shape[d]
                view = view.narrow(d, self.mesh.index(ax, rank) * n, n)
            view.copy_(piece)
        return full

    def batch_rows(self, n: int) -> np.ndarray:
        """This rank's rows of a batch of ``n``: a contiguous 1/ways slice
        over ``batch_axes(n)`` (every row where no DP axis divides n)."""
        axes = self.batch_axes(n)
        if not axes:
            return np.arange(n)
        m = n // self.mesh.ways(axes)
        i = self.mesh.index(axes)
        return np.arange(i * m, (i + 1) * m)

    def put_batch(self, value) -> torch.Tensor:
        """This rank's rows of a batch-like array, on its device."""
        rows = self.batch_rows(len(value))
        return torch.as_tensor(np.asarray(value)[rows], device=self.device)

    def put_replicated(self, value) -> torch.Tensor:
        return torch.as_tensor(value, device=self.device)

    # ---------------------------------------------------------- collectives
    def reduce_batch(self, t: torch.Tensor, n: int) -> torch.Tensor:
        """``t`` summed in place over the axes a batch of ``n`` is split over
        (every rank of a batch group holds the same sum). Collective."""
        if self.mesh is None:
            return t
        return self.mesh.all_reduce(t, self.batch_axes(n))

    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """A batch of ``n`` rows in batch order from each rank's
        ``batch_rows(n)`` rows ``local``. Collective."""
        if self.mesh is None:
            return local
        axes = self.batch_axes(n)
        if not axes:
            return local
        pieces = self.mesh.all_gather(local, axes)
        order = [self.mesh.index(axes, r) for r in self.mesh.members(axes)]
        return torch.cat([pieces[j] for j in np.argsort(order)])

    # ------------------------------------------------- row-split tables
    def row_axes(self, name: str, shape: Sequence[int]) -> Tuple[str, ...]:
        """The axes ``name``'s rule splits the rows (dim 0) of a table of
        ``shape`` over (``()`` where it replicates them). Raises where the
        rule splits another dim: a row-wise reader could not use it."""
        if self.mesh is None:
            return ()
        spec = self.param_spec(name, tuple(shape))
        if any(_entry_axes(e) for e in spec[1:]):
            raise ValueError(f"{name} {tuple(shape)} is split off its rows under "
                             f"{self.describe()} (spec {spec}); serving reads it by rows")
        return _entry_axes(spec[0]) if spec else ()

    def gather_blocks(self, local: torch.Tensor, axes: Sequence[str],
                      dim: int) -> torch.Tensor:
        """Every member's ``local`` over ``axes`` concatenated along ``dim`` in
        block order (``index(axes)``): e.g. each rank's columns of the
        [B, E] scores against its rows of the entity table. Collective."""
        if self.mesh is None or not axes:
            return local
        pieces = self.mesh.all_gather(local, axes)
        order = [self.mesh.index(axes, r) for r in self.mesh.members(axes)]
        return torch.cat([pieces[j] for j in np.argsort(order)], dim=dim)

    def fetch_rows(self, local: torch.Tensor, axes: Sequence[str],
                   ids: np.ndarray) -> torch.Tensor:
        """Rows ``ids`` (global row ids) of a table split by rows over
        ``axes``, of which this rank holds ``local`` (block ``index(axes)``).
        Each rank contributes the rows it holds, zeros elsewhere, to one
        all-gather, and every row is taken from its owner's piece: the rows
        are bitwise the owner's, -0.0 and NaN included. Collective."""
        ids_t = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=local.device)
        if self.mesh is None or not axes:
            return local[ids_t]
        n = local.shape[0]
        block = ids_t // n
        me = self.mesh.index(axes)
        mine = block == me
        contrib = local.new_zeros((len(ids_t),) + tuple(local.shape[1:]))
        contrib[mine] = local[ids_t[mine] - me * n]
        pieces = self.mesh.all_gather(contrib, axes)
        slot = torch.empty(self.mesh.ways(axes), dtype=torch.long)
        for j, r in enumerate(self.mesh.members(axes)):
            slot[self.mesh.index(axes, r)] = j
        owner = slot.to(local.device)[block]
        return torch.stack(pieces)[owner, torch.arange(len(ids_t), device=local.device)]


# --------------------------------------------------------------------------
# Mesh-spec parsing (the launch surface: ``--mesh data=N[,model=M]``)
# --------------------------------------------------------------------------

_KNOWN_AXES = ("pod", "data", "model")


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"data=8"`` / ``"data=4,model=2"`` -> {"data": 4, "model": 2}.

    Axis names are restricted to the rule table's vocabulary so a typo fails
    here, not as a silently-replicated parameter."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, size = part.partition("=")
        name = name.strip()
        if not eq or name not in _KNOWN_AXES:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected comma-separated "
                f"axis=size with axes from {_KNOWN_AXES}, got {part!r}")
        try:
            n = int(size)
        except ValueError:
            raise ValueError(f"bad mesh spec {spec!r}: size {size!r} is not "
                             f"an integer") from None
        if n < 1:
            raise ValueError(f"bad mesh spec {spec!r}: {name}={n} must be >= 1")
        if name in out:
            raise ValueError(f"bad mesh spec {spec!r}: duplicate axis {name!r}")
        out[name] = n
    if "data" not in out:
        raise ValueError(f"bad mesh spec {spec!r}: a 'data' axis is required")
    out.setdefault("model", 1)  # rule table assumes both axes exist
    return out


def default_backend(device: torch.device) -> str:
    """NCCL on CUDA, gloo on the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device=None) -> torch.device:
    """``device``, or ``cuda:LOCAL_RANK`` (the launcher's local rank) when
    none is given; it never falls back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the mesh on the CPU (gloo)")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


def init_process_group_from_env(device=None, backend: Optional[str] = None,
                                timeout: datetime.timedelta = TIMEOUT) -> torch.device:
    """Initialise the default process group from ``torchrun``'s environment
    (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``), on the
    backend of ``device`` unless ``backend`` names one, with ``timeout``.
    Returns the rank's device."""
    dev = rank_device(device)
    if "WORLD_SIZE" not in os.environ:
        raise ValueError("no process group: run under torchrun --nproc-per-node N "
                         "(WORLD_SIZE is not set)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend or default_backend(dev), init_method="env://",
                            timeout=timeout)
    return dev


def make_execution_context(mesh_spec: Optional[str] = None, profile: str = "2d",
                           device=None, backend: Optional[str] = None,
                           **kw) -> ExecutionContext:
    """Build an ExecutionContext from a ``--mesh`` spec (None = single
    device) over the initialised default process group, whose world size
    must be the mesh's product and whose backend must be ``backend`` (NCCL
    for a CUDA ``device``, gloo for the CPU, unless given). ``device`` is
    this rank's (``cuda:LOCAL_RANK`` unless given); on CUDA it becomes the
    current device before the ``DeviceMesh`` is built."""
    if mesh_spec is None:
        return ExecutionContext.single_device()
    sizes = parse_mesh_spec(mesh_spec)
    axes = tuple(a for a in _KNOWN_AXES if a in sizes)
    shape = {a: sizes[a] for a in axes}
    need = int(np.prod(list(shape.values())))
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise ValueError(
            f"mesh {mesh_spec!r} needs a process group of world size {need}, "
            + (f"got {have}" if have else "and none is initialised")
            + f"; launch one process a device with torchrun --nproc-per-node {need}")
    dev = rank_device(device)
    want = backend or default_backend(dev)
    if dist.get_backend() != want:
        raise ValueError(f"mesh {mesh_spec!r} on {dev} wants the {want} backend; the "
                         f"process group runs {dist.get_backend()}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return ExecutionContext.from_mesh(ProcessMesh(shape, dev), profile=profile, **kw)
