"""The port's process mesh, with two backends: ranks simulated in one
process, or one rank a process over ``torch.distributed``.

JAX names its devices with a ``jax.sharding.Mesh`` and runs a schedule
once per device inside ``shard_map``.  The port carries the same
information in a small ``Mesh`` (the grid's shape, its axis names and
the torch device), with the ranks in row-major order over
``axis_names``, as JAX orders the devices of ``make_mesh(shape,
axes)``.  A 1x1 mesh is R = 1.  A tensor on the mesh carries one
leading **rank axis** holding the ranks that live in this process,
``local_ranks``:

  * ``make_mesh`` (class ``Mesh``): every rank of the grid in one
    process, on one device; the rank axis is all R ranks and a
    collective is a device copy between its rows;
  * ``make_process_mesh`` (class ``ProcessMesh``): one rank a process,
    over the initialised default ``torch.distributed`` group, whose size
    is R; the rank axis is this process's one rank (its global rank) and
    the collectives are the group's: ``ppermute`` ->
    ``batch_isend_irecv``, ``psum`` -> ``all_reduce``, ``psum_scatter``
    -> ``reduce_scatter_tensor``, ``all_gather`` ->
    ``all_gather_into_tensor``, over subgroups (``dist.new_group``,
    made once a set of axes) where a collective names fewer axes than
    the mesh has.  The transport follows the group's backend and the
    mesh's ``repr`` names it: NCCL takes device tensors, one card a
    rank; gloo takes host tensors, so a CUDA tensor is copied to a
    pinned host buffer and back around each call ("host-staged"), the
    one way several processes can share a card.  Nothing switches
    transport on a failure, and every collective runs under the
    group's timeout (subgroups take the one the caller passes), so a
    rank that diverges fails instead of hanging;
  * ``make_meta_rank_mesh`` (class ``MetaRankMesh``): one rank of a
    process mesh on the meta device with no process group, whose
    collectives return meta tensors and count what that rank would
    receive (the dry-run's count of one rank of a production mesh).

``Mesh`` offers the two halves of ``shard_map`` (``shard`` cuts a
global tensor into the rank-stacked layout of a partition spec, with no
communication: every process holds the global operands, as JAX's
``distributed_matmul`` takes global arrays; ``unshard`` puts a result
back, on a process mesh after an all-gather, so every process holds the
global result) and the collectives of ``jax.lax`` that the schedules
use, each with the JAX meaning over a subset of named axes:
``ppermute``, ``psum``, ``psum_scatter``, ``all_gather`` and
``axis_index`` (``flat_index`` on the host, ``index`` as an integer
where a process holds one rank), each for the local ranks.
The schedules, the engine and the planner run unchanged on either
backend.  The LM runs on a process mesh (or 1x1) with plain local
tensors, through the collectives at the end of this module that
autograd passes through (``psum_ad``, ``psum_rep``, ``enter_rep``,
``all_gather_ad``, ``psum_scatter_ad``, ``cut_rep``, ``gather_rep``
and ``pmax``).  ``traffic`` counts the bytes the local ranks receive from
other ranks, as a ring implementation would move them; on a process
mesh it is this rank's share, and ``traffic_total()`` sums it over the
processes (the in-process mesh's count for the same calls, exactly).

A partition spec is a tuple with one entry per dimension of the global
tensor: ``None`` (replicated), an axis name, or a tuple of axis names
whose flat index (row-major, in the tuple's order) picks the chunk.
Axes a spec does not name replicate the tensor; an axis named in two
entries is refused (JAX's ``DuplicateSpecError``).  ``PartitionSpec``
is that tuple under a name of its own, so that trees of specs can tell
a spec from a tuple of specs.

``make_production_mesh`` and ``HW`` are the counterparts of the JAX
package's production meshes and roofline constants, for a cluster of
H100s: they hold shapes and names only and allocate nothing.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "ProcessMesh", "make_process_mesh",
           "MetaRankMesh", "make_meta_rank_mesh",
           "check_rank_devices", "resolve_device", "PartitionSpec", "P",
           "is_spec", "make_production_mesh", "HW", "hw_for", "axis_size",
           "psum_ad", "psum_rep", "enter_rep", "all_gather_ad",
           "psum_scatter_ad", "cut_rep", "gather_rep", "pmax"]

Axes = Union[str, Sequence[str]]


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The port's device policy: ``None`` means CUDA, and asking for CUDA
    where there is none raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "asked for a CUDA device but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _ranks(idx: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """Host rank indices as an index tensor on ``x``'s device."""
    return torch.as_tensor(idx, dtype=torch.long, device=x.device)


def _new_traffic() -> dict:
    return {"ppermute": 0, "psum": 0, "psum_scatter": 0, "all_gather": 0}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process grid: ``axis_names`` with ``axis_sizes``, all ranks
    computing on ``device`` in this process.  ``shape`` maps axis name
    -> size, as JAX's does."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device
    traffic: dict = dataclasses.field(default_factory=_new_traffic,
                                      compare=False, repr=False)

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(
                f"mesh shape {self.axis_sizes} does not match axes "
                f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")
        if any(s < 1 for s in self.axis_sizes):
            raise ValueError(f"mesh shape {self.axis_sizes} has an empty axis")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "mesh asks for a CUDA device but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def n_ranks(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def local_ranks(self) -> np.ndarray:
        """The ranks that live in this process, in the order of the rank
        axis: every rank of the grid."""
        return np.arange(self.n_ranks)

    @property
    def transport(self) -> str:
        return "in-process"

    def reset_traffic(self) -> None:
        for key in self.traffic:
            self.traffic[key] = 0

    def traffic_total(self) -> dict:
        """``traffic`` summed over every rank of the mesh."""
        return dict(self.traffic)

    def agree(self, value):
        """Mesh rank 0's ``value`` on every process (a host object, for
        decisions taken from measurements, which differ from process to
        process): ``value`` itself in process."""
        return value

    # ------------------------------------------------------------ ranks

    def _names(self, axes: Axes) -> Tuple[str, ...]:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in names:
            if a not in self.axis_names:
                raise ValueError(f"{a!r} is not an axis of the mesh "
                                 f"{self.axis_names}")
        if len(set(names)) != len(names):
            raise ValueError(f"repeated axis in {names}")
        return names

    def _coords(self) -> np.ndarray:
        """(R, n_axes) coordinates of every rank, row-major."""
        return np.stack(np.unravel_index(np.arange(self.n_ranks),
                                         self.axis_sizes), axis=1)

    def _flat(self, names: Tuple[str, ...]) -> np.ndarray:
        """Every rank's flat index over ``names``, row-major in the order
        of ``names`` (not the mesh's): JAX's index of a joint axis."""
        coords = self._coords()
        flat = np.zeros(self.n_ranks, dtype=np.int64)
        for a in names:
            i = self.axis_names.index(a)
            flat = flat * self.axis_sizes[i] + coords[:, i]
        return flat

    def _groups(self, names: Tuple[str, ...]) -> np.ndarray:
        """``table[r, j]``: the rank that shares rank r's coordinates on
        every axis outside ``names`` and has flat index j over them."""
        others = tuple(a for a in self.axis_names if a not in names)
        n = math.prod(self.shape[a] for a in names)
        other_flat, flat = self._flat(others), self._flat(names)
        by_key = np.zeros((math.prod(self.shape[a] for a in others), n),
                          dtype=np.int64)
        by_key[other_flat, flat] = np.arange(self.n_ranks)
        return by_key[other_flat]

    def _sources(self, names: Tuple[str, ...],
                 perm: Sequence[Tuple[int, int]]) -> np.ndarray:
        """Every rank's source under ``ppermute``'s ``perm`` over
        ``names`` (-1 where no pair sends to it)."""
        n = math.prod(self.shape[a] for a in names)
        src_of = np.full(n, -1, dtype=np.int64)
        for src, dst in perm:
            if not (0 <= src < n and 0 <= dst < n):
                raise ValueError(f"pair {(src, dst)} outside 0..{n - 1}")
            if src_of[dst] >= 0:
                raise ValueError(f"two pairs send to {dst} in {list(perm)}")
            src_of[dst] = src
        if len({s for s, _ in perm}) != len(perm):
            raise ValueError(f"a rank sends twice in {list(perm)}")
        flat, table = self._flat(names), self._groups(names)
        src_flat = src_of[flat]
        return np.where(src_flat >= 0,
                        table[np.arange(self.n_ranks),
                              np.maximum(src_flat, 0)], -1)

    def _check(self, x: torch.Tensor) -> None:
        local = len(self.local_ranks)
        if x.ndim < 1 or x.shape[0] != local:
            raise ValueError(
                f"a tensor on this mesh has a leading rank axis of "
                f"{local}, got shape {tuple(x.shape)}")

    def _count(self, op: str, x: torch.Tensor, rank_shares: float) -> None:
        """Add ``rank_shares`` of one rank's ``x`` to ``op``'s traffic."""
        self.traffic[op] += int(round(rank_shares * x[0].numel()
                                      * x.element_size()))

    # ------------------------------------------------------ collectives

    def flat_index(self, axis: Axes) -> np.ndarray:
        """Each local rank's (flat) index over ``axis``, row-major in the
        order of ``axis``: ``axis_index`` as a host int64 array."""
        return self._flat(self._names(axis))[self.local_ranks]

    def index(self, axis: Axes) -> int:
        """This process's flat index over ``axis`` as a host integer
        (``axis_index`` of its one rank); refused where a process holds
        several ranks."""
        flat = self.flat_index(axis)
        if len(flat) != 1:
            raise ValueError(f"{len(flat)} ranks live in this process: "
                             "index() needs one (a process mesh or 1x1)")
        return int(flat[0])

    def axis_index(self, axis: Axes) -> torch.Tensor:
        """``jax.lax.axis_index``: each local rank's (flat) index over
        ``axis``, an int64 tensor on the mesh's device."""
        return torch.as_tensor(self.flat_index(axis), dtype=torch.long,
                               device=self.device)

    def ppermute(self, x: torch.Tensor, axes: Axes,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``jax.lax.ppermute``: send each rank's ``x`` along the
        ``(source, destination)`` pairs over the flat index of ``axes``
        (in the order of ``axes``), within each group of ranks that
        agree on the other axes.  A rank that no pair sends to receives
        zeros.  An identity permutation returns ``x`` itself."""
        self._check(x)
        src = self._sources(self._names(axes), perm)
        recv = src >= 0
        ranks = np.arange(self.n_ranks)
        if recv.all() and (src == ranks).all():
            return x
        self._count("ppermute", x, float(np.count_nonzero(recv & (src != ranks))))
        if recv.all():
            return x.index_select(0, _ranks(src, x))
        out = torch.zeros_like(x)
        if recv.any():
            dst = np.flatnonzero(recv)
            out.index_copy_(0, _ranks(dst, x),
                            x.index_select(0, _ranks(src[dst], x)))
        return out

    def _group_sum(self, x: torch.Tensor, names: Tuple[str, ...]):
        """``(sums, group_of)``: the sum of ``x`` over each group of
        ``names``, added in the group's flat order, and every rank's
        row of ``sums``."""
        table = self._groups(names)
        lead = np.flatnonzero(self._flat(names) == 0)   # one rank a group
        members = table[lead]                           # (n_groups, n)
        acc = x.index_select(0, _ranks(members[:, 0], x))
        for j in range(1, members.shape[1]):
            acc = acc + x.index_select(0, _ranks(members[:, j], x))
        group_of = np.zeros(self.n_ranks, dtype=np.int64)
        group_of[members] = np.arange(len(lead))[:, None]
        return acc, group_of

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``jax.lax.psum`` over ``axes``: every rank gets the sum of its
        group's ``x``, added in the flat order of ``axes``."""
        self._check(x)
        names = self._names(axes)
        n = math.prod(self.shape[a] for a in names)
        if n == 1:
            return x
        sums, group_of = self._group_sum(x, names)
        self._count("psum", x, self.n_ranks * 2.0 * (n - 1) / n)
        return sums.index_select(0, _ranks(group_of, x))

    def pmax(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        """``jax.lax.pmax`` over ``axes``: the elementwise maximum of each
        group's ``x`` on every rank of the group."""
        self._check(x)
        names = self._names(axes)
        table = self._groups(names)
        if table.shape[1] == 1:
            return x
        acc = x.index_select(0, _ranks(table[:, 0], x))
        for j in range(1, table.shape[1]):
            acc = torch.maximum(acc, x.index_select(0, _ranks(table[:, j], x)))
        self._count("psum", x, self.n_ranks * 2.0 * (table.shape[1] - 1)
                    / table.shape[1])
        return acc

    def _scatter_size(self, x: torch.Tensor, names, scatter_dimension: int,
                      tiled: bool) -> Tuple[int, int]:
        """``(n, dim)``: the group size of ``names`` and the block
        dimension ``psum_scatter`` cuts, checked."""
        if not tiled:
            raise NotImplementedError("psum_scatter(tiled=False)")
        self._check(x)
        dim = 1 + scatter_dimension
        n = math.prod(self.shape[a] for a in names)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {scatter_dimension} of size "
                             f"{x.shape[dim]} does not split into {n}")
        return n, dim

    def psum_scatter(self, x: torch.Tensor, axes: Axes, *,
                     scatter_dimension: int = 0,
                     tiled: bool = True) -> torch.Tensor:
        """``jax.lax.psum_scatter(..., tiled=True)``: the group sum of
        ``x``, cut into n chunks along ``scatter_dimension`` of a rank's
        block; the rank with flat index j over ``axes`` keeps chunk j."""
        names = self._names(axes)
        n, dim = self._scatter_size(x, names, scatter_dimension, tiled)
        if n == 1:
            return x
        sums, group_of = self._group_sum(x, names)
        size = x.shape[dim] // n
        flat = self._flat(names)
        out = torch.stack([sums[group_of[r]].narrow(dim - 1,
                                                    int(flat[r]) * size, size)
                           for r in range(self.n_ranks)])
        self._count("psum_scatter", x, self.n_ranks * (n - 1) / n)
        return out

    def all_gather(self, x: torch.Tensor, axes: Axes, *, axis: int = 0,
                   tiled: bool = True) -> torch.Tensor:
        """``jax.lax.all_gather(..., tiled=True)``: every rank gets its
        group's blocks concatenated along ``axis`` of a rank's block, in
        the flat order of ``axes``."""
        if not tiled:
            raise NotImplementedError("all_gather(tiled=False)")
        self._check(x)
        names = self._names(axes)
        table = self._groups(names)
        n = table.shape[1]
        if n == 1:
            return x
        dim = 1 + axis
        size = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * size
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        for j in range(n):
            out.narrow(dim, j * size, size).copy_(
                x.index_select(0, _ranks(table[:, j], x)))
        self._count("all_gather", x, self.n_ranks * (n - 1))
        return out

    # -------------------------------------------------- shard / unshard

    def _spec_names(self, spec, ndim: int):
        if len(spec) != ndim:
            raise ValueError(f"spec {spec} has {len(spec)} entries for a "
                             f"{ndim}-D tensor")
        per_dim = [() if s is None else self._names(s) for s in spec]
        named = [a for names in per_dim for a in names]
        if len(set(named)) != len(named):
            # JAX's NamedSharding raises DuplicateSpecError here
            raise ValueError(f"spec {tuple(spec)} names a mesh axis in more "
                             "than one entry")
        return per_dim

    def shard(self, x: torch.Tensor, spec: Sequence) -> torch.Tensor:
        """Cut a global tensor into the rank-stacked layout of ``spec``:
        (local ranks, *block), each local rank holding the chunk its
        coordinates name (no communication).  A tensor ``spec``
        replicates entirely comes back as a view (no copy); so does
        every tensor on a 1x1 mesh."""
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, the mesh on {self.device}")
        per_dim = self._spec_names(spec, x.ndim)
        parts = [math.prod(self.shape[a] for a in names) for names in per_dim]
        for d, (size, n) in enumerate(zip(x.shape, parts)):
            if size % n:
                raise ValueError(
                    f"dimension {d} of size {size} does not split over "
                    f"{per_dim[d]} ({n} ranks)")
        local = self.local_ranks
        if all(n == 1 for n in parts):
            return x.unsqueeze(0).expand((len(local),) + tuple(x.shape))
        block = [size // n for size, n in zip(x.shape, parts)]
        flats = [self._flat(names) for names in per_dim]
        out = torch.empty([len(local)] + block, dtype=x.dtype,
                          device=x.device)
        for i, r in enumerate(local):
            idx = tuple(slice(int(f[r]) * b, (int(f[r]) + 1) * b)
                        for f, b in zip(flats, block))
            out[i].copy_(x[idx])
        return out

    def _all_ranks(self, c: torch.Tensor, dst=None) -> torch.Tensor:
        """Every rank's block of a rank-stacked ``c``, (R, *block) (on
        mesh rank ``dst`` alone where it is given; None elsewhere)."""
        return c

    def unshard(self, c: torch.Tensor, spec: Sequence,
                dst: Optional[int] = None) -> torch.Tensor:
        """Put a rank-stacked result back into one global tensor laid out
        by ``spec``, on every process (on the process of mesh rank
        ``dst`` alone where it is given: the others get None).  Ranks
        that differ only on axes ``spec`` does not name hold replicas;
        the one at coordinate 0 on those axes is taken (JAX's
        ``out_specs`` assumes they agree)."""
        self._check(c)
        per_dim = self._spec_names(spec, c.ndim - 1)
        named = {a for names in per_dim for a in names}
        if self.n_ranks == 1 or not named:
            return c[0]
        c = self._all_ranks(c, dst)
        if c is None:
            return None
        coords = self._coords()
        keep = np.ones(self.n_ranks, dtype=bool)
        for i, a in enumerate(self.axis_names):
            if a not in named:
                keep &= coords[:, i] == 0
        parts = [math.prod(self.shape[a] for a in names) for names in per_dim]
        block = list(c.shape[1:])
        out = torch.empty([b * n for b, n in zip(block, parts)],
                          dtype=c.dtype, device=c.device)
        flats = [self._flat(names) for names in per_dim]
        for r in np.flatnonzero(keep):
            idx = tuple(slice(int(f[r]) * b, (int(f[r]) + 1) * b)
                        for f, b in zip(flats, block))
            out[idx] = c[r]
        return out


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: Union[str, torch.device, None] = None) -> Mesh:
    """The counterpart of ``repro.launch.mesh.make_mesh``: a mesh of
    ``shape`` over ``axes`` on ``resolve_device(device)``, every rank
    simulated on that one device."""
    return Mesh(tuple(int(s) for s in shape), tuple(axes),
                resolve_device(device))


# ---------------------------------------------------------------------------
# one rank a process: torch.distributed
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, repr=False)
class ProcessMesh(Mesh):
    """A mesh whose ranks are the processes of the default
    ``torch.distributed`` group (``make_process_mesh``): this process is
    mesh rank ``rank`` (its global rank) and holds that one rank of
    every rank-stacked tensor."""

    rank: int = 0
    backend: str = "gloo"
    group: object = dataclasses.field(default=None, compare=False)
    timeout: Optional[datetime.timedelta] = dataclasses.field(
        default=None, compare=False)
    _subgroups: dict = dataclasses.field(default_factory=dict,
                                         compare=False)

    def __repr__(self) -> str:
        return (f"ProcessMesh({self.shape}, rank {self.rank} of "
                f"{self.n_ranks}, device {self.device}, transport "
                f"{self.transport})")

    @property
    def local_ranks(self) -> np.ndarray:
        return np.array([self.rank])

    @property
    def transport(self) -> str:
        return "gloo, host-staged" if self._staged else self.backend

    @property
    def _staged(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    # ---------------------------------------------------- the transport

    def _wire(self, t: torch.Tensor, *, fresh: bool = False) -> torch.Tensor:
        """``t`` as the transport takes it: in pinned host memory under
        host-staged gloo, else contiguous on the device (a copy the
        transport may overwrite when ``fresh``)."""
        if self._staged:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            return host
        if fresh:
            return t.clone(memory_format=torch.contiguous_format)
        return t.contiguous()

    def _wire_empty(self, shape, dtype: torch.dtype) -> torch.Tensor:
        if self._staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _unwire(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device) if self._staged else t

    def _subgroup(self, names: Tuple[str, ...]):
        """``(group, order)``: the process group of the ranks that agree
        with this one on every axis outside ``names``, and its mesh
        ranks in group-rank order (ascending).  Every group of a set of
        axes is made once, on every process, in one order, as
        ``dist.new_group`` requires."""
        import torch.distributed as dist

        table = self._groups(names)
        order = np.sort(table[self.rank])
        if len(order) == self.n_ranks:
            return self.group, order
        key = frozenset(names)
        pg = self._subgroups.get(key)
        if pg is None:
            for row in np.unique(np.sort(table, axis=1), axis=0):
                made = dist.new_group(row.tolist(), timeout=self.timeout)
                if self.rank in row:
                    pg = made
            self._subgroups[key] = pg
        return pg, order

    def _count(self, op: str, x: torch.Tensor, rank_shares: float) -> None:
        """This rank's part of the in-process count: the total split
        evenly over the ranks (in whole bytes, the remainder to the
        lowest ranks), so the sum over processes is that count."""
        total = int(round(rank_shares * x[0].numel() * x.element_size()))
        q, rem = divmod(total, self.n_ranks)
        self.traffic[op] += q + (1 if self.rank < rem else 0)

    def traffic_total(self) -> dict:
        """``traffic`` summed over the processes (one ``all_reduce``)."""
        import torch.distributed as dist

        keys = sorted(self.traffic)
        t = torch.tensor([self.traffic[k] for k in keys], dtype=torch.int64,
                         device=self.device if self.backend == "nccl"
                         else "cpu")
        dist.all_reduce(t, group=self.group)
        return dict(zip(keys, (int(v) for v in t.tolist())))

    def agree(self, value):
        import torch.distributed as dist

        box = [value]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    # ------------------------------------------------------ collectives

    def ppermute(self, x: torch.Tensor, axes: Axes,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        self._check(x)
        src = self._sources(self._names(axes), perm)
        ranks = np.arange(self.n_ranks)
        if (src == ranks).all():
            return x
        me = self.rank
        dsts = [int(d) for d in np.flatnonzero((src == me) & (ranks != me))]
        buf = None
        if src[me] >= 0 and src[me] != me:
            buf = self._wire_empty(x.shape[1:], x.dtype)
            self.traffic["ppermute"] += x[0].numel() * x.element_size()
        if dsts or buf is not None:
            self._exchange(x[0], dsts, buf, int(src[me]))
        if buf is not None:
            return self._unwire(buf).unsqueeze(0)
        return x if src[me] == me else torch.zeros_like(x)

    def _exchange(self, block: torch.Tensor, dsts, buf, src: int) -> None:
        """``ppermute``'s transfer: ``block`` to each rank of ``dsts``, and
        ``buf`` (where it is not None) from rank ``src``."""
        import torch.distributed as dist

        ops = [dist.P2POp(dist.isend, self._wire(block), d, group=self.group)
               for d in dsts]
        if buf is not None:
            ops.append(dist.P2POp(dist.irecv, buf, src, group=self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()

    def _all_reduce(self, y: torch.Tensor, pg, op: str = "sum") -> None:
        import torch.distributed as dist

        dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM, group=pg)

    def psum(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        self._check(x)
        names = self._names(axes)
        n = math.prod(self.shape[a] for a in names)
        if n == 1:
            return x
        pg, _ = self._subgroup(names)
        y = self._wire(x[0], fresh=True)
        self._all_reduce(y, pg)
        self._count("psum", x, self.n_ranks * 2.0 * (n - 1) / n)
        return self._unwire(y).unsqueeze(0)

    def pmax(self, x: torch.Tensor, axes: Axes) -> torch.Tensor:
        self._check(x)
        names = self._names(axes)
        n = math.prod(self.shape[a] for a in names)
        if n == 1:
            return x
        pg, _ = self._subgroup(names)
        y = self._wire(x[0], fresh=True)
        self._all_reduce(y, pg, "max")
        self._count("psum", x, self.n_ranks * 2.0 * (n - 1) / n)
        return self._unwire(y).unsqueeze(0)

    def _reduce_scatter(self, out: torch.Tensor, inp: torch.Tensor,
                        pg) -> None:
        import torch.distributed as dist

        dist.reduce_scatter_tensor(out, inp, group=pg)

    def psum_scatter(self, x: torch.Tensor, axes: Axes, *,
                     scatter_dimension: int = 0,
                     tiled: bool = True) -> torch.Tensor:
        names = self._names(axes)
        n, dim = self._scatter_size(x, names, scatter_dimension, tiled)
        if n == 1:
            return x
        pg, order = self._subgroup(names)
        flat = self._flat(names)
        size = x.shape[dim] // n
        block = x[0]
        # group rank g keeps the chunk of its rank's flat index
        chunks = torch.stack([block.narrow(dim - 1, int(flat[r]) * size, size)
                              for r in order])
        out = self._wire_empty(chunks[0].numel(), x.dtype)
        self._reduce_scatter(out, self._wire(chunks.reshape(-1)), pg)
        self._count("psum_scatter", x, self.n_ranks * (n - 1) / n)
        return self._unwire(out).view((1,) + tuple(chunks.shape[1:]))

    def all_gather(self, x: torch.Tensor, axes: Axes, *, axis: int = 0,
                   tiled: bool = True) -> torch.Tensor:
        if not tiled:
            raise NotImplementedError("all_gather(tiled=False)")
        self._check(x)
        names = self._names(axes)
        pg, order = self._subgroup(names)
        n = len(order)
        if n == 1:
            return x
        got = self._gather(x[0], pg, n)
        # group rank g is mesh rank order[g]; concatenate in flat order
        at = {int(r): g for g, r in enumerate(order)}
        members = self._groups(names)[self.rank]
        out = torch.cat([got[at[int(r)]] for r in members], dim=axis)
        self._count("all_gather", x, self.n_ranks * (n - 1))
        return out.unsqueeze(0)

    def _gather(self, block: torch.Tensor, pg, n: int) -> torch.Tensor:
        """(n, *block): the blocks of ``pg``'s n ranks in group-rank
        order (the transport takes flat buffers)."""
        import torch.distributed as dist

        got = self._wire_empty(n * block.numel(), block.dtype)
        dist.all_gather_into_tensor(got, self._wire(block.reshape(-1)),
                                    group=pg)
        return self._unwire(got).view((n,) + tuple(block.shape))

    def _all_ranks(self, c: torch.Tensor, dst=None) -> torch.Tensor:
        if dst is None:
            return self._gather(c[0], self.group, self.n_ranks)
        import torch.distributed as dist

        block = c[0]
        got = ([self._wire_empty(block.shape, block.dtype)
                for _ in range(self.n_ranks)] if self.rank == dst else None)
        dist.gather(self._wire(block), got, dst=dst, group=self.group)
        if got is None:
            return None
        return self._unwire(torch.stack(got))


@dataclasses.dataclass(frozen=True, repr=False)
class MetaRankMesh(ProcessMesh):
    """One rank of a process mesh on the meta device, with no process
    group (``make_meta_rank_mesh``): every collective runs
    ``ProcessMesh``'s own steps, so it checks its arguments, adds to
    ``traffic`` what that rank's call adds, and returns a meta tensor of
    the result's shape; no byte moves.  ``calls`` counts the calls that
    move data to this rank, by ``traffic``'s kinds.  The dry-run counts
    one rank's step of a production mesh on it."""

    calls: dict = dataclasses.field(default_factory=_new_traffic,
                                    compare=False)

    def __repr__(self) -> str:
        return (f"MetaRankMesh({self.shape}, rank {self.rank} of "
                f"{self.n_ranks})")

    @property
    def transport(self) -> str:
        return "meta"

    def reset_traffic(self) -> None:
        super().reset_traffic()
        for key in self.calls:
            self.calls[key] = 0

    def _count(self, op: str, x: torch.Tensor, rank_shares: float) -> None:
        super()._count(op, x, rank_shares)
        self.calls[op] += 1

    def _subgroup(self, names: Tuple[str, ...]):
        return None, np.sort(self._groups(names)[self.rank])

    def _exchange(self, block, dsts, buf, src) -> None:
        if buf is not None:
            self.calls["ppermute"] += 1

    def _all_reduce(self, y, pg, op="sum") -> None:
        pass

    def _reduce_scatter(self, out, inp, pg) -> None:
        pass

    def _gather(self, block: torch.Tensor, pg, n: int) -> torch.Tensor:
        return block.new_empty((n,) + tuple(block.shape))

    def _all_ranks(self, c: torch.Tensor, dst=None) -> torch.Tensor:
        if dst is not None and dst != self.rank:
            return None
        return self._gather(c[0], None, self.n_ranks)

    def traffic_total(self) -> dict:
        raise NotImplementedError("a meta rank mesh holds one rank's count")

    def agree(self, value):
        return value


def make_meta_rank_mesh(shape: Sequence[int], axes: Sequence[str], *,
                        rank: int = 0) -> MetaRankMesh:
    """Rank ``rank`` of a process mesh of ``shape`` over ``axes``, on the
    meta device and with no process group (``MetaRankMesh``): the LM's
    entry points run on its shard shapes and count that rank's
    collectives, for the dry-run of a mesh no machine here holds."""
    shape = tuple(int(x) for x in shape)
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} outside a mesh of {shape}")
    return MetaRankMesh(shape, tuple(axes), torch.device("meta"), rank=rank,
                        backend="meta")


def check_rank_devices(backend: str, devices: Sequence[str]) -> None:
    """The device map of a process mesh, rank by rank: NCCL refuses two
    ranks on one GPU ("Duplicate GPU detected"), so say so first."""
    if backend != "nccl":
        return
    seen = {}
    for r, d in enumerate(devices):
        if d in seen:
            raise ValueError(
                f"ranks {seen[d]} and {r} both resolve to {d}: NCCL takes "
                "one card a rank; give each rank its own card, or share a "
                "card over gloo (host-staged)")
        seen[d] = r


def make_process_mesh(shape: Sequence[int], axes: Sequence[str], *,
                      device: Union[str, torch.device, None] = None,
                      timeout: Optional[datetime.timedelta] = None
                      ) -> ProcessMesh:
    """The counterpart of JAX's ``make_mesh`` over the devices of all
    processes: a mesh of ``shape`` over ``axes`` whose ranks are the
    processes of the initialised default group, global rank r mesh rank
    r (row-major over ``axes``).  ``device`` defaults to
    ``cuda:(rank % torch.cuda.device_count())`` and follows
    ``resolve_device`` (CUDA where there is none raises; pass
    ``device="cpu"``).  ``timeout`` is the one the default group was
    made with (``init_process_group``'s; None for torch's default), so
    that the subgroups of the collectives over fewer axes fail as soon
    as it does.  Every process must call it, with the same shape and
    axes."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_process_mesh needs an initialised torch.distributed "
            "process group (torch.distributed.init_process_group)")
    group = dist.group.WORLD
    shape = tuple(int(s) for s in shape)
    size = dist.get_world_size(group)
    if size != math.prod(shape):
        raise ValueError(f"a mesh of shape {shape} has {math.prod(shape)} "
                         f"ranks, the process group {size}")
    backend = str(dist.get_backend(group))
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"no transport for the {backend!r} backend "
                         "(gloo or nccl)")
    rank = dist.get_rank(group)
    if device is None and torch.cuda.is_available():
        device = torch.device("cuda", rank % torch.cuda.device_count())
    dev = resolve_device(device)
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"NCCL carries CUDA tensors, the mesh is on {dev}")
        torch.cuda.set_device(dev)
    seen = [None] * size
    dist.all_gather_object(seen, (shape, tuple(axes), str(dev)), group=group)
    for r, (s, a, _) in enumerate(seen):
        if (s, a) != (shape, tuple(axes)):
            raise ValueError(f"rank {r} asks for a mesh of {s} over {a}, "
                             f"rank {rank} of {shape} over {tuple(axes)}")
    check_rank_devices(backend, [d for _, _, d in seen])
    return ProcessMesh(shape, tuple(axes), dev, rank=rank, backend=backend,
                       group=group, timeout=timeout)


# ---------------------------------------------------------------------------
# collectives on local tensors that autograd passes through
# ---------------------------------------------------------------------------
#
# The LM holds one rank's shard of every tensor as a plain tensor (no
# rank axis).  Each function below is the identity where ``mesh`` is
# None or the axes have one rank, so a 1x1 mesh runs the very operations
# of no mesh.  The backward of each runs the same process-group
# operations as a forward, so the processes pair up in it too.  Their
# transposes are JAX's, for the two ways a rank can hold a cotangent:
#
#   * ``psum_ad``: forward psum, backward psum.  Each rank holds the
#     cotangent of its own use of the sum (it goes on to compute
#     something of its own with it), so the sum's cotangent is theirs
#     summed.
#   * ``psum_rep`` and ``enter_rep``: Megatron's pair for a block whose
#     input every rank of ``axes`` holds alike and whose output every
#     rank uses alike.  ``psum_rep`` (psum forward, identity backward)
#     ends the block: every rank computes the same cotangent of the sum
#     downstream, and that is the cotangent of each summand.
#     ``enter_rep`` (identity forward, psum backward) starts it: each
#     rank's cotangent of the shared input covers its own part of the
#     block only.
#   * ``all_gather_ad`` (tiled; backward ``psum_scatter``) and
#     ``psum_scatter_ad`` (backward ``all_gather``).
#   * ``cut_rep`` and ``gather_rep``: the pair of the sequence-parallel
#     residual around a block every rank runs alike.  ``cut_rep`` keeps
#     this rank's chunk of a tensor every rank holds alike (backward
#     ``all_gather``: each rank's cotangent covers its chunk only);
#     ``gather_rep`` all-gathers the chunks into a tensor every rank then
#     uses alike (backward: this rank's chunk of the cotangent, which
#     every rank computes the same).


def axis_size(mesh, axes: Axes) -> int:
    """The number of ranks over ``axes`` (1 where ``mesh`` is None)."""
    if mesh is None:
        return 1
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    return math.prod(mesh.shape[a] for a in names)


def _on(mesh, axes: Axes) -> bool:
    return axis_size(mesh, axes) > 1


def _local(op, x: torch.Tensor, *args, **kw) -> torch.Tensor:
    return op(x.unsqueeze(0), *args, **kw)[0]


class _PsumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _local(mesh.psum, x, axes)

    @staticmethod
    def backward(ctx, g):
        return _local(ctx.mesh.psum, g.contiguous(), ctx.axes), None, None


class _PsumRep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _local(mesh.psum, x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _EnterRep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _local(ctx.mesh.psum, g.contiguous(), ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, axis):
        ctx.mesh, ctx.axes, ctx.axis = mesh, axes, axis
        return _local(mesh.all_gather, x, axes, axis=axis)

    @staticmethod
    def backward(ctx, g):
        return (_local(ctx.mesh.psum_scatter, g.contiguous(), ctx.axes,
                       scatter_dimension=ctx.axis), None, None, None)


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, axis):
        ctx.mesh, ctx.axes, ctx.axis = mesh, axes, axis
        return _local(mesh.psum_scatter, x, axes, scatter_dimension=axis)

    @staticmethod
    def backward(ctx, g):
        return (_local(ctx.mesh.all_gather, g.contiguous(), ctx.axes,
                       axis=ctx.axis), None, None, None)


def _chunk(x: torch.Tensor, mesh, axes: Axes, axis: int) -> torch.Tensor:
    """This process's chunk of ``x`` along ``axis``, cut in
    ``axis_size(mesh, axes)`` in the flat order of ``axes``."""
    size = x.shape[axis] // axis_size(mesh, axes)
    return x.narrow(axis, mesh.index(axes) * size, size)


class _CutRep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, axis):
        ctx.mesh, ctx.axes, ctx.axis = mesh, axes, axis
        return _chunk(x, mesh, axes, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_local(ctx.mesh.all_gather, g.contiguous(), ctx.axes,
                       axis=ctx.axis), None, None, None)


class _GatherRep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, axis):
        ctx.mesh, ctx.axes, ctx.axis = mesh, axes, axis
        return _local(mesh.all_gather, x, axes, axis=axis)

    @staticmethod
    def backward(ctx, g):
        return (_chunk(g, ctx.mesh, ctx.axes, ctx.axis).contiguous(), None,
                None, None)


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def psum_ad(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """psum over ``axes``; backward psum (see above)."""
    if not _on(mesh, axes):
        return x
    if _tracked(x):
        return _PsumBoth.apply(x, mesh, axes)
    return _local(mesh.psum, x, axes)


def psum_rep(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """psum over ``axes``; backward the identity (see above)."""
    if not _on(mesh, axes):
        return x
    if _tracked(x):
        return _PsumRep.apply(x, mesh, axes)
    return _local(mesh.psum, x, axes)


def enter_rep(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The identity; backward psum over ``axes`` (see above)."""
    if not _on(mesh, axes) or not _tracked(x):
        return x
    return _EnterRep.apply(x, mesh, axes)


def all_gather_ad(x: torch.Tensor, mesh, axes: Axes, *,
                  axis: int = 0) -> torch.Tensor:
    """Tiled all_gather over ``axes`` along ``axis``; backward psum_scatter."""
    if not _on(mesh, axes):
        return x
    if _tracked(x):
        return _AllGather.apply(x, mesh, axes, axis)
    return _local(mesh.all_gather, x, axes, axis=axis)


def psum_scatter_ad(x: torch.Tensor, mesh, axes: Axes, *,
                    axis: int = 0) -> torch.Tensor:
    """Tiled psum_scatter over ``axes`` along ``axis``; backward all_gather."""
    if not _on(mesh, axes):
        return x
    if _tracked(x):
        return _PsumScatter.apply(x, mesh, axes, axis)
    return _local(mesh.psum_scatter, x, axes, scatter_dimension=axis)


def cut_rep(x: torch.Tensor, mesh, axes: Axes, *,
            axis: int = 0) -> torch.Tensor:
    """This rank's chunk along ``axis`` of a tensor every rank of ``axes``
    holds alike; backward all_gather (see above)."""
    if not _on(mesh, axes):
        return x
    if _tracked(x):
        return _CutRep.apply(x, mesh, axes, axis)
    return _chunk(x, mesh, axes, axis).contiguous()


def gather_rep(x: torch.Tensor, mesh, axes: Axes, *,
               axis: int = 0) -> torch.Tensor:
    """Tiled all_gather over ``axes`` along ``axis`` into a tensor every
    rank uses alike; backward this rank's chunk (see above)."""
    if not _on(mesh, axes):
        return x
    if _tracked(x):
        return _GatherRep.apply(x, mesh, axes, axis)
    return _local(mesh.all_gather, x, axes, axis=axis)


def pmax(x: torch.Tensor, mesh, axes: Axes) -> torch.Tensor:
    """The elementwise maximum over ``axes`` (no gradient)."""
    if not _on(mesh, axes):
        return x
    return _local(mesh.pmax, x.detach(), axes)


# ---------------------------------------------------------------------------
# partition specs, production meshes and the card's roofline constants
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """A partition spec (see the module's docstring): ``PartitionSpec(None,
    "model")``, a tuple with one entry a dimension, as
    ``jax.sharding.PartitionSpec``.  A spec shorter than its tensor's rank
    replicates the dimensions it leaves out.  As JAX's does, an entry of
    no axes becomes None and one of a single axis that axis' name."""

    def __new__(cls, *parts):
        def canon(p):
            if isinstance(p, (tuple, list)):
                p = tuple(p)
                return None if not p else p[0] if len(p) == 1 else p
            return p

        return super().__new__(cls, tuple(canon(p) for p in parts))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


P = PartitionSpec


def is_spec(x) -> bool:
    """The leaf test of a tree of specs (a spec is itself a tuple)."""
    return isinstance(x, PartitionSpec)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Union[str, torch.device] = "meta") -> Mesh:
    """The production mesh: 32 x 8 (``data``, ``model``), or 2 x 32 x 8
    with ``pod`` outermost, on ``device`` (default ``meta``: a mesh of
    shape and names, for the sharding helpers and the dry-run).

    The JAX package's pod is 256 TPU v5e chips in a 16 x 16 torus whose
    links are all alike.  256 H100s are 32 nodes of 8: NVLink joins the 8
    cards of a node (450 GB/s each way), InfiniBand the nodes, an order of
    magnitude slower.  So the ``model`` axis, which carries the tensor-
    and expert-parallel collectives of every layer, is the 8 cards of one
    node, and ``data`` (gradient reductions once a step) spans the nodes."""
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


# NVIDIA's H100 SXM data sheet, dense rates (no sparsity), at the full
# 700 W power limit: tensor-core peaks by compute dtype ("tf32": f32
# operands with allow_tf32 on), the f32 / f64 rate outside the tensor
# cores, HBM size and rate, NVLink each way.
HW = {
    "name": "h100_sxm",
    "peak_flops": {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
                   "float32": 67e12, "float64": 67e12},
    "peak_flops_bf16": 989e12,
    "hbm_bw": 3.35e12,
    "hbm_bytes": 80e9,
    "nvlink_bw": 450e9,
}

_H100_PCIE = {
    "name": "h100_pcie",
    "peak_flops": {"bfloat16": 756e12, "float16": 756e12, "tf32": 378e12,
                   "float32": 51e12, "float64": 51e12},
    "peak_flops_bf16": 756e12,
    "hbm_bw": 2.0e12,
    "hbm_bytes": 80e9,
    "nvlink_bw": 300e9,
}

_H100_NVL = {
    "name": "h100_nvl",
    "peak_flops": {"bfloat16": 835.5e12, "float16": 835.5e12,
                   "tf32": 417.5e12, "float32": 60e12, "float64": 60e12},
    "peak_flops_bf16": 835.5e12,
    "hbm_bw": 3.9e12,
    "hbm_bytes": 94e9,
    "nvlink_bw": 300e9,
}


def hw_for(card_name: str) -> dict:
    """The data-sheet constants of the H100 part ``card_name`` names
    (``torch.cuda.get_device_name``): PCIe, NVL, else SXM (``HW``)."""
    if "PCIe" in card_name:
        return _H100_PCIE
    if "NVL" in card_name:
        return _H100_NVL
    return HW
