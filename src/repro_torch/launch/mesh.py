"""The port's process mesh, with its ranks simulated in one process.

JAX names its devices with a ``jax.sharding.Mesh`` and runs a schedule
once per device inside ``shard_map``.  The port carries the same
information in a small ``Mesh`` (the grid's shape, its axis names and
the torch device) and runs every rank of the grid in one process on
that device: a tensor on the mesh carries one leading **rank axis** of
size R, the product of the axis sizes, with the ranks in row-major
order over ``axis_names``, as JAX orders the devices of
``make_mesh(shape, axes)``.  A 1x1 mesh is R = 1.

``Mesh`` offers the two halves of ``shard_map`` (``shard`` cuts a
global tensor into the rank-stacked layout of a partition spec,
``unshard`` puts a result back) and the collectives of ``jax.lax`` that
the schedules use, each with the JAX meaning over a subset of named
axes: ``ppermute``, ``psum``, ``psum_scatter``, ``all_gather`` and
``axis_index`` (``flat_index`` on the host).  A collective is a device
copy on one card; ``traffic`` counts the bytes a rank receives from
other ranks, summed over ranks, as a ring implementation would move
them.  A ``torch.distributed``
backend (one rank a process) would implement the same methods.

A partition spec is a tuple with one entry per dimension of the global
tensor: ``None`` (replicated), an axis name, or a tuple of axis names
whose flat index (row-major, in the tuple's order) picks the chunk.
Axes a spec does not name replicate the tensor.  ``PartitionSpec`` is
that tuple under a name of its own, so that trees of specs can tell a
spec from a tuple of specs.

``make_production_mesh`` and ``HW`` are the counterparts of the JAX
package's production meshes and roofline constants, for a cluster of
H100s: they hold shapes and names only and allocate nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "resolve_device", "PartitionSpec", "P",
           "is_spec", "make_production_mesh", "HW", "hw_for"]

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
    computing on ``device``.  ``shape`` maps axis name -> size, as
    JAX's does."""

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

    def reset_traffic(self) -> None:
        for key in self.traffic:
            self.traffic[key] = 0

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

    def _check(self, x: torch.Tensor) -> None:
        if x.ndim < 1 or x.shape[0] != self.n_ranks:
            raise ValueError(
                f"a tensor on this mesh has a leading rank axis of "
                f"{self.n_ranks}, got shape {tuple(x.shape)}")

    def _count(self, op: str, x: torch.Tensor, rank_shares: float) -> None:
        """Add ``rank_shares`` of one rank's ``x`` to ``op``'s traffic."""
        self.traffic[op] += int(round(rank_shares * x[0].numel()
                                      * x.element_size()))

    # ------------------------------------------------------ collectives

    def flat_index(self, axis: Axes) -> np.ndarray:
        """Every rank's (flat) index over ``axis``, row-major in the order
        of ``axis``: ``axis_index`` as a host int64 array of shape (R,)."""
        return self._flat(self._names(axis))

    def axis_index(self, axis: Axes) -> torch.Tensor:
        """``jax.lax.axis_index``: every rank's (flat) index over
        ``axis``, an int64 tensor of shape (R,) on the mesh's device."""
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
        names = self._names(axes)
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
        recv = src_flat >= 0
        ranks = np.arange(self.n_ranks)
        src = np.where(recv, table[ranks, np.maximum(src_flat, 0)], -1)
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

    def psum_scatter(self, x: torch.Tensor, axes: Axes, *,
                     scatter_dimension: int = 0,
                     tiled: bool = True) -> torch.Tensor:
        """``jax.lax.psum_scatter(..., tiled=True)``: the group sum of
        ``x``, cut into n chunks along ``scatter_dimension`` of a rank's
        block; the rank with flat index j over ``axes`` keeps chunk j."""
        if not tiled:
            raise NotImplementedError("psum_scatter(tiled=False)")
        self._check(x)
        names = self._names(axes)
        dim = 1 + scatter_dimension
        n = math.prod(self.shape[a] for a in names)
        if x.shape[dim] % n:
            raise ValueError(f"dimension {scatter_dimension} of size "
                             f"{x.shape[dim]} does not split into {n}")
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
        return [() if s is None else self._names(s) for s in spec]

    def shard(self, x: torch.Tensor, spec: Sequence) -> torch.Tensor:
        """Cut a global tensor into the rank-stacked layout of ``spec``:
        (R, *block), rank r holding the chunk its coordinates name.  A
        tensor ``spec`` replicates entirely comes back as a view (no
        copy); so does every tensor on a 1x1 mesh."""
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, the mesh on {self.device}")
        per_dim = self._spec_names(spec, x.ndim)
        parts = [math.prod(self.shape[a] for a in names) for names in per_dim]
        for d, (size, n) in enumerate(zip(x.shape, parts)):
            if size % n:
                raise ValueError(
                    f"dimension {d} of size {size} does not split over "
                    f"{per_dim[d]} ({n} ranks)")
        if all(n == 1 for n in parts):
            return x.unsqueeze(0).expand((self.n_ranks,) + tuple(x.shape))
        block = [size // n for size, n in zip(x.shape, parts)]
        flats = [self._flat(names) for names in per_dim]
        out = torch.empty([self.n_ranks] + block, dtype=x.dtype,
                          device=x.device)
        for r in range(self.n_ranks):
            idx = tuple(slice(int(f[r]) * b, (int(f[r]) + 1) * b)
                        for f, b in zip(flats, block))
            out[r].copy_(x[idx])
        return out

    def unshard(self, c: torch.Tensor, spec: Sequence) -> torch.Tensor:
        """Put a rank-stacked result back into one global tensor laid out
        by ``spec``.  Ranks that differ only on axes ``spec`` does not
        name hold replicas; the one at coordinate 0 on those axes is
        taken (JAX's ``out_specs`` assumes they agree)."""
        self._check(c)
        per_dim = self._spec_names(spec, c.ndim - 1)
        if self.n_ranks == 1:
            return c[0]
        named = {a for names in per_dim for a in names}
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
