"""The port's process mesh.

JAX names its devices with a ``jax.sharding.Mesh``; the port carries
the same information in a small ``Mesh``: the grid's shape, its axis
names and the torch device this process computes on.  The
communication the schedules need (Cannon's skew and shifts) goes
through ``Mesh.ppermute``, so a multi-rank mesh only has to add ranks
behind that one method.

This slice runs one rank: every axis has size 1, and a permutation over
a size-1 axis is the identity.  Larger grids are ROADMAP Queue A3.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple, Union

import torch

__all__ = ["Mesh", "make_mesh", "resolve_device"]


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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process grid: ``axis_names`` with ``axis_sizes``, computing on
    ``device``.  ``shape`` maps axis name -> size, as JAX's does."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    device: torch.device

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(
                f"mesh shape {self.axis_sizes} does not match axes "
                f"{self.axis_names}")
        if any(s != 1 for s in self.axis_sizes):
            raise NotImplementedError(
                f"mesh {self.axis_sizes}: only the 1x1 grid is ported; "
                "multi-rank meshes are ROADMAP Queue A3")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "mesh asks for a CUDA device but torch.cuda.is_available() "
                "is False; pass device='cpu' to run on the CPU")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    def ppermute(self, x: torch.Tensor, axes: Union[str, Sequence[str]],
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Send ``x`` along ``(source, destination)`` pairs over the flat
        index space of ``axes``, like ``jax.lax.ppermute``: a rank that
        no pair sends to receives zeros."""
        me = 0  # this rank's flat index over ``axes``: the 1x1 grid's only rank
        sources = [src for src, dst in perm if dst == me]
        if not sources:
            return torch.zeros_like(x)
        if sources != [me]:
            raise NotImplementedError(
                f"permutation {list(perm)} moves data between ranks; "
                "multi-rank meshes are ROADMAP Queue A3")
        return x


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: Union[str, torch.device, None] = None) -> Mesh:
    """The counterpart of ``repro.launch.mesh.make_mesh``: a mesh of
    ``shape`` over ``axes`` on ``resolve_device(device)``."""
    return Mesh(tuple(int(s) for s in shape), tuple(axes),
                resolve_device(device))
