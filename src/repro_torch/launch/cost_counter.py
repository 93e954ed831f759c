"""Operation counts of a PyTorch callable: the counterpart of
``repro.launch.hlo_analysis``.

The JAX package compiles a step and walks its partitioned HLO, because
``compiled.cost_analysis()`` counts a loop body once and says nothing of
collectives.  Eager PyTorch has no HLO.  ``count_costs`` instead runs the
callable under a ``TorchDispatchMode`` -- for the dry-run on the meta
device, where every op computes shapes and dtypes only and nothing is
allocated or launched -- and sums over the aten ops it sees:

  * FLOPs, by the formulas of ``torch.utils.flop_counter`` (the registry
    ``FlopCounterMode`` reads, decomposing what it has no formula for as
    ``FlopCounterMode`` does), split by compute dtype: ``bfloat16``,
    ``float16``, ``float32``, ``tf32`` (f32 operands while
    ``torch.backends.cuda.matmul.allow_tf32`` is on) and ``float64``;
  * HBM bytes: each op's operand bytes read once plus its result written
    once.  In eager mode every op is a kernel boundary, so this is the
    port's own traffic, not the fused figure XLA's analysis gives.
    Views and allocations move nothing; a gather reads what it writes,
    an indexed write moves its source, ``copy_`` its source and target;
  * collective bytes by kind, from ``Mesh.traffic`` of the mesh passed
    in (a one-rank path moves none): on a ``MetaRankMesh``, the bytes
    that rank of the process mesh receives; ``collective_count`` from
    the mesh's ``calls`` where it keeps them (the meta rank mesh does);
  * ``peak_live_bytes``: the argument storages plus every storage an op
    returns, from its creation until it dies (``weakref.finalize`` on
    the storage), the counterpart of the caching allocator's
    ``max_memory_allocated``.  Temporaries that a kernel allocates inside
    one aten op are not seen.

A kernel launched outside aten (the ctypes-loaded CUDA kernels) is
invisible to the mode: its wrapper charges the active counter by
formula through ``charge``, as decode_attention's meta branch does.
``replaying`` makes a loop of identical calls (the train step's
microbatches) cost one call's counting, as the reference's analysis
scales a loop body by its trip count.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

__all__ = ["OpCosts", "CostCounter", "count_costs", "charge", "active"]

aten = torch.ops.aten

# metadata queries FlopCounterMode passes through uncounted
_QUERIES = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
            aten.is_contiguous.memory_format,
            aten.is_strides_like_format.default,
            aten.is_non_overlapping_and_dense.default, aten.size.default,
            aten.sym_size.default, aten.stride.default,
            aten.sym_stride.default, aten.storage_offset.default,
            aten.sym_storage_offset.default, aten.numel.default,
            aten.sym_numel.default, aten.dim.default,
            torch.ops.prim.layout.default}

_GATHERS = {aten.index_select, aten.gather, aten.embedding, aten.index}
_SCATTERS = {aten.index_copy_, aten.index_copy, aten.index_put_,
             aten.index_put, aten.scatter_, aten.scatter, aten.index_add_,
             aten.index_add, aten.slice_scatter, aten.select_scatter}
_WRITES = {aten.zeros, aten.ones, aten.full, aten.arange, aten.zeros_like,
           aten.ones_like, aten.full_like, aten.new_zeros, aten.new_ones,
           aten.new_full, aten.scalar_tensor, aten.fill_, aten.zero_,
           aten.fill, aten.randn, aten.rand, aten.normal_, aten.uniform_}
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten._local_scalar_dense, aten.set_,
         aten.resize_, aten.lift_fresh}


@dataclasses.dataclass
class OpCosts:
    """The reference's ``HloCosts`` fields, per device (one device here),
    plus what eager execution can say besides."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    collective_count: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))
    unknown_trip_loops: int = 0
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=lambda: defaultdict(float))
    n_ops: int = 0
    argument_bytes: int = 0
    peak_live_bytes: int = 0
    charged: Dict[str, int] = dataclasses.field(
        default_factory=lambda: defaultdict(int))

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_count": dict(self.collective_count),
            "total_collective_bytes": self.total_collective_bytes,
            "unknown_trip_loops": self.unknown_trip_loops,
            "flops_by_dtype": dict(self.flops_by_dtype),
            "n_ops": self.n_ops,
            "argument_bytes": self.argument_bytes,
            "peak_live_bytes": self.peak_live_bytes,
            "charged": dict(self.charged),
        }


def _leaves(x) -> list:
    """The leaves of nested lists, tuples and dicts, in order."""
    if isinstance(x, dict):
        return [y for v in x.values() for y in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [y for v in x for y in _leaves(v)]
    return [x]


def _tensors(x) -> list:
    return [t for t in _leaves(x) if isinstance(t, torch.Tensor)]


@dataclasses.dataclass(frozen=True)
class _Meta:
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _skeleton(x):
    """``x`` with every tensor replaced by its shape and dtype (holding no
    storage alive)."""
    if isinstance(x, torch.Tensor):
        return _Meta(tuple(x.shape), x.dtype)
    if isinstance(x, dict):
        return {k: _skeleton(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_skeleton(v) for v in x)
    return x


def _like(x):
    """A ``_skeleton`` with a new meta tensor in place of each shape."""
    if isinstance(x, _Meta):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    if isinstance(x, dict):
        return {k: _like(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_like(v) for v in x)
    return x


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _compute_dtype(packet, args) -> str:
    t = next((a for a in args if isinstance(a, torch.Tensor)), None)
    if t is None:
        return "unknown"
    if t.dtype == torch.float32:
        conv = packet in (aten.convolution, aten._convolution,
                          aten.cudnn_convolution, aten.convolution_backward)
        tf32 = (torch.backends.cudnn.allow_tf32 if conv
                else torch.backends.cuda.matmul.allow_tf32)
        return "tf32" if tf32 else "float32"
    return str(t.dtype).replace("torch.", "")


_KIND: Dict[Any, str] = {}


def _kind(func) -> str:
    """How an op moves bytes: view, free, gather, scatter, copy, write
    (its result only) or plain (operands read, results written)."""
    kind = _KIND.get(func)
    if kind is None:
        packet = func._overloadpacket
        rets = func._schema.returns
        if packet in _FREE:
            kind = "free"
        elif rets and all(r.alias_info is not None
                          and not r.alias_info.is_write for r in rets):
            kind = "view"
        elif packet in _GATHERS:
            kind = "gather"
        elif packet in _SCATTERS:
            kind = "scatter"
        elif packet is aten.copy_:
            kind = "copy"
        elif packet in _WRITES:
            kind = "write"
        else:
            kind = "plain"
        _KIND[func] = kind
    return kind


def _op_bytes(kind: str, args, kwargs, out) -> int:
    if kind in ("view", "free"):
        return 0
    outs = _tensors(out)
    if kind == "write":
        return sum(map(_nbytes, outs))
    ins = _tensors((args, kwargs))
    if kind == "gather":        # the rows it reads, the index, the result
        return 2 * sum(map(_nbytes, outs)) + sum(
            _nbytes(t) for t in ins[1:] if not t.is_floating_point())
    if kind == "scatter":       # the index and source read, source written
        rest = ins[1:]
        return sum(map(_nbytes, rest)) + (_nbytes(rest[-1]) if rest else 0)
    if kind == "copy":
        return _nbytes(ins[1]) + _nbytes(ins[0])
    return sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))


class CostCounter(TorchDispatchMode):
    """The dispatch mode behind ``count_costs``; ``costs`` holds the sums.
    Enter it with ``with``; ``track`` registers the argument storages."""

    def __init__(self, mesh=None):
        super().__init__()
        self.costs = OpCosts()
        self.mesh = mesh
        self._live: Dict[int, int] = {}
        self._current = 0
        self._quiet = 0
        self._open = True
        self._traffic0 = dict(mesh.traffic) if mesh is not None else {}
        self._calls0 = dict(getattr(mesh, "calls", {}))

    # ----------------------------------------------------------- storage

    def _died(self, key: int) -> None:
        if self._open:
            self._current -= self._live.pop(key, 0)

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors as live; returns the
        bytes newly counted."""
        added = 0
        for t in _tensors(tree):
            st = t.untyped_storage()
            key, n = st._cdata, st.nbytes()
            old = self._live.get(key)
            if old is None:
                weakref.finalize(st, self._died, key)
            if old != n:
                self._live[key] = n
                added += n - (old or 0)
        self._current += added
        if self._current > self.costs.peak_live_bytes:
            self.costs.peak_live_bytes = self._current
        return added

    @property
    def live_bytes(self) -> int:
        return self._current

    # ---------------------------------------------------------- dispatch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _QUERIES:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if (packet not in flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self.track(out)
        if self._quiet:
            return out
        c = self.costs
        c.n_ops += 1
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            c.flops += f
            c.flops_by_dtype[_compute_dtype(packet, args)] += f
        c.hbm_bytes += _op_bytes(_kind(func), args, kwargs, out)
        return out

    def charge(self, name: str, *, flops: float = 0.0, hbm_bytes: float = 0.0,
               dtype: str = "float32") -> None:
        """Add a kernel's cost, computed by formula, under ``name``."""
        if self._quiet:
            return
        c = self.costs
        c.flops += flops
        c.flops_by_dtype[dtype] += flops
        c.hbm_bytes += hbm_bytes
        c.charged[name] += 1

    def close(self) -> OpCosts:
        """Stop tracking and fold in the mesh's traffic; returns the sums."""
        self._open = False
        if self.mesh is not None:
            for kind, n in self.mesh.traffic.items():
                moved = n - self._traffic0.get(kind, 0)
                if moved:
                    self.costs.collective_bytes[kind] += moved
            for kind, n in getattr(self.mesh, "calls", {}).items():
                made = n - self._calls0.get(kind, 0)
                if made:
                    self.costs.collective_count[kind] += made
        return self.costs

    # ------------------------------------------------------------ replay

    @contextlib.contextmanager
    def replaying(self, owner, name: str):
        """While open, ``owner.name`` (a function of tensors that returns a
        tree of tensors) is counted in full on its first call with a given
        signature (the shapes and dtypes of its tensor arguments and the
        identity of the others); a later call with that signature adds the
        first call's costs, raises the peak by as much above its live bytes
        as the first call did, and returns new meta tensors of the first
        call's result shapes.  For the meta device only, where a result's
        values are never read."""
        fn = getattr(owner, name)
        seen: Dict[Tuple, Tuple] = {}

        def signature(args, kwargs):
            return tuple((tuple(x.shape), x.dtype)
                         if isinstance(x, torch.Tensor) else id(x)
                         for x in _leaves((args, kwargs)))

        def replayed(*args, **kwargs):
            key = signature(args, kwargs)
            if key not in seen:
                before = dataclasses.replace(
                    self.costs, flops_by_dtype=defaultdict(
                        float, self.costs.flops_by_dtype))
                live0 = self._current
                peak0 = self.costs.peak_live_bytes
                self.costs.peak_live_bytes = live0
                out = fn(*args, **kwargs)
                rise = self.costs.peak_live_bytes - live0
                self.costs.peak_live_bytes = max(peak0,
                                                 self.costs.peak_live_bytes)
                seen[key] = (_delta(self.costs, before), rise, _skeleton(out))
                return out
            delta, rise, first = seen[key]
            self.costs.peak_live_bytes = max(self.costs.peak_live_bytes,
                                             self._current + rise)
            _add(self.costs, delta)
            self._quiet += 1
            try:
                return _like(first)
            finally:
                self._quiet -= 1

        setattr(owner, name, replayed)
        try:
            yield
        finally:
            setattr(owner, name, fn)


def _delta(now: OpCosts, before: OpCosts) -> dict:
    return {"flops": now.flops - before.flops,
            "hbm_bytes": now.hbm_bytes - before.hbm_bytes,
            "n_ops": now.n_ops - before.n_ops,
            "by_dtype": {k: v - before.flops_by_dtype.get(k, 0.0)
                         for k, v in now.flops_by_dtype.items()}}


def _add(c: OpCosts, d: dict) -> None:
    c.flops += d["flops"]
    c.hbm_bytes += d["hbm_bytes"]
    c.n_ops += d["n_ops"]
    for k, v in d["by_dtype"].items():
        c.flops_by_dtype[k] += v


def count_costs(fn: Callable, *args, mesh=None,
                replay: Tuple = (), **kwargs) -> Tuple[Any, OpCosts]:
    """Run ``fn(*args, **kwargs)`` under a ``CostCounter``; returns (its
    result, the ``OpCosts``).  The argument storages count as live from
    the start (``argument_bytes``).  ``replay``: (owner, name) pairs to
    run under ``CostCounter.replaying``."""
    counter = CostCounter(mesh)
    counter.costs.argument_bytes = counter.track((args, kwargs))
    with contextlib.ExitStack() as stack:
        stack.enter_context(counter)
        for owner, name in replay:
            stack.enter_context(counter.replaying(owner, name))
        try:
            out = fn(*args, **kwargs)
        finally:
            counter.close()
    return out, counter.costs


def active() -> Optional[CostCounter]:
    """The innermost ``CostCounter`` on the dispatch mode stack, if any."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, CostCounter):
            return mode
    return None


def charge(name: str, *, flops: float = 0.0, hbm_bytes: float = 0.0,
           dtype: str = "float32") -> bool:
    """Charge a kernel launched outside aten to the active counter; False
    if none is active."""
    counter = active()
    if counter is None:
        return False
    counter.charge(name, flops=flops, hbm_bytes=hbm_bytes, dtype=dtype)
    return True
