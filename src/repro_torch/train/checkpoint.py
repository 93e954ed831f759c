"""Checkpointing, the counterpart of ``repro.train.checkpoint``, in its
on-disk format: ``<dir>/step_<N>/manifest.json`` plus one ``.npy`` per
leaf, keyed by the flattened tree path (dict keys in sorted order, list
and tuple indices), written under a temporary name and renamed into
place, with rotation.  The two packages read each other's checkpoints.

bf16 leaves are stored as the JAX package stores them: the raw two-byte
values (``<V2`` in the ``.npy`` header, ``"dtype": "bfloat16"`` in the
manifest), read back through ``view(torch.bfloat16)``.  numpy has no
bfloat16, and none is needed.  (The JAX package writes such a leaf but
cannot restore it: its restore casts a ``V2`` array.)

On a process mesh (``mesh=`` with the tree's resolved ``specs``, e.g.
``train_step.state_specs``), a save gathers each leaf to its whole
value on rank 0, one leaf at a time, and rank 0 alone writes; a restore reads the
whole leaves and cuts each by the specs of the mesh it is given, any
mesh (the JAX package's elastic re-mesh).  The files are the same as one
card's.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

from ..launch.mesh import is_spec, resolve_device
from ..models.common import tree_leaves, tree_map

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "all_steps", "CheckpointManager"]


def _flatten_with_path(tree, path: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) in ``jax.tree_util`` order: dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _flatten_with_path(t, path + (i,))
    else:
        yield path, tree


def _leaf_key(path) -> str:
    return "/".join(str(p) for p in path)


def _save_leaf(path: str, t: torch.Tensor) -> str:
    """Write one leaf as ``.npy``; returns the manifest's dtype name."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        raw = t.view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": raw.shape})
            f.write(raw.tobytes())
        return "bfloat16"
    arr = t.numpy()
    np.save(path, arr)
    return str(arr.dtype)


def _load_leaf(path: str, dtype: str) -> torch.Tensor:
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _multi(mesh) -> bool:
    return mesh is not None and mesh.n_ranks > 1


def _barrier(mesh) -> None:
    if _multi(mesh):
        import torch.distributed as dist

        dist.barrier(group=mesh.group)


def save_checkpoint(directory: str, step: int, state: Any,
                    *, keep_last: int = 3, mesh=None, specs=None) -> str:
    """Write the tree ``state`` (tensors on any device) at
    ``<directory>/step_<step>``.  Atomic via rename.  On a process mesh,
    ``state`` holds this process's shards and ``specs`` their resolved
    specs; every process calls it, rank 0 writes."""
    multi = _multi(mesh)
    writer = not multi or mesh.rank == 0
    spec_of = (dict(zip((p for p, _ in _flatten_with_path(state)),
                        tree_leaves(specs, is_leaf=is_spec)))
               if multi else {})
    tmp = os.path.join(directory, f".tmp_step_{step}")
    final = os.path.join(directory, f"step_{step}")
    if writer:
        os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for path, leaf in _flatten_with_path(state):
        if multi:      # the whole leaf, on the writer
            leaf = mesh.unshard(leaf.detach().unsqueeze(0), spec_of[path],
                                dst=0)
        if not writer:
            continue
        key = _leaf_key(path)
        fname = key.replace("/", "__") + ".npy"
        dtype = _save_leaf(os.path.join(tmp, fname), leaf)
        manifest["leaves"].append({
            "key": key, "file": fname,
            "shape": list(leaf.shape), "dtype": dtype,
        })
    if writer:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _rotate(directory, keep_last)
    _barrier(mesh)
    return final


def _rotate(directory: str, keep_last: int):
    steps = sorted(all_steps(directory))
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(directory, f"step_{s}"), ignore_errors=True)


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            out.append(int(m.group(1)))
    return out


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, target: Any, *,
                       device=None, mesh=None, specs=None) -> Any:
    """Restore into the structure of ``target`` (a tree of tensors, meta
    tensors allowed), each leaf in its target's dtype, on ``device``, or
    where ``device`` is None on its target's device (CUDA for a meta
    target).  On a process mesh, ``target`` holds this process's shards
    and each whole leaf read is cut by ``specs``, whatever mesh wrote
    it."""
    multi = _multi(mesh)
    spec_of = (dict(zip((p for p, _ in _flatten_with_path(target)),
                        tree_leaves(specs, is_leaf=is_spec)))
               if multi else {})
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {e["key"]: e for e in manifest["leaves"]}
    out = []
    for path, leaf in _flatten_with_path(target):
        key = _leaf_key(path)
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = _load_leaf(os.path.join(d, by_key[key]["file"]),
                       by_key[key]["dtype"])
        dev = device if device is not None else (
            None if leaf.device.type == "meta" else leaf.device)
        if multi:
            t = mesh.shard(t.to(mesh.device), spec_of[path])[0]
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)} != "
                             f"target {tuple(leaf.shape)}")
        out.append(t.to(device=resolve_device(dev), dtype=leaf.dtype))
    it = iter(out)
    return tree_map(lambda _: next(it), target)


class CheckpointManager:
    """Periodic save with optional async (background-thread) writes.  The
    host snapshot is taken on the caller's thread, so the state may be
    updated in place as soon as ``maybe_save`` returns; a failed
    background save raises from the next ``wait`` or ``maybe_save``."""

    def __init__(self, directory: str, every: int = 100,
                 keep_last: int = 3, async_save: bool = True):
        self.directory = directory
        self.every = every
        self.keep_last = keep_last
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _save(self, step: int, host_state: Any):
        try:
            save_checkpoint(self.directory, step, host_state,
                            keep_last=self.keep_last)
        except Exception as e:   # re-raised on the caller's thread
            self._error = e

    def maybe_save(self, step: int, state: Any) -> bool:
        if step % self.every:
            return False
        self.wait()
        host_state = tree_map(lambda x: x.detach().to("cpu", copy=True),
                              state)
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save, args=(step, host_state), daemon=True)
            self._thread.start()
        else:
            save_checkpoint(self.directory, step, host_state,
                            keep_last=self.keep_last)
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
