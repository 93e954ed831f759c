"""Faults planted under the timed path, for the tests that see ``correct``
come out false.  Each is a context manager that patches the port in this
process and undoes the patch on exit; the benchmark's own runs plant
none.

* ``answer_altered``: one entry of each product moved by a thousandth of
  the product's largest, where the product is made.
* ``half_dropped``: the product summed over the first half of K only,
  doubled (half of the work left out, the rest scaled up to stand in).
* ``state_unchanged``: the product never written: zeros come back.
* ``exchange_dropped``: a process mesh's point-to-point shift left out,
  each rank keeping the block it would have sent.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, attr: str, make):
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


def _product_fault(change):
    from repro_torch.core import multiply

    def make(orig):
        def wrapped(a, b, **kw):
            c, plan = orig(a, b, **kw)
            return change(c), plan
        return wrapped
    return _patched(multiply, "_distributed_matmul", make)


def _altered(c):
    c = c.clone()
    c[0, 0] += 1e-3 * float(c.abs().max())
    return c


def _half_dropped():
    from repro_torch.core import multiply

    def make(orig):
        def wrapped(a, b, **kw):
            block = kw.get("block_k", 64)
            half = (a.shape[1] // block // 2) * block
            for key in ("a_mask", "b_mask", "a_norms", "b_norms"):
                if kw.get(key) is not None:
                    raise ValueError("half_dropped plants on dense operands")
            return orig(2 * a[:, :half].contiguous(),
                        b[:half].contiguous(), **kw)
        return wrapped
    return _patched(multiply, "_distributed_matmul", make)


def _exchange_dropped():
    from repro_torch.launch import mesh

    def make(orig):
        def wrapped(self, x, axes, perm):
            return x
        return wrapped
    return _patched(mesh.ProcessMesh, "ppermute", make)


FAULTS = {
    "answer_altered": lambda: _product_fault(_altered),
    "half_dropped": _half_dropped,
    "state_unchanged": lambda: _product_fault(lambda c: c.new_zeros(c.shape)),
    "exchange_dropped": _exchange_dropped,
}


def planted(name):
    """The context of fault ``name`` (None: no fault)."""
    return contextlib.nullcontext() if name is None else FAULTS[name]()
