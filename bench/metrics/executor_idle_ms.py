"""executor_idle_ms: the card's idle ms a call while the host ran the
local multiply's own host code: the traced slice's idle gaps whose
innermost open host range is one of the port's ``dbcsr.local`` (the
local multiply built), ``dbcsr.pack``, ``dbcsr.launch`` and
``dbcsr.unpack`` (``core/densify.py``, ``core/engine.py``, the
kernels' wrappers), over the slice's calls."""
UNIT = "ms"
RANGES = ("dbcsr.local", "dbcsr.pack", "dbcsr.launch", "dbcsr.unpack")


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] == 0.0:
        return None
    # a program without the port's ranges shows none of them: nothing to
    # read; a program with them reads 0 where no gap fell under these
    if not any(k.startswith("dbcsr.") for k in tr["gaps"]):
        return None
    return 1e3 * sum(v for k, v in tr["gaps"].items()
                     if k in RANGES) / tr["calls"]
