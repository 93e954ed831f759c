"""dispatch_idle_ms: the card's idle ms a call while the host ran the
call's own code outside the planner and the local multiply: the traced
slice's idle gaps whose innermost open host range is one of the port's
``dbcsr.multiply``, ``dbcsr.dispatch``, ``dbcsr.stats``,
``dbcsr.result_mask``, ``dbcsr.verify`` and ``dbcsr.repair``
(``core/dbcsr.py``, ``core/multiply.py``, ``core/schedule.py``), over
the slice's calls."""
UNIT = "ms"
RANGES = ("dbcsr.multiply", "dbcsr.dispatch", "dbcsr.stats",
          "dbcsr.result_mask", "dbcsr.verify", "dbcsr.repair")


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
