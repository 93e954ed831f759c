"""plan_idle_ms: the card's idle ms a call while the host ran the
planner's own code: the traced slice's idle gaps whose innermost open
host range is the port's ``dbcsr.plan`` (``planner/`` plan_multiply and
the occupancy it prices), over the slice's calls."""
UNIT = "ms"
RANGES = ("dbcsr.plan",)


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
