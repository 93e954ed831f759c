"""setup_s: process start to the first timed call: imports, loading (or
building) the port's kernels, the operands drawn from the seed and the
warm-up calls; on a process mesh the spawn and the group's set-up too
(host clock)."""
UNIT = "s"


def read(ctx):
    return ctx["setup_s"]
