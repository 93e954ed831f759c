"""host_return_ms: the mean, over the window's calls, of the host's time
from entering ``dbcsr.multiply`` to its return, before the synchronize
that follows (host clock).  Where the port synchronizes inside the call,
the device's time up to that point is in it."""
UNIT = "ms"


def read(ctx):
    ret = ctx["host_return_s"]
    return 1e3 * sum(ret) / len(ret)
