"""multiply_p95_ms: the 95th percentile of every call's latency in the
window, from the call to the synchronize after it (host clock)."""
import numpy as np

UNIT = "ms"


def read(ctx):
    return 1e3 * float(np.percentile(ctx["latencies_s"], 95))
