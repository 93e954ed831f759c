"""multiply_ms: the window's wall time over the calls that completed in
it (host clock; each call ends with ``torch.cuda.synchronize()``)."""
UNIT = "ms"


def read(ctx):
    return 1e3 * ctx["window_s"] / ctx["calls"]
