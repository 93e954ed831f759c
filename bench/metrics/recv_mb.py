"""recv_mb: the bytes rank 0 receives a call, in MB (1e6 bytes): its
count of the process mesh's traffic (``Mesh.traffic``) over the window,
over the window's calls."""
UNIT = "MB"


def read(ctx):
    if ctx["chips"] == 1 or ctx["recv_bytes"] == 0:
        return None
    return ctx["recv_bytes"] / ctx["calls"] / 1e6
