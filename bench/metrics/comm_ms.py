"""comm_ms: device ms a call in collective kernels (NCCL's, named
``nccl...``) on rank 0's card."""
UNIT = "ms"


def is_collective(name: str) -> bool:
    return name.startswith("nccl")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    s = sum(v for k, v in tr["ops"].items() if is_collective(k))
    if s == 0.0:
        return None
    return 1e3 * s / tr["calls"]
