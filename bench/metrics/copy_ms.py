"""copy_ms: device ms a call in operations classed as copy, fill or
elementwise: memory copies and sets, and every kernel of PyTorch's own
``at::native`` namespace (its elementwise, copy, fill, index and
reduction kernels).  GEMM libraries and the port's kernels are named
otherwise."""
UNIT = "ms"


def is_copy(name: str) -> bool:
    return (name.startswith("Memcpy") or name.startswith("Memset")
            or "at::native::" in name)


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["ops"]:
        return None
    s = sum(v for k, v in tr["ops"].items() if is_copy(k))
    return 1e3 * s / tr["calls"]
