"""gemm_roofline: the share of its roofline that the multiply's GEMM work
reaches.  The bound (``ctx["bound_s"]``, from ``bench/work.py``) is the
larger of one rank's useful FLOPs over the f32 peak and its bytes (each
input read once, C written once) over the HBM bandwidth; it is divided
by the device time a call of every operation that is neither copy
(``copy_ms.is_copy``) nor collective (``comm_ms.is_collective``):
cuBLAS, the port's smm, tiled_matmul and grouped_gemm, or a GEMM kernel
under any other name."""
UNIT = "%"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    copy, comm = ctx["reader"]("copy_ms"), ctx["reader"]("comm_ms")
    gemm_s = sum(v for k, v in tr["ops"].items()
                 if not copy.is_copy(k) and not comm.is_collective(k))
    if gemm_s == 0.0:
        return None
    return 100.0 * ctx["bound_s"] / (gemm_s / tr["calls"])
