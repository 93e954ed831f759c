"""multiply_mfu_pct: the whole call's share of the chips' f32 peak: the
multiply's useful FLOPs (2 * block^3 a retained block triple) over the
peak of every chip the cell uses times the traced slice's time a call."""
UNIT = "%"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] == 0.0:
        return None
    per_call = tr["slice_s"] / tr["calls"]
    return 100.0 * ctx["flops"] / (ctx["chips"] * ctx["f32_peak"] * per_call)
