"""device_idle_pct: the share of the traced slice in which no operation
ran on the card (rank 0's card on a process mesh)."""
UNIT = "%"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] == 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["slice_s"])
