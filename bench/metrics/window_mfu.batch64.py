"""The whole traced stretch's share of the card's roofline: the format-free
bound of its dispatched batches over the stretch's wall time, in %."""


def read(ctx):
    t = ctx.trace
    if not t or not t["batches"] or t["busy_s"] <= 0:
        return None
    return 100.0 * t["bound_s"] / t["window_s"]
