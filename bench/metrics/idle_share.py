"""Share of the traced stretch in which no kernel or copy ran on the
device, in %."""


def read(ctx):
    t = ctx.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
