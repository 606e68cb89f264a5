"""The traced stretch's format-free bound (``benchkit.bound``, summed over
its dispatched batches) over the summed device time of every kernel and
copy in it, in %."""


def read(ctx):
    t = ctx.trace
    if not t or not t["batches"] or t["device_s"] <= 0:
        return None
    return 100.0 * t["bound_s"] / t["device_s"]
