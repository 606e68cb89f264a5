"""Mean host microseconds of a ``step()`` call that dispatched a batch,
inside the window (the wait for a full in-flight window is outside it).
Read in the traced run over the window's first and last quarters, outside
the traced stretch: the profiler records the device's activity there but
not the harness's host spans."""


def read(ctx):
    return 1e6 * sum(ctx.step_host_s) / len(ctx.step_host_s) if ctx.step_host_s else None
