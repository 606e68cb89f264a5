"""Median latency of every request due in the window, timed from when it
was due; a failed request counts as an infinite latency."""
from benchkit.cell import percentile


def read(ctx):
    return percentile(ctx.latencies_ms, 50) if ctx.latencies_ms else None
