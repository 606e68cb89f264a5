"""Host seconds around ``SparseEngine(...)`` and its warm-up: plan lookup
or search, prepare of every bucket's format, graph capture."""


def read(ctx):
    return ctx.build_s
