"""Real requests per dispatched batch over the window, from the engine's
own counters (``EngineStats``)."""


def read(ctx):
    return ctx.occupied_cols / ctx.dispatches if ctx.dispatches else None
