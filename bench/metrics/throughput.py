"""Requests completed inside the window over the window's seconds."""


def read(ctx):
    return ctx.completed / ctx.window_s if ctx.window_s > 0 else None
