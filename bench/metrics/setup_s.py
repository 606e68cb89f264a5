"""Process start to the window's start: imports, card start-up, the
matrix, values and x pool, the engine's plans, prepare and warm-up."""


def read(ctx):
    return ctx.setup_s
