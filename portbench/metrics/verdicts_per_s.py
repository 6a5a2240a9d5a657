"""verdicts_per_s: verdicts returned in the window over the window's
seconds (host clock, the window closed on a whole call)."""


def read(ctx):
    return ctx.attempted / ctx.window_s if ctx.window_s > 0 else None
