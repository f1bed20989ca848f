"""From the top of ``run.py`` to the first timed request (seconds)."""


def read(ctx):
    return ctx.setup_s
