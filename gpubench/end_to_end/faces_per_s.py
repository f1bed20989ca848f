"""Distinct face crops the entry returned or wrote in the window, over
the whole window (faces/s)."""


def read(ctx):
    return ctx.faces / ctx.window_s if ctx.window_s else None
