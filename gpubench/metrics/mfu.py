"""Counted FLOPs of every network run in the traced window, real images
and crops only (padding rows not counted), over the window's length, the
cards and the published float32 peak (percent)."""

from gpubench.counts import PEAK_F32_FLOP_PER_S


def read(ctx):
    if not ctx.real_flop or not ctx.window_s:
        return None
    return 100.0 * ctx.real_flop / (ctx.window_s * ctx.cards * PEAK_F32_FLOP_PER_S)
