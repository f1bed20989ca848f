"""RetinaFace's counted FLOPs (every row it ran) over the device time of
its forwards (CUDA events on each forward's stream), against the float32 peak
(percent)."""

from gpubench.counts import PEAK_F32_FLOP_PER_S


def read(ctx):
    seconds = ctx.summary["span_s"].get("det_net", 0.0) if ctx.summary else 0.0
    if not seconds or not ctx.work.det_net_flop:
        return None
    return 100.0 * ctx.work.det_net_flop / seconds / PEAK_F32_FLOP_PER_S
