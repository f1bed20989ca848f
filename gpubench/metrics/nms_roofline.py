"""The greedy-NMS kernel (``csrc/nms.cu``, both passes): the operations of
its launches' (N, K) at the float32 peak, over its device time by name
(percent)."""

from gpubench.counts import PEAK_F32_FLOP_PER_S


def read(ctx):
    if not ctx.summary:
        return None
    seconds = sum(s for name, s in ctx.summary["kernel_s"].items() if "nms_" in name)
    if not seconds or not ctx.work.nms_ops:
        return None
    return 100.0 * ctx.work.nms_ops / PEAK_F32_FLOP_PER_S / seconds
