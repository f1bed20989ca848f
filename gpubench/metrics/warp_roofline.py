"""The warp kernel (``csrc/warp.cu``): the bytes its launches must move
(crops written, transforms read) at the HBM peak, over its device time by
name (percent)."""

from gpubench.counts import PEAK_HBM_BYTES_PER_S


def read(ctx):
    if not ctx.summary:
        return None
    seconds = sum(s for name, s in ctx.summary["kernel_s"].items() if "warp_affine_u8" in name)
    if not seconds or not ctx.work.warp_bytes:
        return None
    return 100.0 * ctx.work.warp_bytes / PEAK_HBM_BYTES_PER_S / seconds
