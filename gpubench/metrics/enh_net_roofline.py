"""RRDBNet's counted FLOPs (every row of the package's ``enh_net`` span, a
whole padded interim each) over the span's device seconds (a CUDA event
pair around each forward), against the float32 peak (percent)."""

from gpubench.counts import PEAK_F32_FLOP_PER_S
from gpubench.counts import rrdb


def read(ctx):
    span = ctx.net_s.get("enh_net")
    if not span or not span["seconds"] or not span["rows"]:
        return None
    interim = ctx.kw["resize_size"]
    flop = span["rows"] * rrdb.row_flop(interim, interim, ctx.model["enhancer"])
    return 100.0 * flop / span["seconds"] / PEAK_F32_FLOP_PER_S
