"""The device milliseconds of the package's ``enh_net`` span (a CUDA event
pair around each forward) over the images its gate took (the ``enh_gate``
counter's items); nothing to read from a package without the counter."""


def read(ctx):
    span = ctx.net_s.get("enh_net")
    gated = ctx.stats.get("enh_gate", {}).get("items", 0)
    if not span or not span["seconds"] or not gated:
        return None
    return 1e3 * span["seconds"] / gated
