"""``Cropper.stats`` "read" in the window: decode seconds summed over the
worker threads, per image read (milliseconds)."""


def read(ctx):
    stage = ctx.stats.get("read")
    if not stage or not stage["items"]:
        return None
    return 1e3 * stage["seconds"] / stage["items"]
