"""``Cropper.stats`` "save" in the window: encode-and-write seconds summed
over the worker threads, per face saved (milliseconds)."""


def read(ctx):
    stage = ctx.stats.get("save")
    if not stage or not stage["items"]:
        return None
    return 1e3 * stage["seconds"] / stage["items"]
