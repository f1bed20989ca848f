"""The worker threads' queue for the card: the package's
``device_lock.wait`` spans (acquiring ``Cropper``'s device lock), summed
over the threads, per file batch (``batch`` spans; milliseconds)."""


def read(ctx):
    wait, batch = ctx.stats.get("device_lock.wait"), ctx.stats.get("batch")
    if not wait or not batch or not batch["calls"]:
        return None
    return 1e3 * wait["seconds"] / batch["calls"]
