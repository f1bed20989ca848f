"""Host work while the device lock is held: the package's ``device_lock``
spans less the ``wait_device`` spans nested in them (``device_lock.host``),
summed over the threads, per file batch (``batch`` spans; milliseconds)."""


def read(ctx):
    host, batch = ctx.stats.get("device_lock.host"), ctx.stats.get("batch")
    if not host or not batch or not batch["calls"]:
        return None
    return 1e3 * host["seconds"] / batch["calls"]
