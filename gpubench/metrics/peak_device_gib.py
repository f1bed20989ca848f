"""``torch.cuda.max_memory_allocated`` of the fullest card through the
window (GiB): set-up's warm-up runs the window's shapes, so this is the
window's peak."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
