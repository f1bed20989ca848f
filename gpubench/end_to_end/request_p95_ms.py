"""Nearest-rank 95th percentile over every request of the window, each
from the call of ``process_images`` to its return; a failed request is
infinitely late (milliseconds)."""

import math


def read(ctx):
    lat = sorted(getattr(ctx, "latencies", None) or [])
    if not lat:
        return None
    value = lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3
    return value if math.isfinite(value) else None
