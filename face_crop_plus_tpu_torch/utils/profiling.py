"""Per-stage wall-time accounting for the directory pipeline.

Counterpart of ``face_crop_plus_tpu.utils.profiling.PipelineStats``
(``:30-72``).  ``Cropper.stats`` accumulates the stages "read", "detect",
"detect+crop", "crop" and "save"; on a card the stage times are host
clocks around work that ends with a device→host copy.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class PipelineStats:
    """Thread-safe accumulated wall time and counts per pipeline stage."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.items: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] += dt
                self.calls[name] += 1
                self.items[name] += items

    def report(self) -> str:
        """Human-readable per-stage table, slowest first."""
        lines = ["stage            total_s   calls   items   items/s"]
        for name, sec in sorted(self.seconds.items(), key=lambda kv: -kv[1]):
            items = self.items[name]
            rate = f"{items / sec:10.1f}" if items and sec > 0 else "         -"
            lines.append(f"{name:<16}{sec:9.3f}{self.calls[name]:8d}{items:8d}{rate}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {
            name: {
                "seconds": self.seconds[name],
                "calls": self.calls[name],
                "items": self.items[name],
            }
            for name in self.seconds
        }
