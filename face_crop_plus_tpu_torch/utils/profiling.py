"""Per-stage wall-time accounting, a profiler trace and a host probe.

Counterpart of ``face_crop_plus_tpu.utils.profiling``.
``Cropper.stats`` (:class:`PipelineStats`) accumulates the stages "read",
"detect", "detect+crop", "crop" and "save"; on a card the stage times are
host clocks around work that ends with a device→host copy.  :func:`trace`
records a ``torch.profiler`` trace of a block (the card's kernels and
copies beside the host's calls) as a Chrome trace file::

    with trace("/tmp/fcpt-trace"):    # chrome://tracing, Perfetto, TensorBoard
        cropper.process_dir(...)

:func:`host_speed_probe` is the host's fingerprint for benchmarks.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict

import numpy as np
import torch


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


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Runs the block under ``torch.profiler.profile`` (no-op when
    ``log_dir`` is None): CPU activity, plus CUDA activity where CUDA is
    available.  On exit a Chrome trace ``<host>_<pid>.<ms>.pt.trace.json``
    lands in ``log_dir``, which is created."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


#: The probe's image path, written once a process.
_PROBE: dict[str, str] = {}


def host_speed_probe(reps: int = 120) -> float | None:
    """Fixed-work host throughput probe: codec round trips per second.

    The JAX package's probe through the port's codec path
    (``utils/io.py: imread_rgb``/``imwrite``: cv2, else PIL): one
    synthetic CelebA-sized (218×178) JPEG decoded and re-encoded ``reps``
    times, after one warm-up, the median of three groups.  The absolute value is meaningless; the ratio
    between two runs of the probe is the host slowdown between them, which
    a benchmark records to tell "the pipeline got slower" from "the shared
    host was loaded".

    Returns round trips/s, or None when the probe cannot run.
    """
    try:
        import tempfile

        from .io import imread_rgb, imwrite

        if "path" not in _PROBE:
            rng = np.random.default_rng(0)
            # Natural-image-like content (JPEG cost depends on entropy):
            # smooth low-frequency base + mild noise, CelebA-sized.
            y, x = np.mgrid[0:218, 0:178].astype(np.float32)
            base = (
                128
                + 60 * np.sin(x / 23.0)[..., None]
                + 50 * np.cos(y / 31.0)[..., None]
                + rng.normal(0, 12, (218, 178, 3))
            )
            img = np.clip(base, 0, 255).astype(np.uint8)
            path = os.path.join(tempfile.gettempdir(), "fcpt_host_probe.jpg")
            imwrite(path, img)
            _PROBE["path"] = path
        path = _PROBE["path"]
        out = path + ".rt.jpg"
        imwrite(out, imread_rgb(path))  # warm
        rates = []
        for _ in range(3):  # median of 3 groups rejects scheduler blips
            t0 = time.perf_counter()
            for _ in range(reps):
                imwrite(out, imread_rgb(path))
            dt = time.perf_counter() - t0
            if dt > 0:
                rates.append(reps / dt)
        with contextlib.suppress(OSError):
            os.remove(out)
        return float(np.median(rates)) if rates else None
    except Exception:  # pragma: no cover - environment-dependent
        return None
