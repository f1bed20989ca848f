"""The traced run: ranges and launch shapes around calls into the package,
``torch.profiler`` over the window, and the reduction of its trace.

These spans are opened from this file around the package's own
functions:

* ``det_net`` around each RetinaFace forward
  (``models/detection.py: retinaface_forward``), counting the rows and
  the interim size it ran, timed on the device by a pair of CUDA events
  on the forward's stream (the profiler records ranges of the thread that
  started it only, and ``process_dir`` runs its batches in worker
  threads);
* ``fused::<stage>`` through ``FusedPipeline.stage_timer`` and
  ``stage::<name>`` around each ``Cropper.stats`` stage (host clock, any
  thread): labels for the device's idle gaps;
* the greedy-NMS and warp wrappers (``ops/cuda/nms.py``,
  ``ops/cuda/warp.py``) record each launch's (N, K) and crop count.

The device's busy time and each kernel's time are read from the
profiler's Chrome trace: kernels, copies and sets by device.  The
package's own network spans (``det_net``, ``enh_net``, ``parse_net``,
each with a CUDA event pair) are read from its timeline after the window
(:func:`network_spans`).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import time
from collections import defaultdict

import torch

from ..counts import kernels as kernel_counts
from ..counts import retinaface as retinaface_counts

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: The package's spans around its networks' forwards (``utils/profiling.py``).
NETWORK_SPANS = ("det_net", "enh_net", "parse_net")


class Work:
    """Work counted by the wrappers during the traced window."""

    def __init__(self):
        self.det_net_flop = 0
        self.nms_ops = 0
        self.warp_bytes = 0
        self.launches = defaultdict(int)
        #: span name → [(start event, end event)] of the device's work.
        self.events = defaultdict(list)
        #: (label, host start, host end) in ``time.perf_counter`` seconds.
        self.host_spans = []

    @contextlib.contextmanager
    def device_span(self, name: str, device: torch.device):
        """Times the work the block enqueues on ``device``'s current stream."""
        if device.type != "cuda":
            yield
            return
        stream = torch.cuda.current_stream(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        try:
            yield
        finally:
            end.record(stream)
            self.events[name].append((start, end))

    def device_seconds(self) -> dict:
        """Span name → device seconds (after the devices synchronised)."""
        return {name: sum(s.elapsed_time(e) for s, e in pairs) * 1e-3
                for name, pairs in self.events.items()}


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def instrument(cropper, work: Work, model: dict):
    """Opens the ranges and records the launch shapes while the block runs."""
    from torch.profiler import record_function

    from face_crop_plus_tpu_torch import cropper as cropper_mod
    from face_crop_plus_tpu_torch import pipeline as pipeline_mod
    from face_crop_plus_tpu_torch.models import detection
    from face_crop_plus_tpu_torch.ops.cuda import nms as nms_mod

    forward = detection.retinaface_forward
    nms = nms_mod.greedy_nms_mask_cuda
    warp = pipeline_mod.warp_affine_u8

    def det_forward(net, x):
        rows, h, w = x.shape[:3]
        work.det_net_flop += rows * 2 * retinaface_counts.network_macs(h, w, model)
        with record_function("gpubench::det_net"), work.device_span("det_net", x.device):
            return forward(net, x)

    def greedy_nms(boxes, valid, threshold):
        n, k = valid.shape
        work.nms_ops += kernel_counts.nms_ops(n, k)
        work.launches["nms"] += 1
        return nms(boxes, valid, threshold)

    def warp_u8(images, matrices, img_idx, output_size, *args, **kwargs):
        work.warp_bytes += kernel_counts.warp_bytes(matrices.shape[0], output_size[1],
                                                    output_size[0])
        work.launches["warp"] += 1
        return warp(images, matrices, img_idx, output_size, *args, **kwargs)

    stack = contextlib.ExitStack()
    with stack:
        stack.enter_context(_patched(detection, "retinaface_forward", det_forward))
        stack.enter_context(_patched(nms_mod, "greedy_nms_mask_cuda", greedy_nms))
        stack.enter_context(_patched(pipeline_mod, "warp_affine_u8", warp_u8))
        stack.enter_context(_patched(cropper_mod, "warp_affine_u8", warp_u8))
        fused = getattr(cropper, "_fused", None)
        if fused is not None:
            stack.enter_context(_patched(fused, "stage_timer",
                                         lambda name: record_function(f"fused::{name}")))
        stage = cropper.stats.stage

        @contextlib.contextmanager
        def labelled(name, items=0):
            t0 = time.perf_counter()
            try:
                with stage(name, items):
                    yield
            finally:
                work.host_spans.append((f"stage::{name}", t0, time.perf_counter()))

        stack.enter_context(_patched(cropper.stats, "stage", labelled))
        yield


class Profile:
    """``torch.profiler`` over a block; :attr:`summary` after it."""

    def __init__(self, path: str, host_spans: list):
        self.path = path
        self.host_spans = host_spans
        self.window_s = 0.0
        self.summary = None

    @contextlib.contextmanager
    def run(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function("gpubench::anchor"):
                t0 = time.perf_counter()
            yield
            if torch.cuda.is_available():
                for i in range(torch.cuda.device_count()):
                    torch.cuda.synchronize(i)
            self.window_s = time.perf_counter() - t0
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        prof.export_chrome_trace(self.path)
        try:
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(self.path)
        self.summary = summarize(events, self.host_spans, t0)


def network_spans(records: list) -> dict:
    """Each network span that ran → {``seconds``: its device time summed
    from each span's CUDA event pair, None where a span has none (the
    CPU); ``rows``: the rows it ran}, from the package's timeline
    (``profiling.take_timeline()``, once the devices synchronised)."""
    out = {}
    for r in records:
        if r.name not in NETWORK_SPANS:
            continue
        ms = r.device_ms()
        net = out.setdefault(r.name, {"seconds": 0.0, "rows": 0})
        net["rows"] += r.items
        if ms is None or net["seconds"] is None:
            net["seconds"] = None
        else:
            net["seconds"] += ms * 1e-3
    return out


def _union(intervals):
    """Merged [start, end) intervals of an unsorted list."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list, host_spans: list = (), anchor: float | None = None) -> dict:
    """What the metrics read from a Chrome trace (times in seconds):

    ``busy`` device → seconds with a kernel, copy or set running;
    ``kernel_s`` kernel name → seconds; ``gaps`` the idle intervals of
    each device's timeline, labelled by the innermost host range open at
    their middle: the trace's own ranges, and ``host_spans`` (label,
    ``perf_counter`` start, end) placed on the trace's clock by the
    ``gpubench::anchor`` range, opened at ``perf_counter`` ``anchor``.
    """
    device, ranges = [], defaultdict(list)
    for e in events:
        cat = e.get("cat")
        if cat in DEVICE_CATS:
            args = e.get("args", {})
            device.append((cat, e.get("name", ""), int(args.get("device", 0)),
                           float(e["ts"]), float(e.get("dur", 0.0))))
        elif cat == "user_annotation":
            ranges[e.get("tid")].append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)),
                                         e.get("name", "")))
    anchors = [r[0] for rs in ranges.values() for r in rs if r[2] == "gpubench::anchor"]
    if anchors and anchor is not None:
        offset = anchors[0] - anchor * 1e6
        ranges["host"] = [(s * 1e6 + offset, e * 1e6 + offset, name) for name, s, e in host_spans]
    busy, kernel_s = {}, defaultdict(float)
    by_device = defaultdict(list)
    for cat, name, dev, ts, dur in device:
        by_device[dev].append((ts, ts + dur))
        if cat == "kernel":
            kernel_s[name] += dur * 1e-6
    gaps = []
    all_ranges = [r for rs in ranges.values() for r in rs if r[2] != "gpubench::anchor"]
    all_ranges.sort()
    all_starts = [r[0] for r in all_ranges]
    for dev, iv in by_device.items():
        merged = _union(iv)
        busy[dev] = sum(e - s for s, e in merged) * 1e-6
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            mid = (e0 + s1) / 2
            hi = bisect.bisect_right(all_starts, mid)
            inner = [r for r in all_ranges[max(0, hi - 512): hi] if r[0] <= mid <= r[1]]
            label = max(inner, key=lambda r: r[0])[2] if inner else "no host range"
            gaps.append((label, (s1 - e0) * 1e-6))
    return {"busy": busy, "kernel_s": dict(kernel_s), "gaps": gaps}


def breakdown(summary: dict) -> dict:
    """The ten device operations that took most time and the ten host
    activities behind the most idle time, as ``[name, seconds]``."""
    ops = sorted(summary["kernel_s"].items(), key=lambda kv: -kv[1])[:10]
    idle = defaultdict(float)
    for label, s in summary["gaps"]:
        idle[label] += s
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in gaps]}
