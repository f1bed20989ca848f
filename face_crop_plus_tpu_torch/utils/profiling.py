"""Per-stage wall time, spans and counters, a profiler trace and a host probe.

Counterpart of ``face_crop_plus_tpu.utils.profiling``.
``Cropper.stats`` (:class:`PipelineStats`) accumulates the stages "read",
"detect", "detect+crop", "crop", "parse", "enhance" and "save" at all
times; on a card the stage times are host clocks around work that ends
with a device→host copy.

**Tracing** is on exactly while a ``torch.profiler`` profile runs, in any
thread (:func:`tracing`; :func:`trace` is the documented way to turn it
on).  Off, each span site costs one read of the profiler's flag and keeps
nothing.  On, every span (:meth:`PipelineStats.span`, and the stages):

* adds its seconds, one call and its items to its stats under its name;
* appends a record to the process's timeline: name, thread, start and end
  on ``time.perf_counter``, request id, parent span, items, and for the
  networks a CUDA event pair timing their work on the card;
* opens ``record_function("fcpt::<name>")``, which the profiler keeps for
  its own thread.

Spans named in :data:`HOST_SPLIT` also add ``<name>.host``: their duration
less the :data:`WAIT` spans nested in them on their thread, the time the
host worked rather than waited on the card.  Counters
(:meth:`PipelineStats.count`) add one call and their items, no seconds.
A request id comes from the span that opens the request (``request``,
``batch``, ``stream.dispatch``) and passes to every span opened inside it
on the same thread (a ``contextvars`` variable).

:func:`trace` records a block as one Chrome trace file holding the card's
kernels and the spans of every thread::

    with trace("/tmp/fcpt-trace"):    # chrome://tracing, Perfetto, TensorBoard
        cropper.process_dir(...)
    print(cropper.stats.report())

:func:`host_speed_probe` is the host's fingerprint for benchmarks.
"""

from __future__ import annotations

import bisect
import contextlib
import contextvars
import itertools
import json
import os
import socket
import sys
import threading
import time
from collections import defaultdict

import numpy as np
import torch

#: The module whose ``_is_profiler_enabled`` is True while a profile runs.
_PROFILER = torch.autograd.profiler

#: Spans that also keep ``<name>.host``: their time less their waits.
HOST_SPLIT = frozenset({"request", "batch", "device_lock"})
#: The span of the host blocked on the card (:func:`.device.wait_device`).
WAIT = "wait_device"
#: Records the timeline keeps at most; later ones are dropped.
TIMELINE_MAX = 1 << 20

_NULL = contextlib.nullcontext()
#: The span open on this thread, or None.
_OPEN: contextvars.ContextVar = contextvars.ContextVar("fcpt_open_span", default=None)
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
#: Every span and count recorded while tracing, in the order they ended.
_TIMELINE: list = []


def tracing() -> bool:
    """Whether spans and counters are kept: while a ``torch.profiler``
    profile runs, in any thread of the process."""
    return _PROFILER._is_profiler_enabled


def take_timeline() -> list:
    """The recorded spans (:class:`Span`) and counts (:class:`Count`),
    which the timeline then forgets."""
    out = _TIMELINE[:]
    del _TIMELINE[: len(out)]
    return out


def _keep(record) -> None:
    if len(_TIMELINE) < TIMELINE_MAX:
        _TIMELINE.append(record)


class Span:
    """One traced span; a record of :func:`take_timeline`.

    ``request`` True opens a new request id, an int carries that id, None
    takes the enclosing span's.  ``device`` is the torch device whose
    current stream a pair of CUDA events brackets (None, or a CPU device:
    no events).
    """

    __slots__ = ("stats", "name", "items", "request", "id", "parent", "thread", "start", "end",
                 "waited", "events", "_up", "_token", "_range")

    def __init__(self, stats, name: str, items: int = 0, request=None, device=None):
        self.stats, self.name, self.items = stats, name, int(items)
        self.request, self.events = request, device
        self.waited = 0.0

    def __enter__(self):
        up = _OPEN.get()
        if self.request is True:
            self.request = next(_request_ids)
        elif self.request is None and up is not None:
            self.request = up.request
        self.id = next(_span_ids)
        self.parent = None if up is None else up.id
        self._up = up
        self.thread = threading.get_native_id()
        self._token = _OPEN.set(self)
        self._range = torch.profiler.record_function(f"fcpt::{self.name}")
        self._range.__enter__()
        device, self.events = self.events, None
        if device is not None and device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(device))
            self.events = (start, device)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter()
        if self.events is not None:
            start, device = self.events
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(device))
            self.events = (start, end)
        self._range.__exit__(None, None, None)
        _OPEN.reset(self._token)
        dt = self.end - self.start
        if self.name == WAIT:
            chain, up = [], self._up
            while up is not None and up.name != WAIT:  # a wait inside a wait counts once
                chain.append(up)
                up = up._up
            for up in chain if up is None else ():
                up.waited += dt
        self.stats._add(self.name, dt, self.items)
        if self.name in HOST_SPLIT:
            self.stats._add(self.name + ".host", dt - self.waited, self.items)
        self._up = self._token = self._range = None
        _keep(self)
        return False

    def device_ms(self) -> float | None:
        """The card's time between the span's events (ms), once the card
        has passed the end event; None without events."""
        if self.events is None:
            return None
        start, end = self.events
        return start.elapsed_time(end)


class Count:
    """One traced count; ``args`` are the launch's shape."""

    __slots__ = ("name", "items", "args", "request", "parent", "thread", "start", "end")

    def __init__(self, name: str, items: int, args: dict):
        up = _OPEN.get()
        self.name, self.items, self.args = name, int(items), args
        self.request = None if up is None else up.request
        self.parent = None if up is None else up.id
        self.thread = threading.get_native_id()
        self.start = self.end = time.perf_counter()


class _TracedLock:
    """A lock whose acquisition is the span "device_lock.wait" and whose
    hold is the span "device_lock"."""

    def __init__(self, stats, lock):
        self.stats, self.lock = stats, lock

    def __enter__(self):
        with Span(self.stats, "device_lock.wait"):
            self.lock.__enter__()
        self.held = Span(self.stats, "device_lock")
        self.held.__enter__()

    def __exit__(self, *exc):
        try:
            self.held.__exit__(*exc)
        finally:
            self.lock.__exit__(*exc)
        return False


class PipelineStats:
    """Thread-safe accumulated wall time and counts per pipeline stage, and
    while tracing, per span and counter."""

    def __init__(self):
        self._lock = threading.Lock()
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.items: dict[str, int] = defaultdict(int)

    def _add(self, name: str, seconds: float, items: int) -> None:
        with self._lock:
            self.seconds[name] += seconds
            self.calls[name] += 1
            self.items[name] += items

    def stage(self, name: str, items: int = 0):
        """A stage, timed always; a span while tracing."""
        if _PROFILER._is_profiler_enabled:
            return Span(self, name, items)
        return self._timed(name, items)

    @contextlib.contextmanager
    def _timed(self, name: str, items: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, time.perf_counter() - t0, items)

    def span(self, name: str, items: int = 0, request=None, device=None):
        """A span while tracing (:class:`Span`), else a shared no-op."""
        if _PROFILER._is_profiler_enabled:
            return Span(self, name, items, request, device)
        return _NULL

    def count(self, name: str, items: int = 1, **args) -> None:
        """While tracing, adds one call and ``items`` under ``name`` and
        records ``args`` (the launch's shape) on the timeline."""
        if _PROFILER._is_profiler_enabled:
            self._add(name, 0.0, items)
            _keep(Count(name, items, args))

    def locked(self, lock):
        """``lock`` itself, or while tracing the lock with its wait
        ("device_lock.wait") and hold ("device_lock") as spans."""
        if _PROFILER._is_profiler_enabled:
            return _TracedLock(self, lock)
        return lock

    def report(self) -> str:
        """Human-readable per-stage table, slowest first."""
        lines = ["stage            total_s   calls   items   items/s"]
        for name, sec in sorted(self.seconds.items(), key=lambda kv: -kv[1]):
            items = self.items[name]
            rate = f"{items / sec:10.1f}" if items and sec > 0 else "         -"
            lines.append(f"{name:<16}{sec:9.3f}{self.calls[name]:8d}{items:8d}{rate}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        with self._lock:
            return {
                name: {
                    "seconds": self.seconds[name],
                    "calls": self.calls[name],
                    "items": self.items[name],
                }
                for name in list(self.seconds)
            }


#: Name of the ranges that put the timeline on the trace's clock.
ANCHOR = "fcpt::anchor"
#: How far (us) a span's mapped start may lie from the profiler's range of it.
MATCH_US = 1000.0


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Runs the block under ``torch.profiler.profile`` (no-op when
    ``log_dir`` is None): CPU activity, plus CUDA activity where CUDA is
    available, with tracing on (:func:`tracing`).  On exit a Chrome trace
    ``<host>_<pid>.<ms>.pt.trace.json`` lands in ``log_dir``, which is
    created: the profiler's events and the package's spans of every thread
    (:func:`merge_spans`)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    anchors = []
    take_timeline()
    prof = profile(activities=activities)
    try:
        with prof:
            for _ in range(2):  # the first range of a profile opens slowly
                with record_function(ANCHOR):
                    t = time.perf_counter()
            anchors.append(t)
            try:
                yield
            finally:
                with record_function(ANCHOR):
                    anchors.append(time.perf_counter())
    finally:
        _export(prof, log_dir, anchors, take_timeline())


def _export(prof, log_dir: str, anchors: list, records: list) -> None:
    """Writes the profile's Chrome trace with ``records`` merged in."""
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                 f"{int(time.time() * 1000)}.pt.trace.json")
    prof.export_chrome_trace(path)
    if len(anchors) < 2:  # the block never ran
        return
    with open(path) as f:
        data = json.load(f)
    clock = merge_spans(data["traceEvents"], records, anchors)
    data["fcptClock"] = clock
    with open(path, "w") as f:
        json.dump(data, f)
    print(f"fcpt trace: {clock['added']} spans added beside {clock['matched']} the profiler "
          f"kept; clock drift {clock['drift_us']:.3f} us over {clock['anchor_s']:.3f} s",
          file=sys.stderr)


def _args(record) -> dict:
    args = {"request": record.request, "parent": record.parent, "items": record.items}
    if isinstance(record, Span):
        args["span"] = record.id
        with contextlib.suppress(RuntimeError):
            ms = record.device_ms()
            if ms is not None:
                args["device_ms"] = ms
    else:
        args.update(record.args)
    return args


def merge_spans(events: list, records: list, anchors: list) -> dict:
    """Puts ``records`` (spans and counts of :func:`take_timeline`) into a
    Chrome trace's ``events``, on the trace's clock.

    The last two ``fcpt::anchor`` ranges, opened at the ``time.perf_counter``
    instants ``anchors`` (read just inside each range, as a span reads its
    start), map the timeline's clock onto the trace's linearly.  A span the
    profiler kept (its ``fcpt::<name>`` range on the same thread, nearest to
    the mapped start within :data:`MATCH_US`) gets the span's args (request, parent, span, items, device_ms); every other
    span is added as a complete event (``"ph": "X"``, category ``fcpt``)
    and every count as an instant event.  Returns the clock: both anchors
    as (perf_counter s, trace us), the drift between them, and the counts
    of matched and added spans.
    """
    ts = sorted(float(e["ts"]) for e in events
                if e.get("cat") == "user_annotation" and e.get("name") == ANCHOR)
    if len(ts) < 2 or len(anchors) < 2:
        raise ValueError("the trace lacks the two fcpt::anchor ranges")
    (p0, p1), (t0, t1) = anchors[-2:], ts[-2:]
    rate = (t1 - t0) / ((p1 - p0) * 1e6) if p1 > p0 else 1.0

    def place(t: float) -> float:
        return t0 + (t - p0) * 1e6 * rate

    kept = defaultdict(list)
    pid = os.getpid()
    for e in events:
        if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("fcpt::"):
            kept[(e["name"], e.get("tid"))].append(e)
            pid = e.get("pid", pid)
    for group in kept.values():
        group.sort(key=lambda e: float(e["ts"]))
    starts = {key: [float(e["ts"]) for e in group] for key, group in kept.items()}
    used = set()
    matched = added = 0
    for r in records:
        name, start = f"fcpt::{r.name}", place(r.start)
        if isinstance(r, Count):
            events.append({"ph": "i", "s": "t", "cat": "fcpt", "name": name, "pid": pid,
                           "tid": r.thread, "ts": start, "args": _args(r)})
            continue
        key = (name, r.thread)
        group = kept.get(key, ())
        best = None
        if group:
            i = bisect.bisect_left(starts[key], start)
            near = [j for j in (i - 1, i, i + 1) if 0 <= j < len(group)
                    and (key, j) not in used and abs(starts[key][j] - start) <= MATCH_US]
            best = min(near, key=lambda j: abs(starts[key][j] - start), default=None)
        if best is not None:
            used.add((key, best))
            group[best].setdefault("args", {}).update(_args(r))
            matched += 1
            continue
        events.append({"ph": "X", "cat": "fcpt", "name": name, "pid": pid, "tid": r.thread,
                       "ts": start, "dur": (r.end - r.start) * 1e6 * rate, "args": _args(r)})
        added += 1
    return {"anchors": [[p0, t0], [p1, t1]], "drift_us": (t1 - t0) - (p1 - p0) * 1e6,
            "anchor_s": p1 - p0, "matched": matched, "added": added}


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
