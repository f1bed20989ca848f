"""The port's tracer: spans and counters in ``utils/profiling.py``.

Tracing is on exactly while a ``torch.profiler`` profile runs.  Under a
CPU profile: the span tree of one ``process_images`` (one request id,
parents, ``request.host``), a four-thread ``process_dir`` (a request id a
batch, the device lock's wait and hold on every thread), a stream's
dispatch/collect pairs, the package's counters against the benchmark's
wrappers over the same calls, and ``trace(dir)``'s merged Chrome trace.
Off: a span site reads the profiler's flag once and keeps nothing.  Last,
the benchmark's traced CPU rehearsal reads the three metrics these spans
feed.  Random detector weights, 72×60 images, a 64² interim, 32² crops.
"""

import json
import math
import os
import sys
import threading
import warnings
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from face_crop_plus_tpu_torch import Cropper
from face_crop_plus_tpu_torch.pipeline import FusedPipeline
from face_crop_plus_tpu_torch.utils import device as port_device
from face_crop_plus_tpu_torch.utils import profiling
from face_crop_plus_tpu_torch.utils.io import imwrite

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

KW = dict(device="cpu", output_size=32, resize_size=64, det_threshold=-1.0, batch_size=4)
#: The stage names a Cropper records with tracing off.
STAGE_NAMES = {"read", "detect+crop", "detect", "crop", "parse", "enhance", "save"}


@pytest.fixture(autouse=True)
def _device_warp(monkeypatch):
    # The card's crop path: the fused pipeline warps with the kernel's wrapper.
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    profiling.take_timeline()
    yield
    profiling.take_timeline()


def _cropper(**kw) -> Cropper:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random weights
        return Cropper(**{**KW, **kw})


def _images(n: int = 4, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, 72, 60, 3), np.uint8)


def _traced(run):
    """``run()`` under a CPU profile; its result and the spans and counts
    recorded meanwhile."""
    profiling.take_timeline()
    with profile(activities=[ProfilerActivity.CPU]):
        out = run()
    return out, profiling.take_timeline()


def _spans(records):
    return [r for r in records if isinstance(r, profiling.Span)]


def _ancestors(span, by_id):
    out = []
    while span.parent is not None:
        span = by_id[span.parent]
        out.append(span)
    return out


@pytest.mark.parametrize("strategy", ["largest", "all"])
def test_span_tree_of_one_request(strategy):
    c = _cropper(strategy=strategy)
    c.process_images(_images())  # shapes granted, caps grown
    c.stats = profiling.PipelineStats()
    _, records = _traced(lambda: c.process_images(_images(seed=1)))
    spans = _spans(records)
    by_id = {s.id: s for s in spans}
    names = Counter(s.name for s in spans)
    assert {"request", "device_lock.wait", "device_lock", "resize_pad", "network", "det_net",
            "select", "fit_warp", "to_host", "wait_device"} <= set(names)
    if strategy == "all":
        assert names["compact"] == 1
    assert names["request"] == 1
    (request,) = [s for s in spans if s.name == "request"]
    assert request.parent is None and request.items == 4
    assert {r.request for r in records} == {request.request} and request.request is not None
    assert all(request in _ancestors(s, by_id) for s in spans if s is not request)
    lock = next(s for s in spans if s.name == "device_lock")
    parent = {s.name: by_id[s.parent].name for s in spans if s.parent is not None}
    assert parent["device_lock"] == parent["device_lock.wait"] == "request"
    assert parent["det_net"] == "network" and parent["network"] == "device_lock"
    assert {parent[n] for n in ("resize_pad", "select", "fit_warp", "to_host")} == {"device_lock"}
    stage_names = {s.name for s in spans if by_id.get(s.parent) is lock} - {"wait_device"}
    assert stage_names <= set(FusedPipeline.STAGES)
    waits = [s for s in spans if s.name == "wait_device"]
    stats = c.stats.as_dict()
    assert math.isclose(stats["request.host"]["seconds"],
                        (request.end - request.start) - sum(w.end - w.start for w in waits),
                        rel_tol=1e-9, abs_tol=1e-12)
    assert stats["request"]["calls"] == stats["request.host"]["calls"] == 1
    assert stats["faces_kept"]["items"] == len(c.process_images(_images(seed=1))[0])


def _write_dir(path, n: int) -> str:
    os.makedirs(path, exist_ok=True)
    for i, img in enumerate(_images(n, seed=2)):
        imwrite(os.path.join(path, f"{i:03d}.jpg"), img)
    return str(path)


def test_process_dir_threads_and_the_device_lock(tmp_path):
    src = _write_dir(tmp_path / "in", 16)
    c = _cropper(batch_size=2, num_processes=4)
    c.process_dir(src, str(tmp_path / "warm"), desc=None)
    _, records = _traced(lambda: c.process_dir(src, str(tmp_path / "out"), desc=None))
    spans = _spans(records)
    batches = [s for s in spans if s.name == "batch"]
    assert len(batches) == 8 and len({b.request for b in batches}) == 8
    by_thread = {}
    for s in spans:
        by_thread.setdefault(s.thread, Counter())[s.name] += 1
    threads = {b.thread for b in batches}
    assert len(threads) > 1 and threading.get_native_id() not in threads
    for t in threads:
        assert by_thread[t]["device_lock.wait"] >= by_thread[t]["batch"]
        assert by_thread[t]["device_lock"] == by_thread[t]["device_lock.wait"]
    for s in spans:
        if s.name != "batch":
            owner = next(b for b in batches if b.request == s.request)
            assert s.thread == owner.thread
    stats = c.stats.as_dict()
    for name in ("batch", "device_lock"):
        assert stats[name + ".host"]["calls"] == stats[name]["calls"] > 0
        assert 0 <= stats[name + ".host"]["seconds"] <= stats[name]["seconds"]
    assert stats["batch"]["items"] == 16


def test_stream_dispatch_and_collect_pair_by_id():
    c = _cropper()
    batches = [_images(seed=s) for s in (3, 4, 5)]
    list(c.process_images_stream(batches[:1], depth=2))
    out, records = _traced(lambda: list(c.process_images_stream(batches, depth=2)))
    assert len(out) == 3
    spans = _spans(records)
    pairs = {}
    for s in spans:
        if s.name.startswith("stream."):
            pairs.setdefault(s.request, {})[s.name] = s
    assert len(pairs) == 3 and None not in pairs
    for pair in pairs.values():
        assert set(pair) == {"stream.dispatch", "stream.collect"}
        assert pair["stream.dispatch"].end <= pair["stream.collect"].start
    assert not any(s.name == "request" for s in spans)


def test_tracing_off_keeps_nothing(tmp_path):
    c = _cropper()
    assert not profiling.tracing()
    c.process_images(_images())
    src = _write_dir(tmp_path / "in", 6)
    c.process_dir(src, str(tmp_path / "out"), desc=None)
    list(c.process_images_stream([_images(seed=7)]))
    assert profiling.take_timeline() == []
    assert set(c.stats.as_dict()) <= STAGE_NAMES


def test_spans_of_many_threads_lose_no_update():
    stats = profiling.PipelineStats()
    lock = threading.Lock()
    switch = sys.getswitchinterval()

    def work():
        for _ in range(100):
            with stats.span("batch", 2, request=True), stats.locked(lock):
                with port_device.wait_device(stats):
                    pass
                stats.count("faces_kept", 3)

    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            threads = [threading.Thread(target=work) for _ in range(4 * (os.cpu_count() or 1))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    n = 100 * len(threads)
    got = stats.as_dict()
    for name in ("batch", "batch.host", "device_lock.wait", "device_lock", "device_lock.host",
                 "wait_device", "faces_kept"):
        assert got[name]["calls"] == n, name
    assert got["batch"]["items"] == 2 * n and got["faces_kept"]["items"] == 3 * n
    records = profiling.take_timeline()
    assert len(records) == 5 * n
    assert len({r.request for r in records}) == n


def test_a_wait_inside_a_wait_counts_once():
    stats = profiling.PipelineStats()
    with profile(activities=[ProfilerActivity.CPU]):
        with stats.span("request", request=True) as request:
            with port_device.wait_device(stats) as outer:
                with port_device.wait_device(stats):
                    pass
    host = stats.as_dict()["request.host"]["seconds"]
    assert math.isclose(host, (request.end - request.start) - (outer.end - outer.start),
                        rel_tol=1e-9, abs_tol=1e-12)


class _Flag:
    """The profiler's flag, counting its reads."""

    def __init__(self):
        self.reads = 0

    @property
    def _is_profiler_enabled(self):
        self.reads += 1
        return False


@pytest.mark.parametrize("site", ["span", "count", "locked", "wait_device", "stage_span"])
def test_a_span_site_off_reads_one_flag(monkeypatch, site):
    flag = _Flag()
    monkeypatch.setattr(profiling, "_PROFILER", flag)
    stats = profiling.PipelineStats()
    lock = threading.Lock()
    pipe = FusedPipeline.__new__(FusedPipeline)
    pipe.stats, pipe.stage_timer = stats, None
    out = {
        "span": lambda: stats.span("network", 3),
        "count": lambda: stats.count("warp_crops", 16, size=(32, 32)),
        "locked": lambda: stats.locked(lock),
        "wait_device": lambda: port_device.wait_device(stats),
        "stage_span": lambda: pipe._stage("select"),
    }[site]()
    assert flag.reads == 1
    if site == "locked":
        assert out is lock
    elif site != "count":
        assert out is profiling._NULL
    assert profiling.take_timeline() == [] and stats.as_dict() == {}


@pytest.mark.parametrize("strategy", ["largest", "all"])
def test_counters_match_the_benchmarks_wrappers(strategy):
    from gpubench.counts import kernels as kernel_counts
    from gpubench.counts import retinaface as retinaface_counts
    from gpubench.harness.trace import Work, instrument

    with open(os.path.join(ROOT, "gpubench", "configs", "retinaface_r50_largest.json")) as f:
        model = json.load(f)["model"]
    c = _cropper(strategy=strategy)
    c.process_images(_images())
    work = Work()

    def run():
        with instrument(c, work, model):
            for seed in (8, 9):
                c.process_images(_images(seed=seed))

    _, records = _traced(run)
    counts = [r for r in records if isinstance(r, profiling.Count)]
    nms = [r for r in counts if r.name == "nms_pairs"]
    warps = [r for r in counts if r.name == "warp_crops"]
    nets = [r for r in _spans(records) if r.name == "det_net"]
    assert len(nms) == work.launches["nms"] > 0 and len(warps) == work.launches["warp"] > 0
    assert sum(kernel_counts.nms_ops(r.args["n"], r.args["k"]) for r in nms) == work.nms_ops
    assert all(r.items == r.args["n"] * r.args["k"] * (r.args["k"] - 1) // 2 for r in nms)
    assert sum(kernel_counts.warp_bytes(r.items, r.args["size"][1], r.args["size"][0])
               for r in warps) == work.warp_bytes
    flop = sum(r.items * 2 * retinaface_counts.network_macs(64, 64, model) for r in nets)
    assert nets and flop == work.det_net_flop
    stats = c.stats.as_dict()
    assert stats["nms_pairs"]["calls"] == len(nms) and stats["det_net"]["calls"] == len(nets)


def test_trace_merges_every_threads_spans(tmp_path):
    c = _cropper()
    c.process_images(_images())
    worker = _cropper()
    worker.process_images(_images())

    def other_thread():
        worker.process_images(_images(seed=10))

    with profiling.trace(str(tmp_path)):
        with c.stats.span("probe") as probe:
            pass
        c.process_images(_images(seed=11))
        t = threading.Thread(target=other_thread)
        t.start()
        t.join()
    (path,) = tmp_path.glob("*.pt.trace.json")
    with open(path) as f:
        data = json.load(f)
    clock, events = data["fcptClock"], data["traceEvents"]
    ids = [e["args"]["span"] for e in events if "span" in e.get("args", {})]
    assert len(ids) == len(set(ids)) == clock["matched"] + clock["added"]
    assert clock["matched"] > 0 and clock["added"] > 0
    tids = {e["tid"] for e in events if str(e.get("name", "")).startswith("fcpt::request")}
    assert tids == {threading.get_native_id(), t.native_id}
    added = {e["name"] for e in events if e.get("cat") == "fcpt" and e.get("ph") == "X"}
    assert {"fcpt::request", "fcpt::det_net", "fcpt::fit_warp"} <= added
    (kept,) = [e for e in events if e.get("name") == "fcpt::probe"]
    assert kept["cat"] == "user_annotation" and kept["args"]["span"] == probe.id
    (p0, t0), (p1, t1) = clock["anchors"]
    placed = t0 + (probe.start - p0) * (t1 - t0) / (p1 - p0)
    assert abs(placed - float(kept["ts"])) < 100.0
    assert profiling.take_timeline() == []


@pytest.mark.parametrize("workload", ["r50_largest_requests", "r50_largest_dir"])
def test_the_benchmarks_traced_rehearsal_reads_the_span_metrics(workload, tmp_path):
    from gpubench.harness import spec
    from gpubench.tests.helpers import benchmark_copy, result, run_cell

    # A copy of the benchmark of its own: its work directory is not shared.
    root = benchmark_copy(str(tmp_path))
    rc, lines, err, _ = run_cell(workload, "--trace", "1", "--rehearse-cpu", root=root,
                                 timeout=300)
    assert rc == 0, err[-3000:]
    metrics = result(lines)["metrics"]
    bench = spec.load_benchmark(ROOT)
    for name in ("request_host_ms", "lock_wait_ms_per_batch", "lock_host_ms_per_batch"):
        (entry,) = [m for m in bench["per_layer"] if m["name"] == name]
        if workload in entry["workloads"]:
            assert math.isfinite(metrics[name]["value"]) and metrics[name]["value"] >= 0
            assert metrics[name]["unit"] == entry["unit"]
        else:
            assert name not in metrics


def test_trace_writes_its_file_when_the_block_raises(tmp_path):
    c = _cropper()
    with pytest.raises(RuntimeError, match="stop"):
        with profiling.trace(str(tmp_path)):
            c.process_images(_images())
            raise RuntimeError("stop")
    (path,) = tmp_path.glob("*.pt.trace.json")
    with open(path) as f:
        data = json.load(f)
    assert data["fcptClock"]["matched"] > 0
    assert any(e.get("name") == "fcpt::request" for e in data["traceEvents"])
