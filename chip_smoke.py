#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse-cpu   # tiny CPU run of the control flow

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

0. Card identity (``nvidia-smi``), torch/CUDA versions; TF32 off, so the
   port computes in f32 as the JAX package does off the TPU.
1. Build the greedy-NMS kernel from ``face_crop_plus_tpu_torch/csrc`` and
   print ``ptxas -v`` (registers, shared memory, spills).
2. Kernel vs plain on the card: N = 16, K in {168, 256, 512, 1024}, random,
   identical, all-invalid, near-threshold, NaN/inf and the detector's own
   top-K boxes at 1024²; keep masks must be bitwise equal.  Times on the
   detector's boxes at each K (profiler device time of the kernel, CUDA
   events around the wrapper call and around the plain version, after
   warm-up), beside the bound.
3. The slice at full width: ``Cropper(device="cuda", output_size=256,
   resize_size=1024, strategy="largest", det_threshold=-1.0,
   batch_size=16)`` with seeded random-init RetinaFace ResNet-50, driven by
   ``process_images`` on seeded 16×218×178×3 uint8 batches; the kernel's
   launch count must rise on every request.  Faces/s, the stage split and
   peak memory are printed, and one profiled request's kernel time by name.
   Then a small-input reference check: the same slice on the card and on
   the CPU (plain path) at a 128² interim with tamed weights must give
   equal indices and crops within ±1.
4. The ``kernels`` JSON line, the card line, and the ``ok`` line last.

The rehearsal runs every phase on the CPU at tiny sizes with the plain
versions (no build, no launch counts) and exits 3 without an ``ok`` line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s
#: outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
#: f32 operations per candidate pair of the IoU-and-compare step.
OPS_PER_PAIR = 20
THR = 0.4


def log(*args):
    print(*args, flush=True)


def card_line(rehearse: bool) -> str:
    if rehearse:
        return "cpu (rehearsal), no power limit"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


class Clock:
    """Elapsed milliseconds of a callable: CUDA events on a card, else host."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def ms(self, fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps


def device_kernels(fn, reps: int) -> list[tuple[str, float, int]]:
    """(kernel name, device µs in all, launches) of ``reps`` calls, by name.

    From ``torch.profiler``'s CUDA activity; empty when the profiler saw no
    device time.
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [
        (e.key, float(e.self_device_time_total), int(e.count))
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    return sorted(rows, key=lambda r: -r[1])


class StageTimer:
    """Per-stage milliseconds by synchronised host clocks."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.ms: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        yield
        if self.cuda:
            torch.cuda.synchronize()
        self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3


# ---------------------------------------------------------------------------
# Phase 2 inputs
# ---------------------------------------------------------------------------


def _random_boxes(rng, n, k, hi=300.0):
    x1 = rng.uniform(0, hi, (n, k))
    y1 = rng.uniform(0, hi, (n, k))
    w = rng.uniform(5, 60, (n, k))
    h = rng.uniform(5, 60, (n, k))
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


def _near_threshold(rng, n, k):
    # Box [0, y, w, y + w] and its copy shifted by 3(w + 1)/7 have IoU 0.4
    # exactly; the shift is nudged by up to 2 ulps either way.
    boxes = np.zeros((n, k, 4), np.float32)
    for b in range(n):
        for p in range(0, k - 1, 2):
            w = np.float32(rng.integers(20, 91))
            y = np.float32(100 * (p // 2))
            d = np.float32(3.0 * (w + 1.0) / 7.0)
            toward = np.float32(np.inf if rng.random() < 0.5 else -np.inf)
            for _ in range(int(rng.integers(0, 3))):
                d = np.nextafter(d, toward)
            boxes[b, p] = (0, y, w, y + w)
            boxes[b, p + 1] = (d, y, d + w, y + w)
    return boxes


def nms_cases(rng, n, k):
    """name → (boxes (n, k, 4) f32, valid (n, k) bool) numpy inputs."""
    rand = _random_boxes(rng, n, k)
    valid = rng.random((n, k)) < 0.8
    hit = rng.random(rand.shape) < 0.05
    specials = rng.choice(np.array([np.nan, np.inf, -np.inf], np.float32), rand.shape)
    return {
        "random": (rand, valid),
        "identical": (np.tile(rand[:, :1], (1, k, 1)), np.ones((n, k), bool)),
        "all_invalid": (rand, np.zeros((n, k), bool)),
        "near_threshold": (_near_threshold(rng, n, k), np.ones((n, k), bool)),
        "nonfinite": (np.where(hit, specials, rand).astype(np.float32), valid),
    }


def detector_candidates(cropper, images: torch.Tensor, k: int):
    """The detector's own score-sorted top-K boxes and validity."""
    from face_crop_plus_tpu_torch.models.detection import (
        decode_detections, preprocess, retinaface_forward,
    )
    from face_crop_plus_tpu_torch.ops.anchors import anchor_grid
    from face_crop_plus_tpu_torch.ops.nms import top_candidates
    from face_crop_plus_tpu_torch.pipeline import device_resize_pad

    det = cropper.det_model
    iw, ih = cropper.resize_size
    with torch.no_grad():
        interim, _, _ = device_resize_pad(images, (iw, ih))
        scores2, loc, ldm = retinaface_forward(det.net, preprocess(interim))
        priors = torch.tensor(anchor_grid(ih, iw), device=images.device)
        boxes, _ = decode_detections(loc, ldm, priors, (ih, iw))
        idx, valid, _ = top_candidates(scores2[..., 1].float(), det.vis_threshold, k)
        b = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)).contiguous()
    return b, valid.contiguous()


def phase2_kernel_vs_plain(cropper, images, ks, n, device, clock, card):
    from face_crop_plus_tpu_torch.ops import nms as plain
    from face_crop_plus_tpu_torch.ops.cuda import nms as kern

    def plain_keep(b, v):
        return plain.greedy_nms_mask(plain.iou_matrix_plus1(b), v, THR)

    rng = np.random.default_rng(2)
    max_err = 0
    timings = {}
    for k in ks:
        cases = {
            name: (torch.from_numpy(b).to(device), torch.from_numpy(v).to(device))
            for name, (b, v) in nms_cases(rng, n, k).items()
        }
        cases["detector"] = detector_candidates(cropper, images, k)
        for name, (b, v) in cases.items():
            ours = kern.greedy_nms_mask_cuda(b, v, THR)
            ref = plain_keep(b, v)
            if device.type == "cuda":
                torch.cuda.synchronize()
            err = int((ours.int() - ref.int()).abs().max())
            max_err = max(max_err, err)
            log(f"  K={k:5d} {name:15s} kept={int(ours.sum()):6d} "
                f"bitwise_equal={torch.equal(ours, ref)}")
            if not torch.equal(ours, ref):
                raise SystemExit(f"FAIL: kernel != plain at K={k}, case {name}")
        b, v = cases["detector"]
        keep = plain_keep(b, v)
        # Work this run's data needs: IoUs of every kept row i against j > i.
        kept_i = keep.nonzero()[:, 1]
        pairs = int((k - 1 - kept_i).sum())
        bytes_moved = b.numel() * 4 + v.numel() + keep.numel()
        t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
        t_ops = OPS_PER_PAIR * pairs / PEAK_F32_FLOPS * 1e3
        call = lambda: kern.greedy_nms_mask_cuda(b, v, THR)  # noqa: E731
        call_ms = clock.ms(call, reps=50)
        plain_ms = clock.ms(lambda: plain_keep(b, v), reps=3, warmup=1)
        # Device time of the kernel's two passes; the call time above also
        # holds the wrapper's host work when the host is the slower side.
        kernel_ms, source = call_ms, "CUDA events around the wrapper call"
        if device.type == "cuda":
            rows = [r for r in device_kernels(call, reps=20) if "nms_" in r[0]]
            if rows:
                kernel_ms = sum(r[1] for r in rows) / 20 / 1e3
                source = "profiler device time: " + ", ".join(
                    f"{'mask pass' if 'nms_mask' in r[0] else 'scan pass'} "
                    f"{r[1] / 20:.3f} us" for r in rows
                )
        timings[k] = dict(
            ms=kernel_ms, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
        log(f"  [{card}] N={n} K={k} detector boxes: kernel {kernel_ms:.6f} ms "
            f"({source}), wrapper call {call_ms:.6f} ms, "
            f"plain {plain_ms:.6f} ms, bound {max(t_bytes, t_ops):.6f} ms "
            f"(bytes {t_bytes:.6f} ms for {bytes_moved} B, operations "
            f"{t_ops:.6f} ms for {pairs} kept-row pairs), K-step chain {k} steps")
    return max_err, timings


# ---------------------------------------------------------------------------
# Phase 3
# ---------------------------------------------------------------------------


def tamed_state_dict(net, seed: int = 1):
    """Seeded weights that keep scores spread inside (0, 1) on small inputs."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, ref in net.state_dict().items():
        if ref.ndim == 4:
            fan_in = ref.shape[1] * ref.shape[2] * ref.shape[3]
            out[key] = torch.from_numpy(
                (rng.normal(size=tuple(ref.shape)) / np.sqrt(fan_in)).astype(np.float32)
            )
        elif key.endswith(".scale"):
            out[key] = torch.full(tuple(ref.shape), 0.7)
        else:
            out[key] = torch.from_numpy((rng.normal(size=tuple(ref.shape)) * 0.01).astype(np.float32))
    return out


def reference_check(device):
    """The slice on ``device`` vs on the CPU (plain path), small input."""
    from face_crop_plus_tpu_torch import Cropper

    kw = dict(output_size=64, resize_size=128, strategy="largest",
              padding="replicate", det_threshold=-1.0, batch_size=4)
    a = Cropper(device=device, **kw)
    b = Cropper(device="cpu", **kw)
    sd = tamed_state_dict(b.det_model.net)
    a.det_model.net.load_state_dict(sd)
    b.det_model.net.load_state_dict(sd)
    batch = np.random.default_rng(3).integers(0, 256, (4, 96, 80, 3), dtype=np.uint8)
    ca, ia, _ = a.process_images(batch)
    cb, ib, _ = b.process_images(batch)
    if not np.array_equal(ia, ib):
        raise SystemExit(f"FAIL: reference check indices {ia} != {ib}")
    diff = int(np.abs(ca.astype(np.int16) - cb.astype(np.int16)).max()) if len(ca) else 0
    log(f"  reference check ({device} vs cpu, 128² interim, tamed weights): "
        f"indices {ia.tolist()}, crop max |diff| {diff}, "
        f"pre_topk {a.det_model.pre_topk}/{b.det_model.pre_topk}")
    if diff > 1 or ca.shape != cb.shape or a.det_model.pre_topk != b.det_model.pre_topk:
        raise SystemExit("FAIL: reference check crops differ by more than 1 level")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run the control flow on the CPU at tiny sizes")
    opts = ap.parse_args()
    rehearse = opts.rehearse_cpu

    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; needs a CUDA card",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "face_crop_plus_tpu_torch")):
        print("chip_smoke: face_crop_plus_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # Seeded random weights: look for no checkpoint outside the checkout.
    os.environ["FCPT_CACHE_DIR"] = os.path.join(ROOT, "face_crop_plus_tpu_torch", "_build", "no-weights")

    from face_crop_plus_tpu_torch import Cropper
    from face_crop_plus_tpu_torch.ops.cuda import build
    from face_crop_plus_tpu_torch.ops.cuda import nms as kern

    device = torch.device("cpu" if rehearse else "cuda")
    clock = Clock(device)

    # -- phase 0 -----------------------------------------------------------
    card = card_line(rehearse)
    log(f"phase 0: card: {card}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("  TF32 off for matmul and cuDNN: f32 compute")

    # -- phase 1 -----------------------------------------------------------
    if rehearse:
        log("phase 1: build skipped (rehearsal: no nvcc)")
    else:
        t0 = time.perf_counter()
        build.load_library("nms.cu")
        info = build.build_info["nms.cu"]
        log(f"phase 1: built csrc/nms.cu in {time.perf_counter() - t0:.3f} s "
            f"(nvcc {info['seconds']:.3f} s)")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  ptxas: " + line.strip())

    # -- models ------------------------------------------------------------
    if rehearse:
        n, ks, src_hw, resize, out_size = 2, (168,), (40, 30), 64, 32
    else:
        n, ks, src_hw, resize, out_size = 16, (168, 256, 512, 1024), (218, 178), 1024, 256
    t0 = time.perf_counter()
    cropper = Cropper(device=str(device), output_size=out_size, resize_size=resize,
                      strategy="largest", det_threshold=-1.0, batch_size=n)
    log(f"  Cropper init {time.perf_counter() - t0:.3f} s "
        f"(pretrained={cropper.det_model.pretrained})")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (n, *src_hw, 3), dtype=np.uint8) for _ in range(6)]

    # -- phase 2 -----------------------------------------------------------
    log(f"phase 2: kernel vs plain, N={n}, K in {ks}")
    images0 = torch.from_numpy(batches[0]).to(device)
    max_err, timings = phase2_kernel_vs_plain(cropper, images0, ks, n, device, clock, card)
    del images0

    # -- phase 3 -----------------------------------------------------------
    log(f"phase 3: process_images, {n}x{src_hw[0]}x{src_hw[1]}x3 → {resize}² "
        f"RetinaFace ResNet-50 → {out_size}² crops")
    net = cropper.det_model.net
    on_dev = all(t.device.type == device.type for t in list(net.parameters()) + list(net.buffers()))
    if not on_dev or cropper._fused.device.type != device.type:
        raise SystemExit("FAIL: detector parameters are not on the device")
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    kern.launches = 0
    per_request = []
    seconds = []
    faces = []
    for r, batch in enumerate(batches[:5]):
        before = kern.launches
        t0 = time.perf_counter()
        crops, indices, groups = cropper.process_images(batch)
        seconds.append(time.perf_counter() - t0)
        per_request.append(kern.launches - before)
        faces.append(len(indices))
        if crops.shape != (n, out_size, out_size, 3) or crops.dtype != np.uint8:
            raise SystemExit(f"FAIL: request {r}: crops {crops.shape} {crops.dtype}")
        if not np.array_equal(indices, np.arange(n)) or groups != (None, None):
            raise SystemExit(f"FAIL: request {r}: indices {indices}")
    main_launches = kern.launches
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    log(f"  K1 launches per request {per_request} (pre_topk now "
        f"{cropper.det_model.pre_topk}); request seconds "
        + ", ".join(f"{s:.6f}" for s in seconds))
    if not rehearse and (main_launches == 0 or min(per_request) < 1):
        raise SystemExit("FAIL: the NMS kernel did not launch on every request")
    timed = seconds[1:]
    fps = sum(faces[1:]) / sum(timed)
    log(f"  [{card}] {fps:.6f} faces/s over {len(timed)} requests after one "
        f"warm-up ({sum(faces[1:])} faces, {sum(timed):.6f} s)")
    log(f"  [{card}] peak device memory {peak} B ({peak / 2**30:.6f} GiB)")

    timer = StageTimer(device)
    cropper._fused.stage_timer = timer
    t0 = time.perf_counter()
    cropper.process_images(batches[5])
    total = (time.perf_counter() - t0) * 1e3
    cropper._fused.stage_timer = None
    split = ", ".join(f"{k} {timer.ms.get(k, 0.0):.6f}" for k in cropper._fused.STAGES)
    log(f"  [{card}] stage split (ms, synchronised host clocks): {split}; "
        f"request {total:.6f}")

    if device.type == "cuda":
        t0 = time.perf_counter()
        rows = device_kernels(lambda: cropper.process_images(batches[4]), reps=1)
        wall_us = (time.perf_counter() - t0) * 1e6
        busy = sum(r[1] for r in rows)
        log(f"  [{card}] profiled request: device kernel time {busy:.3f} us of "
            f"{wall_us:.3f} us wall (profiler on); busy share {busy / wall_us:.6f}; "
            f"{sum(r[2] for r in rows)} kernel launches; top kernels:")
        for name, us, count in rows[:8]:
            log(f"    {us:12.3f} us  x{count:4d}  {name[:110]}")

    reference_check(device)

    # -- phase 4 -----------------------------------------------------------
    t_main = timings[max(ks)]
    t_256 = timings.get(256, t_main)
    kernels = {"kernels": [{
        "name": "greedy_nms",
        "route": "cuda",
        "source": "face_crop_plus_tpu_torch/csrc/nms.cu",
        "replaces": "face_crop_plus_tpu/ops/pallas/nms_kernel.py:28",
        "launches": main_launches,
        "max_abs_err": max_err,
        "bitwise_equal": max_err == 0,
        "ms": t_main["ms"],
        "call_ms": t_main["call_ms"],
        "plain_ms": t_main["plain_ms"],
        "bound_ms": t_main["bound_ms"],
        "bound_by": t_main["bound_by"],
        "library_ms": None,
        "shape": f"N={n} K={max(ks)}",
        "ms_k256": t_256["ms"],
        "plain_ms_k256": t_256["plain_ms"],
        "bound_ms_k256": t_256["bound_ms"],
    }]}
    log(json.dumps(kernels))
    if rehearse:
        log("rehearsal finished: every phase ran on the CPU; no ok line")
        return 3
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
