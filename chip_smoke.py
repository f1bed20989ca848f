#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse-cpu   # tiny CPU run of the control flow

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

0. Card identity (``nvidia-smi``), torch/CUDA versions, the precision the
   package pins for its detector (f32: TF32 off inside the package only;
   the script sets no global flag), and the host codecs: whether the
   native JPEG decoder built (else the compiler's message), cv2's and
   PIL's versions.
1. Build the kernels from ``face_crop_plus_tpu_torch/csrc`` (greedy NMS
   and the warp/gather source, one ``nvcc`` each, in parallel) and print
   ``ptxas -v`` (registers, shared memory, spills).
2. NMS kernel vs plain on the card: N = 16, K in {168, 256, 512, 1024},
   random, identical, all-invalid, near-threshold, NaN/inf and the
   detector's own top-K boxes at 1024², plus the word edges K in {1, 63,
   64, 65, 1000} on the same synthetic cases; keep masks must be bitwise
   equal.  Times on the detector's boxes at K in {168, 256, 512, 1024}
   (profiler device time of each of the kernel's two passes, CUDA events
   around the wrapper call and around the plain version, after warm-up),
   beside the bound.
2b. Warp kernel vs plain on the card: all 5 border modes × {no windows,
   per-face windows}, at F = 16 and F = 512 faces from 16×218×178 sources
   (a "largest" request; one strategy-"all" chunk) and F = 512 faces from
   16×1024² uint8 interim sources (the interim window), seeded random
   similarity transforms, some sampling far outside, and NaN/inf matrix
   rows (must not fault; not compared).  Edge cases: an odd output size
   (61×97, unaligned tile heads and tails), near-singular and
   negative-determinant matrices, and 70,000 crops of 8×8 (faces past the
   grid's 65,535 rows).  Every comparison must be bitwise equal (largest
   uint8 difference 0).  Times at each shape (profiler device time,
   wrapper call, plain version, bound from bytes, and ``F.grid_sample`` as
   the library yardstick for constant without windows).
   Then ``gather2d`` (the TPU probe's own function) on the probe's 10
   cases, bitwise equal to ``torch.gather``, timed at 256×256.
3. The "largest" slice at full width: ``Cropper(device="cuda",
   output_size=256, resize_size=1024, strategy="largest",
   det_threshold=-1.0, batch_size=16)`` with seeded random-init RetinaFace
   ResNet-50, driven by ``process_images`` on seeded 16×218×178×3 uint8
   batches; the NMS and warp kernels must launch on every request.
   Faces/s, the stage split and peak memory are printed, and one profiled
   request's kernel time by name.
3b. Strategy "all" at full width, same settings: one warm-up and 3 timed
   requests (faces, crop chunks, launches, grown caps per request; faces/s,
   peak memory, stage split, top kernels); both kernels must launch on
   every request.  One chunk of a later request, with the detector's own
   fit matrices, must equal the plain warp on the same tensors bitwise.
   Then one "all" request with ``crop_source="interim"``
   and one "largest" request with ``crop_source="interim"``.
   Reference check: small inputs on the card and on the CPU (plain path) at
   a 128² interim with tamed weights — "largest" and "all" with
   ``crop_source="interim"`` and ``padding="reflect"`` — must give equal
   indices and crops within ±1 (the network's f32 sums differ between
   cuDNN and the CPU).
5. The directory pipeline at full width, on a directory written with the
   port's own ``imwrite``: 256 JPEGs of 218×178 (the fused path), 8 JPEGs
   of other sizes (one above 2× the interim) and a PNG (the staged path),
   and a corrupt file (warns, skipped); tamed seeded weights written as the
   ``retinaface.npz`` both packages read; 1024² interim, 256² crops, batch
   16, ``det_threshold`` 0.  (a) ``python -m face_crop_plus_tpu_torch`` as
   a subprocess: names exact, every crop 256×256×3.  (b) ``process_dir``
   "largest" with ``num_processes`` 1 and 4: a warm-up, then two timed
   passes each (faces/s, ``Cropper.stats`` split, K1 and warp launches;
   the staged ones must be > 0); the 4-thread tree equals the 1-thread
   tree byte for byte; one staged warp call (windows on the host interim)
   bitwise equal to the plain warp.  (c) strategy "all" (at most 4 faces
   an image), one pass.  (d) card vs CPU on 4 fused + 4 staged images,
   PNG: names equal, pixels within ±1.
4. The ``kernels`` JSON line (phase 5's launches beside the others), the
   card line, and the ``ok`` line last.

The rehearsal runs every phase on the CPU at tiny sizes with the plain
versions (no build, no launch counts; phase 5's CLI with ``-d cpu``) and
exits 3 without an ``ok`` line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

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


def phase2_kernel_vs_plain(cropper, images, ks, edge_ks, n, device, clock, card):
    from face_crop_plus_tpu_torch.ops import nms as plain
    from face_crop_plus_tpu_torch.ops.cuda import nms as kern

    def plain_keep(b, v):
        return plain.greedy_nms_mask(plain.iou_matrix_plus1(b), v, THR)

    rng = np.random.default_rng(2)
    max_err = 0
    timings = {}
    for k in sorted(set(ks) | set(edge_ks)):
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
        if k not in ks:
            continue
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
        passes = {"mask": None, "scan": None}
        if device.type == "cuda":
            rows = [r for r in device_kernels(call, reps=20) if "nms_" in r[0]]
            if rows:
                kernel_ms = sum(r[1] for r in rows) / 20 / 1e3
                for r in rows:
                    passes["mask" if "nms_mask" in r[0] else "scan"] = r[1] / 20 / 1e3
                source = "profiler device time: " + ", ".join(
                    f"{p} pass {t * 1e3:.3f} us" for p, t in passes.items() if t is not None
                )
        timings[k] = dict(
            ms=kernel_ms, call_ms=call_ms, plain_ms=plain_ms,
            mask_pass_ms=passes["mask"], scan_pass_ms=passes["scan"],
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
        )
        if device.type == "cuda":
            # The random-weight detector keeps every candidate, so no word's
            # diagonal block has a bit; the synthetic random boxes overlap
            # and run the scan's in-word chain.
            rb, rv = cases["random"]
            rows = [r for r in device_kernels(lambda: kern.greedy_nms_mask_cuda(rb, rv, THR),  # noqa: B023
                                              reps=20) if "nms_" in r[0]]
            timings[k]["random_ms"] = sum(r[1] for r in rows) / 20 / 1e3
            log(f"  [{card}] N={n} K={k} random boxes ({int(plain_keep(rb, rv).sum())} kept): "
                f"kernel {timings[k]['random_ms']:.6f} ms (profiler device time: " + ", ".join(
                    f"{'mask' if 'nms_mask' in r[0] else 'scan'} pass {r[1] / 20:.3f} us"
                    for r in rows) + ")")
        log(f"  [{card}] N={n} K={k} detector boxes: kernel {kernel_ms:.6f} ms "
            f"({source}), wrapper call {call_ms:.6f} ms, "
            f"plain {plain_ms:.6f} ms, bound {max(t_bytes, t_ops):.6f} ms "
            f"(bytes {t_bytes:.6f} ms for {bytes_moved} B, operations "
            f"{t_ops:.6f} ms for {pairs} kept-row pairs), K-step chain {k} steps")
    return max_err, timings


# ---------------------------------------------------------------------------
# Phase 2b: the warp kernel and gather2d
# ---------------------------------------------------------------------------

BORDER_MODES = ("constant", "replicate", "reflect", "wrap", "reflect_101")


def warp_inputs(rng, n, h, w, f, out_size, window=None):
    """Seeded uint8 sources and F similarity transforms, faces spread evenly.

    Transforms map a face center (some well outside the source or window)
    to the crop center at 0.3-4 crop px per source px.  Every 37th matrix
    is NaN and every 41st has an inf translation (degenerate fits).
    ``window`` (top, left, height, width) tiles one window over all faces;
    otherwise per-face windows are random inside the source.
    """
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    img_idx = (np.arange(f) // max(f // n, 1)).clip(max=n - 1).astype(np.int32)
    s = rng.uniform(0.3, 4.0, f)
    ang = rng.uniform(-np.pi, np.pi, f)
    cx = rng.uniform(-0.5 * w, 1.5 * w, f)
    cy = rng.uniform(-0.5 * h, 1.5 * h, f)
    a, b = s * np.cos(ang), s * np.sin(ang)
    c = out_size / 2.0
    m = np.stack([np.stack([a, -b, c - (a * cx - b * cy)], -1),
                  np.stack([b, a, c - (b * cx + a * cy)], -1)], 1).astype(np.float32)
    m[::37] = np.nan
    m[5::41, 0, 2] = np.inf
    if window is not None:
        win = np.tile(np.asarray(window, np.int32), (f, 1))
    else:
        top = rng.integers(0, h // 4, f)
        left = rng.integers(0, w // 4, f)
        win = np.stack([top, left, rng.integers(1, h - top + 1), rng.integers(1, w - left + 1)],
                       -1).astype(np.int32)
    return images, m, img_idx, win


def _finite_rows(m: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(m.reshape(len(m), -1)).all(dim=1)


def warp_bound(images, m, idx, out_size, mode, win):
    """(bytes, bound ms) of one warp call: crops written, inputs read once.

    Source bytes count the pixels these crops need (nonzero bilinear weight
    in a finite row), found as the nonzero gradient of the plain warp.
    """
    from face_crop_plus_tpu_torch.ops.warp import warp_affine_batch

    ok = _finite_rows(m)
    src = images.to(torch.float32).requires_grad_(True)
    out = warp_affine_batch(src, m[ok], idx[ok], (out_size, out_size), mode,
                            None if win is None else win[ok])
    out.sum().backward()
    touched = int((src.grad != 0).any(dim=-1).sum())
    f = len(m)
    nbytes = f * out_size * out_size * 3 + 3 * touched + f * (24 + 4) + (0 if win is None else 16 * f)
    return nbytes, nbytes / PEAK_BYTES_PER_S * 1e3


def grid_sample_ms(images, m, idx, out_size, clock):
    """``F.grid_sample`` (bilinear, zeros, align_corners) of the same crops.

    The library yardstick for constant without windows: a float NCHW copy
    of the sources and a precomputed grid with each image's faces stacked
    along the height; only the call is timed.  Also returns the largest
    difference of its rounded output from the kernel's (finite rows).
    """
    import torch.nn.functional as F

    from face_crop_plus_tpu_torch.ops.cuda.warp import warp_affine_u8
    from face_crop_plus_tpu_torch.ops.transform import invert_affine
    from face_crop_plus_tpu_torch.ops.warp import _source_coords, to_uint8

    n, h, w, _ = images.shape
    f = len(m)
    per = f // n
    sx, sy = _source_coords(invert_affine(m), (out_size, out_size))
    grid = torch.stack([sx * (2.0 / (w - 1)) - 1.0, sy * (2.0 / (h - 1)) - 1.0], -1)
    grid = grid.reshape(n, per * out_size, out_size, 2).contiguous()
    inp = images.permute(0, 3, 1, 2).to(torch.float32).contiguous()
    call = lambda: F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",  # noqa: E731
                                 align_corners=True)
    ms = clock.ms(call, reps=20)
    lib = to_uint8(call().permute(0, 2, 3, 1).reshape(f, out_size, out_size, 3))
    ours = warp_affine_u8(images, m, idx, (out_size, out_size), "constant")
    ok = _finite_rows(m)
    diff = int((lib[ok].int() - ours[ok].int()).abs().max())
    return ms, diff


def phase2b_warp(device, clock, card, rehearse):
    """The warp kernel vs its plain version, and its times; see the docstring."""
    from face_crop_plus_tpu_torch.ops.cuda import warp as kern
    from face_crop_plus_tpu_torch.ops.warp import to_uint8, warp_affine_batch

    rng = np.random.default_rng(21)
    if rehearse:
        shapes = {"F=4 largest": (2, 40, 30, 4, 32, None),
                  "F=8 all": (2, 40, 30, 8, 32, None),
                  "F=8 interim": (2, 64, 64, 8, 32, (0, 8, 64, 48))}
    else:
        shapes = {"F=16 largest": (16, 218, 178, 16, 256, None),
                  "F=512 all": (16, 218, 178, 512, 256, None),
                  "F=512 interim": (16, 1024, 1024, 512, 256, (0, 94, 1024, 836))}
    max_err, timings = 0, {}
    for label, (n, h, w, f, out, window) in shapes.items():
        images, m, idx, win = (torch.from_numpy(a).to(device)
                               for a in warp_inputs(rng, n, h, w, f, out, window))
        ok = _finite_rows(m)
        log(f"  {label}: {n}x{h}x{w}x3 uint8 sources → {f} crops of {out}², "
            f"{int((~ok).sum())} NaN/inf matrix rows excluded from the comparison")
        for mode in BORDER_MODES:
            for wins in (None, win):
                ours = kern.warp_affine_u8(images, m, idx, (out, out), mode, wins)
                if device.type == "cuda":
                    torch.cuda.synchronize()  # a fault shows here
                plain = to_uint8(warp_affine_batch(images, m, idx, (out, out), mode, wins))
                d = (ours[ok].int() - plain[ok].int()).abs()
                err = int(d.max())
                max_err = max(max_err, err)
                log(f"    {mode:11s} windows={'yes' if wins is not None else 'no ':3s} "
                    f"max |diff| {err}, differing share {float((d > 0).float().mean()):.9f}, "
                    f"bitwise_equal={err == 0}")
                if err > 0:
                    raise SystemExit(f"FAIL: warp kernel differs from plain by {err} ({label}, {mode})")
        for mode, wins in (("replicate", None), ("constant", win), ("constant", None)):
            key = f"{mode}{'+windows' if wins is not None else ''}"
            call = lambda: kern.warp_affine_u8(images, m, idx, (out, out), mode, wins)  # noqa: E731,B023
            call_ms = clock.ms(call, reps=20)
            plain_ms = clock.ms(lambda: to_uint8(warp_affine_batch(  # noqa: B023
                images, m, idx, (out, out), mode, wins)), reps=3, warmup=1)
            kernel_ms, source = call_ms, "CUDA events around the wrapper call"
            if device.type == "cuda":
                rows = [r for r in device_kernels(call, reps=20) if "warp_affine" in r[0]]
                if rows:
                    kernel_ms, source = rows[0][1] / 20 / 1e3, "profiler device time"
            nbytes, bound_ms = warp_bound(images, m, idx, out, mode, wins)
            t = dict(ms=kernel_ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bytes=nbytes, library_ms=None, f=f, out=out)
            extra = ""
            if mode == "constant" and wins is None and device.type == "cuda":
                t["library_ms"], lib_diff = grid_sample_ms(images, m, idx, out, clock)
                extra = (f", F.grid_sample {t['library_ms']:.6f} ms (rounded output within "
                         f"{lib_diff} of the kernel's)")
            timings[(label, key)] = t
            log(f"    [{card}] {label} {key}: kernel {kernel_ms:.6f} ms ({source}), wrapper "
                f"call {call_ms:.6f} ms, plain {plain_ms:.6f} ms, bound {bound_ms:.6f} ms "
                f"(bytes: {nbytes} B){extra}")
        del images, m, idx, win
    max_err = max(max_err, warp_edge_cases(device, rehearse))
    return max_err, timings


def warp_edge_cases(device, rehearse) -> int:
    """Odd output size, near-singular and mirrored fits, faces past 65,535.

    Returns the largest uint8 difference from the plain version (finite
    rows); fails above 0.
    """
    from face_crop_plus_tpu_torch.ops.cuda import warp as kern
    from face_crop_plus_tpu_torch.ops.warp import to_uint8, warp_affine_batch

    rng = np.random.default_rng(23)
    max_err = 0
    # (label, n, h, w, f, (wo, ho), modes)
    cases = [("odd 61x97, singular/mirrored", 4, 218, 178, 64, (61, 97), BORDER_MODES),
             ("past the grid's rows", 4, 64, 64, 2000 if rehearse else 70000, (8, 8),
              ("constant", "reflect"))]
    for label, n, h, w, f, (wo, ho), modes in cases:
        images, m, idx, win = warp_inputs(rng, n, h, w, f, max(wo, ho))
        # Near-singular linear parts (|det| below, at and above the 1e-12
        # epsilon) and mirrored fits (negative determinant).
        m[1, :, :2] = [[1e-6, 0.0], [0.0, 1e-6]]
        m[2, :, :2] = [[1e-6, 0.0], [0.0, -1e-6]]
        m[3, :, :2] = [[2e-6, 1e-6], [4e-6, 2.0000002e-6]]
        m[4, :, :2] = [[3e-7, 0.0], [0.0, 3e-7]]
        m[6::3, 0, :2] *= -1.0
        images, m, idx, win = (torch.from_numpy(a).to(device) for a in (images, m, idx, win))
        ok = _finite_rows(m)
        for mode in modes:
            for wins in (None, win):
                ours = kern.warp_affine_u8(images, m, idx, (wo, ho), mode, wins)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                plain = to_uint8(warp_affine_batch(images, m, idx, (wo, ho), mode, wins))
                err = int((ours[ok].int() - plain[ok].int()).abs().max())
                max_err = max(max_err, err)
                log(f"  edge {label}: {mode:11s} windows={'yes' if wins is not None else 'no ':3s} "
                    f"{f} crops of {wo}x{ho}, max |diff| {err}, bitwise_equal={err == 0}")
                if err > 0:
                    raise SystemExit(f"FAIL: warp kernel differs from plain by {err} ({label}, {mode})")
    return max_err


#: The TPU probe's cases (tools/mosaic_gather_probe.py:58-64): (h, w, axis).
PROBE_CASES = [
    (8, 128, 0), (8, 256, 0), (8, 512, 0), (16, 128, 0), (64, 128, 0), (256, 256, 0),
    (8, 128, 1), (8, 256, 1), (16, 256, 1), (256, 256, 1),
]


def phase_gather2d(device, clock, card):
    """gather2d vs torch.gather on the probe's cases; times at 256×256."""
    from face_crop_plus_tpu_torch.ops.cuda import warp as kern

    rng = np.random.default_rng(22)
    timings = {}
    for h, w, axis in PROBE_CASES:
        hi = h if axis == 0 else w
        idx = torch.from_numpy(rng.integers(0, hi, (h, w)).astype(np.int32)).to(device)
        src = torch.from_numpy(rng.random((h, w)).astype(np.float32)).to(device)
        ours = kern.gather2d(src, idx, axis)
        ref = torch.gather(src, axis, idx.long())
        if device.type == "cuda":
            torch.cuda.synchronize()
        equal = torch.equal(ours, ref)
        log(f"  gather2d {h}x{w} axis {axis}: bitwise_equal={equal}")
        if not equal:
            raise SystemExit(f"FAIL: gather2d != torch.gather at {h}x{w} axis {axis}")
        if (h, w) == (256, 256):
            call = lambda: kern.gather2d(src, idx, axis)  # noqa: E731,B023
            call_ms = clock.ms(call, reps=50)
            lib_ms = clock.ms(lambda: torch.gather(src, axis, idx.long()), reps=50)  # noqa: B023
            kernel_ms = call_ms
            if device.type == "cuda":
                rows = [r for r in device_kernels(call, reps=50) if "gather2d" in r[0]]
                if rows:
                    kernel_ms = rows[0][1] / 50 / 1e3
            distinct = len(torch.unique(idx.long() * w + torch.arange(w, device=device)
                                        if axis == 0 else
                                        torch.arange(h, device=device)[:, None] * w + idx.long()))
            nbytes = 4 * h * w * 2 + 4 * distinct
            timings[axis] = dict(ms=kernel_ms, call_ms=call_ms, plain_ms=lib_ms,
                                 library_ms=lib_ms, bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                                 bytes=nbytes)
            log(f"  [{card}] gather2d 256x256 axis {axis}: kernel {kernel_ms:.6f} ms, wrapper "
                f"call {call_ms:.6f} ms, torch.gather {lib_ms:.6f} ms, bound "
                f"{timings[axis]['bound_ms']:.6f} ms ({nbytes} B)")
    return timings


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


def smooth_batch(rng, shape, cell=8):
    """Smooth, photo-like uint8 images: a coarse random grid, upsampled.

    The strategy "all" check crops every candidate of a random detector,
    some minified 20-50× so that they sample far outside the image; on
    per-pixel noise the f32 rounding of the network (cuDNN vs CPU) moves
    such samples by more than a level, on smooth images it does not.
    """
    n, h, w, c = shape
    coarse = rng.uniform(0, 255, (n, c, h // cell + 2, w // cell + 2)).astype(np.float32)
    up = torch.nn.functional.interpolate(
        torch.from_numpy(coarse), size=(h, w), mode="bilinear", align_corners=False
    )
    return np.clip(np.rint(up.permute(0, 2, 3, 1).numpy()), 0, 255).astype(np.uint8)


def match_faces(lm_a, lm_b, idx):
    """Per image, the face of ``b`` nearest each face of ``a`` by landmarks.

    Returns (order, distance): ``b[order]`` lines up with ``a``; distance is
    the largest landmark difference (px) of a matched pair.  Raises when
    the nearest faces do not form a one-to-one matching.
    """
    order = np.empty(len(idx), np.int64)
    for img in np.unique(idx):
        rows = np.nonzero(idx == img)[0]
        d = np.abs(lm_a[rows][:, None] - lm_b[rows][None]).reshape(len(rows), len(rows), -1)
        near = d.max(-1).argmin(1)
        if len(set(near.tolist())) != len(rows):
            raise SystemExit(f"FAIL: faces of image {img} do not match one to one")
        order[rows] = rows[near]
    return order, float(np.abs(lm_a - lm_b[order]).max()) if len(idx) else 0.0


def reference_check(device):
    """The slice on ``device`` vs on the CPU (plain path), small inputs.

    Strategy "all" returns an image's faces in score order, and the f32
    rounding of the network (cuDNN vs CPU) can swap two faces of nearly
    equal score; its faces are matched by landmarks before the crops are
    compared, and the largest landmark difference is printed in both
    orders.
    """
    from face_crop_plus_tpu_torch import Cropper

    rng = np.random.default_rng(3)
    cases = [
        (dict(strategy="largest", padding="replicate"),
         rng.integers(0, 256, (4, 96, 80, 3), dtype=np.uint8)),
        (dict(strategy="all", padding="reflect", crop_source="interim"),
         smooth_batch(rng, (4, 96, 80, 3))),
    ]
    for extra, batch in cases:
        kw = dict(output_size=64, resize_size=128, det_threshold=-1.0, batch_size=4, **extra)
        a = Cropper(device=device, **kw)
        b = Cropper(device="cpu", **kw)
        sd = tamed_state_dict(b.det_model.net)
        a.det_model.net.load_state_dict(sd)
        b.det_model.net.load_state_dict(sd)
        ca, la, ia = a._fused.process(batch, a.resize_size)
        cb, lb, ib = b._fused.process(batch, b.resize_size)
        if not np.array_equal(ia, ib) or ca.shape != cb.shape:
            raise SystemExit(f"FAIL: reference check {extra} indices {ia} != {ib}")
        in_order = float(np.abs(la - lb).max()) if len(ia) else 0.0
        order, matched = match_faces(la, lb, ia)
        moved = int((order != np.arange(len(order))).sum())
        diff = int(np.abs(ca.astype(np.int16) - cb[order].astype(np.int16)).max()) if len(ca) else 0
        caps = ((a.det_model.pre_topk, a.det_model.max_faces),
                (b.det_model.pre_topk, b.det_model.max_faces))
        log(f"  reference check {extra} ({device} vs cpu, 128² interim, tamed weights): "
            f"{len(ia)} faces, per image {np.bincount(ia, minlength=4).tolist()}; landmark "
            f"max |diff| {in_order:.6g} px in order, {matched:.6g} px matched ({moved} faces "
            f"in another rank); crop max |diff| {diff} (matched); (pre_topk, max_faces) "
            f"{caps[0]}/{caps[1]}")
        if diff > 1 or matched > 1e-2 or caps[0] != caps[1]:
            raise SystemExit("FAIL: reference check crops differ by more than 1 level")


def check_chunk(args, kwargs, label: str = "main-path chunk") -> int:
    """A recorded warp call on the main path, kernel vs plain on its tensors.

    Returns the largest uint8 difference over the rows with finite
    matrices; fails above 0.
    """
    from face_crop_plus_tpu_torch.ops.cuda import warp as kern
    from face_crop_plus_tpu_torch.ops.warp import to_uint8, warp_affine_batch

    images, mats, img_idx = args[:3]
    ours = kern.warp_affine_u8(*args, **kwargs)
    plain = to_uint8(warp_affine_batch(*args, **kwargs))
    ok = _finite_rows(mats)
    d = (ours[ok].int() - plain[ok].int()).abs()
    err = int(d.max()) if len(d) else 0
    log(f"  {label}: {len(mats)} crops from {tuple(images.shape)} sources, "
        f"{int((~ok).sum())} non-finite fits excluded; kernel vs plain max |diff| {err}, "
        f"differing share {float((d > 0).float().mean()) if len(d) else 0.0:.9f}, "
        f"bitwise_equal={err == 0}")
    if err > 0:
        raise SystemExit(f"FAIL: {label}: warp kernel differs from plain by {err}")
    return err


def phase3b_all(Cropper, device, card, n, src_hw, resize, out_size, deadline, rehearse):
    """Strategy "all" at full width.

    Returns (K1 launches, warp launches, the largest warp difference of
    the recorded chunk).
    """
    from face_crop_plus_tpu_torch import pipeline
    from face_crop_plus_tpu_torch.ops.cuda import nms as nms_kern
    from face_crop_plus_tpu_torch.ops.cuda import warp as warp_kern

    kw = dict(device=str(device), output_size=out_size, resize_size=resize,
              det_threshold=-1.0, batch_size=n)
    cropper = Cropper(strategy="all", **kw)
    det = cropper.det_model
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 256, (n, *src_hw, 3), dtype=np.uint8) for _ in range(6)]
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    nms_kern.launches = 0
    warp_kern.launches = 0
    faces, seconds, per_request = [], [], []
    for r, batch in enumerate(batches[:4]):
        if r >= 2 and time.monotonic() > deadline:
            log(f"  time budget: stopping after {r} requests")
            break
        b_nms, b_warp = nms_kern.launches, warp_kern.launches
        t0 = time.perf_counter()
        crops, indices, groups = cropper.process_images(batch)
        seconds.append(time.perf_counter() - t0)
        d_nms, d_warp = nms_kern.launches - b_nms, warp_kern.launches - b_warp
        per_request.append((d_nms, d_warp))
        faces.append(len(indices))
        if (crops.shape != (len(indices), out_size, out_size, 3) or crops.dtype != np.uint8
                or groups != (None, None) or (len(indices) and not (
                    np.all(np.diff(indices) >= 0) and 0 <= indices[0] and indices[-1] < n))):
            raise SystemExit(f"FAIL: 'all' request {r}: crops {crops.shape} {crops.dtype}")
        log(f"  request {r}: F={len(indices)} faces (per image min "
            f"{np.bincount(indices, minlength=n).min()}, max "
            f"{np.bincount(indices, minlength=n).max()}), crop chunks {d_warp}, K1 launches "
            f"{d_nms}, warp launches {d_warp}, pre_topk {det.pre_topk}, max_faces "
            f"{det.max_faces}, {seconds[-1]:.6f} s")
        del crops
    launches = (nms_kern.launches, warp_kern.launches)
    if not rehearse and min(min(p) for p in per_request) < 1:
        raise SystemExit("FAIL: a kernel did not launch on every strategy-'all' request")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    timed = seconds[1:]
    log(f"  [{card}] {sum(faces[1:]) / sum(timed):.6f} faces/s over {len(timed)} requests "
        f"after one warm-up ({sum(faces[1:])} faces, {sum(timed):.6f} s; request seconds "
        + ", ".join(f"{s:.6f}" for s in seconds) + ")")
    log(f"  [{card}] peak device memory {peak} B ({peak / 2**30:.6f} GiB)")

    timer = StageTimer(device)
    cropper._fused.stage_timer = timer
    recorded = []
    real_warp = pipeline.warp_affine_u8

    def recording_warp(*args, **kwargs):
        if not recorded:
            recorded.append((args, kwargs))
        return real_warp(*args, **kwargs)

    pipeline.warp_affine_u8 = recording_warp
    try:
        t0 = time.perf_counter()
        cropper.process_images(batches[4])
        total = (time.perf_counter() - t0) * 1e3
    finally:
        pipeline.warp_affine_u8 = real_warp
    cropper._fused.stage_timer = None
    split = ", ".join(f"{k} {timer.ms.get(k, 0.0):.6f}" for k in cropper._fused.STAGES)
    log(f"  [{card}] stage split (ms, synchronised host clocks; fit_warp and to_host "
        f"summed over the chunks): {split}; request {total:.6f}")
    chunk_err = check_chunk(*recorded[0])
    del recorded
    if device.type == "cuda":
        t0 = time.perf_counter()
        rows = device_kernels(lambda: cropper.process_images(batches[5]), reps=1)
        wall_us = (time.perf_counter() - t0) * 1e6
        busy = sum(r[1] for r in rows)
        log(f"  [{card}] profiled request: device kernel time {busy:.3f} us of "
            f"{wall_us:.3f} us wall (profiler on); busy share {busy / wall_us:.6f}; "
            f"{sum(r[2] for r in rows)} kernel launches; top kernels:")
        for name, us, count in rows[:8]:
            log(f"    {us:12.3f} us  x{count:4d}  {name[:110]}")
    del cropper

    for strategy in ("all", "largest"):
        c = Cropper(strategy=strategy, crop_source="interim", **kw)
        before = warp_kern.launches
        t0 = time.perf_counter()
        crops, indices, _ = c.process_images(batches[1])
        sec = time.perf_counter() - t0
        ok = crops.dtype == np.uint8 and crops.shape == (len(indices), out_size, out_size, 3)
        log(f"  {strategy!r} with crop_source='interim': F={len(indices)} crops "
            f"{crops.shape} {crops.dtype}, warp launches {warp_kern.launches - before}, "
            f"{sec:.6f} s (first request: caps grow)")
        if not ok or (not rehearse and warp_kern.launches == before):
            raise SystemExit(f"FAIL: {strategy!r} interim request: {crops.shape} {crops.dtype}")
        del c, crops
    return (*launches, chunk_err)


# ---------------------------------------------------------------------------
# Phase 5: the directory pipeline
# ---------------------------------------------------------------------------


def photo_like(rng, h, w):
    """Smooth uint8 (h, w, 3) content with mild noise, JPEG-compressible."""
    coarse = rng.uniform(0, 255, (1, 3, h // 16 + 2, w // 16 + 2)).astype(np.float32)
    up = torch.nn.functional.interpolate(torch.from_numpy(coarse), size=(h, w),
                                         mode="bilinear", align_corners=False)
    img = up[0].permute(1, 2, 0).numpy() + rng.normal(0, 4, (h, w, 3))
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def write_directory(path, n_uniform, uniform_hw, ragged_hw, seed=5):
    """The phase-5 input directory, written with the port's own ``imwrite``.

    ``n_uniform`` JPEGs of ``uniform_hw`` (the fused group), one JPEG per
    ``ragged_hw`` entry, one PNG and one corrupt file; the single-shape
    files are spread through the sorted listing, so most file batches mix
    the fused and the staged path.  Returns the readable file names.
    """
    from face_crop_plus_tpu_torch.utils.io import imwrite

    rng = np.random.default_rng(seed)
    os.makedirs(path)
    readable = []
    for i in range(n_uniform):
        readable.append(f"img_{i:04d}.jpg")
        imwrite(os.path.join(path, readable[-1]), photo_like(rng, *uniform_hw))
    step = max(1, n_uniform // (len(ragged_hw) + 2))
    for k, hw in enumerate(ragged_hw):
        readable.append(f"img_{k * step:04d}_r.jpg")
        imwrite(os.path.join(path, readable[-1]), photo_like(rng, *hw))
    k = len(ragged_hw)
    readable.append(f"img_{k * step:04d}_p.png")
    imwrite(os.path.join(path, readable[-1]), photo_like(rng, 97, 131))
    with open(os.path.join(path, f"img_{(k + 1) * step:04d}_z.jpg"), "wb") as f:
        f.write(b"\xff\xd8\xff\xe0 corrupt")
    return sorted(readable)


def write_npz(path, net, seed=1):
    """Tamed seeded weights as the ``retinaface.npz`` both packages read
    (JAX layout: HWIO conv kernels, folded BN)."""
    os.makedirs(path, exist_ok=True)
    arrays = {}
    for key, val in tamed_state_dict(net, seed).items():
        val = val.numpy()
        arrays[key] = np.transpose(val, (2, 3, 1, 0)) if val.ndim == 4 else val
    np.savez(os.path.join(path, "retinaface.npz"), **arrays)


def check_tree(out_dir, expected, out_size, what):
    """Names exactly ``expected``; every file decodes to out_size² × 3."""
    from face_crop_plus_tpu_torch.utils.io import imread_rgb

    got = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
    if got != sorted(expected):
        missing, extra = sorted(set(expected) - set(got)), sorted(set(got) - set(expected))
        raise SystemExit(f"FAIL: {what}: {len(got)} files, expected {len(expected)}; "
                         f"missing {missing[:5]}, unexpected {extra[:5]}")
    for name in got:
        img = imread_rgb(os.path.join(out_dir, name))
        if img is None or img.shape != (out_size, out_size, 3):
            raise SystemExit(f"FAIL: {what}: {name} decodes to "
                             f"{None if img is None else img.shape}")


def tree_diff(dir_a, dir_b) -> tuple[int, int]:
    """(files whose bytes differ, largest decoded pixel difference) of two
    trees with the same names; (-1, -1) when the names differ."""
    from face_crop_plus_tpu_torch.utils.io import imread_rgb

    names = sorted(os.listdir(dir_a))
    if names != sorted(os.listdir(dir_b)):
        return -1, -1
    files, pixels = 0, 0
    for n in names:
        pa, pb = os.path.join(dir_a, n), os.path.join(dir_b, n)
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            if fa.read() == fb.read():
                continue
        files += 1
        pixels = max(pixels, int(np.abs(imread_rgb(pa).astype(np.int16)
                                        - imread_rgb(pb).astype(np.int16)).max()))
    return files, pixels


def fused_batch_sizes(cropper, src, names, sizes, card):
    """Fused ``process`` of n same-shape images for each n: ms a batch and an
    image (CUDA events around the call, after a warm-up call), beside the
    Cropper's own call, which pads the group to ``batch_size``, and the top
    device kernels of one call at the first two sizes."""
    from face_crop_plus_tpu_torch.utils.io import read_images

    images, _ = read_images(names[: max(sizes)], src)
    batch = np.stack(images)
    device = cropper._device
    clock = Clock(device)
    for n in sizes:
        call = lambda: cropper._fused.process(batch[:n], cropper.resize_size)  # noqa: E731,B023
        ms = clock.ms(call, reps=3, warmup=1)
        padded = ""
        if n < cropper.batch_size:
            pad_ms = clock.ms(lambda: cropper._fused_process(batch[:n]), reps=3,  # noqa: B023
                              warmup=1)
            padded = f"; padded to {cropper.batch_size} (the Cropper's call) {pad_ms:.6f} ms"
        log(f"  [{card}] (e) fused process of {n} images: {ms:.6f} ms a batch, "
            f"{ms / n:.6f} ms an image{padded}")
        if device.type == "cuda" and n in sizes[:2]:
            rows = device_kernels(call, reps=1)
            log(f"    {sum(r[1] for r in rows):.3f} us device time, {sum(r[2] for r in rows)} "
                "launches; top kernels:")
            for name, us, count in rows[:5]:
                log(f"    {us:12.3f} us  x{count:4d}  {name[:110]}")


def phase5_directory(device, card, rehearse):
    """The directory pipeline at full width; see the module docstring.

    Returns (K1 launches, warp launches) of the timed "largest" passes and
    the "all" pass, the largest staged-warp difference from plain, and the
    timings for the kernels line.
    """
    from face_crop_plus_tpu_torch import Cropper
    from face_crop_plus_tpu_torch import cropper as cropper_mod
    from face_crop_plus_tpu_torch.models.detection import RetinaFaceNet
    from face_crop_plus_tpu_torch.ops.cuda import nms as nms_kern
    from face_crop_plus_tpu_torch.ops.cuda import warp as warp_kern
    from face_crop_plus_tpu_torch.utils.io import codecs, imread_rgb
    from face_crop_plus_tpu_torch.utils.profiling import PipelineStats

    if rehearse:
        n_uni, uni_hw, resize, out, bs = 12, (40, 30), 64, 32, 4
        ragged = [(160, 130), (50, 70), (33, 45), (64, 48), (20, 28), (90, 60), (70, 70), (25, 40)]
    else:
        n_uni, uni_hw, resize, out, bs = 256, (218, 178), 1024, 256, 16
        ragged = [(2400, 1800), (480, 640), (1080, 1920), (333, 500), (1024, 768),
                  (90, 120), (1500, 1000), (600, 600)]
    work = os.path.join(ROOT, "face_crop_plus_tpu_torch", "_build", "phase5")
    shutil.rmtree(work, ignore_errors=True)
    src, wdir = os.path.join(work, "in"), os.path.join(work, "weights")
    t0 = time.perf_counter()
    readable = write_directory(src, n_uni, uni_hw, ragged)
    log(f"  input: {len(os.listdir(src))} files ({n_uni} JPEGs of {uni_hw[0]}x{uni_hw[1]}, "
        f"{len(ragged)} JPEGs of other sizes up to {max(max(hw) for hw in ragged)} px, one PNG, "
        f"one corrupt) written in {time.perf_counter() - t0:.3f} s; interim {resize}², crops "
        f"{out}², batch {bs}; codecs {json.dumps(codecs())[:400]}")
    kw = dict(output_size=out, resize_size=resize, det_threshold=0.0, batch_size=bs,
              weights_dir=wdir)

    # (a) the CLI, in a process of its own.  -dt 0 keeps every candidate of
    # the tamed detector (a negative threshold switches detection off).
    write_npz(wdir, RetinaFaceNet())
    cli_out = os.path.join(work, "cli")
    cmd = [sys.executable, "-m", "face_crop_plus_tpu_torch", "-i", src, "-o", cli_out,
           "-r", str(resize), "-s", str(out), "-dt", "0", "-b", str(bs), "-w", wdir]
    if rehearse:
        cmd += ["-d", "cpu"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise SystemExit(f"FAIL: the CLI exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    check_tree(cli_out, readable, out, "CLI tree")
    log(f"  (a) CLI `{' '.join(cmd[1:3])} …` exit 0 in {time.perf_counter() - t0:.3f} s "
        f"(process start, build, model init, one pass): {len(readable)} crops, names exact, "
        f"each {out}x{out}x3; corrupt file warned: "
        f"{'Could not read' in proc.stderr}")

    # (b) in-process "largest": one warm-up pass, then two timed passes per
    # thread count.  Stage split from Cropper.stats (summed over threads).
    c = Cropper(device=str(device), strategy="largest", **kw)
    c.process_dir(src, os.path.join(work, "warm"), desc=None)
    real_staged, real_warp = c._detect_crop_staged, cropper_mod.warp_affine_u8
    staged, recorded = [0, 0], []

    def counted_staged(images):
        before = (nms_kern.launches, warp_kern.launches)
        result = real_staged(images)
        staged[0] += nms_kern.launches - before[0]
        staged[1] += warp_kern.launches - before[1]
        return result

    def recording_warp(*args, **kwargs):
        if not recorded:
            recorded.append((args, kwargs))
        return real_warp(*args, **kwargs)

    nms_kern.launches = 0
    warp_kern.launches = 0
    rates, trees = {}, {}
    for n_proc in (1, 4):
        c.num_processes = n_proc
        for rep in range(2):
            dst = os.path.join(work, f"largest_p{n_proc}_{rep}")
            c.stats = PipelineStats()
            if device.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            if n_proc == 1:  # staged launches are exact with one thread
                c._detect_crop_staged = counted_staged
                cropper_mod.warp_affine_u8 = recording_warp
            b_nms, b_warp = nms_kern.launches, warp_kern.launches
            t0 = time.perf_counter()
            try:
                c.process_dir(src, dst, desc=None)
            finally:
                c._detect_crop_staged = real_staged
                cropper_mod.warp_affine_u8 = real_warp
            sec = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
            check_tree(dst, readable, out, f"process_dir num_processes={n_proc}")
            rates.setdefault(n_proc, []).append(len(readable) / sec)
            trees[(n_proc, rep)] = dst
            split = ", ".join(f"{k} {v['seconds']:.6f} s/{v['calls']} calls/{v['items']} items"
                              for k, v in c.stats.as_dict().items())
            log(f"  [{card}] (b) 'largest' num_processes={n_proc} pass {rep}: {len(readable)} "
                f"crops in {sec:.6f} s = {len(readable) / sec:.6f} faces/s; K1 launches "
                f"{nms_kern.launches - b_nms}, warp launches {warp_kern.launches - b_warp}; "
                f"peak device memory {peak} B; stages: {split}")
    dir_nms, dir_warp = nms_kern.launches, warp_kern.launches
    log(f"  (b) launches over the 4 timed passes: K1 {dir_nms}, warp {dir_warp}; of the 2 "
        f"one-thread passes on the staged path: K1 {staged[0]}, warp {staged[1]}")
    if not rehearse and (min(staged) < 1 or dir_nms < 1 or dir_warp < 1):
        raise SystemExit("FAIL: a kernel did not launch on the staged path of process_dir")
    diffs = {(p, r): tree_diff(trees[(1, 0)], trees[(p, r)]) for p, r in trees if (p, r) != (1, 0)}
    log("  (b) against the first one-thread tree (files differing, max pixel |diff|): "
        + ", ".join(f"num_processes={p} pass {r}: {d}" for (p, r), d in diffs.items()))
    if any(d != (0, 0) for d in diffs.values()):
        raise SystemExit("FAIL: process_dir wrote another tree on another pass or thread count")
    staged_err = check_chunk(*recorded[0], label="staged warp (windows, host interim)")
    del recorded
    # Without the device lock, four batches share the card at once.
    c._device_lock = contextlib.nullcontext()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    c.process_dir(src, os.path.join(work, "unlocked"), desc=None)
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    log(f"  [{card}] (b) diagnostic, num_processes=4 without the device lock: "
        f"{len(readable) / sec:.6f} faces/s, peak device memory {peak} B; against the "
        f"one-thread tree (files differing, max pixel |diff|): "
        f"{tree_diff(trees[(1, 0)], os.path.join(work, 'unlocked'))}")
    fused_batch_sizes(c, src, [n for n in readable if "_" not in n[4:]],
                      (16, 15, 12, 10, 8, 4, 2, 1) if not rehearse else (4, 3, 1), card)
    del c

    # (c) strategy "all", one pass, at most 4 faces an image (the tamed
    # detector keeps hundreds of disjoint candidates an image).
    c = Cropper(device=str(device), strategy="all", max_faces=4, auto_grow=False, **kw)
    all_out = os.path.join(work, "all")
    b_nms, b_warp = nms_kern.launches, warp_kern.launches
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the binding caps warn once
        c.process_dir(src, all_out, desc=None)
    sec = time.perf_counter() - t0
    all_nms, all_warp = nms_kern.launches - b_nms, warp_kern.launches - b_warp
    got = sorted(os.listdir(all_out))
    stems = {os.path.splitext(n)[0].rsplit("_", 1)[0] for n in got}
    zeros = {os.path.splitext(n)[0][:-2] for n in got if os.path.splitext(n)[0].endswith("_0")}
    want = {os.path.splitext(n)[0] for n in readable}
    bad = [n for n in got if (im := imread_rgb(os.path.join(all_out, n))) is None
           or im.shape != (out, out, 3)]
    log(f"  [{card}] (c) 'all' (max_faces 4, auto_grow off): {len(got)} crops of "
        f"{len(stems)} images in {sec:.6f} s (first pass of its Cropper) = "
        f"{len(got) / sec:.6f} faces/s; K1 launches {all_nms}, warp launches {all_warp}")
    if stems != want or zeros != want or bad or len(got) > 4 * len(want):
        raise SystemExit(f"FAIL: 'all' tree: {len(got)} files, {len(stems)} sources, bad {bad[:3]}")
    del c

    # (d) the port on the card vs on the CPU, 4 fused + 4 staged images, PNG.
    sub = os.path.join(work, "sub")
    os.makedirs(sub)
    pick = [n for n in readable if "_" not in n[4:]][:4] + \
        [n for n in readable if n.endswith("_r.jpg")][:4]
    for n in pick:
        shutil.copy(os.path.join(src, n), sub)
    fused = None
    for dev in (str(device), "cpu"):
        cd = Cropper(device=dev, strategy="largest", output_format="png",
                     **dict(kw, batch_size=4))
        cd.process_dir(sub, os.path.join(work, f"sub_{dev}"), desc=None)
        fused = fused or cd._fused_shapes
    a_dir, b_dir = os.path.join(work, f"sub_{device}"), os.path.join(work, "sub_cpu")
    names_a, names_b = sorted(os.listdir(a_dir)), sorted(os.listdir(b_dir))
    if names_a != names_b or len(names_a) != len(pick):
        raise SystemExit(f"FAIL: card vs CPU trees differ in names: {names_a} / {names_b}")
    diff = max(int(np.abs(imread_rgb(os.path.join(a_dir, n)).astype(np.int16)
                          - imread_rgb(os.path.join(b_dir, n)).astype(np.int16)).max())
               for n in names_a)
    log(f"  (d) {device} vs cpu, {len(pick)} images ({len(pick) // 2} fused: shapes {fused}; "
        f"{len(pick) - len(pick) // 2} staged), PNG: names equal, max pixel |diff| {diff}")
    if diff > 1:
        raise SystemExit(f"FAIL: card vs CPU crops differ by {diff} > 1")
    shutil.rmtree(work, ignore_errors=True)
    return dict(nms=dir_nms + all_nms, warp=dir_warp + all_warp, staged_nms=staged[0],
                staged_warp=staged[1], staged_err=staged_err,
                faces_per_s={p: r for p, r in rates.items()})


#: f32 operations per output pixel of the warp (coordinates, floor and
#: fraction, four weights, 3 channels of 4 products and 3 sums, rounding).
WARP_OPS_PER_PIXEL = 48


def _rows(timings: dict) -> dict:
    return {f"{label} {key}": {k: t[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                                    "library_ms")}
            for (label, key), t in timings.items()}


def warp_row(wtimings, max_err, launches_largest, launches_all, p5) -> dict:
    """The ``kernels`` entry of warp_affine_u8 at phase 3b's chunk shape.

    One strategy-"all" chunk: 512 faces from the 16 original sources,
    constant border, no windows; the other shapes are under ``cases``.
    """
    label = next(lab for lab, _ in wtimings if lab.endswith(" all"))
    t = wtimings[(label, "constant")]
    f, out = t["f"], t["out"]
    t_ops = WARP_OPS_PER_PIXEL * f * out * out / PEAK_F32_FLOPS * 1e3
    return {
        "name": "warp_affine_u8",
        "route": "cuda",
        "source": "face_crop_plus_tpu_torch/csrc/warp.cu",
        "replaces": "tools/mosaic_gather_probe.py:40",
        "redesigned": "PR 3",
        "launches": launches_largest + launches_all + p5["warp"],
        "launches_largest": launches_largest,
        "launches_all": launches_all,
        "launches_directory": p5["warp"],
        "launches_directory_staged": p5["staged_warp"],
        "max_abs_err": max_err,
        "bitwise_equal": max_err == 0,
        "ms": t["ms"],
        "call_ms": t["call_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": max(t["bound_ms"], t_ops),
        "bound_by": "bytes" if t["bound_ms"] >= t_ops else "operations",
        "library_ms": t["library_ms"],
        "shape": f"{label}: {f} crops of {out}² from the original uint8 sources, constant, "
                 "no windows",
        "cases": _rows(wtimings),
    }


def gather_row(gtimings, launches) -> dict:
    """The ``kernels`` entry of gather2d (256×256, axis 0; axis 1 beside)."""
    t, t1 = gtimings[0], gtimings[1]
    return {
        "name": "gather2d",
        "route": "cuda",
        "source": "face_crop_plus_tpu_torch/csrc/warp.cu",
        "replaces": "tools/mosaic_gather_probe.py:40",
        "launches": launches,
        "launches_from": "its own check phase: not on the main path",
        "max_abs_err": 0.0,
        "bitwise_equal": True,
        "ms": t["ms"],
        "call_ms": t["call_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "library_ms": t["library_ms"],
        "shape": "256x256 f32, axis 0",
        "ms_axis1": t1["ms"],
        "library_ms_axis1": t1["library_ms"],
        "bound_ms_axis1": t1["bound_ms"],
    }


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
    from face_crop_plus_tpu_torch.ops.cuda import warp as warp_kern

    # Cut phase 3b's timed requests, never its width, past this point.
    deadline = time.monotonic() + 780.0

    device = torch.device("cpu" if rehearse else "cuda")
    clock = Clock(device)

    # -- phase 0 -----------------------------------------------------------
    card = card_line(rehearse)
    log(f"phase 0: card: {card}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    from face_crop_plus_tpu_torch.utils.device import compute_precision
    from face_crop_plus_tpu_torch.utils.io import codecs

    log(f"  detector precision (as the package pins it): {json.dumps(compute_precision())}; "
        f"process-wide flags outside it: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    for name, status in codecs().items():
        log(f"  codec {name}: {status if status is not None else 'absent'}")

    # -- phase 1 -----------------------------------------------------------
    if rehearse:
        log("phase 1: build skipped (rehearsal: no nvcc)")
    else:
        t0 = time.perf_counter()
        sources = ("nms.cu", "warp.cu")
        with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source at once
            list(pool.map(build.load_library, sources))
        log(f"phase 1: built csrc/{{{','.join(sources)}}} in parallel in "
            f"{time.perf_counter() - t0:.3f} s")
        for source in sources:
            info = build.build_info[source]
            log(f"  csrc/{source}: nvcc {info['seconds']:.3f} s")
            for line in info["log"].splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    log("  ptxas: " + line.strip())

    # -- models ------------------------------------------------------------
    if rehearse:
        n, ks, edge_ks, src_hw, resize, out_size = 2, (168,), (1, 65), (40, 30), 64, 32
    else:
        n, ks, src_hw, resize, out_size = 16, (168, 256, 512, 1024), (218, 178), 1024, 256
        edge_ks = (1, 63, 64, 65, 1000)
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
    max_err, timings = phase2_kernel_vs_plain(cropper, images0, ks, edge_ks, n, device, clock,
                                              card)
    del images0

    # -- phase 2b ----------------------------------------------------------
    log("phase 2b: warp kernel vs plain, 5 border modes x {no windows, windows}")
    warp_err, wtimings = phase2b_warp(device, clock, card, rehearse)
    warp_kern.gather2d_launches = 0
    gtimings = phase_gather2d(device, clock, card)
    gather_launches = warp_kern.gather2d_launches
    if not rehearse and gather_launches == 0:
        raise SystemExit("FAIL: the gather2d kernel did not launch")

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
    warp_kern.launches = 0
    per_request = []
    warp_per_request = []
    seconds = []
    faces = []
    for r, batch in enumerate(batches[:5]):
        before = kern.launches
        before_warp = warp_kern.launches
        t0 = time.perf_counter()
        crops, indices, groups = cropper.process_images(batch)
        seconds.append(time.perf_counter() - t0)
        per_request.append(kern.launches - before)
        warp_per_request.append(warp_kern.launches - before_warp)
        faces.append(len(indices))
        if crops.shape != (n, out_size, out_size, 3) or crops.dtype != np.uint8:
            raise SystemExit(f"FAIL: request {r}: crops {crops.shape} {crops.dtype}")
        if not np.array_equal(indices, np.arange(n)) or groups != (None, None):
            raise SystemExit(f"FAIL: request {r}: indices {indices}")
    main_launches = kern.launches
    warp_main_launches = warp_kern.launches
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    log(f"  K1 launches per request {per_request}, warp launches per request "
        f"{warp_per_request} (pre_topk now {cropper.det_model.pre_topk}); request seconds "
        + ", ".join(f"{s:.6f}" for s in seconds))
    if not rehearse and (min(per_request) < 1 or min(warp_per_request) < 1):
        raise SystemExit("FAIL: the NMS or warp kernel did not launch on every request")
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
    del cropper

    # -- phase 3b ----------------------------------------------------------
    log(f"phase 3b: strategy 'all', {n}x{src_hw[0]}x{src_hw[1]}x3 → {resize}² "
        f"RetinaFace ResNet-50 → {out_size}² crops of every kept face")
    all_nms, all_warp, chunk_err = phase3b_all(Cropper, device, card, n, src_hw, resize, out_size,
                                    deadline, rehearse)

    reference_check(device)

    # -- phase 5 -----------------------------------------------------------
    log("phase 5: directory pipeline: process_dir and the CLI, fused + staged paths")
    p5 = phase5_directory(device, card, rehearse)

    # -- phase 4 -----------------------------------------------------------
    t_main = timings[max(ks)]
    t_256 = timings.get(256, t_main)
    kernels = {"kernels": [{
        "name": "greedy_nms",
        "route": "cuda",
        "source": "face_crop_plus_tpu_torch/csrc/nms.cu",
        "replaces": "face_crop_plus_tpu/ops/pallas/nms_kernel.py:28",
        "redesigned": "PR 3",
        "launches": main_launches + all_nms + p5["nms"],
        "launches_largest": main_launches,
        "launches_all": all_nms,
        "launches_directory": p5["nms"],
        "launches_directory_staged": p5["staged_nms"],
        "max_abs_err": max_err,
        "bitwise_equal": max_err == 0,
        "ms": t_main["ms"],
        "call_ms": t_main["call_ms"],
        "plain_ms": t_main["plain_ms"],
        "bound_ms": t_main["bound_ms"],
        "bound_by": t_main["bound_by"],
        "library_ms": None,
        "shape": f"N={n} K={max(ks)}",
        "ms_random_boxes": t_main.get("random_ms"),
        "mask_pass_ms": t_main["mask_pass_ms"],
        "scan_pass_ms": t_main["scan_pass_ms"],
        "ms_k256": t_256["ms"],
        "mask_pass_ms_k256": t_256["mask_pass_ms"],
        "scan_pass_ms_k256": t_256["scan_pass_ms"],
        "plain_ms_k256": t_256["plain_ms"],
        "bound_ms_k256": t_256["bound_ms"],
    }, warp_row(wtimings, max(warp_err, chunk_err, p5["staged_err"]), warp_main_launches,
               all_warp, p5),
        gather_row(gtimings, gather_launches)]}
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
