#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path on one NVIDIA GPU and checks it.

    python3 chip_smoke.py                  # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse-cpu   # tiny CPU run of the control flow

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

0. Card identity (``nvidia-smi``), torch/CUDA versions, the precision
   each model reports when built with its defaults (``compute_precision``:
   float32, TF32 off inside the package only; the script sets no global
   flag), and the host codecs: whether the
   native JPEG decoder built (else the compiler's message), cv2's and
   PIL's versions.
1. Build the kernels from ``face_crop_plus_tpu_torch/csrc`` (greedy NMS,
   the warp/gather source and the two epilogues, one ``nvcc`` each, in
   parallel) and print ``ptxas -v`` (registers, shared memory, spills).
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
2c. The convolutions' epilogue (``csrc/bn_act.cu``: folded BN, residual,
   ReLU) vs its plain version: every one of the 69 epilogues of a seeded
   detector forward at 16×1024², bitwise; edge cases (NaN, ±0, ±inf; every
   residual kind with and without ReLU; N = 1, odd and tiny planes,
   unaligned inputs, channel slices, in place); each distinct epilogue's
   time beside the plain version's and its bound by bytes; the whole
   forward with the kernel and with the plain passes, bitwise, both timed.
3. The "largest" slice at full width: ``Cropper(device="cuda",
   output_size=256, resize_size=1024, strategy="largest",
   det_threshold=-1.0, batch_size=16)`` with seeded random-init RetinaFace
   ResNet-50, driven by ``process_images`` on seeded 16×218×178×3 uint8
   batches; the NMS and warp kernels, and bn_act 69 times, must launch on
   every request.
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
   PNG: names equal, pixels within ±1.  (e) Fused process of n images at
   several n, and the staged detect of n interims for n = 1…16, unpadded
   and padded as the Cropper pads it (``STAGED_PAD_SIZES``).
6. Parsing at full width: BiSeNet (ResNet-18 trunk, context path, feature
   fusion) at 512², 19 classes, seeded tamed weights, batch 16, behind
   phase 3's detector and crops; groups: a positive attribute, a negative
   one, a multi-class group OR-joined, and mask groups, one of which
   ("face") nearly every face joins.  (a) ``process_images`` with groups on
   phase 3's batches: the parser's parameters on the card, K1 and the warp
   launched on every request, groups not empty; request seconds, faces/s
   beside phase 3's, the stage "parse", peak memory, one profiled request's
   top kernels; parse times of 16 crops, of 15 padded to 16 and (a
   diagnostic) of 15 unpadded; the parser's multiply-adds a face.  (b) The
   card against the CPU on 4 crops: labels equal except where the CPU's
   top-2 logit margin is at most 1e-3 (counted), counts within those
   flips, groups equal.  (c) ``process_dir`` with groups over phase 5's
   directory, "largest" with 1 thread (2 passes) and 4 (1 pass): trees byte
   for byte equal, every ``<attr>/<mask>`` directory beside its ``_mask``,
   faces/s; then "all" at 4 faces an image, whose pure batches hand the
   parser their crops on the device (counted, must be > 0).  (d) The
   landmark-free mode through the CLI (``-dt -1 -ag … -mg …``) over the
   directory's uniform originals.
7. Enhancement at full width: RRDBNet x4 (23 RRDBs, nf 64, gc 32) with
   seeded tamed weights (He init through 23 blocks saturates every pixel).
   (a) One 128² image through the network on the card and on the CPU: the
   f32 x4 output's difference, the enhanced uint8 within ±1, at least half
   the pixels strictly inside 1…254.  (b) ``process_images`` on phase 3's
   first batch with a threshold midway between the 2nd and 3rd smallest
   mean face factors (2 of 16 gated): one warm-up and 3 timed requests
   (faces/s, launches, peak memory, the stage split with "enhance"), one
   gated 1024² interim through ``enhance_device`` alone (ms, multiply-adds
   a pixel counted by conv hooks, TFLOP/s, the f32 bound, a profiled
   call's top kernels); the non-gated crops bitwise equal to the same call
   without an enhancer.  (c) A ragged 3-image ``process_images`` (the
   staged path) with one image gated, card vs CPU at a 128² interim: crops
   within ±1, ±2 on the gated face.  (d) ``process_dir`` over phase 5's
   directory with a threshold gating 3 images (from a warm-up pass's
   recorded factors), 1 and 4 threads: trees byte-equal, faces/s.  (e) The
   landmark-free CLI ``-dt -1 -et 1`` over 16 uniform originals and the
   2400×1800 file: every image enhanced, peak memory.  (f) A diagnostic:
   TF32 allowed inside the enhancer, its time and its level differences
   from f32.  (g), run first: the enhancer's convolution epilogue
   (``csrc/rrdb_act.cu``) on every epilogue of one 1024² forward of the
   tamed network, bitwise against its plain version and the module's own
   convolution; edge cases; each distinct epilogue timed from a cold L2
   beside its bound by bytes; the whole forward against its composition
   before the kernel (``torch.cat``, ATen passes): bits equal, times,
   peak memory.  The phase's wall time.
8. The host path at full width, on phase 5's directory, with
   ``build_status()`` of the native host library printed first (where it
   does not build for want of libjpeg, no host warp, 4:2:0 codec or packed
   decode exists and every crop is the warp kernel's).  (a) The
   landmark-file mode: 5-point landmarks of every readable file from the
   tamed detector, written as a CelebA-style whitespace file in which
   every 11th file has no row and every 7th two rows; ``process_dir`` with
   strategy "all" (``_0``/``_1`` names), batch 64, 256² crops, constant
   border, 1 thread (2 passes) and 4 threads: names exact, trees byte-equal,
   the warp kernel launched on every batch, K1 never, faces/s; then 16
   files in all five border modes, card vs CPU, PNG, within ±1.  (b) The
   landmark mode with BiSeNet (512², tamed) over 64 files, card vs CPU on
   4 crops as phase 6 (b) holds them; with RRDBNet (23 RRDBs, tamed) over
   16 files, the threshold midway between the 2nd and 3rd smallest mean
   face factors (2 gated), card vs CPU: gated crops within ±2, plain ones
   ±1.  (a) and (b) run under ``FCPT_HOST_CROP=auto``, whose gates must
   be off on the card.  (c) ``FCPT_HOST_CROP=1`` on phase 3's batches
   beside the default, with phase 3's random-init detector and with
   tamed detector weights (as phase 7 (b) tames them): the detect-only
   program (K1 on every request), numpy fits, the warp that ran (the
   kernel, the native warp being absent), indices equal, pixels within ±2
   (random detector: faces of thousands of pixels, where the host's and
   the device's fits differ most) and ±1 (tamed), faces/s of each.
   (d) The packed wire's device half
   on rows packed by ``rgb_to_yuv420_np`` from phase 3's first batch: the
   device reconstruction and packing bitwise equal to the numpy twins;
   "largest" on packed rows equal to "largest" on their reconstruction;
   "all" with ``pack_crops``: rows bitwise equal to the numpy packing of
   the RGB crops, the ``to_host`` stage and its bytes beside the RGB
   fetch.  The phase's wall time.
9. Serving and sharding.  (a) Phase 3's configuration (random-init
   detector, "largest", 16×218×178 batches) through
   ``process_images_stream`` at depths 1, 2 and 3 beside a per-call
   ``process_images`` loop, 24 seeded requests each after one warm-up:
   every yield bitwise equal to the loop's, faces/s and request latency
   p50/p99 (from the generator pulling a batch to yielding its result),
   K1 and the warp launched once per request; the host time to return
   from one dispatch (``FusedPipeline.process_async``) on an idle card
   (the median of 9 dispatches, each after a synchronize; every sample
   printed), and of its upload during the depth-2 stream (the median of
   its dispatches), each under a tenth of the network's ms (uploads go
   through pinned memory without waiting); the
   whole dispatch's host time in the stream beside a probe of the CUDA
   launch queue (how many launches the host enqueues behind a busy card
   before one blocks); 8 requests profiled at depth 2 beside 8 per-call
   ones: the device's busy share and its longest idle gaps.  (c) A mixed
   stream (uniform, uniform, ragged in three shapes, empty, uniform):
   order kept, results equal to per-call; strategy "all" (max_faces 64,
   auto_grow off) through the stream, serialized, equal to per-call.
   (b) ``FCPT_HOST_CROP=1`` with the tamed detector on smooth batches:
   the stream at depth 2 equal to per-call; with ``pack_upload`` indices
   equal to the RGB stream and mean pixel difference < 4 (the JAX
   package's band); the gate states (no native warp on the card's
   machine: the warp kernel crops, after a second upload).  (d) Phase 6's
   BiSeNet configuration, 8 requests at depth 2: crops and groups equal to
   per-call.  (e) ``python -m face_crop_plus_tpu_torch -si auto`` as two
   processes (``RANK`` 0/1, ``WORLD_SIZE`` 2, ``LOCAL_RANK`` 0) on the one
   card over the uniform 218×178 JPEGs of phase 5's directory, PNG (a
   shard's batches hold other files than one process's, and a ragged
   file's path hangs on its batch): the two name sets partition a
   one-process run's, pixels within ±1 (files differing counted), the
   pair's wall time beside one process's.  The phase's wall time.
10. The in-process data mesh, phase 3's settings (1024² interim, 256²
   crops, batch 16, its 16×218×178 batches) with phase 5's tamed detector
   weights: the random-init detector's fits of huge faces magnify the f32
   rounding of another batch size into several levels.
   Its batches are smooth (``smooth_batch``) at phase 3's 16×218×178:
   "all" crops every candidate, some minified 20-50×, and on per-pixel
   noise another batch size's f32 rounding moves their samples by several
   levels; phase 3's noise batch runs at S = 4 as a diagnostic.
   (a) ``Cropper(mesh=...)`` over a mesh of the one card: "largest" on
   5 batches and "all" (one request after a warm-up) bitwise
   equal to a single-device ``Cropper`` (crops, indices), K1 and the
   warp launched by the one shard on every pass.  (b) Meshes repeating
   the card, ``make_mesh(devices=[cuda:0] * S)`` for S = 2 and 4: indices
   exactly the single device's, crops within ±1 (cuDNN may pick other
   algorithms at 8 or 4 rows a shard); every shard's detect pass launches
   K1 once and the warp at least once (counted a shard, by spies on the
   per-shard calls); 13 images over 4 shards give 13 images' faces and
   none of the padding rows'; faces/s and peak memory beside phase 3's,
   and the host time to enqueue all S shards.  (c) Every stage on a mesh
   of 2 repeated cards: ``process_dir`` over phase 5's directory, strategy
   "all" (2 faces an image at most), tamed RRDBNet (23 RRDBs) gating 3
   images (a threshold midway between two factors of a warm-up pass),
   tamed BiSeNet at 512² with an attribute and a mask group, PNG: the
   fused path ran, the gated rows went through the shard-local SR, the
   tree's names equal the single device's, crops within ±1, mask pixels
   (labels near ties may flip at another batch size) differing at most
   1e-3 of them; ``FusedPipeline.process(packed_hw=...)`` on rows packed
   by ``rgb_to_yuv420_np``: indices equal to the RGB run.  (d) With two
   cards or more: (a)'s and (b)'s checks over ``make_mesh()`` (every card;
   ±1), and ``Cropper(device="cuda:{n-1}")`` bitwise equal to cuda:0;
   with one card a line says (d) did not run.  The phase's wall time.
11. The weights' host path and the package surface, phase 3's settings
   (1024² interim, 256² crops, batch 16, "largest") with phase 6's
   groups.  (a) Phase 5's tamed detector and phase 6's tamed parser
   weights written as reference-form ``.pth`` checkpoints (unfolded BN,
   OIHW) under the released filenames in a "server" directory; with an
   empty ``FCPT_CACHE_DIR`` and ``FCPT_WEIGHTS_URL`` a ``file://`` root to
   it, ``Cropper(device="cuda", ...)`` fetches both, converts them and
   caches each ``.npz``: the networks' weights are the checkpoints',
   bitwise; 3 of phase 3's requests are bitwise equal (crops, indices,
   groups) to a Cropper given the same weights by ``load_state_dict``;
   the construction's time with the fetch and conversion beside one that
   reads the cache.  (b) ``python -m face_crop_plus_tpu_torch.convert
   --verify`` on each checkpoint (two processes at once): exit 0, archives
   equal to (a)'s cache array for array.  (c) One request under
   ``utils.profiling.trace``: the Chrome trace it writes holds
   ``nms_mask_kernel``, ``nms_scan_kernel`` and ``warp_affine_u8_kernel``
   events as many times as the wrappers' counters launched them; the
   trace's size and the three kernels' device µs.  (d) The ``models``,
   ``ops`` and ``utils`` re-exports import; ``as_device`` puts phase 3's
   16×218×178 batch on the card as float32 NHWC and ``as_numpy`` brings it
   back bitwise; ``host_speed_probe()`` with the codec that served it (a
   host number).  The fetch is on only inside (a): the script sets
   ``FCPT_NO_DOWNLOAD=1`` for every other phase and subprocess.  The
   phase's wall time.
12. The models' ``compute_dtype``, bfloat16 against float32 at full
   width, with phase 5's tamed detector, phase 6's tamed parser and
   phase 7's tamed enhancer (23 RRDBs) on smooth batches.  (a)
   ``FusedPipeline`` "largest" with ``RetinaFace(compute_dtype=...)``,
   16×218×178 → 1024² → 256² crops: each network's median of 5 calls by
   CUDA events, TFLOP/s of the multiply-adds counted by conv hooks
   beside the f32 and the dense bf16 peaks; 5 requests each after a
   warm-up (K1 and the warp once per request); one request's landmarks
   (max and median px) and crops (levels), bf16 against f32; that bf16
   request's K1 keep mask and warp crops bitwise equal to their plain
   versions on the recorded inputs; one 1024² image of the card's bf16
   network against the CPU's bf16 and f32, held to the test suite's
   relative band by the mean (no farther from the CPU's bf16 than the
   CPU's bf16 is from its f32; the largest and 99th-percentile
   differences printed).  (b) ``BiSeNet.predict`` of (a)'s
   16 bf16 crops at 512², each dtype: the median of 5 calls, TFLOP/s,
   the share of labels equal.  (c) ``enhance_device`` of one 1024²
   interim, each dtype: the median of 2 calls, TFLOP/s, peak device
   memory, the output's level differences.  The phase's wall time.
4. The ``kernels`` JSON line (phase 5's to 12's launches beside the
   others), the card line, and the ``ok`` line last.

Phases 3-7 and 9-12 run with ``FCPT_HOST_CROP=0``: they hold the device path,
which "auto" gives on a card, in the CPU rehearsal too.

The rehearsal runs every phase on the CPU at tiny sizes with the plain
versions (no build, no launch counts; phase 5's CLI with ``-d cpu``) and
exits 3 without an ``ok`` line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

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


def release_cached(device: torch.device) -> str:
    """Releases this process's cached device memory to the card before a
    subprocess shares the card (the caching allocator keeps what earlier
    phases freed), and says how much there was."""
    if device.type != "cuda":
        return "no card"
    import gc

    gc.collect()
    held = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    return (f"this process's cached device memory {held} B before the subprocess, "
            f"{torch.cuda.memory_reserved()} B after releasing it")


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


def _bn_act_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _special_planes(rng, shape, device):
    """Normal floats with NaN, ±0, ±inf and tiny negatives planted."""
    x = rng.normal(0, 2, shape).astype(np.float32)
    flat = x.reshape(-1)
    k = max(1, flat.size // 16)
    picks = rng.permutation(flat.size)[:6 * k] if flat.size < 96 else rng.integers(0, flat.size, 6 * k)
    for j, v in enumerate((np.nan, 0.0, -0.0, np.inf, -np.inf, -1e-30)):
        flat[picks[j * k:(j + 1) * k]] = v
    return torch.from_numpy(x).to(device)


def _special_bn(rng, c, device):
    from face_crop_plus_tpu_torch.ops.nn import FoldedBatchNorm

    bn = FoldedBatchNorm(c)
    scale = rng.uniform(-1.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.5, c).astype(np.float32)
    scale[::7], bias[1::5], bias[2::5] = 0.0, 0.0, -0.0
    bn.scale.copy_(torch.from_numpy(scale))
    bn.bias.copy_(torch.from_numpy(bias))
    return bn.to(device)


def _bn_act_bytes(numel: int, kind: str) -> int:
    """Bytes the epilogue must move: x read and y written, the residual
    (or the downsample's input) read."""
    return 4 * numel * (2 + (kind != "none"))


def _device_ms(fn, clock, device, reps: int = 20) -> float:
    """Device ms a call from HBM: CUDA events around each of ``reps``
    calls, each after a 128 MB fill that evicts the 50 MB L2 (outside the
    events), after a warm-up; the host clock in the rehearsal.  Every
    launch is enqueued behind a ~20 ms spin kernel, so the wrapper's host
    time between small launches never shows between the events.  (The
    profiler's kernel time loses events late in a long process: it saw 11
    of 20 launches there, reading 160 % of the HBM bound.)"""
    if device.type != "cuda":
        return clock.ms(fn, reps=3)
    flush = torch.empty(2**25, device=device)
    fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)  # ~20 ms at the H100's ~1.98 GHz
    for start, end in events:
        flush.fill_(1.0)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / reps


def phase2c_bn_act(device, clock, card, rehearse):
    """The convolutions' epilogue (``csrc/bn_act.cu``) against its plain
    version on the card.

    (a) Every epilogue of one seeded detector forward at 16×1024² (tamed
    weights), the kernel's output bitwise against the plain version on a
    copy of the same inputs.  (b) Edge cases on planted NaN, ±0 and ±inf:
    every residual kind with and without ReLU at N = 1, odd and tiny planes,
    a plane longer than one unit, unaligned inputs and channel slices, in
    place.  (c) Each distinct epilogue of (a) timed from a cold L2 (device
    time by CUDA events, :func:`_device_ms`, of the kernel into a separate
    buffer, and of the plain version's kernels), beside its bound by bytes; summed over the
    forward's launches.  (d) The whole forward with
    the kernel and with the plain passes patched in, in the package's f32
    (TF32 off): outputs bitwise equal, device times (median of 5 by CUDA
    events).

    Returns the numbers of the kernels line.
    """
    from face_crop_plus_tpu_torch.models import backbones, detection
    from face_crop_plus_tpu_torch.ops import nn as nn_ops
    from face_crop_plus_tpu_torch.ops.cuda import bn_act as kern
    from face_crop_plus_tpu_torch.utils.device import f32_precision

    n, hw = (2, 64) if rehearse else (16, 1024)
    start_launches = kern.launches
    net = detection.RetinaFaceNet()
    net.load_state_dict(tamed_state_dict(net, seed=3))
    net = net.to(device).eval().requires_grad_(False)
    x_in = torch.from_numpy(
        np.random.default_rng(31).normal(0, 60, (n, 3, hw, hw)).astype(np.float32)).to(device)

    # (a) every epilogue of one forward.
    real = nn_ops.bn_act
    seen = []

    def spy(x, bn, relu=False, residual=None, residual_bn=None, out=None):
        kind = "none" if residual is None else "plain" if residual_bn is None else "affine"
        want = nn_ops.bn_act_plain(x.clone(), bn, relu, residual, residual_bn)
        got = real(x, bn, relu, residual, residual_bn, out)
        same = torch.equal(_bn_act_bits(got), _bn_act_bits(want))
        seen.append((tuple(x.shape), relu, kind, out is not None, same))
        return got

    with torch.no_grad(), f32_precision(), mock.patch.object(backbones, "bn_act", spy), \
            mock.patch.object(detection, "bn_act", spy):
        net(x_in)
    if device.type == "cuda":
        torch.cuda.synchronize()
    bad = [s for s in seen if not s[-1]]
    log(f"  (a) {len(seen)} epilogues of one {n}x{hw}² forward: "
        f"{len(seen) - len(bad)} bitwise equal to the plain version")
    if bad or len(seen) != 69:
        raise SystemExit(f"FAIL: bn_act kernel != plain at {bad[:3]} ({len(seen)} epilogues)")

    # (b) edge cases.
    rng = np.random.default_rng(32)
    cases = 0
    for shape in ((1, 7, 9, 11), (3, 5, 1, 1), (2, 3, 67, 129), (1, 2, 1, 4099),
                  (1, 64, 64, 64)):
        for kind in ("none", "plain", "affine"):
            for relu in (False, True):
                for mode in ("in place", "slice", "unaligned"):
                    c = shape[1]
                    numel = int(np.prod(shape))
                    if mode == "unaligned":
                        x = _special_planes(rng, (numel + 1,), device)[1:].view(shape)
                    else:
                        x = _special_planes(rng, shape, device)
                    bn = _special_bn(rng, c, device)
                    res = None if kind == "none" else _special_planes(rng, shape, device)
                    res_bn = _special_bn(rng, c, device) if kind == "affine" else None
                    want = nn_ops.bn_act_plain(x.clone(), bn, relu, res, res_bn)
                    out = None
                    if mode == "slice":
                        big = torch.full((shape[0], c + 4, *shape[2:]), 7.0, device=device)
                        out = big[:, 1:1 + c]
                    got = nn_ops.bn_act(x, bn, relu=relu, residual=res, residual_bn=res_bn,
                                        out=out)
                    if device.type == "cuda":
                        torch.cuda.synchronize()
                    ok = torch.equal(_bn_act_bits(got), _bn_act_bits(want))
                    if mode == "slice":
                        ok = ok and bool((big[:, :1] == 7).all()) and bool((big[:, 1 + c:] == 7).all())
                    elif not rehearse:
                        ok = ok and got.data_ptr() == x.data_ptr()
                    if not ok:
                        raise SystemExit(f"FAIL: bn_act kernel != plain at {shape} {kind} "
                                         f"relu={relu} {mode}")
                    cases += 1
    log(f"  (b) {cases} edge cases (NaN, ±0, ±inf; N = 1, odd and tiny planes, unaligned "
        "inputs, slices, in place): bitwise equal")

    # (c) each distinct epilogue timed.
    configs = {}
    for shape, relu, kind, _sliced, _same in seen:
        configs[shape, relu, kind] = configs.get((shape, relu, kind), 0) + 1
    rows = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0}
    for (shape, relu, kind), count in configs.items():
        x = torch.randn(shape, device=device)
        bn = _special_bn(rng, shape[1], device)
        res = None if kind == "none" else torch.randn(shape, device=device)
        res_bn = _special_bn(rng, shape[1], device) if kind == "affine" else None
        y = torch.empty_like(x)
        ms = _device_ms(lambda: nn_ops.bn_act(x, bn, relu=relu, residual=res,  # noqa: B023
                                              residual_bn=res_bn, out=y),  # noqa: B023
                        clock, device)
        plain_ms = _device_ms(lambda: nn_ops.bn_act_plain(x, bn, relu, res, res_bn),  # noqa: B023
                              clock, device)
        nbytes = _bn_act_bytes(x.numel(), kind)
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        rows.append(dict(shape=list(shape), relu=relu, residual=kind, launches=count,
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms))
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                         ("bytes", nbytes)):
            tot[key] += count * val
        log(f"  [{card}] {tuple(shape)} relu={relu} residual={kind} x{count}: kernel "
            f"{ms:.6f} ms, plain {plain_ms:.6f} ms, bound {bound_ms:.6f} ms "
            f"({100 * bound_ms / ms:.2f} % of {PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")
        del x, res, y
    log(f"  [{card}] (c) one forward's 69 epilogues: kernel {tot['ms']:.6f} ms, plain "
        f"{tot['plain_ms']:.6f} ms, bound {tot['bound_ms']:.6f} ms ({tot['bytes']} B; "
        f"{100 * tot['bound_ms'] / tot['ms']:.2f} % of the bound)")

    # (d) the whole forward, kernel against plain passes.
    def forward_ms(reps):
        times = []
        for _ in range(reps):
            times.append(clock.ms(lambda: net(x_in), reps=1, warmup=0))
        return float(np.median(times))

    with torch.no_grad(), f32_precision():  # the package's precision: TF32 off
        got = net(x_in)
        fused_ms = forward_ms(5)
        with mock.patch.object(backbones, "bn_act", nn_ops.bn_act_plain), \
                mock.patch.object(detection, "bn_act", nn_ops.bn_act_plain):
            want = net(x_in)
            plain_fwd_ms = forward_ms(5)
    same = all(torch.equal(_bn_act_bits(g), _bn_act_bits(w)) for g, w in zip(got, want))
    log(f"  [{card}] (d) {n}x{hw}² forward: with the kernel {fused_ms:.6f} ms, with the plain "
        f"passes {plain_fwd_ms:.6f} ms (medians of 5); outputs bitwise equal: {same}")
    if not same:
        raise SystemExit("FAIL: the forward with the kernel != the forward with plain passes")
    launches = kern.launches - start_launches
    if not rehearse and launches == 0:
        raise SystemExit("FAIL: the bn_act kernel did not launch")
    return dict(tot, launches=launches, cases=cases, forward_ms=fused_ms,
                forward_plain_ms=plain_fwd_ms, rows=rows, shape=f"{n}x{hw}²")


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


def staged_batch_sizes(cropper, src, names, sizes, card):
    """The staged detect of n host-resized interims for each n: ms of the
    detector on n rows (CUDA events after one warm-up call, 3 calls) and on
    the batch the Cropper pads n to (:meth:`Cropper._staged_pad_size`).
    Returns {n: (unpadded ms, pad size, padded ms)}."""
    from face_crop_plus_tpu_torch.utils.batching import as_batch
    from face_crop_plus_tpu_torch.utils.io import read_images

    images, _ = read_images(names[: max(sizes)], src, max(cropper.resize_size))
    batch, _, _ = as_batch(images, cropper.resize_size)
    dev = torch.from_numpy(batch).to(cropper._device)
    clock = Clock(cropper._device)
    table = {}
    with cropper._device_lock:
        for n in sizes:
            m = cropper._staged_pad_size(n)
            padded = torch.cat([dev[:n], dev[n - 1 : n].expand(m - n, *dev.shape[1:])])
            ms = clock.ms(lambda: cropper.det_model.predict(dev[:n]), reps=3, warmup=1)  # noqa: B023
            pad_ms = ms if m == n else clock.ms(
                lambda: cropper.det_model.predict(padded), reps=3, warmup=1)  # noqa: B023
            table[n] = (ms, m, pad_ms)
            log(f"  [{card}] (e) staged detect of {n} interims: unpadded {ms:.6f} ms; padded "
                f"to {m} (the Cropper's call) {pad_ms:.6f} ms")
    return table


def phase5_directory(device, card, rehearse):
    """The directory pipeline at full width; see the module docstring.

    Returns (K1 launches, warp launches) of the timed "largest" passes and
    the "all" pass, the largest staged-warp difference from plain, and the
    timings for the kernels line.
    """
    from face_crop_plus_tpu_torch import Cropper
    from face_crop_plus_tpu_torch import cropper as cropper_mod
    from face_crop_plus_tpu_torch.models.detection import RetinaFaceNet
    from face_crop_plus_tpu_torch.models.weights import save_npz, to_jax_params
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
    save_npz(to_jax_params(tamed_state_dict(RetinaFaceNet())), os.path.join(wdir, "retinaface.npz"))
    cli_out = os.path.join(work, "cli")
    cmd = [sys.executable, "-m", "face_crop_plus_tpu_torch", "-i", src, "-o", cli_out,
           "-r", str(resize), "-s", str(out), "-dt", "0", "-b", str(bs), "-w", wdir]
    if rehearse:
        cmd += ["-d", "cpu"]
    log(f"  (a) {release_cached(device)}")
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
    uniform = [n for n in readable if "_" not in n[4:]]
    fused_batch_sizes(c, src, uniform, (16, 15, 12, 10, 8, 4, 2, 1) if not rehearse else (4, 3, 1),
                      card)
    staged_table = staged_batch_sizes(c, src, uniform, range(1, bs + 1), card)
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
    return dict(nms=dir_nms + all_nms, warp=dir_warp + all_warp, staged_nms=staged[0],
                staged_warp=staged[1], staged_err=staged_err,
                faces_per_s={p: r for p, r in rates.items()},
                work=work, src=src, wdir=wdir, readable=readable, kw=kw,
                staged_table=staged_table)


# ---------------------------------------------------------------------------
# Phase 6: parsing
# ---------------------------------------------------------------------------

#: Phase 6's groups: a positive attribute, a negative one, a two-class
#: group (OR-joined: the parser's ``attr_join_by_and`` is switched off),
#: and mask groups, of which "face" (every class but the background) takes
#: nearly every face.  The tamed random weights give no class its meaning:
#: on crops and originals they label most pixels 18 and 1, many 9, 12 and
#: 14, a few 2 and 13, and none 3.
ATTR_GROUPS = {"has_1": [1], "not_3": [-3], "2_or_13": [2, 13]}
MASK_GROUPS = {"face": list(range(1, 19)), "cls_9": [9]}
#: Tamed parser weights (the recipe of ``tests/torch_parity.py``): conv
#: gain, BN scale, bias spread and the gain of the final class conv; they
#: spread the logits over many classes with few near-ties.
PARSER_TAMING = (2.0, 0.7, 0.3, 16.0)
#: Card vs CPU: labels may differ only where the CPU's top-2 logit margin
#: is at most this (f32 on both; cuDNN and the CPU sum in other orders).
PARSE_EPS = 1e-3


def tamed_parser_state_dict(net, seed: int = 1):
    """Seeded parser weights after :data:`PARSER_TAMING`."""
    gain, bn_scale, bias, head_gain = PARSER_TAMING
    rng = np.random.default_rng(seed)
    out = {}
    for key, ref in net.state_dict().items():
        if ref.ndim == 4:
            fan_in = ref.shape[1] * ref.shape[2] * ref.shape[3]
            g = head_gain if key == "conv_out.conv_out.weight" else gain
            w = rng.normal(size=tuple(ref.shape)) * np.sqrt(g / fan_in)
            out[key] = torch.from_numpy(w.astype(np.float32))
        elif key.endswith(".scale"):
            out[key] = torch.full(tuple(ref.shape), bn_scale)
        else:
            out[key] = torch.from_numpy((rng.normal(size=tuple(ref.shape)) * bias).astype(np.float32))
    return out


def parser_macs(par, n: int, hw: int) -> tuple[int, int]:
    """(conv, resize) multiply-adds of one sub-batch of n faces of hw²:
    every convolution from its output shape, and the two resizes' products
    (the input to 512², the 64² logits to 512²)."""
    convs = [m for m in par.net.modules() if isinstance(m, torch.nn.Conv2d)]
    total = [0]

    def hook(m, _inp, out):
        total[0] += out.numel() * (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]

    handles = [m.register_forward_hook(hook) for m in convs]
    try:
        par._logits(torch.zeros((n, hw, hw, 3), dtype=torch.uint8, device=par.device))
    finally:
        for h in handles:
            h.remove()
    resize = n * 3 * (512 * hw * hw + 512 * 512 * hw) + n * 19 * (512 * 64 * 64 + 512 * 512 * 64)
    return total[0], resize


def tree_digest(root) -> dict:
    """Every file under ``root`` by relative path → its bytes."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def check_parse_tree(root, most_faces, what) -> tuple[dict, int]:
    """Holds a parse tree: every directory is ``<attr>/<mask>`` or its
    ``_mask`` sibling with as many files, at least one ``<attr>/face``
    exists, masks are 2-D 0/255 of their crop's size.  Returns the files
    per directory and the faces written (distinct names under ``*/face``;
    a face in no attribute group is not written), at most ``most_faces``."""
    import cv2

    from face_crop_plus_tpu_torch.utils.io import imread_rgb

    per_dir, names = {}, set()
    for d, _, files in os.walk(root):
        if files:
            rel = os.path.relpath(d, root)
            per_dir[rel] = len(files)
            if rel.endswith("/face"):
                names.update(files)
    bad = [k for k in per_dir if not k.endswith("_mask") and per_dir.get(k + "_mask") != per_dir[k]]
    if bad or any(k.count("/") != 1 for k in per_dir) or not 0 < len(names) <= most_faces:
        raise SystemExit(f"FAIL: {what}: directories {per_dir}, {len(names)} faces under "
                         f"*/face (at most {most_faces}), without masks {bad}")
    d = next(k for k in per_dir if k.endswith("/face_mask"))
    name = sorted(os.listdir(os.path.join(root, d)))[0]
    mask = cv2.imread(os.path.join(root, d, name), cv2.IMREAD_UNCHANGED)
    crop = imread_rgb(os.path.join(root, d[: -len("_mask")], name))
    if mask is None or mask.ndim != 2 or mask.shape != crop.shape[:2] or not set(
            np.unique(mask).tolist()) <= {0, 255}:
        raise SystemExit(f"FAIL: {what}: mask {d}/{name} is not a 2-D 0/255 mask of its crop")
    return per_dir, len(names)


def count_inputs(model) -> dict:
    """Wraps ``model.predict`` to count device-tensor and host-array inputs."""
    inputs = {"device": 0, "host": 0}
    real = model.predict

    def predict(images, *args, **kwargs):
        inputs["device" if torch.is_tensor(images) else "host"] += 1
        return real(images, *args, **kwargs)

    model.predict = predict
    return inputs


def parse_card_vs_cpu(par, crops, groups_kw, device, label):
    """The parser on the card against the CPU on the same crops: labels
    equal except where the CPU's top-2 logit margin is at most
    :data:`PARSE_EPS`, counts within those flips, groups equal."""
    from face_crop_plus_tpu_torch.models.parsing import BiSeNet
    from face_crop_plus_tpu_torch.ops.nn import resize_nearest

    out = crops.shape[1:3]
    cpu = BiSeNet(max_batch_size=len(crops), device="cpu", **groups_kw)
    cpu.net.load_state_dict(par.net.state_dict())
    cpu.attr_join_by_and = par.attr_join_by_and
    lab_d, cnt_d = par.parse_batch(crops)
    lab_c, cnt_c = cpu.parse_batch(crops)
    logits_c = cpu._logits(torch.from_numpy(crops))
    logits_d = par._logits(torch.from_numpy(crops).to(device)).cpu()
    top2 = logits_c.topk(2, dim=1).values
    near = resize_nearest((top2[:, :1] - top2[:, 1:2]), out)[:, 0].numpy() <= PARSE_EPS
    differ = lab_d != lab_c
    flips = differ.reshape(len(crops), -1).sum(1)
    gd, gc = par.predict(crops), cpu.predict(crops)
    same_groups = gd[0] == gc[0] and {k: v[0] for k, v in gd[1].items()} == {
        k: v[0] for k, v in gc[1].items()}
    log(f"  {label} {device} vs cpu on {len(crops)} crops: logits max |diff| "
        f"{float((logits_d - logits_c).abs().max()):.6g} (max |logit| "
        f"{float(logits_c.abs().max()):.6g}); {int(near.sum())} near-tie pixels (CPU top-2 "
        f"margin <= {PARSE_EPS}); labels differ at {int(differ.sum())} pixels, "
        f"{int((differ & ~near).sum())} of them off near-ties; counts |diff| per face "
        f"{np.abs(cnt_d.astype(np.int64) - cnt_c).sum(1).tolist()} (flips {flips.tolist()}); "
        f"groups equal: {same_groups}")
    if (differ & ~near).any() or (np.abs(cnt_d.astype(np.int64) - cnt_c).sum(1) > 2 * flips).any() \
            or not same_groups:
        raise SystemExit("FAIL: parse on the card differs from the CPU off near-ties")


def phase6_parsing(batches, p3_fps, p5, device, card, rehearse):
    """Parsing at full width; see the module docstring.

    Returns the kernels' launches on the parse requests and directory
    passes, and the numbers the kernels line carries.
    """
    from face_crop_plus_tpu_torch import Cropper
    from face_crop_plus_tpu_torch.models.weights import save_npz, to_jax_params
    from face_crop_plus_tpu_torch.ops.cuda import nms as nms_kern
    from face_crop_plus_tpu_torch.ops.cuda import warp as warp_kern
    from face_crop_plus_tpu_torch.utils.profiling import PipelineStats

    n = batches[0].shape[0]
    out, resize = (32, 64) if rehearse else (256, 1024)
    groups_kw = dict(attr_groups=ATTR_GROUPS, mask_groups=MASK_GROUPS)
    c = Cropper(device=str(device), strategy="largest", det_threshold=-1.0, batch_size=n,
                output_size=out, resize_size=resize, **groups_kw)
    par = c.par_model
    par.net.load_state_dict(tamed_parser_state_dict(par.net))
    par.attr_join_by_and = False
    if not all(t.device.type == device.type for t in par.net.state_dict().values()) or \
            par.device.type != device.type:
        raise SystemExit("FAIL: parser parameters are not on the device")

    # (a) process_images with groups on the phase-3 batches.
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    nms_kern.launches = 0
    warp_kern.launches = 0
    per_request, seconds, faces = [], [], []
    for r, batch in enumerate(batches[:5]):
        before = (nms_kern.launches, warp_kern.launches)
        t0 = time.perf_counter()
        crops, indices, (attr, mask) = c.process_images(batch)
        seconds.append(time.perf_counter() - t0)
        per_request.append((nms_kern.launches - before[0], warp_kern.launches - before[1]))
        faces.append(len(indices))
        sizes = {**{k: len(v) for k, v in (attr or {}).items()},
                 **{f"{k} (mask)": len(v[0]) for k, v in (mask or {}).items()}}
        if (crops.shape != (n, out, out, 3) or not attr or not mask or "face" not in mask
                or mask["face"][1].shape[1:] != (out, out)):
            raise SystemExit(f"FAIL: parse request {r}: crops {crops.shape}, groups {sizes}")
        log(f"  (a) request {r}: {len(indices)} faces, group sizes {sizes}, K1 launches "
            f"{per_request[-1][0]}, warp launches {per_request[-1][1]}, {seconds[-1]:.6f} s")
        if r == 0:
            c.stats = PipelineStats()  # stage times after the warm-up
    launches = (nms_kern.launches, warp_kern.launches)
    if not rehearse and min(min(p) for p in per_request) < 1:
        raise SystemExit("FAIL: K1 or the warp did not launch on every parse request")
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    fps = sum(faces[1:]) / sum(seconds[1:])
    parse = c.stats.as_dict()["parse"]
    parse_ms = parse["seconds"] / parse["calls"] * 1e3
    log(f"  [{card}] (a) {fps:.6f} faces/s with parsing over {len(seconds) - 1} requests after "
        f"one warm-up (phase 3 without parsing: {p3_fps:.6f}); request seconds "
        + ", ".join(f"{s:.6f}" for s in seconds))
    log(f"  [{card}] (a) stage 'parse' {parse_ms:.6f} ms a request ({parse['calls']} calls "
        f"after the warm-up, {parse['items']} faces, synchronised by the host copies); peak "
        f"device memory {peak} B ({peak / 2**30:.6f} GiB)")
    if device.type == "cuda":
        t0 = time.perf_counter()
        rows = device_kernels(lambda: c.process_images(batches[4]), reps=1)
        wall_us = (time.perf_counter() - t0) * 1e6
        busy = sum(r[1] for r in rows)
        log(f"  [{card}] (a) profiled request: device kernel time {busy:.3f} us of "
            f"{wall_us:.3f} us wall (profiler on); busy share {busy / wall_us:.6f}; "
            f"{sum(r[2] for r in rows)} kernel launches; top kernels:")
        for name, us, count in rows[:10]:
            log(f"    {us:12.3f} us  x{count:4d}  {name[:110]}")

    # Parse times at n and at a padded n - 1, beside an unpadded n - 1.
    clock = Clock(device)
    ms_n = clock.ms(lambda: par.predict(crops), reps=5, warmup=1)
    ms_pad = clock.ms(lambda: par.predict(crops[: n - 1]), reps=5, warmup=1)
    dev_short = torch.from_numpy(crops[: n - 1]).to(device)
    ms_short = clock.ms(lambda: par._parse(dev_short, out, out), reps=3, warmup=1)
    conv_macs, resize_macs = parser_macs(par, n, out)
    t_ops = 2 * (conv_macs + resize_macs) / PEAK_F32_FLOPS * 1e3
    log(f"  [{card}] parse of {n} crops (predict: upload, network, argmax, counts, packed "
        f"masks, host copies): {ms_n:.6f} ms; of {n - 1} padded to {n}: {ms_pad:.6f} ms; "
        f"diagnostic, {n - 1} unpadded (_parse only): {ms_short:.6f} ms")
    log(f"  [{card}] parser work a sub-batch of {n}: {conv_macs / n / 1e9:.6f} G MAC of "
        f"convolution and {resize_macs / n / 1e9:.6f} G MAC of resizes a face; "
        f"{2 * (conv_macs + resize_macs) / (ms_n * 1e-3) / 1e12:.6f} TFLOP/s achieved by "
        f"predict; f32 bound {t_ops:.6f} ms at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s")

    # (b) the card against the CPU on 4 crops.
    parse_card_vs_cpu(par, crops[:4], groups_kw, device, "(b)")
    del c

    # (c) process_dir with groups over phase 5's directory.
    src, readable, kw = p5["src"], p5["readable"], dict(p5["kw"], **groups_kw)
    save_npz(to_jax_params(tamed_parser_state_dict(par.net)), os.path.join(p5["wdir"], "bisenet.npz"))
    del par
    cd = Cropper(device=str(device), strategy="largest", **kw)
    cd.par_model.attr_join_by_and = False
    cd.process_dir(src, os.path.join(p5["work"], "parse_warm"), desc=None)
    inputs = count_inputs(cd.par_model)
    nms_kern.launches = 0
    warp_kern.launches = 0
    digests = {}
    for n_proc, reps in ((1, 2), (4, 1)):
        cd.num_processes = n_proc
        for rep in range(reps):
            dst = os.path.join(p5["work"], f"parse_p{n_proc}_{rep}")
            cd.stats = PipelineStats()
            t0 = time.perf_counter()
            cd.process_dir(src, dst, desc=None)
            sec = time.perf_counter() - t0
            per_dir, n_faces = check_parse_tree(dst, len(readable), f"parse tree p{n_proc} pass {rep}")
            digests[(n_proc, rep)] = tree_digest(dst)
            split = ", ".join(f"{k} {v['seconds']:.6f} s/{v['calls']} calls/{v['items']} items"
                              for k, v in cd.stats.as_dict().items())
            log(f"  [{card}] (c) 'largest' with groups, num_processes={n_proc} pass {rep}: "
                f"{len(readable)} crops in {sec:.6f} s = {len(readable) / sec:.6f} faces/s "
                f"({n_faces} written: the rest are in no attribute group; "
                f"{sum(per_dir.values())} files); stages: {split}")
            log(f"    tree {per_dir}")
    base = digests[(1, 0)]
    differ = {f"p{k[0]} pass {k[1]}": sum(base.get(f) != v.get(f) for f in set(base) | set(v))
              for k, v in digests.items()}
    log(f"  (c) files differing from the first one-thread tree: {differ}; parser inputs on the "
        f"timed passes: {inputs['device']} device handoffs, {inputs['host']} host crop arrays")
    if any(differ.values()):
        raise SystemExit("FAIL: the parse tree differs across passes or thread counts")
    dir_launches = (nms_kern.launches, warp_kern.launches)
    if not rehearse and min(dir_launches) < 1:
        raise SystemExit("FAIL: K1 or the warp did not launch in the parse passes")
    del cd

    ca = Cropper(device=str(device), strategy="all", max_faces=4, auto_grow=False, **kw)
    ca.par_model.attr_join_by_and = False
    inputs = count_inputs(ca.par_model)
    all_out = os.path.join(p5["work"], "parse_all")
    before = (nms_kern.launches, warp_kern.launches)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the binding caps warn once
        ca.process_dir(src, all_out, desc=None)
    sec = time.perf_counter() - t0
    per_dir, n_faces = check_parse_tree(all_out, 4 * len(readable), "'all' parse tree")
    log(f"  [{card}] (c) 'all' with groups (max_faces 4): {n_faces} faces written in "
        f"{sec:.6f} s = {n_faces / sec:.6f} faces/s (first pass of its Cropper); parser "
        f"inputs: {inputs['device']} device handoffs, {inputs['host']} host crop arrays; K1 "
        f"launches {nms_kern.launches - before[0]}, warp launches "
        f"{warp_kern.launches - before[1]}; tree {per_dir}")
    if not rehearse and inputs["device"] < 1:
        raise SystemExit("FAIL: no parser input came by the device handoff in 'all'")
    dir_launches = (nms_kern.launches, warp_kern.launches)
    del ca

    # (d) the landmark-free mode through the CLI, over the uniform files.
    uni = os.path.join(p5["work"], "uniform")
    os.makedirs(uni)
    names = [f for f in readable if "_" not in f[4:]]
    for f in names:
        os.link(os.path.join(src, f), os.path.join(uni, f))
    cli_out = os.path.join(p5["work"], "parse_cli")
    cmd = [sys.executable, "-m", "face_crop_plus_tpu_torch", "-i", uni, "-o", cli_out, "-dt", "-1",
           "-b", str(n), "-w", p5["wdir"], "-ag", json.dumps(ATTR_GROUPS),
           "-mg", json.dumps(MASK_GROUPS)]
    if rehearse:
        cmd += ["-d", "cpu"]
    log(f"  (d) {release_cached(device)}")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    sec = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"FAIL: the landmark-free CLI exited {proc.returncode}:\n"
                         f"{proc.stderr[-3000:]}")
    per_dir, n_faces = check_parse_tree(cli_out, len(names), "landmark-free CLI tree")
    log(f"  (d) CLI `-dt -1 -ag … -mg …` over {len(names)} uniform originals: exit 0 in "
        f"{sec:.3f} s (process start, model init, one pass); {n_faces} written; tree {per_dir}")
    return dict(nms=launches[0], warp=launches[1], dir_nms=dir_launches[0],
                dir_warp=dir_launches[1], fps=fps, parse_ms=parse_ms)


# ---------------------------------------------------------------------------
# Phase 7: enhancement
# ---------------------------------------------------------------------------

#: Tamed enhancer weights (the recipe of ``tests/torch_parity.py``): conv
#: gain, bias spread, the gain and bias of ``conv_last``; ``trunk_conv``'s
#: gain is 1.44^-blocks.  Each RRDB returns ~1.2x its input, so He-init
#: weights through 23 blocks saturate every pixel at 0 or 255 and make every
#: comparison vacuous; these centre the output on mid-grey, unsaturated.
RRDB_TAMING = (1.0, 0.01, 0.5, 0.5)
#: Multiply-adds a pixel of the full network, counted from its shapes: the
#: dense blocks 23 x 3 x (64+96+128+160)·32·9 + 192·64·9, conv_first and
#: trunk_conv, and the x4 tail (upconv1 at 2x; upconv2, HRconv, conv_last
#: at 4x).  The script counts it again with conv hooks.
RRDB_MACS_PER_PIXEL = 17_926_848


def tamed_rrdb_state_dict(net, seed: int = 1):
    """Seeded enhancer weights after :data:`RRDB_TAMING`."""
    gain, bias, last_gain, last_bias = RRDB_TAMING
    blocks = len(net.RRDB_trunk)
    rng = np.random.default_rng(seed)
    out = {}
    for key, ref in net.state_dict().items():
        if ref.ndim == 4:
            fan_in = ref.shape[1] * ref.shape[2] * ref.shape[3]
            g = {"conv_last.weight": last_gain, "trunk_conv.weight": 1.44 ** -blocks}.get(key, gain)
            # Drawn HWIO, as the tests' JAX-layout recipe draws them.
            w = rng.normal(size=(ref.shape[2], ref.shape[3], ref.shape[1], ref.shape[0]))
            w = (w * np.sqrt(g / fan_in)).transpose(3, 2, 0, 1)
            out[key] = torch.from_numpy(np.ascontiguousarray(w, np.float32))
        elif key == "conv_last.bias":
            out[key] = torch.full(tuple(ref.shape), last_bias)
        else:
            out[key] = torch.from_numpy((rng.normal(size=tuple(ref.shape)) * bias).astype(np.float32))
    return out


def tame_enhancer(model, blocks: int):
    """Gives ``model`` (an ``RRDBNet``) a tamed ``blocks``-block network."""
    from face_crop_plus_tpu_torch.models.enhancement import RRDBNetwork

    net = RRDBNetwork(blocks)
    net.load_state_dict(tamed_rrdb_state_dict(net))
    model.num_blocks = blocks
    model.net = net.to(model.device, model.compute_dtype).eval().requires_grad_(False)
    return model


def rrdb_macs_per_pixel(net) -> int:
    """Multiply-adds of one input pixel, from conv hooks on a 16² forward
    (every convolution is stride 1; the tail's grow with the input).  The
    hooks run on a CPU network of ``net``'s depth: in float32 on a card the
    network calls its convolutions' weights (``rrdb_conv``), not the
    modules, so no hook would fire there."""
    from face_crop_plus_tpu_torch.models.enhancement import RRDBNetwork

    twin = RRDBNetwork(len(net.RRDB_trunk))
    convs = [m for m in twin.modules() if isinstance(m, torch.nn.Conv2d)]
    total = [0]

    def hook(m, _inp, out):
        total[0] += out.numel() * m.in_channels * m.kernel_size[0] * m.kernel_size[1]

    handles = [m.register_forward_hook(hook) for m in convs]
    try:
        with torch.no_grad():
            twin(torch.zeros((1, 3, 16, 16)))
    finally:
        for h in handles:
            h.remove()
    return total[0] // 256


def rrdb_composition_before(net, x):
    """RRDBNetwork's forward as its modules composed it before the
    epilogue kernel: each convolution with its bias, each LeakyReLU,
    ``mul_(0.2)`` and ``add_`` an ATen pass, the dense blocks'
    ``torch.cat`` (in the layout ``x`` brings, as the modules ran it)."""
    import torch.nn.functional as F

    from face_crop_plus_tpu_torch.ops.nn import upsample2x_nearest

    def act(t):
        return F.leaky_relu(t, 0.2, inplace=True)

    def dense(d, t):
        c = t
        for k in range(1, 5):
            c = torch.cat([c, act(getattr(d, f"conv{k}")(c))], dim=1)
        return d.conv5(c).mul_(0.2).add_(t)

    fea = net.conv_first(x)
    t = fea
    for b in net.RRDB_trunk:
        t = dense(b.RDB3, dense(b.RDB2, dense(b.RDB1, t))).mul_(0.2).add_(t)
    fea = net.trunk_conv(t).add_(fea)
    fea = act(net.upconv1(upsample2x_nearest(fea)))
    fea = act(net.upconv2(upsample2x_nearest(fea)))
    return net.conv_last(act(net.HRconv(fea)))


def phase7g_rrdb_act(device, clock, card, rehearse):
    """RRDBNet's convolution epilogue (``csrc/rrdb_act.cu``) against its
    plain version and the forward before it, on the card.

    (a) Every epilogue of one forward of a 1024² interim through the tamed
    23-RRDB network: the kernel's output bitwise against the plain version
    on the same bias-less convolution, and against the module's own
    convolution (bias inside) composed with the ATen passes, each on the
    inputs as they stood before the launch.  (b) Each form on planted NaN,
    ±0 and ±inf at N = 1 and 3, odd planes, unaligned and sliced.  (c) Each
    distinct epilogue of (a) timed from a cold L2 (device time by CUDA
    events, :func:`_device_ms`, of the kernel into its buffer slice, and of
    the plain version's kernels), beside its bound by bytes; summed over the forward's launches.
    (d) The whole forward against the composition before the kernel
    (:func:`rrdb_composition_before`) in the package's f32 (TF32 off), on
    the channels-last input ``_sr_uint8`` gives: outputs bitwise equal,
    device times (median of 3 by CUDA events), peak memory of each.  The
    CPU rehearsal checks
    (a) against the module composition only (the CPU adds a bias inside
    its sums) and (b) not at all.

    Returns the numbers of the kernels line.
    """
    import torch.nn.functional as F

    from face_crop_plus_tpu_torch.models import enhancement as enh_mod
    from face_crop_plus_tpu_torch.models.enhancement import RRDBNetwork
    from face_crop_plus_tpu_torch.ops import nn as nn_ops
    from face_crop_plus_tpu_torch.ops.cuda import rrdb_act as kern
    from face_crop_plus_tpu_torch.utils.device import f32_precision

    cuda = device.type == "cuda"
    blocks, side = (1, 24) if rehearse else (23, 1024)
    start_launches = kern.launches
    net = RRDBNetwork(blocks)
    net.load_state_dict(tamed_rrdb_state_dict(net))
    net = net.to(device).eval().requires_grad_(False)
    img = photo_like(np.random.default_rng(41), side, side)[None]
    x_in = (torch.from_numpy(img).permute(0, 3, 1, 2).float() / 255.0).to(device)

    def bits(t):
        return t.view(torch.int32)

    def plain_epilogue(y, bias, form, residual=None, outer=None, out=None):
        """ATen's add of the bias after the convolution, then the plain passes."""
        return nn_ops.rrdb_act_plain(y.add_(bias.reshape(1, -1, 1, 1)), form, residual, outer,
                                     out)

    # (a) every epilogue of one forward.
    real = nn_ops.rrdb_conv
    seen = []

    def spy(x, conv, form="bias", residual=None, outer=None, out=None, channels_last=False):
        # The references run each convolution in the layout the modules ran it.
        xr = x.contiguous(memory_format=torch.channels_last) if channels_last else x
        module = nn_ops.rrdb_act_plain(conv(xr), form, residual, outer)
        plain = None
        if cuda:
            y = F.conv2d(xr, conv.weight, None, conv.stride, conv.padding)
            plain = plain_epilogue(y, conv.bias, form, residual, outer)
        got = real(x, conv, form, residual, outer, out, channels_last)
        same = torch.equal(bits(got), bits(module)) and (
            plain is None or torch.equal(bits(got), bits(plain)))
        seen.append((tuple(got.shape), form, out is not None, same))
        return got

    with torch.no_grad(), f32_precision(), mock.patch.object(enh_mod, "rrdb_conv", spy):
        net(x_in)
    if cuda:
        torch.cuda.synchronize()
    bad = [s for s in seen if not s[-1]]
    expected = 15 * blocks + 6
    log(f"  (a) {len(seen)} epilogues of one {side}² forward ({blocks} RRDBs): "
        f"{len(seen) - len(bad)} bitwise equal to the plain version"
        + (" and to the module's convolution with its bias" if cuda else
           " (rehearsal: to the module composition)"))
    if bad or len(seen) != expected:
        raise SystemExit(f"FAIL: rrdb_act != plain at {bad[:3]} ({len(seen)} epilogues, "
                         f"{expected} expected)")

    # (b) edge cases.
    rng = np.random.default_rng(42)
    cases = 0
    for shape in ((1, 7, 9, 11), (3, 5, 1, 1), (3, 3, 67, 129), (1, 2, 1, 4099),
                  (1, 32, 64, 64), (3, 32, 64, 64)):
        for form, (_code, reads) in kern.FORMS.items():
            for mode in ("in place", "slice", "unaligned"):
                if not cuda:
                    continue
                n, c = shape[:2]
                numel = int(np.prod(shape))
                if mode == "unaligned":
                    y = _special_planes(rng, (numel + 1,), device)[1:].view(shape)
                else:
                    y = _special_planes(rng, shape, device)
                bias = _special_planes(rng, (c,), device)
                res = [_special_planes(rng, (n, c + 3, *shape[2:]), device)[:, 1:1 + c]
                       for _ in range(reads)] + [None] * (2 - reads)
                want = plain_epilogue(y.clone(), bias, form, *res)
                out = None
                if mode == "slice":
                    big = torch.full((n, c + 4, *shape[2:]), 7.0, device=device)
                    out = big[:, 1:1 + c]
                got = kern.rrdb_act_cuda(y, bias, form, *res, out=out)
                torch.cuda.synchronize()
                ok = torch.equal(bits(got), bits(want))
                if mode == "slice":
                    ok = ok and bool((big[:, :1] == 7).all()) and bool((big[:, 1 + c:] == 7).all())
                if not ok:
                    raise SystemExit(f"FAIL: rrdb_act kernel != plain at {shape} {form} {mode}")
                cases += 1
    log(f"  (b) {cases} edge cases (NaN, ±0, ±inf; N = 1 and 3, odd and tiny planes, "
        "unaligned inputs, sliced residuals and outputs): bitwise equal")

    # (c) each distinct epilogue timed.
    configs = {}
    for shape, form, sliced, _same in seen:
        configs[shape, form, sliced] = configs.get((shape, form, sliced), 0) + 1
    rows = []
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes": 0}
    for (shape, form, sliced), count in configs.items():
        n, c = shape[:2]
        reads = kern.FORMS[form][1]
        y = torch.randn(shape, device=device)
        bias = torch.randn(c, device=device)
        res = [torch.randn((n, 192, *shape[2:]), device=device)[:, :c] for _ in range(reads)]
        res += [None] * (2 - reads)
        dst = torch.empty((n, 192 if sliced else c, *shape[2:]), device=device)[:, :c]

        def fused(y=y, bias=bias, form=form, res=res, dst=dst):
            if cuda:
                kern.rrdb_act_cuda(y, bias, form, *res, out=dst)
            else:
                plain_epilogue(y.clone(), bias, form, *res, out=dst)

        def plain(y=y, bias=bias, form=form, res=res, dst=dst):
            plain_epilogue(y, bias, form, *res, out=dst)

        ms = _device_ms(fused, clock, device)
        plain_ms = _device_ms(plain, clock, device)
        nbytes = 4 * y.numel() * (2 + reads)
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        rows.append(dict(shape=list(shape), form=form, sliced=sliced, launches=count, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound_ms))
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound_ms),
                         ("bytes", nbytes)):
            tot[key] += count * val
        log(f"  [{card}] {tuple(shape)} {form}{' into a slice' if sliced else ''} x{count}: "
            f"kernel {ms:.6f} ms, plain {plain_ms:.6f} ms, bound {bound_ms:.6f} ms "
            f"({100 * bound_ms / ms:.2f} % of {PEAK_BYTES_PER_S / 1e12:.2f} TB/s)")
        del y, res, dst
    log(f"  [{card}] (c) one forward's {len(seen)} epilogues: kernel {tot['ms']:.6f} ms, plain "
        f"{tot['plain_ms']:.6f} ms, bound {tot['bound_ms']:.6f} ms ({tot['bytes']} B; "
        f"{100 * tot['bound_ms'] / tot['ms']:.2f} % of the bound)")

    # (d) the whole forward, after against before.
    def timed(fn):
        times, peak = [], 0
        for _ in range(3):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            times.append(clock.ms(fn, reps=1, warmup=0))
            if cuda:
                peak = max(peak, torch.cuda.max_memory_allocated())
        return float(np.median(times)), peak

    with torch.no_grad(), f32_precision():
        after = net(x_in)
        before = rrdb_composition_before(net, x_in)
        same = torch.equal(bits(after), bits(before))
        del before, after
        before_ms, before_peak = timed(lambda: rrdb_composition_before(net, x_in))
        after_ms, after_peak = timed(lambda: net(x_in))
    log(f"  [{card}] (d) {side}² forward ({blocks} RRDBs): after {after_ms:.6f} ms, before "
        f"{before_ms:.6f} ms (medians of 3); peak {after_peak} B after, {before_peak} B before; "
        f"outputs bitwise equal: {same}")
    if not same:
        raise SystemExit("FAIL: the enhancer's forward != its composition before the kernel")
    launches = kern.launches - start_launches
    if cuda and launches == 0:
        raise SystemExit("FAIL: the rrdb_act kernel did not launch")
    return dict(tot, launches=launches, cases=cases, epilogues=len(seen),
                forward_ms=after_ms, forward_before_ms=before_ms, peak=after_peak,
                peak_before=before_peak, rows=rows, shape=f"1x{side}²")


@contextlib.contextmanager
def tf32_allowed():
    """TF32 on for cuDNN convolutions and CUDA matmuls (a diagnostic)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def level_diff(a, b) -> tuple[int, float]:
    """(largest uint8 difference, share of differing values)."""
    d = np.abs(np.asarray(a).astype(np.int16) - np.asarray(b).astype(np.int16))
    return (int(d.max()), float((d > 0).mean())) if d.size else (0, 0.0)


def midway(factors, k: int) -> float:
    """A gate threshold midway between the k-th and (k+1)-th smallest finite
    factors: it gates k images, and no factor sits near it."""
    f = np.sort(np.asarray(factors)[np.isfinite(factors)])
    return float(f[k - 1] + f[k]) / 2


def fused_factors(cropper, batch):
    """Each image's mean face factor, as the fused gate computes it, from one
    detect pass."""
    from face_crop_plus_tpu_torch.models.enhancement import mean_face_factor
    from face_crop_plus_tpu_torch.pipeline import interim_geometry

    lm, idx = cropper._fused.detect_only(batch, cropper.resize_size)
    scale, _ = interim_geometry(batch.shape[1], batch.shape[2], cropper.resize_size)
    iw, ih = cropper.resize_size
    return mean_face_factor(lm * scale, idx, len(batch), (ih, iw))


def count_enhanced(model) -> list:
    """Wraps ``model.enhance_device`` to count the rows it enhances."""
    rows = [0]
    real = model.enhance_device

    def enhance_device(images):
        rows[0] += images.shape[0]
        return real(images)

    model.enhance_device = enhance_device
    return rows


def phase7_enhancement(batches, p5, device, card, rehearse):
    """Gated RRDBNet x4 enhancement at full width; see the module docstring.

    Returns the kernels' launches on the fused requests and the directory
    passes.
    """
    from face_crop_plus_tpu_torch import Cropper
    from face_crop_plus_tpu_torch import pipeline
    from face_crop_plus_tpu_torch.models import enhancement as enh_mod
    from face_crop_plus_tpu_torch.models.enhancement import RRDBNet, RRDBNetwork
    from face_crop_plus_tpu_torch.models.weights import save_npz, to_jax_params
    from face_crop_plus_tpu_torch.ops.cuda import nms as nms_kern
    from face_crop_plus_tpu_torch.ops.cuda import rrdb_act as rrdb_kern
    from face_crop_plus_tpu_torch.ops.cuda import warp as warp_kern
    from face_crop_plus_tpu_torch.ops.warp import to_uint8
    from face_crop_plus_tpu_torch.utils.device import f32_precision
    from face_crop_plus_tpu_torch.utils.io import imread_rgb
    from face_crop_plus_tpu_torch.utils.profiling import PipelineStats

    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    clock = Clock(device)
    log("  (g) RRDBNet's convolution epilogue (rrdb_act) vs plain: every epilogue of one "
        "forward, edge cases, times, the forward before and after")
    rrdb_t = phase7g_rrdb_act(device, clock, card, rehearse)
    blocks = 1 if rehearse else 23
    n = batches[0].shape[0]
    out, resize = (32, 64) if rehearse else (256, 1024)
    gate_k = 2 if n > 2 else 1

    # (a) one image through the network on the card and on the CPU.
    side = 32 if rehearse else 128
    dev_m = tame_enhancer(RRDBNet(device=device, num_blocks=blocks), blocks)
    cpu_m = tame_enhancer(RRDBNet(device="cpu", num_blocks=blocks), blocks)
    img = photo_like(np.random.default_rng(7), side, side)[None]
    x = torch.from_numpy(img).permute(0, 3, 1, 2).float() / 255.0
    with f32_precision(), torch.no_grad():
        hr_d = dev_m.net(x.to(device)).cpu()
        hr_c = cpu_m.net(x)
    u_d = dev_m._sr_uint8(torch.from_numpy(img).to(device)).cpu().numpy()
    u_c = cpu_m._sr_uint8(torch.from_numpy(img)).numpy()
    lv, share = level_diff(u_d, u_c)
    inside = float(((u_d > 0) & (u_d < 255)).mean())
    log(f"  (a) {device} vs cpu, one {side}² image through {blocks} RRDBs (nf 64, gc 32): "
        f"x4 output {tuple(hr_d.shape)} max |diff| {float((hr_d - hr_c).abs().max()):.6g} "
        f"(max |x| {float(hr_c.abs().max()):.6g}); enhanced uint8 max |diff| {lv}, differing "
        f"share {share:.9f}; pixels strictly inside 1..254: {inside:.6f}; mean |enhanced - "
        f"input| {float(np.abs(u_d.astype(np.int16) - img).mean()):.6f} levels")
    if lv > 1 or inside < 0.5:
        raise SystemExit("FAIL: enhancement on the card differs from the CPU by more than 1 "
                         "level, or the tamed output saturates")
    del dev_m, cpu_m, hr_d, hr_c

    # (b) fused process_images, 2 of n gated.
    c = Cropper(device=str(device), output_size=out, resize_size=resize, strategy="largest",
                det_threshold=-1.0, batch_size=n, enh_threshold=0.0)
    # Tamed detector weights: the random-init detector's largest faces span
    # thousands of pixels, and their crops sample only the border.
    c.det_model.net.load_state_dict(tamed_state_dict(c.det_model.net))
    enh = tame_enhancer(c.enh_model, blocks)
    batch = batches[0]
    factors = fused_factors(c, batch)
    thr = midway(factors, gate_k)
    enh.min_face_factor = c.enh_threshold = thr
    gated = np.nonzero(factors <= thr)[0]
    log(f"  (b) factors (sorted) {np.round(np.sort(factors), 9).tolist()}; threshold {thr:.9g} "
        f"gates images {gated.tolist()}")
    if len(gated) != gate_k:
        raise SystemExit(f"FAIL: the threshold gates {len(gated)} images, not {gate_k}")
    enhanced_rows = count_enhanced(enh)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    nms_kern.launches = 0
    warp_kern.launches = 0
    rrdb_before = rrdb_kern.launches
    seconds = []
    for r in range(4):
        t0 = time.perf_counter()
        crops, indices, _ = c.process_images(batch)
        seconds.append(time.perf_counter() - t0)
        if crops.shape != (n, out, out, 3) or not np.array_equal(indices, np.arange(n)):
            raise SystemExit(f"FAIL: enhanced request {r}: crops {crops.shape}, indices {indices}")
    launches = (nms_kern.launches, warp_kern.launches)
    rrdb_launches = rrdb_kern.launches - rrdb_before
    gated_rows = enhanced_rows[0]
    # One epilogue launch a convolution: 15 a block, 6 more a forward, a
    # forward a gated row (enh_batch_size 1).
    rrdb_per_row = 15 * blocks + 6
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if enhanced_rows[0] != 4 * gate_k or (not rehearse and min(launches) < 4):
        raise SystemExit(f"FAIL: {enhanced_rows[0]} rows enhanced over 4 requests, launches "
                         f"{launches}")
    if cuda and rrdb_launches != gated_rows * rrdb_per_row:
        raise SystemExit(f"FAIL: {rrdb_launches} rrdb_act launches over {gated_rows} "
                         f"gated rows, {rrdb_per_row} a row expected")
    fps = 3 * n / sum(seconds[1:])
    log(f"  [{card}] (b) {fps:.6f} faces/s over 3 requests after one warm-up, {gate_k} of {n} "
        f"images gated; request seconds " + ", ".join(f"{s:.6f}" for s in seconds)
        + f"; K1 launches {launches[0]}, warp launches {launches[1]}, rrdb_act launches "
        f"{rrdb_launches} ({gated_rows} gated rows); peak device memory "
        f"{peak} B ({peak / 2**30:.6f} GiB)")
    timer = StageTimer(device)
    c._fused.stage_timer = timer
    t0 = time.perf_counter()
    c.process_images(batch)
    total = (time.perf_counter() - t0) * 1e3
    c._fused.stage_timer = None
    log(f"  [{card}] (b) stage split (ms, synchronised host clocks): "
        + ", ".join(f"{k} {timer.ms.get(k, 0.0):.6f}" for k in c._fused.STAGES)
        + f"; request {total:.6f}")

    # The enhancer alone on one gated interim row, its work and its bound.
    interim, _, _ = pipeline.device_resize_pad(torch.from_numpy(batch).to(device), c.resize_size)
    one = to_uint8(interim[gated[:1].tolist()]).contiguous()
    del interim
    ms = clock.ms(lambda: enh.enhance_device(one), reps=2, warmup=1)
    macs = rrdb_macs_per_pixel(enh.net)
    pixels = one.shape[1] * one.shape[2]
    flop = 2 * macs * pixels
    log(f"  [{card}] (b) enhance_device of one {one.shape[1]}x{one.shape[2]} interim: {ms:.6f} ms "
        f"({blocks} RRDBs); {macs} MAC a pixel counted by conv hooks (shapes: "
        f"{RRDB_MACS_PER_PIXEL} at 23 RRDBs), {flop / 1e12:.6f} TFLOP; "
        f"{flop / (ms * 1e-3) / 1e12:.6f} TFLOP/s; f32 bound {flop / PEAK_F32_FLOPS * 1e3:.6f} ms "
        f"at {PEAK_F32_FLOPS / 1e12:.0f} TFLOP/s")
    if cuda:
        t0 = time.perf_counter()
        rows = device_kernels(lambda: enh.enhance_device(one), reps=1)
        wall_us = (time.perf_counter() - t0) * 1e6
        busy = sum(r[1] for r in rows)
        log(f"  [{card}] (b) profiled enhance_device: device time {busy:.3f} us of "
            f"{wall_us:.3f} us wall (profiler on); {sum(r[2] for r in rows)} launches; top:")
        for name, us, count in rows[:8]:
            log(f"    {us:12.3f} us  x{count:4d}  {name[:110]}")

    # Non-gated crops against the same call without an enhancer, bitwise.
    c._fused.enh = None
    plain, plain_idx, _ = c.process_images(batch)
    c._fused.enh = enh
    keep = ~np.isin(indices, gated)
    same = np.array_equal(plain[keep], crops[keep]) and np.array_equal(plain_idx, indices)
    g_lv, _ = level_diff(plain[~keep], crops[~keep])
    log(f"  (b) non-gated crops vs enh_threshold=None: bitwise equal {same} "
        f"({int(keep.sum())} crops); gated crops differ from unenhanced by up to {g_lv} levels")
    if not same or g_lv == 0:
        raise SystemExit("FAIL: non-gated crops changed, or gated crops were not enhanced")

    # (f) diagnostic: TF32 allowed inside the enhancer only.
    real_precision = enh_mod.f32_precision
    enh_mod.f32_precision = tf32_allowed
    try:
        tf_ms = clock.ms(lambda: enh.enhance_device(one), reps=2, warmup=1)
        tf_img = enh.enhance_device(one).cpu().numpy()
        tf_crops, _, _ = c.process_images(batch)
    finally:
        enh_mod.f32_precision = real_precision
    f32_img = enh.enhance_device(one).cpu().numpy()
    img_lv, img_share = level_diff(tf_img, f32_img)
    crop_lv, crop_share = level_diff(tf_crops[~keep], crops[~keep])
    log(f"  [{card}] (f) diagnostic, TF32 allowed in the enhancer: enhance_device {tf_ms:.6f} ms "
        f"(f32 {ms:.6f}); enhanced image vs f32 max |diff| {img_lv} levels (share "
        f"{img_share:.9f}); gated crops vs f32 max |diff| {crop_lv} (share {crop_share:.9f})")
    del c, enh, one, crops, plain, tf_crops

    # (c) the staged path, card vs CPU: 3 ragged images, one gated.
    rng = np.random.default_rng(8)
    ragged = [smooth_batch(rng, (1, *hw, 3))[0] for hw in ((96, 80), (120, 90), (70, 110))]
    kw = dict(output_size=64, resize_size=32 if rehearse else 128, det_threshold=-1.0,
              batch_size=4, enh_threshold=0.0, padding="replicate")
    pair = []
    for dev in (str(device), "cpu"):
        cc = Cropper(device=dev, **kw)
        cc.det_model.net.load_state_dict(tamed_state_dict(cc.det_model.net))
        tame_enhancer(cc.enh_model, blocks)
        pair.append(cc)
    _, _, lm, idx = pair[1]._detect_interim(ragged)
    side = pair[1].resize_size
    s_factors = enh_mod.mean_face_factor(lm, idx, 3, (side[1], side[0]))
    s_thr = midway(s_factors, 1)
    results = []
    for cc in pair:
        cc.enh_model.min_face_factor = s_thr
        rows = count_enhanced(cc.enh_model)
        results.append((*cc.process_images(ragged)[:2], rows[0]))
    (ca, ia, ra), (cb, ib, rb) = results
    if not np.array_equal(ia, ib) or ca.shape != cb.shape or (ra, rb) != (1, 1):
        raise SystemExit(f"FAIL: staged card vs CPU: indices {ia} / {ib}, enhanced rows {ra}/{rb}")
    s_gated = np.isin(ia, np.nonzero(s_factors <= s_thr)[0])
    lv_g, _ = level_diff(ca[s_gated], cb[s_gated])
    lv_o, _ = level_diff(ca[~s_gated], cb[~s_gated])
    log(f"  (c) staged ragged process_images, {device} vs cpu ({kw['resize_size']}² interim, "
        f"tamed weights): factors {np.round(s_factors, 9).tolist()}, threshold {s_thr:.9g}; "
        f"{len(ia)} faces, {int(s_gated.sum())} gated; crops max |diff| {lv_g} on gated faces, "
        f"{lv_o} on the others")
    if lv_g > 2 or lv_o > 1 or not s_gated.any():
        raise SystemExit("FAIL: staged enhanced crops on the card differ from the CPU")
    del pair, results

    # (d) process_dir with enh_threshold over phase 5's directory.
    src, readable, wdir = p5["src"], p5["readable"], p5["wdir"]
    # The full network's tamed weights, as the CLI of (e) reads them.
    save_npz(to_jax_params(tamed_rrdb_state_dict(RRDBNetwork())), os.path.join(wdir, "rrdb.npz"))
    cd = Cropper(device=str(device), strategy="largest", enh_threshold=-np.inf, **p5["kw"])
    tame_enhancer(cd.enh_model, blocks)
    seen = []
    real_fused, real_enh = pipeline.mean_face_factor, enh_mod.mean_face_factor

    def recording(*args, **kwargs):
        seen.append(real_fused(*args, **kwargs))
        return seen[-1]

    pipeline.mean_face_factor = enh_mod.mean_face_factor = recording
    try:
        t0 = time.perf_counter()
        cd.process_dir(src, os.path.join(p5["work"], "enh_warm"), desc=None)
        warm = time.perf_counter() - t0
    finally:
        pipeline.mean_face_factor, enh_mod.mean_face_factor = real_fused, real_enh
    all_factors = np.concatenate(seen)
    d_thr = midway(all_factors, 3)
    cd.enh_model.min_face_factor = cd.enh_threshold = d_thr
    rows = count_enhanced(cd.enh_model)
    nms_kern.launches = 0
    warp_kern.launches = 0
    digests, rates = {}, {}
    for n_proc in (1, 4):
        cd.num_processes = n_proc
        cd.stats = PipelineStats()
        before = rows[0]
        dst = os.path.join(p5["work"], f"enh_p{n_proc}")
        t0 = time.perf_counter()
        cd.process_dir(src, dst, desc=None)
        sec = time.perf_counter() - t0
        check_tree(dst, readable, p5["kw"]["output_size"], f"enhanced tree p{n_proc}")
        digests[n_proc] = tree_digest(dst)
        rates[n_proc] = len(readable) / sec
        split = ", ".join(f"{k} {v['seconds']:.6f} s/{v['calls']} calls/{v['items']} items"
                          for k, v in cd.stats.as_dict().items())
        log(f"  [{card}] (d) process_dir with enh_threshold {d_thr:.9g}, num_processes={n_proc}: "
            f"{len(readable)} crops in {sec:.6f} s = {rates[n_proc]:.6f} faces/s; "
            f"{rows[0] - before} images enhanced; stages: {split}")
    dir_launches = (nms_kern.launches, warp_kern.launches)
    differ = sum(digests[1].get(f) != digests[4].get(f) for f in set(digests[1]) | set(digests[4]))
    log(f"  (d) warm-up pass (nothing gated) {warm:.6f} s; {len(all_factors)} factors recorded, "
        f"{int(np.isfinite(all_factors).sum())} finite; files differing between 1 and 4 threads: "
        f"{differ}; K1 launches {dir_launches[0]}, warp launches {dir_launches[1]}")
    if differ or rows[0] != 6 or (not rehearse and min(dir_launches) < 1):
        raise SystemExit(f"FAIL: enhanced process_dir: {differ} files differ, {rows[0]} images "
                         "enhanced over 2 passes (3 each expected)")
    del cd

    # (e) the landmark-free CLI, every image enhanced, a large original too.
    lf = os.path.join(p5["work"], "enh_lf")
    os.makedirs(lf)
    names = [f for f in readable if "_" not in f[4:]][:16] + [
        next(f for f in readable if f.endswith("_r.jpg"))]
    for f in names:
        os.link(os.path.join(src, f), os.path.join(lf, f))
    lf_out = os.path.join(p5["work"], "enh_lf_out")
    argv = ["-i", lf, "-o", lf_out, "-dt", "-1", "-et", "1", "-b", str(n), "-w", wdir]
    if rehearse:
        argv += ["-d", "cpu"]
    code = ("import runpy, sys, torch; sys.argv = ['face_crop_plus_tpu_torch'] + sys.argv[1:]; "
            "runpy.run_module('face_crop_plus_tpu_torch', run_name='__main__'); "
            "print('PEAK', torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0)")
    log(f"  (e) {release_cached(device)}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, *argv], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    sec = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"FAIL: the landmark-free CLI with -et exited {proc.returncode}:\n"
                         f"{proc.stderr[-3000:]}")
    lf_peak = int(proc.stdout.split("PEAK")[-1])
    got = sorted(os.listdir(lf_out))
    shapes = {}
    changed = 0
    for f in got:
        a, b = imread_rgb(os.path.join(lf_out, f)), imread_rgb(os.path.join(lf, f))
        shapes[f] = a.shape
        changed += int(a.shape == b.shape and np.abs(a.astype(np.int16) - b).mean() > 2)
    big = names[-1]
    log(f"  [{card}] (e) CLI `-dt -1 -et 1` over {len(names)} originals ({len(names) - 1} of "
        f"{shapes.get(names[0])}, one of {shapes.get(big)}): exit 0 in {sec:.3f} s (process "
        f"start, model init, one pass); {changed} of {len(got)} files visibly enhanced; peak "
        f"device memory {lf_peak} B ({lf_peak / 2**30:.6f} GiB)")
    if got != sorted(names) or changed != len(names):
        raise SystemExit(f"FAIL: landmark-free enhanced tree: {len(got)} files, {changed} enhanced")

    wall = time.perf_counter() - t_phase
    log(f"  phase 7 wall time {wall:.3f} s")
    return dict(nms=launches[0], warp=launches[1], dir_nms=dir_launches[0],
                dir_warp=dir_launches[1], fps=fps, wall=wall, rrdb_act=rrdb_t,
                rrdb_fused_gate=rrdb_launches, rrdb_gated_rows=gated_rows)


# ---------------------------------------------------------------------------
# Phase 8: the host path
# ---------------------------------------------------------------------------


class PathCounter:
    """Which path each batch took while active: detect-only passes (the
    host-crop mode's batches), fused passes and detect-only passes over
    packed rows (packed groups), and host warps that ran (the native
    library's RGB or 4:2:0 warp; the warp kernel counts its own launches)."""

    def __init__(self):
        self.n = {"host_crop_batches": 0, "packed_groups": 0, "host_warps": 0}
        self._undo = []

    def _wrap(self, owner, name, count):
        real = getattr(owner, name)

        def wrapped(*args, **kwargs):
            out = real(*args, **kwargs)
            count(kwargs, out)
            return out

        setattr(owner, name, wrapped)
        self._undo.append((owner, name, real))

    def _add(self, key, cond=True):
        self.n[key] += int(bool(cond))

    def __enter__(self):
        from face_crop_plus_tpu_torch.pipeline import FusedPipeline
        from face_crop_plus_tpu_torch.utils import native_io

        def detect_only(kw, _out):
            self._add("host_crop_batches")
            self._add("packed_groups", kw.get("packed_hw") is not None)

        self._wrap(FusedPipeline, "detect_only", detect_only)
        self._wrap(FusedPipeline, "process",
                   lambda kw, _out: self._add("packed_groups", kw.get("packed_hw") is not None))
        for name in ("warp_affine_batch_native", "warp_yuv420_batch_native"):
            self._wrap(native_io, name, lambda _kw, out: self._add("host_warps", out is not None))
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)

    def __str__(self):
        return ", ".join(f"{k} {v}" for k, v in self.n.items())


def landmark_table(p5, device) -> dict:
    """5-point landmarks (source coordinates) of phase 5's readable files:
    the tamed detector's "largest" face of each, by fused detect-only
    passes of up to 16 same-shape images."""
    from face_crop_plus_tpu_torch import Cropper
    from face_crop_plus_tpu_torch.utils.io import read_images

    c = Cropper(device=str(device), strategy="largest", **p5["kw"])
    images, names = read_images(p5["readable"], p5["src"])
    by_shape: dict = {}
    for i, im in enumerate(images):
        by_shape.setdefault(im.shape, []).append(i)
    table = {}
    for ids in by_shape.values():
        for s in range(0, len(ids), 16):
            chunk = ids[s : s + 16]
            lm, idx = c._fused.detect_only(np.stack([images[i] for i in chunk]), c.resize_size)
            for pts, k in zip(lm, idx):
                table[str(names[chunk[k]])] = pts
    return table


def write_landmarks(path, table, names) -> list[str]:
    """A CelebA-style whitespace landmarks file (``bench.py:141-149``'s
    layout, 5 points a row) for ``names``: every 11th file has no row, every
    7th a second row 3 px off the first.  Returns the crop names strategy
    "all" writes."""
    rows, expected = [], []
    for k, name in enumerate(names):
        if k % 11 == 5 or name not in table:
            continue
        stem, ext = os.path.splitext(name)
        shifts = (0.0, 3.0) if k % 7 == 3 else (0.0,)
        for j, shift in enumerate(shifts):
            rows.append(name + " " + " ".join(f"{v:.4f}" for v in (table[name] + shift).ravel()))
            expected.append(f"{stem}_{j}{ext}")
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return sorted(expected)


def link_subset(src, dst, names):
    os.makedirs(dst)
    for f in names:
        os.link(os.path.join(src, f), os.path.join(dst, f))
    return dst


def decoded_diff(dir_a, dir_b) -> int:
    """Largest decoded pixel difference of two trees with the same names."""
    from face_crop_plus_tpu_torch.utils.io import imread_rgb

    return max(int(np.abs(imread_rgb(os.path.join(dir_a, f)).astype(np.int16)
                          - imread_rgb(os.path.join(dir_b, f))).max())
               for f in os.listdir(dir_a))


def phase8_host_path(batches, p3_fps, p5, device, card, rehearse):
    """The host path at full width; see the module docstring.

    Returns each sub-phase's K1 and warp launches for the kernels line.
    """
    from face_crop_plus_tpu_torch import Cropper
    from face_crop_plus_tpu_torch.models.enhancement import mean_face_factor
    from face_crop_plus_tpu_torch.ops import yuv
    from face_crop_plus_tpu_torch.ops.cuda import nms as nms_kern
    from face_crop_plus_tpu_torch.ops.cuda import warp as warp_kern
    from face_crop_plus_tpu_torch.utils import native_io
    from face_crop_plus_tpu_torch.utils.io import read_images
    from face_crop_plus_tpu_torch.utils.landmarks import parse_landmarks_file

    t_phase = time.perf_counter()
    launches = {}
    log("  native host library build_status: "
        + json.dumps(native_io.build_status())[:600])
    # The default routing, but for the rehearsal, whose CPU would take the
    # host-crop mode under "auto" wherever the native library builds.
    default_env = "0" if rehearse else "auto"
    os.environ["FCPT_HOST_CROP"] = default_env
    work, src, readable = p5["work"], p5["src"], p5["readable"]
    n, out, resize = batches[0].shape[0], p5["kw"]["output_size"], p5["kw"]["resize_size"]
    bs = 4 if rehearse else 64

    # (a) the landmark-file mode over phase 5's directory.
    t0 = time.perf_counter()
    table = landmark_table(p5, device)
    lm_path = os.path.join(work, "landmarks.txt")
    expected = write_landmarks(lm_path, table, readable)
    log(f"  (a) landmarks of {len(table)} files from the tamed detector, written as "
        f"{len(expected)} rows of 5 points ({sum(e.endswith(('_1.jpg', '_1.png')) for e in expected)} "
        f"files with two rows, {len(readable) - len({e.rsplit('_', 1)[0] for e in expected})} "
        f"with none) in {time.perf_counter() - t0:.3f} s")
    c = Cropper(device=str(device), landmarks=lm_path, strategy="all", output_size=out,
                batch_size=bs)
    if c.det_model is not None or c._fused is not None:
        raise SystemExit("FAIL: the landmark-file mode built a detector")
    gates = dict(host_crop=c._host_crop_enabled(), yuv_crop=c._yuv_crop_eligible())
    log(f"  FCPT_HOST_CROP={default_env}: gates {gates}")
    if not rehearse and any(gates.values()):
        raise SystemExit("FAIL: 'auto' turned a host warp on on the card")
    per_batch = []
    real_batch = c.process_batch

    def counted_batch(file_names, **kw):
        before = warp_kern.launches
        real_batch(file_names, **kw)
        per_batch.append(warp_kern.launches - before)

    nms_kern.launches = 0
    warp_kern.launches = 0
    trees, rates = {}, {}
    with PathCounter() as paths:
        for n_proc, reps in ((1, 2), (4, 1)):
            c.num_processes = n_proc
            c.process_batch = counted_batch if n_proc == 1 else real_batch
            for rep in range(reps):
                dst = os.path.join(work, f"lm_p{n_proc}_{rep}")
                t0 = time.perf_counter()
                c.process_dir(src, dst, desc=None)
                sec = time.perf_counter() - t0
                check_tree(dst, expected, out, f"landmark tree p{n_proc} pass {rep}")
                trees[(n_proc, rep)] = tree_digest(dst)
                rates[(n_proc, rep)] = len(expected) / sec
                log(f"  [{card}] (a) landmarks 'all', constant, batch {bs}, num_processes="
                    f"{n_proc} pass {rep}: {len(expected)} crops of {len(readable)} files in "
                    f"{sec:.6f} s = {rates[(n_proc, rep)]:.6f} faces/s")
    launches["landmarks"] = (nms_kern.launches, warp_kern.launches)
    differ = {k: sum(trees[(1, 0)].get(f) != v.get(f) for f in set(v) | set(trees[(1, 0)]))
              for k, v in trees.items()}
    log(f"  (a) warp launches per one-thread batch {per_batch}; in all: K1 "
        f"{launches['landmarks'][0]}, warp {launches['landmarks'][1]}; paths: {paths}; files "
        f"differing from the first one-thread tree: {differ}")
    if any(differ.values()):
        raise SystemExit("FAIL: the landmark tree differs across passes or thread counts")
    if not rehearse and (min(per_batch) < 1 or paths.n["host_warps"] or launches["landmarks"][0]):
        raise SystemExit("FAIL: a landmark batch did not crop through the warp kernel")
    del c

    # The five border modes over 16 files, card vs CPU, PNG.
    uniform = [f for f in readable if "_" not in f[4:]]
    sub = link_subset(src, os.path.join(work, "lm16"), uniform[:12] + [
        f for f in readable if f.endswith(("_r.jpg", "_p.png"))][:4])
    sub_expected = sorted(e for e in expected if e.rsplit("_", 1)[0] in
                          {os.path.splitext(f)[0] for f in os.listdir(sub)})
    sub_expected = [os.path.splitext(e)[0] + ".png" for e in sub_expected]
    worst = {}
    for mode in ("constant", "replicate", "reflect", "wrap", "reflect_101"):
        dirs = []
        for k, dev in enumerate((str(device), "cpu")):
            cm = Cropper(device=dev, landmarks=lm_path, strategy="all", output_size=out,
                         batch_size=bs, padding=mode, output_format="png")
            dirs.append(os.path.join(work, f"lm16_{mode}_{k}"))
            cm.process_dir(sub, dirs[-1], desc=None)
            check_tree(dirs[-1], sub_expected, out, f"landmark subset {mode} on {dev}")
        worst[mode] = decoded_diff(*dirs)
    log(f"  (a) {len(os.listdir(sub))} files ({len(sub_expected)} crops), {device} vs cpu, PNG, "
        f"max pixel |diff| by border mode: {worst}")
    if max(worst.values()) > 1:
        raise SystemExit("FAIL: landmark crops on the card differ from the CPU by more than 1")

    # (b) the landmark mode with the parser, then with the enhancer.
    lm_names = {e.rsplit("_", 1)[0] for e in expected}
    one_row = [f for f in uniform if f"{os.path.splitext(f)[0]}_1.jpg" not in expected
               and os.path.splitext(f)[0] in lm_names]
    par_dir = link_subset(src, os.path.join(work, "lm64"), uniform[: 8 if rehearse else 64])
    groups_kw = dict(attr_groups=ATTR_GROUPS, mask_groups=MASK_GROUPS)
    cp = Cropper(device=str(device), landmarks=lm_path, strategy="largest", output_size=out,
                 batch_size=n, **groups_kw)
    cp.par_model.net.load_state_dict(tamed_parser_state_dict(cp.par_model.net))
    cp.par_model.attr_join_by_and = False
    seen = []
    real_predict = cp.par_model.predict

    def recording(images, *args, **kwargs):
        seen.append(np.asarray(images))
        return real_predict(images, *args, **kwargs)

    cp.par_model.predict = recording
    par_out = os.path.join(work, "lm64_parse")
    nms_kern.launches = 0
    warp_kern.launches = 0
    t0 = time.perf_counter()
    cp.process_dir(par_dir, par_out, desc=None)
    sec = time.perf_counter() - t0
    launches["landmarks_parse"] = (nms_kern.launches, warp_kern.launches)
    cp.par_model.predict = real_predict
    n_files, n_parsed = len(os.listdir(par_dir)), sum(len(x) for x in seen)
    per_dir, n_faces = check_parse_tree(par_out, n_files, "landmark parse tree")
    log(f"  [{card}] (b) landmarks + BiSeNet (512², tamed) over {n_files} files: "
        f"{n_parsed} crops parsed in {len(seen)} batches, {n_faces} written (a second row "
        f"overwrites its file's first under 'largest'), {sec:.6f} s = {n_parsed / sec:.6f} "
        f"faces/s (first pass); warp launches {launches['landmarks_parse'][1]}; tree {per_dir}")
    if not rehearse and launches["landmarks_parse"][1] < len(seen):
        raise SystemExit("FAIL: a landmark parse batch did not crop through the warp kernel")
    parse_card_vs_cpu(cp.par_model, seen[0][:4], groups_kw, device, "(b)")
    del cp, seen

    blocks = 1 if rehearse else 23
    enh16 = one_row[:n]
    rows_lm, rows_names = parse_landmarks_file(lm_path)
    pts = np.stack([rows_lm[list(rows_names).index(f)] for f in enh16])
    hw = read_images(enh16[:1], src)[0][0].shape[:2]
    factors = mean_face_factor(pts, list(range(len(enh16))), len(enh16), hw)
    thr = midway(factors, 2 if len(enh16) > 2 else 1)
    gated = [enh16[i] for i in np.nonzero(factors <= thr)[0]]
    plain = [f for f in enh16 if f not in gated][:2]
    enh_dirs = []
    for k, (dev, names) in enumerate(((str(device), enh16), ("cpu", gated + plain))):
        ce = Cropper(device=dev, landmarks=lm_path, strategy="largest", output_size=out,
                     batch_size=n, enh_threshold=thr, output_format="png")
        tame_enhancer(ce.enh_model, blocks)
        rows = [0]
        real_enh = ce.enh_model.enhance_images

        def counted_enh(images, *args, _real=real_enh, _rows=rows, **kwargs):
            _rows[0] += len(images)
            return _real(images, *args, **kwargs)

        ce.enh_model.enhance_images = counted_enh
        d_in = link_subset(src, os.path.join(work, f"lm_enh_in_{k}"), names)
        enh_dirs.append(os.path.join(work, f"lm_enh_{k}"))
        nms_kern.launches = 0
        warp_kern.launches = 0
        t0 = time.perf_counter()
        ce.process_dir(d_in, enh_dirs[-1], desc=None)
        sec = time.perf_counter() - t0
        if k == 0:
            launches["landmarks_enhance"] = (nms_kern.launches, warp_kern.launches)
        log(f"  [{card if k == 0 else 'cpu'}] (b) landmarks + RRDBNet ({blocks} RRDBs, "
            f"tamed) on {dev}: {len(names)} files, threshold {thr:.9g}, {rows[0]} enhanced, "
            f"{sec:.6f} s")
        if rows[0] != len(gated):
            raise SystemExit(f"FAIL: {rows[0]} images enhanced on {dev}, not {len(gated)}")
        del ce
    lv = {f: int(np.abs(read_rgb(enh_dirs[0], f).astype(np.int16)
                        - read_rgb(enh_dirs[1], f)).max()) for f in gated + plain}
    log(f"  (b) {device} vs cpu, gated {gated} and plain {plain}: max pixel |diff| {lv}")
    if any(lv[f] > 2 for f in gated) or any(lv[f] > 1 for f in plain):
        raise SystemExit("FAIL: enhanced landmark crops differ between the card and the CPU")

    # (c) the host-crop mode forced on phase 3's batches, with phase 3's
    # random-init detector and with tamed weights.  The random detector's
    # faces span thousands of pixels, so its crops minify the noise 20-50x
    # and the host's numpy fit and the device's f32 fit move such samples
    # by up to 2 levels (the band against the host warp, PERF.md §2); the
    # tamed detector's faces sit inside the image, where the fits agree
    # within 1 level.
    host_crop_launches = [0, 0]
    for weights, band in (("random", 2), ("tamed", 1)):
        ch = Cropper(device=str(device), output_size=out, resize_size=resize,
                     strategy="largest", det_threshold=-1.0, batch_size=n)
        if weights == "tamed":
            ch.det_model.net.load_state_dict(tamed_state_dict(ch.det_model.net))
        runs = {}
        for env in ("0", "1"):
            os.environ["FCPT_HOST_CROP"] = env
            nms_kern.launches = 0
            warp_kern.launches = 0
            per_request, seconds, results = [], [], []
            with PathCounter() as paths:
                for batch in batches[:5]:
                    before = (nms_kern.launches, warp_kern.launches)
                    t0 = time.perf_counter()
                    results.append(ch.process_images(batch)[:2])
                    seconds.append(time.perf_counter() - t0)
                    per_request.append((nms_kern.launches - before[0],
                                        warp_kern.launches - before[1]))
            fps = sum(len(r[1]) for r in results[1:]) / sum(seconds[1:])
            runs[env] = (results, per_request, paths.n, fps)
            log(f"  [{card}] (c) {weights} detector, FCPT_HOST_CROP={env}: {fps:.6f} faces/s "
                f"over 4 requests after one warm-up (phase 3: {p3_fps:.6f}); (K1, warp) "
                f"launches per request {per_request}; paths: {paths}; request seconds "
                + ", ".join(f"{s:.6f}" for s in seconds))
        os.environ["FCPT_HOST_CROP"] = default_env
        host_crop_launches[0] += sum(p[0] for p in runs["1"][1])
        host_crop_launches[1] += sum(p[1] for p in runs["1"][1])
        host_warp = "native (host)" if runs["1"][2]["host_warps"] else "warp_affine_u8 (card)"
        diffs = [level_diff(a[0], b[0]) for a, b in zip(runs["0"][0], runs["1"][0])]
        same_idx = all(np.array_equal(a[1], b[1]) for a, b in zip(runs["0"][0], runs["1"][0]))
        log(f"  (c) {weights} detector, host-crop mode: detect-only passes "
            f"{runs['1'][2]['host_crop_batches']}, crops by {host_warp}; indices equal to the "
            f"default path's {same_idx}; max pixel |diff| per request {[d[0] for d in diffs]} "
            f"(limit {band}), differing share " + ", ".join(f"{d[1]:.9f}" for d in diffs))
        if not same_idx or max(d[0] for d in diffs) > band or runs["1"][2]["host_crop_batches"] != 5:
            raise SystemExit(f"FAIL: host-crop crops ({weights} detector) differ from the "
                             "default path's")
        if not rehearse and (min(p[0] for p in runs["1"][1]) < 1
                             or min(p[1] for p in runs["1"][1]) < 1):
            raise SystemExit("FAIL: K1 or the warp did not launch on every host-crop request")
    launches["host_crop"] = tuple(host_crop_launches)

    # (d) the packed wire's device half, on rows packed by the numpy twin.
    h, w = batches[0].shape[1:3]
    rows_np = yuv.rgb_to_yuv420_np(batches[0])
    recon_np = yuv.yuv420_to_rgb_np(rows_np, h, w)
    dev_rows = torch.from_numpy(rows_np).to(device)
    recon_eq = np.array_equal(yuv.yuv420_to_rgb(dev_rows, h, w).cpu().numpy(), recon_np)
    pack_eq = np.array_equal(
        yuv.rgb_to_yuv420(torch.from_numpy(batches[0]).to(device)).cpu().numpy(), rows_np)
    nms_kern.launches = 0
    warp_kern.launches = 0
    with ch._device_lock:
        got = ch._fused.process(rows_np, ch.resize_size, packed_hw=(h, w))
        ref = ch._fused.process(recon_np, ch.resize_size)
    same = all(np.array_equal(a, b) for a, b in zip(got, ref))
    log(f"  (d) {n}x{h}x{w} rows ({rows_np.shape[1]} B each, packed by rgb_to_yuv420_np): "
        f"device reconstruction bitwise equal to yuv420_to_rgb_np {recon_eq}; device packing "
        f"bitwise equal to rgb_to_yuv420_np {pack_eq}; 'largest' on packed rows vs on the "
        f"reconstruction: crops, landmarks, indices equal {same} ({len(got[2])} faces)")
    if not (recon_eq and pack_eq and same):
        raise SystemExit("FAIL: the packed wire's device half differs from its numpy twins")
    del ch
    ca = Cropper(device=str(device), output_size=out, resize_size=resize, strategy="all",
                 det_threshold=-1.0, batch_size=n)
    stage = {}
    for label, kw in (("warm-up", {}), ("RGB", {}), ("packed", dict(pack_crops=True))):
        timer = StageTimer(device)
        ca._fused.stage_timer = timer
        t0 = time.perf_counter()
        res = ca._fused.process(rows_np, ca.resize_size, packed_hw=(h, w), **kw)
        total = (time.perf_counter() - t0) * 1e3
        ca._fused.stage_timer = None
        stage[label] = (res, timer.ms.get("to_host", 0.0), total, timer.ms.get("unpack", 0.0))
    launches["packed"] = (nms_kern.launches, warp_kern.launches)
    (rgb, _, rgb_idx), (packed, _, packed_idx) = stage["RGB"][0], stage["packed"][0]
    chunk = 512
    checked = [(0, min(chunk, len(rgb))), (max(0, len(rgb) - chunk), len(rgb))]
    packed_eq = np.array_equal(rgb_idx, packed_idx) and all(
        np.array_equal(packed[a:b], yuv.rgb_to_yuv420_np(rgb[a:b])) for a, b in checked)
    log(f"  [{card}] (d) 'all' on packed rows, {len(rgb_idx)} crops: to_host {stage['RGB'][1]:.6f} "
        f"ms for {rgb.nbytes} B of RGB crops (request {stage['RGB'][2]:.6f} ms) vs "
        f"{stage['packed'][1]:.6f} ms for {packed.nbytes} B packed on the device (request "
        f"{stage['packed'][2]:.6f} ms); unpack {stage['RGB'][3]:.6f} ms; packed rows of crops "
        f"{checked} bitwise equal to rgb_to_yuv420_np of the RGB crops {packed_eq}; "
        f"(K1, warp) launches {launches['packed']}")
    if not packed_eq:
        raise SystemExit("FAIL: the device packing of crops differs from rgb_to_yuv420_np")
    del ca, stage, rgb, packed

    wall = time.perf_counter() - t_phase
    log(f"  phase 8 wall time {wall:.3f} s")
    return dict(launches=launches, fps=rates, wall=wall)


# ---------------------------------------------------------------------------
# Phase 9: serving and sharding
# ---------------------------------------------------------------------------


def device_activity(fn):
    """Runs ``fn`` under the profiler: (busy µs, window µs, wall µs, the
    longest idle gaps µs, activities) of the card's activity (kernels,
    copies, sets; overlapping spans merged) from its first start to its
    last end; None when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and e.time_range.end > e.time_range.start)
    if not spans:
        return None
    merged = [list(spans[0])]
    for s, e in spans[1:]:
        if s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    gaps = sorted((b[0] - a[1] for a, b in zip(merged, merged[1:])), reverse=True)
    return busy, merged[-1][1] - merged[0][0], wall_us, gaps[:3], len(spans)


def launch_queue_depth(device) -> tuple[int, float]:
    """How many kernel launches the host enqueues behind a busy card before
    one blocks: ~0.3 s of f32 matmuls queued, then one-element adds timed
    one by one until a launch takes over 2 ms.  Returns (adds enqueued
    before it, its host ms), or (-1, 0.0) when none of 16,384 blocked."""
    a = torch.randn(8192, 8192, device=device)
    x = torch.zeros(1, device=device)
    torch.cuda.synchronize()
    for _ in range(15):
        a @ a
    found = (-1, 0.0)
    for i in range(16384):
        t0 = time.perf_counter()
        x.add_(1)
        ms = (time.perf_counter() - t0) * 1e3
        if ms > 2.0:
            found = (i, ms)
            break
    torch.cuda.synchronize()
    return found


def same_result(a, b) -> bool:
    """Two ``process_images`` tuples bitwise equal, groups included."""
    (ca, ia, (attr_a, mask_a)), (cb, ib, (attr_b, mask_b)) = a, b
    if not (np.array_equal(ca, cb) and np.array_equal(ia, ib) and attr_a == attr_b):
        return False
    if (mask_a is None) != (mask_b is None):
        return False
    return mask_a is None or (set(mask_a) == set(mask_b) and all(
        mask_a[k][0] == mask_b[k][0] and np.array_equal(mask_a[k][1], mask_b[k][1])
        for k in mask_a))


def serve(cropper, reqs, depth=None, **kw):
    """``reqs`` through ``process_images_stream`` at ``depth``, or through a
    per-call ``process_images`` loop (``depth`` None): (results, request
    latencies s, wall s, (K1, warp) launches).  A stream request's latency
    runs from the generator pulling its batch to yielding its result."""
    from face_crop_plus_tpu_torch.ops.cuda import nms as nms_kern
    from face_crop_plus_tpu_torch.ops.cuda import warp as warp_kern

    results, lat, pulled = [], [], []

    def source():
        for b in reqs:
            pulled.append(time.perf_counter())
            yield b

    nms_kern.launches = 0
    warp_kern.launches = 0
    t0 = time.perf_counter()
    if depth is None:
        for b in reqs:
            t1 = time.perf_counter()
            results.append(cropper.process_images(b))
            lat.append(time.perf_counter() - t1)
    else:
        for k, r in enumerate(cropper.process_images_stream(source(), depth=depth, **kw)):
            lat.append(time.perf_counter() - pulled[k])
            results.append(r)
    wall = time.perf_counter() - t0
    return results, lat, wall, (nms_kern.launches, warp_kern.launches)


def rate_line(label, results, lat, wall) -> str:
    faces = sum(len(r[1]) for r in results)
    return (f"{label}: {faces / wall:.6f} faces/s ({len(results)} requests, {faces} faces, "
            f"{wall:.6f} s); request latency p50 {np.percentile(lat, 50) * 1e3:.6f} ms, p99 "
            f"{np.percentile(lat, 99) * 1e3:.6f} ms")


#: Idle-card dispatches phase 9 (a) times; their median is held.
IDLE_DISPATCHES = 9


def phase9_serving(batches, p5, device, card, rehearse):
    """Serving and sharding; see the module docstring.

    Returns each sub-phase's (K1, warp) launches for the kernels line.
    """
    from face_crop_plus_tpu_torch import Cropper
    from face_crop_plus_tpu_torch.utils import native_io

    t_phase = time.perf_counter()
    os.environ["FCPT_HOST_CROP"] = "0"
    n, (h, w) = batches[0].shape[0], batches[0].shape[1:3]
    out, resize = (32, 64) if rehearse else (256, 1024)
    n_req = 6 if rehearse else 24
    rng = np.random.default_rng(9)
    reqs = [rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8) for _ in range(n_req)]
    launches = {}

    # (a) the card's default: the single-program pass in flight.
    c = Cropper(device=str(device), output_size=out, resize_size=resize, strategy="largest",
                det_threshold=-1.0, batch_size=n)
    c.process_images(reqs[0])  # warm-up: pre_topk grows to its ceiling here
    timer = StageTimer(device)
    c._fused.stage_timer = timer
    c.process_images(reqs[1])
    c._fused.stage_timer = None
    network_ms = timer.ms["network"]
    # The idle-card dispatch, timed IDLE_DISPATCHES times by the host clock
    # (each after a synchronize, each finished before the next) and held
    # by its median: one sample on a shared host can read twice another.
    idle_samples = []
    for _ in range(IDLE_DISPATCHES):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        handle = c._fused.process_async(c._pad_group(reqs[2]), c.resize_size)
        idle_samples.append((time.perf_counter() - t0) * 1e3)
        c._fused.process_finish(handle)
        del handle
    idle_ms = float(np.median(idle_samples))

    ref, lat, wall, per_call = serve(c, reqs)
    log(f"  [{card}] (a) {rate_line('per-call process_images', ref, lat, wall)}; (K1, warp) "
        f"launches {per_call}")
    rates = {"per_call": sum(len(r[1]) for r in ref) / wall}
    host_ms = {"process_async": [], "_upload": []}

    def timed(name):
        real = getattr(c._fused, name)

        def call(*args, **kwargs):
            t1 = time.perf_counter()
            result = real(*args, **kwargs)
            host_ms[name].append((time.perf_counter() - t1) * 1e3)
            return result

        return call

    stream_launches = [0, 0]
    for depth in (1, 2, 3):
        if depth == 2:  # host times of the dispatch and of its upload
            for name in host_ms:
                setattr(c._fused, name, timed(name))
        try:
            got, lat, wall, counts = serve(c, reqs, depth)
        finally:
            for name in host_ms:
                c._fused.__dict__.pop(name, None)
        same = [same_result(a, b) for a, b in zip(got, ref)]
        rates[f"depth_{depth}"] = sum(len(r[1]) for r in got) / wall
        log(f"  [{card}] (a) {rate_line(f'stream depth {depth}', got, lat, wall)}; (K1, warp) "
            f"launches {counts}; every yield bitwise equal to the per-call loop's "
            f"{all(same) and len(got) == len(ref)}")
        if not all(same) or len(got) != len(ref):
            raise SystemExit(f"FAIL: stream depth {depth} differs from process_images "
                             f"(requests {[k for k, s in enumerate(same) if not s]})")
        if not rehearse and counts != (n_req, n_req):
            raise SystemExit(f"FAIL: stream depth {depth}: (K1, warp) launches {counts}, "
                             f"expected one each per request ({n_req})")
        stream_launches = [a + b for a, b in zip(stream_launches, counts)]
    launches["serving_stream"] = tuple(stream_launches)
    med = {k: float(np.median(v)) for k, v in host_ms.items()}
    top = {k: float(np.max(v)) for k, v in host_ms.items()}
    log(f"  [{card}] (a) host time to return from one dispatch (process_async: upload, "
        f"detect, fit, warp and host copies enqueued) on an idle card, "
        f"{len(idle_samples)} dispatches: "
        + ", ".join(f"{v:.6f}" for v in idle_samples)
        + f" ms; median {idle_ms:.6f} ms, max {max(idle_samples):.6f} ms (the median is "
        f"{idle_ms / network_ms:.6f} of the network's {network_ms:.6f} ms, stage timer, one "
        f"request); during the depth-2 stream, {len(host_ms['process_async'])} dispatches: "
        f"the upload (_upload) median {med['_upload']:.6f} ms, max {top['_upload']:.6f} ms; "
        f"the whole dispatch median {med['process_async']:.6f} ms, max "
        f"{top['process_async']:.6f} ms")
    if not rehearse:
        queued, blocked_ms = launch_queue_depth(device)
        log(f"  [{card}] (a) launch queue: behind a busy card the host enqueued {queued} "
            f"one-element adds before a launch blocked it ({blocked_ms:.6f} ms); with batches "
            f"in flight a dispatch returns when the queue has room for its launches")
    if not rehearse and max(idle_ms, med["_upload"]) >= network_ms / 10:
        raise SystemExit("FAIL: a dispatch or its upload blocks: the median of the idle "
                         "dispatches or of the stream's uploads takes a tenth of the "
                         "network's time or more")
    if device.type == "cuda":
        k = 4 if rehearse else 8
        for label, fn in (("stream depth 2", lambda: list(c.process_images_stream(reqs[:k]))),
                          ("per-call", lambda: [c.process_images(b) for b in reqs[:k]])):
            act = device_activity(fn)
            if act is None:
                log(f"  (a) profiled {label}: the profiler saw no device activity")
                continue
            busy, window, wall_us, gaps, n_act = act
            log(f"  [{card}] (a) profiled {label}, {k} requests: device busy {busy:.3f} us of "
                f"a {window:.3f} us window (busy share {busy / window:.6f}; of the "
                f"{wall_us:.3f} us wall with the profiler on {busy / wall_us:.6f}); longest "
                f"idle gaps " + ", ".join(f"{g:.3f} us" for g in gaps)
                + f"; {n_act} device activities (kernels, copies, sets)")

    # (c) a mixed stream: uniform, ragged (three shapes: one staged detect),
    # empty, uniform; then strategy "all" (serialized).
    ragged = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
              for hw in ((h, w), (h + 40, w - 20), (w, h))]
    mixed = [reqs[0], reqs[1], ragged, [], reqs[2]]
    ref_m, _, _, _ = serve(c, mixed)
    got_m, _, wall, counts = serve(c, mixed, 2)
    same = [same_result(a, b) for a, b in zip(got_m, ref_m)]
    log(f"  (c) mixed stream (uniform, uniform, ragged {[im.shape for im in ragged]}, empty, "
        f"uniform) at depth 2: faces per request {[len(r[1]) for r in got_m]}, equal to "
        f"per-call {same}; (K1, warp) launches {counts}")
    if not all(same) or len(got_m) != len(mixed):
        raise SystemExit("FAIL: a mixed stream differs from per-call process_images")
    launches["serving_mixed"] = counts
    del c
    ca = Cropper(device=str(device), output_size=out, resize_size=resize, strategy="all",
                 det_threshold=-1.0, batch_size=n, auto_grow=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the binding caps warn once
        ref_a, _, _, _ = serve(ca, reqs[:2])
        got_a, _, wall, counts = serve(ca, reqs[:2], 2)
    same = [same_result(a, b) for a, b in zip(got_a, ref_a)]
    log(f"  [{card}] (c) strategy 'all' (max_faces 64, auto_grow off) through the stream, "
        f"serialized: {[len(r[1]) for r in got_a]} crops, equal to per-call {same}; "
        f"{sum(len(r[1]) for r in got_a) / wall:.6f} faces/s; (K1, warp) launches {counts}")
    if not all(same):
        raise SystemExit("FAIL: strategy 'all' through the stream differs from per-call")
    launches["serving_all"] = counts
    del ca, ref_a, got_a

    # (b) the host-crop mode (FCPT_HOST_CROP=1) at depth 2, with the tamed
    # detector on smooth images, with and without packed uploads.
    ch = Cropper(device=str(device), output_size=out, resize_size=resize, strategy="largest",
                 det_threshold=-1.0, batch_size=n)
    ch.det_model.net.load_state_dict(tamed_state_dict(ch.det_model.net))
    smooth = [smooth_batch(rng, (n, h, w, 3), cell=24) for _ in range(4 if rehearse else 8)]
    os.environ["FCPT_HOST_CROP"] = "1"
    try:
        gates = {"host_crop": ch._host_crop_enabled(),
                 "native_warp": native_io.native_warp_available(ch.padding),
                 "native_yuv": native_io.yuv_encoder_available()}
        ch.process_images(smooth[0])  # warm-up
        real_detect, packed_dispatches = ch._fused.detect_only_async, []
        ch._fused.detect_only_async = lambda *a, **k: (
            packed_dispatches.append(k.get("packed_hw") is not None) or real_detect(*a, **k))
        with PathCounter() as paths:
            ref_h, lat, wall, _ = serve(ch, smooth)
            log(f"  [{card}] (b) FCPT_HOST_CROP=1, gates {gates}: "
                f"{rate_line('per-call', ref_h, lat, wall)}")
            got_h, lat, wall, counts = serve(ch, smooth, 2)
            log(f"  [{card}] (b) {rate_line('stream depth 2', got_h, lat, wall)}; (K1, warp) "
                f"launches {counts}")
            packed, lat, wall, counts_p = serve(ch, smooth, 2, pack_upload=True)
            log(f"  [{card}] (b) {rate_line('stream depth 2, pack_upload', packed, lat, wall)}; "
                f"(K1, warp) launches {counts_p}")
    finally:
        os.environ["FCPT_HOST_CROP"] = "0"
        ch._fused.__dict__.pop("detect_only_async", None)
    same = [same_result(a, b) for a, b in zip(got_h, ref_h)]
    idx_eq = all(np.array_equal(a[1], b[1]) for a, b in zip(packed, got_h))
    means = [float(np.abs(a[0].astype(np.int16) - b[0].astype(np.int16)).mean())
             for a, b in zip(packed, got_h)]
    log(f"  (b) paths: {paths}; stream equal to per-call {same}; packed: indices equal to the "
        f"RGB stream {idx_eq}, mean pixel |diff| per request "
        + ", ".join(f"{m:.6f}" for m in means) + f" (limit 4); packed dispatches "
        f"{sum(packed_dispatches)} of {len(packed_dispatches)}; packed groups in the shape "
        f"budget {sorted(k for k in ch._fused_shapes if k[0] == 'yuv420')}")
    if (not all(same) or not idx_eq or max(means) >= 4.0
            or sum(packed_dispatches) != len(smooth)):
        raise SystemExit("FAIL: the host-crop stream differs from per-call or the packed band")
    if not rehearse and min(counts + counts_p) < len(smooth):
        raise SystemExit("FAIL: K1 or the warp did not launch on every host-crop request")
    launches["serving_host_crop"] = (counts[0] + counts_p[0], counts[1] + counts_p[1])
    del ch, ref_h, got_h, packed

    # (d) parsing at collect time: phase 6's BiSeNet configuration.
    cp = Cropper(device=str(device), output_size=out, resize_size=resize, strategy="largest",
                 det_threshold=-1.0, batch_size=n, attr_groups=ATTR_GROUPS,
                 mask_groups=MASK_GROUPS)
    cp.par_model.net.load_state_dict(tamed_parser_state_dict(cp.par_model.net))
    cp.par_model.attr_join_by_and = False
    cp.process_images(reqs[0])  # warm-up
    k = 4 if rehearse else 8
    ref_p, lat, wall, _ = serve(cp, reqs[:k])
    log(f"  [{card}] (d) with BiSeNet: {rate_line('per-call', ref_p, lat, wall)}")
    got_p, lat, wall, counts = serve(cp, reqs[:k], 2)
    same = [same_result(a, b) for a, b in zip(got_p, ref_p)]
    sizes = {g: len(v) for g, v in got_p[0][2][0].items()}
    log(f"  [{card}] (d) {rate_line('stream depth 2', got_p, lat, wall)}; (K1, warp) launches "
        f"{counts}; crops and groups equal to per-call {same}; first request's attribute "
        f"groups {sizes}")
    if not all(same) or not got_p[0][2][1]:
        raise SystemExit("FAIL: parsing at collect differs from per-call process_images")
    launches["serving_parse"] = counts
    del cp, ref_p, got_p

    # (e) two processes on the one card, -si auto, over the uniform files of
    # phase 5's directory.  With the ragged files a file's path would hang
    # on the rest of its batch (a shape takes the fused path only with
    # enough images in the batch, the staged detect pads to the count it
    # holds), and a shard's batches hold other files than one process's.
    kw, work = p5["kw"], os.path.join(p5["work"], "sharded")
    src = link_subset(p5["src"], os.path.join(work, "in"),
                      [f for f in p5["readable"] if "_" not in f[4:]])
    cmd = [sys.executable, "-m", "face_crop_plus_tpu_torch", "-i", src,
           "-r", str(kw["resize_size"]), "-s", str(kw["output_size"]), "-dt", "0",
           "-b", str(kw["batch_size"]), "-w", p5["wdir"], "-f", "png"]
    if rehearse:
        cmd += ["-d", "cpu"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    log(f"  (e) {release_cached(device)}")
    t0 = time.perf_counter()
    one = subprocess.run(cmd + ["-o", os.path.join(work, "one")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    one_s = time.perf_counter() - t0
    if one.returncode != 0:
        raise SystemExit(f"FAIL: the one-process CLI exited {one.returncode}:\n"
                         f"{one.stderr[-3000:]}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2", LOCAL_RANK="0")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["-o", os.path.join(work, f"rank{r}"), "-si", "auto"],
                              cwd=ROOT, env=dict(env, RANK=str(r)), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    pair_s = time.perf_counter() - t0
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise SystemExit(f"FAIL: the -si auto CLI of rank {r} exited {p.returncode}:\n"
                             f"{err[-3000:]}")
    names = [sorted(os.listdir(os.path.join(work, f"rank{r}"))) for r in range(2)]
    all_names = sorted(os.listdir(os.path.join(work, "one")))
    partition = (sorted(names[0] + names[1]) == all_names and not set(names[0]) & set(names[1])
                 and all(names))
    differing, level = 0, 0
    if partition:
        for r in range(2):
            for name in names[r]:
                d = level_diff(read_rgb(os.path.join(work, f"rank{r}"), name),
                               read_rgb(os.path.join(work, "one"), name))[0]
                differing += int(d > 0)
                level = max(level, d)
    log(f"  [{card}] (e) -si auto, two processes (RANK 0/1, WORLD_SIZE 2, LOCAL_RANK 0) on the "
        f"one card over phase 5's {len(os.listdir(src))} uniform files: {len(names[0])} + "
        f"{len(names[1])} crops "
        f"partition the one-process tree's {len(all_names)} {partition}; files differing "
        f"{differing}, max pixel |diff| {level} (limit 1); pair wall {pair_s:.6f} s beside one "
        f"process {one_s:.6f} s (process start, build, model init, one pass each)")
    if not partition or level > 1:
        raise SystemExit("FAIL: the -si auto processes do not partition the one-process tree")

    wall = time.perf_counter() - t_phase
    log(f"  phase 9 wall time {wall:.3f} s")
    return dict(launches=launches, fps=rates, wall=wall)


# ---------------------------------------------------------------------------
# Phase 10: the in-process data mesh
# ---------------------------------------------------------------------------


class ShardCounter:
    """Per-shard calls and kernel launches of a mesh Cropper's fused pipeline.

    Spies on the per-shard calls (each shard's detect pass, "best"/"largest"
    pass and shard-local warps) and adds each call's K1 and warp launches to
    its shard, which the replica it runs (or its place in the block list)
    names; the shard-local warps run one shard at a time through the real
    method, which does the same work.  ``enqueue_ms`` holds the host time
    from the first shard's "largest" pass entering to the last one's
    returning: every shard enqueued.
    """

    def __init__(self, cropper):
        from face_crop_plus_tpu_torch.ops.cuda import nms as nms_kern
        from face_crop_plus_tpu_torch.ops.cuda import warp as warp_kern

        fused, det, s_count = cropper._fused, cropper.det_model, cropper.mesh.size
        self.calls, self.k1, self.warp = [0] * s_count, [0] * s_count, [0] * s_count
        self.enqueue_ms = []
        real_trace, real_core, real_local = (fused._detect_trace, fused._run_core,
                                             fused._crop_local_sharded)
        start = [0.0]

        def shard_of(net):
            return next(i for i, r in enumerate(det.replicas()) if r is net)

        def trace(block, ih, iw, args, net=None):
            s, k0 = shard_of(net), nms_kern.launches
            out = real_trace(block, ih, iw, args, net)
            self.calls[s] += 1
            self.k1[s] += nms_kern.launches - k0
            return out

        def core(block, ih, iw, args, net=None):
            s, w0 = shard_of(net), warp_kern.launches
            if s == 0:
                start[0] = time.perf_counter()
            out = real_core(block, ih, iw, args, net)
            self.warp[s] += warp_kern.launches - w0
            if s == s_count - 1:
                self.enqueue_ms.append((time.perf_counter() - start[0]) * 1e3)
            return out

        def local(blocks, lm, local_idx, window=None):
            c, outs = len(local_idx) // len(blocks), []
            for s, block in enumerate(blocks):
                w0 = warp_kern.launches
                outs += real_local([block], lm[s * c : (s + 1) * c],
                                   local_idx[s * c : (s + 1) * c], window)
                self.warp[s] += warp_kern.launches - w0
            return outs

        fused._detect_trace, fused._run_core, fused._crop_local_sharded = trace, core, local

    def reset(self):
        for counts in (self.calls, self.k1, self.warp):
            counts[:] = [0] * len(counts)


def tree_files(root) -> dict:
    """Relative path → path of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            out[os.path.relpath(os.path.join(d, f), root)] = os.path.join(d, f)
    return out


def compare_trees(dir_a, dir_b) -> tuple[bool, int, int, int, float]:
    """(names equal, files differing, largest crop pixel difference, mask
    files differing, share of mask pixels differing) of two grouped trees;
    ``_mask`` directories hold masks, where a flipped label moves a pixel by
    255."""
    from face_crop_plus_tpu_torch.utils.io import imread_rgb

    a, b = tree_files(dir_a), tree_files(dir_b)
    if sorted(a) != sorted(b):
        return False, -1, -1, -1, -1.0
    files, crop_diff, mask_files, mask_px, mask_total = 0, 0, 0, 0, 0
    for rel in a:
        ia, ib = imread_rgb(a[rel]).astype(np.int16), imread_rgb(b[rel]).astype(np.int16)
        d = np.abs(ia - ib)
        files += int(d.max() > 0)
        if "_mask" in os.path.dirname(rel):
            mask_files += int(d.max() > 0)
            mask_px += int((d.max(axis=-1) > 0).sum())
            mask_total += d.shape[0] * d.shape[1]
        else:
            crop_diff = max(crop_diff, int(d.max()))
    return True, files, crop_diff, mask_files, mask_px / max(mask_total, 1)


def phase10_mesh(batches, p3, p5, device, card, rehearse):
    """The in-process data mesh at full width; see the module docstring.

    Returns each sub-phase's (K1, warp) launches for the kernels line.
    """
    from face_crop_plus_tpu_torch import Cropper
    from face_crop_plus_tpu_torch import pipeline
    from face_crop_plus_tpu_torch.models import enhancement as enh_mod
    from face_crop_plus_tpu_torch.ops.cuda import nms as nms_kern
    from face_crop_plus_tpu_torch.ops.cuda import warp as warp_kern
    from face_crop_plus_tpu_torch.ops.yuv import rgb_to_yuv420_np, yuv420_to_rgb_np
    from face_crop_plus_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    os.environ["FCPT_HOST_CROP"] = "0"
    n, (h, w) = batches[0].shape[0], batches[0].shape[1:3]
    out, resize = (32, 64) if rehearse else (256, 1024)
    kw = dict(output_size=out, resize_size=resize, det_threshold=-1.0, batch_size=n)
    launches = {"mesh_largest": [0, 0], "mesh_all": [0, 0]}
    # Phase 3's shapes, smooth: "all" crops every candidate, some minified
    # 20-50x, and on per-pixel noise another batch size's f32 rounding moves
    # their samples by several levels (smooth_batch); phase 3's own noise
    # batch runs beside, as a diagnostic.
    noise = batches[5]
    rng = np.random.default_rng(10)
    batches = [smooth_batch(rng, (n, h, w, 3)) for _ in range(6)]

    def reset_peak():
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak_line():
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
        return f"peak device memory {peak} B ({peak / 2**30:.6f} GiB)"

    def tamed(cropper):
        """Tamed detector weights (as phase 5's): faces of sane size, where
        the random-init detector's fits of huge faces magnify the f32
        rounding of another batch size into several levels."""
        net = cropper.det_model.net
        net.load_state_dict(tamed_state_dict(net))
        return cropper

    # The single device's results on the same batches.
    single = tamed(Cropper(device=str(device), strategy="largest", **kw))
    ref_largest, seconds = [], []
    for b in batches[:5]:
        t0 = time.perf_counter()
        ref_largest.append(single.process_images(b))
        seconds.append(time.perf_counter() - t0)
    single_fps = {"largest": sum(len(r[1]) for r in ref_largest[1:]) / sum(seconds[1:])}
    odd = np.concatenate(batches)[: 3 if rehearse else 13]  # not a multiple of 2 or 4
    ref_odd = single._fused.process(odd, single.resize_size)
    del single
    single_all = tamed(Cropper(device=str(device), strategy="all", **kw))
    single_all.process_images(batches[4])  # warm-up: the caps grow here
    t0 = time.perf_counter()
    ref_all = single_all.process_images(batches[5])
    single_fps["all"] = len(ref_all[1]) / (time.perf_counter() - t0)
    ref_noise = single_all.process_images(noise)
    del single_all
    log(f"  [{card}] single device, same requests: 'largest' {single_fps['largest']:.6f} "
        f"faces/s over 4 after one warm-up, 'all' {single_fps['all']:.6f} faces/s "
        f"({len(ref_all[1])} faces, one request after a warm-up)")

    def run_mesh(devices, label, bound):
        """"largest" over phase 3's batches and one "all" request after a
        warm-up on a mesh over ``devices``: indices exactly the single
        device's, crops within ``bound`` (0: bitwise), K1 once and the warp
        at least once a shard a dispatch, and every shard launching."""
        mesh = make_mesh(devices=devices)
        s_count = mesh.size
        reset_peak()
        c = tamed(Cropper(mesh=mesh, strategy="largest", **kw))
        counter = ShardCounter(c)
        seconds, faces, worst, passes = [], [], 0, 0
        nms_kern.launches = warp_kern.launches = 0
        for r, batch in enumerate(batches[:5]):
            counter.reset()
            caps = c.det_model.pre_topk
            t0 = time.perf_counter()
            crops, idx, _ = c.process_images(batch)
            seconds.append(time.perf_counter() - t0)
            # A request whose caps grew re-ran every shard once more.
            per = 2 if c.det_model.pre_topk != caps else 1
            passes += per
            faces.append(len(idx))
            ref_crops, ref_idx, _ = ref_largest[r]
            d = level_diff(crops, ref_crops)[0] if crops.shape == ref_crops.shape else 256
            worst = max(worst, d)
            if not np.array_equal(idx, ref_idx) or d > bound:
                raise SystemExit(f"FAIL: {label} 'largest' request {r}: indices equal "
                                 f"{np.array_equal(idx, ref_idx)}, crops max |diff| {d} "
                                 f"(limit {bound})")
            shards_ok = counter.calls == [per] * s_count and (rehearse or (
                counter.k1 == [per] * s_count and counter.warp == [per] * s_count))
            if not shards_ok:
                raise SystemExit(f"FAIL: {label} 'largest' request {r}: per-shard calls "
                                 f"{counter.calls}, K1 {counter.k1}, warp {counter.warp}")
        lg = (nms_kern.launches, warp_kern.launches)
        fps = sum(faces[1:]) / sum(seconds[1:])
        log(f"  [{card}] {label} 'largest': {len(faces)} requests, indices equal, crops max "
            f"|diff| {worst} (limit {bound}); {fps:.6f} faces/s over {len(faces) - 1} after "
            f"one warm-up (phase 3 single device: {p3['fps']:.6f}); K1 launches {lg[0]}, warp "
            f"{lg[1]} over {passes} passes of {s_count} shards ({passes - len(faces)} requests "
            f"grew the caps and re-ran every shard); host time to enqueue all {s_count} shards' "
            f"passes, median "
            f"{float(np.median(counter.enqueue_ms)):.6f} ms, max "
            f"{max(counter.enqueue_ms):.6f} ms; {peak_line()} (phase 3: {p3['peak']} B)")
        if not rehearse and lg != (s_count * passes, s_count * passes):
            raise SystemExit(f"FAIL: {label}: (K1, warp) launches {lg}, expected "
                             f"{s_count} each a pass ({passes} passes)")
        got = c._fused.process(odd, c.resize_size)
        if (not np.array_equal(got[2], ref_odd[2]) or len(got[2]) != len(odd)
                or got[2].max() >= len(odd)):
            raise SystemExit(f"FAIL: {label}: {len(odd)} images over {s_count} shards gave "
                             f"indices {got[2]}")
        # Each shard's network runs its block padded to SHARD_PAD_SIZES, the
        # single device the 13 rows as they are: cuDNN may sum otherwise.
        d_odd = level_diff(got[0], ref_odd[0])[0]
        log(f"  {label}: {len(odd)} images over {s_count} shards: {len(got[2])} faces, indices "
            f"equal to the single device's, crops max |diff| {d_odd} (limit 1)")
        if d_odd > 1:
            raise SystemExit(f"FAIL: {label}: the {len(odd)}-image batch's crops differ by "
                             f"{d_odd}")
        del c

        ca = tamed(Cropper(mesh=mesh, strategy="all", **kw))
        counter = ShardCounter(ca)
        ca.process_images(batches[4])  # warm-up: the caps grow here
        counter.reset()
        nms_kern.launches = warp_kern.launches = 0
        t0 = time.perf_counter()
        crops, idx, _ = ca.process_images(batches[5])
        sec = time.perf_counter() - t0
        al = (nms_kern.launches, warp_kern.launches)
        ref_crops, ref_idx, _ = ref_all
        same_idx = np.array_equal(idx, ref_idx)
        d = level_diff(crops, ref_crops)[0] if same_idx else 256
        log(f"  [{card}] {label} 'all': {len(idx)} faces (single device {len(ref_idx)}), indices "
            f"equal {same_idx}, crops max |diff| {d} (limit {bound}); {len(idx) / sec:.6f} "
            f"faces/s ({sec:.6f} s, one request after a warm-up); K1 launches {al[0]}, warp "
            f"{al[1]}; per shard: K1 {counter.k1}, warp {counter.warp}; {peak_line()}")
        if not same_idx or d > bound:
            raise SystemExit(f"FAIL: {label} 'all' differs from the single device")
        if min(counter.calls) < 1 or (not rehearse and (
                al[0] != s_count or counter.k1 != [1] * s_count or min(counter.warp) < 1
                or al[1] < s_count)):
            raise SystemExit(f"FAIL: {label} 'all': launches {al}, per-shard calls "
                             f"{counter.calls}, K1 {counter.k1}, warp {counter.warp}")
        if s_count == 4:
            crops, idx, _ = ca.process_images(noise)
            same_idx = np.array_equal(idx, ref_noise[1])
            d, share = level_diff(crops, ref_noise[0]) if same_idx else (-1, -1.0)
            log(f"  {label} 'all' on phase 3's noise batch (a diagnostic, not held): "
                f"{len(idx)} faces, indices equal {same_idx}, crops max |diff| {d}, share of "
                f"values differing {share:.9f}")
        del ca, crops
        launches["mesh_largest"] = [a + b for a, b in zip(launches["mesh_largest"], lg)]
        launches["mesh_all"] = [a + b for a, b in zip(launches["mesh_all"], al)]
        return fps

    # (a) a mesh of one device: bitwise the single device.
    rates = {1: run_mesh([device], "(a) make_mesh(devices=[card])" if not rehearse
                         else "(a) mesh of 1", 0)}
    if not rehearse:
        one = make_mesh(1)
        if one.devices != (torch.device("cuda", 0),):
            raise SystemExit(f"FAIL: make_mesh(1) gave {one.devices}")
    # (b) repeated-card meshes: the sharding, padding and per-shard launches.
    for s_count in (2, 4):
        rates[s_count] = run_mesh([device] * s_count, f"(b) mesh of {s_count} x {device}", 1)

    # (c) every stage on a mesh of 2: process_dir, "all", gated RRDBNet,
    # BiSeNet with an attribute and a mask group, against the single device.
    src, wdir, readable = p5["src"], p5["wdir"], p5["readable"]
    dkw = dict(p5["kw"], strategy="all", max_faces=2, auto_grow=False, output_format="png")
    gkw = dict(attr_groups={"has_1": [1]}, mask_groups={"face": list(range(1, 19))})
    blocks = 1 if rehearse else 23
    warm = Cropper(device=str(device), enh_threshold=-np.inf, **dkw)
    seen = []
    real_fused, real_enh = pipeline.mean_face_factor, enh_mod.mean_face_factor

    def recording(*args, **kwargs):
        seen.append(real_fused(*args, **kwargs))
        return seen[-1]

    pipeline.mean_face_factor = enh_mod.mean_face_factor = recording
    try:
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the capped detector warns once
            warm.process_dir(src, os.path.join(p5["work"], "mesh_warm"), desc=None)
        warm_s = time.perf_counter() - t0
    finally:
        pipeline.mean_face_factor, enh_mod.mean_face_factor = real_fused, real_enh
    del warm
    thr = midway(np.concatenate(seen), 3)
    trees, enhanced = {}, {}
    for label, where in (("single", dict(device=str(device))),
                         ("mesh", dict(mesh=make_mesh(devices=[device] * 2)))):
        reset_peak()
        c = Cropper(enh_threshold=thr, **where, **dkw, **gkw)
        if rehearse:
            tame_enhancer(c.enh_model, blocks)
        rows = count_enhanced(c.enh_model)
        if label == "mesh":
            counter = ShardCounter(c)
            shard_rows = [0]
            real_shards = c.enh_model.enhance_shards

            def enhance_shards(blocks_in, *a, **k):
                shard_rows[0] += sum(b.shape[0] for b in blocks_in)
                return real_shards(blocks_in, *a, **k)

            c.enh_model.enhance_shards = enhance_shards
        nms_kern.launches = warp_kern.launches = 0
        dst = os.path.join(p5["work"], f"mesh_{label}")
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            c.process_dir(src, dst, desc=None)
        sec = time.perf_counter() - t0
        trees[label] = dst
        crops = [f for f in tree_files(dst) if "_mask" not in f]
        split = ", ".join(f"{k} {v['seconds']:.6f} s/{v['calls']} calls/{v['items']} items"
                          for k, v in c.stats.as_dict().items())
        log(f"  [{card}] (c) {label}: process_dir over {len(readable)} files, 'all' (2 faces "
            f"an image at most), RRDBNet ({blocks} RRDBs) gate {thr:.9g}, BiSeNet groups: "
            f"{len(crops)} crop files in {sec:.6f} s ({len(readable) / sec:.6f} files/s); "
            f"{rows[0]} interim rows through enhance_device; K1 launches {nms_kern.launches}, "
            f"warp {warp_kern.launches}; {peak_line()}; stages: {split}")
        if c.stats.calls.get("detect+crop", 0) == 0:
            raise SystemExit(f"FAIL: (c) {label}: the fused path did not run")
        if label == "mesh":
            launches["mesh_dir"] = (nms_kern.launches, warp_kern.launches)
            enhanced["mesh"] = shard_rows[0]
            log(f"  (c) mesh: {shard_rows[0]} rows through the shard-local SR "
                f"(enhance_shards); per shard: detect passes {counter.calls}, K1 {counter.k1}, "
                f"warp {counter.warp}")
            if shard_rows[0] < 1 or min(counter.calls) < 1 or (
                    not rehearse and (min(counter.k1) < 1 or min(counter.warp) < 1)):
                raise SystemExit("FAIL: (c) the gated SR or a shard did not run on the mesh")
            # The packed wire through the mesh's FusedPipeline.process.
            packed = rgb_to_yuv420_np(batches[0])
            got_p = c._fused.process(packed, c.resize_size, packed_hw=(h, w))
            got_r = c._fused.process(yuv420_to_rgb_np(packed, h, w), c.resize_size)
            same = np.array_equal(got_p[2], got_r[2])
            log(f"  (c) mesh: FusedPipeline.process on rows packed by rgb_to_yuv420_np: "
                f"{len(got_p[2])} faces, indices equal to the RGB run {same}, crops max |diff| "
                f"{level_diff(got_p[0], got_r[0])[0] if same else -1}")
            if not same:
                raise SystemExit("FAIL: (c) packed rows on the mesh differ from RGB")
        del c
    names_ok, files, crop_diff, mask_files, mask_share = compare_trees(trees["single"],
                                                                       trees["mesh"])
    log(f"  [{card}] (c) mesh vs single device: names equal {names_ok}; files differing "
        f"{files}; crops max |diff| {crop_diff} (limit 1); mask files differing {mask_files}, "
        f"mask pixels differing {mask_share:.9f} (labels flipped by the parsers' other batch "
        f"sizes; limit 1e-3); warm-up pass (nothing gated) {warm_s:.6f} s")
    if not names_ok or crop_diff > 1 or mask_share > 1e-3:
        raise SystemExit("FAIL: (c) the mesh's tree differs from the single device's")

    # (d) distinct cards.
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    if count >= 2:
        rates["cards"] = run_mesh([torch.device("cuda", i) for i in range(count)],
                                  f"(d) make_mesh() over {count} cards", 1)
        c0 = tamed(Cropper(device="cuda:0", strategy="largest", **kw))
        cn = tamed(Cropper(device=f"cuda:{count - 1}", strategy="largest", **kw))
        for r, batch in enumerate(batches[:3]):
            a, b = c0.process_images(batch), cn.process_images(batch)
            if not same_result(a, b):
                raise SystemExit(f"FAIL: (d) cuda:{count - 1} differs from cuda:0 on request {r}")
        log(f"  [{card}] (d) Cropper(device='cuda:{count - 1}') bitwise equal to cuda:0 on 3 "
            "requests")
        del c0, cn
    else:
        log(f"  (d) not run: {count} card{'s' if count != 1 else ''} here; a mesh over distinct "
            "cards and Cropper(device='cuda:1') need a second card")

    wall = time.perf_counter() - t_phase
    log(f"  [{card}] faces/s of 'largest' by mesh size: "
        + ", ".join(f"{k}: {v:.6f}" for k, v in rates.items())
        + f" (the single device {single_fps['largest']:.6f} on the same requests, phase 3 "
        f"{p3['fps']:.6f})")
    log(f"  phase 10 wall time {wall:.3f} s")
    return dict(launches={k: tuple(v) for k, v in launches.items()}, fps=rates, wall=wall)


# ---------------------------------------------------------------------------
# Phase 11: the weights' host path and the package surface
# ---------------------------------------------------------------------------


def reference_pth(state_dict) -> dict:
    """A folded state dict in the form of the reference's checkpoints: each
    BatchNorm unfolded (weight = scale, bias, running_mean 0, running_var
    1 − 1e-5, num_batches_tracked; folding it back gives the same f32
    bits), conv kernels OIHW as they are."""
    bn = {k[: -len(".scale")] for k in state_dict if k.endswith(".scale")}
    out = {}
    for key, val in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        if prefix not in bn:
            out[key] = val.clone()
        elif leaf == "scale":
            out[f"{prefix}.weight"] = val.clone()
            out[f"{prefix}.bias"] = state_dict[f"{prefix}.bias"].clone()
            out[f"{prefix}.running_mean"] = torch.zeros_like(val)
            out[f"{prefix}.running_var"] = torch.full_like(val, 1 - 1e-5)
            out[f"{prefix}.num_batches_tracked"] = torch.tensor(0)
    return out


@contextlib.contextmanager
def scoped_env(**values):
    """Environment variables set for a block and restored after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def same_archive(path_a, path_b) -> bool:
    """Two ``.npz`` archives with the same keys in the same order, dtypes
    and bits."""
    from face_crop_plus_tpu_torch.models.weights import load_npz

    a, b = load_npz(path_a), load_npz(path_b)
    return list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        and a[k].tobytes() == b[k].tobytes() for k in a)


#: The kernels the trace must hold, by the name ``nvcc`` gives them; the
#: launch counter that counts each (one NMS call launches both passes).
TRACED_KERNELS = {"nms_mask_kernel": "nms", "nms_scan_kernel": "nms",
                  "warp_affine_u8_kernel": "warp"}


def trace_kernels(trace_dir) -> tuple[int, dict, int]:
    """(bytes, {kernel: (events, device µs)}, CPU op events) of the one
    Chrome trace ``trace`` wrote into ``trace_dir``."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise SystemExit(f"FAIL: (c) expected one Chrome trace in {trace_dir}, found {files}")
    path = os.path.join(trace_dir, files[0])
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    found = {}
    for name in TRACED_KERNELS:
        hits = [e for e in events if e.get("cat") == "kernel" and name in e.get("name", "")]
        found[name] = (len(hits), sum(float(e.get("dur", 0.0)) for e in hits))
    cpu_ops = sum(1 for e in events if e.get("cat") == "cpu_op")
    return os.path.getsize(path), found, cpu_ops


def phase11_weights_surface(batches, device, card, rehearse):
    """The weights' host path and the package surface; see the module
    docstring.  Returns each sub-phase's (K1, warp) launches for the
    kernels line."""
    from face_crop_plus_tpu_torch import Cropper
    from face_crop_plus_tpu_torch.models.detection import RetinaFaceNet
    from face_crop_plus_tpu_torch.models.parsing import BiSeNetNet
    from face_crop_plus_tpu_torch.models.weights import PTH_FILENAMES
    from face_crop_plus_tpu_torch.ops.cuda import nms as nms_kern
    from face_crop_plus_tpu_torch.ops.cuda import warp as warp_kern
    from face_crop_plus_tpu_torch.utils.io import codecs
    from face_crop_plus_tpu_torch.utils.profiling import host_speed_probe, trace

    t_phase = time.perf_counter()
    n = batches[0].shape[0]
    out, resize = (32, 64) if rehearse else (256, 1024)
    work = os.path.join(ROOT, "face_crop_plus_tpu_torch", "_build", "phase11")
    shutil.rmtree(work, ignore_errors=True)
    server, cache = os.path.join(work, "server"), os.path.join(work, "cache")
    os.makedirs(server)
    tamed = {"retinaface": tamed_state_dict(RetinaFaceNet()),
             "bisenet": tamed_parser_state_dict(BiSeNetNet())}
    for model, sd in tamed.items():
        torch.save(reference_pth(sd), os.path.join(server, PTH_FILENAMES[model]))
    kw = dict(output_size=out, resize_size=resize, strategy="largest", det_threshold=-1.0,
              batch_size=n, attr_groups=ATTR_GROUPS, mask_groups=MASK_GROUPS)
    launches = {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # (a) fetch and convert into an empty cache, then read the cache.
    with scoped_env(FCPT_NO_DOWNLOAD="0", FCPT_CACHE_DIR=cache,
                    FCPT_WEIGHTS_URL=pathlib.Path(server).as_uri() + "/"):
        t0 = time.perf_counter()
        fetched = Cropper(device=str(device), **kw)
        sync()
        fetch_s = time.perf_counter() - t0
        cached_files = sorted(os.listdir(cache))
        t0 = time.perf_counter()
        again = Cropper(device=str(device), **kw)
        sync()
        cached_s = time.perf_counter() - t0
    want = sorted([PTH_FILENAMES[m] for m in tamed] + [f"{m}.npz" for m in tamed])
    log(f"  [{card}] (a) Cropper(device={str(device)!r}, phase 3's settings, parsing) with "
        f"an empty FCPT_CACHE_DIR and a file:// root: {fetch_s:.6f} s with the fetch and "
        f"conversion; {cached_s:.6f} s reading the cached .npz; cache {cached_files}")
    if cached_files != want:
        raise SystemExit(f"FAIL: (a) the cache holds {cached_files}, expected {want}")
    for c in (fetched, again):
        if not (c.det_model.pretrained and c.par_model.pretrained):
            raise SystemExit("FAIL: (a) a model fell back to random weights")
        for net, model in ((c.det_model.net, "retinaface"), (c.par_model.net, "bisenet")):
            got = net.state_dict()
            if set(got) != set(tamed[model]) or not all(
                    torch.equal(got[k].cpu(), v) for k, v in tamed[model].items()):
                raise SystemExit(f"FAIL: (a) the fetched {model} weights differ from the "
                                 "checkpoint's")
    del again
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # random init before the weights are loaded
        ref = Cropper(device=str(device), **kw)
    ref.det_model.net.load_state_dict(tamed["retinaface"])
    ref.par_model.net.load_state_dict(tamed["bisenet"])
    nms_kern.launches = warp_kern.launches = 0
    for r, batch in enumerate(batches[:3]):
        a, b = fetched.process_images(batch), ref.process_images(batch)
        if a[0].shape != (n, out, out, 3) or not same_result(a, b):
            raise SystemExit(f"FAIL: (a) request {r}: the fetched weights' result differs "
                             "from load_state_dict's")
    launches["weights"] = (nms_kern.launches, warp_kern.launches)
    del ref
    log(f"  [{card}] (a) 3 requests: crops, indices and groups bitwise equal to a Cropper "
        f"given the same weights by load_state_dict; (K1, warp) launches {launches['weights']}")
    if not rehearse and min(launches["weights"]) < 1:
        raise SystemExit("FAIL: (a) a kernel did not launch")

    # (b) the converter CLI, one process a checkpoint, both at once.
    conv = os.path.join(work, "convert")
    procs = {}
    t0 = time.perf_counter()
    try:
        for model in tamed:
            procs[model] = subprocess.Popen(
                [sys.executable, "-m", "face_crop_plus_tpu_torch.convert", "--pth",
                 os.path.join(server, PTH_FILENAMES[model]), "--verify", "--out",
                 os.path.join(conv, model)], cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        for model, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            if proc.returncode != 0 or "verify OK" not in stdout:
                raise SystemExit(f"FAIL: (b) convert --verify of {model} exited "
                                 f"{proc.returncode}:\n{stdout[-2000:]}{stderr[-2000:]}")
            if not same_archive(os.path.join(conv, f"{model}.npz"),
                                os.path.join(cache, f"{model}.npz")):
                raise SystemExit(f"FAIL: (b) the CLI's {model}.npz differs from the cache's")
            log(f"  (b) {model}: {stdout.strip().splitlines()[1]}; its archive equals (a)'s "
                "cache array for array")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log(f"  (b) python -m face_crop_plus_tpu_torch.convert --verify, 2 processes: "
        f"{time.perf_counter() - t0:.3f} s wall")

    # (c) one request under trace().
    trace_dir = os.path.join(work, "trace")
    nms_kern.launches = warp_kern.launches = 0
    with trace(trace_dir):
        fetched.process_images(batches[3])
        sync()
    launches["trace"] = (nms_kern.launches, warp_kern.launches)
    size, found, cpu_ops = trace_kernels(trace_dir)
    counters = {"nms": nms_kern.launches, "warp": warp_kern.launches}
    log(f"  [{card}] (c) trace of one request: {size} B, {cpu_ops} CPU op events; "
        + ", ".join(f"{k} x{c} {us:.3f} us" for k, (c, us) in found.items())
        + f"; counters (K1, warp) {launches['trace']}")
    if cpu_ops == 0 or any(found[k][0] != counters[v] for k, v in TRACED_KERNELS.items()):
        raise SystemExit("FAIL: (c) the trace's kernel events differ from the launch counters")
    if not rehearse and min(launches["trace"]) < 1:
        raise SystemExit("FAIL: (c) a kernel did not launch under the trace")
    del fetched

    # (d) the package surface, as_device / as_numpy, the host probe.
    from face_crop_plus_tpu_torch import ops as ops_pkg
    from face_crop_plus_tpu_torch import utils as utils_pkg
    from face_crop_plus_tpu_torch.models import BiSeNet, RetinaFace, RRDBNet  # noqa: F401

    names = [getattr(pkg, name) for pkg in (ops_pkg, utils_pkg) for name in pkg.__all__]
    host = batches[0]
    dev = utils_pkg.as_device(host, "cpu" if rehearse else None)  # None: the card
    back = utils_pkg.as_numpy(dev)
    log(f"  [{card}] (d) {len(names)} ops/utils names and the three models import; "
        f"as_device: {tuple(dev.shape)} {dev.dtype} on {dev.device}; as_numpy back: "
        f"{back.dtype}, bitwise {np.array_equal(back, host)}")
    if (dev.dtype != torch.float32 or dev.device.type != device.type
            or tuple(dev.shape) != host.shape or back.dtype != np.uint8
            or not np.array_equal(back, host)):
        raise SystemExit("FAIL: (d) as_device / as_numpy")
    t0 = time.perf_counter()
    rate = host_speed_probe()
    have = codecs()  # imread_rgb and imwrite take cv2 where it is installed, else PIL
    codec = f"cv2 {have['cv2']}" if have["cv2"] else f"PIL {have['PIL']}"
    log(f"  (d) host_speed_probe(): {rate} round trips/s of a 218x178 JPEG through {codec} "
        f"(a host number), {time.perf_counter() - t0:.3f} s")
    if rate is None or rate <= 0:
        raise SystemExit("FAIL: (d) host_speed_probe returned no rate")
    shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t_phase
    log(f"  phase 11 wall time {wall:.3f} s")
    return dict(launches=launches, fetch_s=fetch_s, cached_s=cached_s, wall=wall)


#: H100 SXM published dense bfloat16 tensor-core peak (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12
#: Single calls phase 12 times for each dtype; the median is reported.
DTYPE_REPS = 5


def conv_macs(net, run) -> int:
    """Multiply-adds of every convolution of ``net`` during ``run()``, from
    the convolutions' output shapes (forward hooks)."""
    convs = [m for m in net.modules() if isinstance(m, torch.nn.Conv2d)]
    total = [0]

    def hook(m, _inp, out):
        total[0] += out.numel() * (m.in_channels // m.groups) * m.kernel_size[0] * m.kernel_size[1]

    handles = [m.register_forward_hook(hook) for m in convs]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in handles:
            h.remove()
    return total[0]


def single_ms(fn, device) -> float:
    """One call's milliseconds: CUDA events around it on a card (after a
    synchronize), the host clock elsewhere."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def median_ms(fn, device, reps: int = DTYPE_REPS) -> tuple[float, list]:
    """(median, samples) of ``reps`` single calls after one warm-up."""
    fn()
    samples = [single_ms(fn, device) for _ in range(reps)]
    return float(np.median(samples)), samples


def dtype_line(what, ms, samples, flop, peak) -> str:
    """A timing line: the median, every sample, TFLOP/s and the bound."""
    return (f"{what}: median {ms:.6f} ms of " + ", ".join(f"{v:.6f}" for v in samples)
            + f"; {flop / (ms * 1e-3) / 1e12:.6f} TFLOP/s of {flop / 1e12:.6f} TFLOP counted; "
            f"bound {flop / peak * 1e3:.6f} ms at {peak / 1e12:.0f} TFLOP/s")


def outputs_held(name, ours, ref_low, ref_f32) -> bool:
    """The test suite's relative network band, by the mean: ``ours`` no
    farther from ``ref_low`` (the CPU's bfloat16) than the CPU's bfloat16
    output is from its float32 one.  The largest and the 99th-percentile
    differences are printed beside it: the tests hold the largest too, on
    a 64² input, but two bfloat16 runs' extremes grow with the output's
    size (43,008 anchors at 1024² against 168 at 64²)."""
    d = (ours.float() - ref_low.float()).abs().numpy()
    j = (ref_low.float() - ref_f32.float()).abs().numpy()
    ok = d.mean() <= j.mean()
    log(f"    {name}: card bf16 vs CPU bf16 mean {d.mean():.6g} max {d.max():.6g} p99 "
        f"{np.quantile(d, 0.99):.6g}; CPU bf16 vs CPU f32 mean {j.mean():.6g} max "
        f"{j.max():.6g} p99 {np.quantile(j, 0.99):.6g}; held {ok}")
    return ok


def phase12_compute_dtype(device, card, rehearse):
    """The models' ``compute_dtype``: bfloat16 against float32 at full
    width; see the module docstring.

    Returns the (K1, warp) launches of its float32 and bfloat16 requests.
    """
    from face_crop_plus_tpu_torch import Cropper, pipeline
    from face_crop_plus_tpu_torch.models.detection import (
        RetinaFace, preprocess, retinaface_forward,
    )
    from face_crop_plus_tpu_torch.models.enhancement import RRDBNet
    from face_crop_plus_tpu_torch.models.parsing import BiSeNet
    from face_crop_plus_tpu_torch.ops import nms as plain_nms
    from face_crop_plus_tpu_torch.ops.cuda import nms as kern
    from face_crop_plus_tpu_torch.ops.cuda import warp as warp_kern
    from face_crop_plus_tpu_torch.ops.warp import to_uint8, warp_affine_batch
    from face_crop_plus_tpu_torch.pipeline import FusedPipeline, device_resize_pad
    from face_crop_plus_tpu_torch.utils.device import compute_precision, f32_precision

    t_phase = time.perf_counter()
    cuda = device.type == "cuda"
    f32, bf16 = torch.float32, torch.bfloat16
    n, src_hw, out, resize = (2, (40, 30), 32, 64) if rehearse else (16, (218, 178), 256, 1024)
    blocks = 1 if rehearse else 23
    rng = np.random.default_rng(12)
    reqs = [smooth_batch(rng, (n, *src_hw, 3)) for _ in range(DTYPE_REPS + 1)]
    launches = {}

    # (a) the detector: phase 3's shapes, phase 5's tamed weights.
    c = Cropper(device=str(device), output_size=out, resize_size=resize, strategy="largest",
                det_threshold=-1.0, batch_size=n)
    sd = tamed_state_dict(c.det_model.net)
    dets = {f32: c.det_model,
            bf16: RetinaFace(strategy="largest", vis=-1.0, device=device, compute_dtype=bf16)}
    pipes = {f32: c._fused,
             bf16: FusedPipeline(dets[bf16], c.landmarks_target, c.output_size, c.padding,
                                 allow_skew=c.allow_skew, crop_source=c.crop_source)}
    for det in dets.values():
        det.net.load_state_dict(sd)
        log(f"  (a) RetinaFace(compute_dtype={det.compute_dtype}): "
            f"{json.dumps(compute_precision(det))}")
    with torch.no_grad(), f32_precision():
        interim, _, _ = device_resize_pad(torch.from_numpy(reqs[0]).to(device), c.resize_size)
        x32 = preprocess(interim)
    del interim
    macs = conv_macs(dets[f32].net, lambda: retinaface_forward(dets[f32].net, x32))
    net_ms = {}
    for dt, det in dets.items():
        x = x32.to(dt)
        with torch.no_grad(), f32_precision():
            net_ms[dt], samples = median_ms(lambda: retinaface_forward(det.net, x), device)
        peak = PEAK_F32_FLOPS if dt == f32 else PEAK_BF16_FLOPS
        log(f"  [{card}] (a) " + dtype_line(f"RetinaFace network {dt}, {n}x{resize}x{resize}",
                                             net_ms[dt], samples, 2 * macs, peak))
        del x
    log(f"  [{card}] (a) bf16 / f32 network time {net_ms[bf16] / net_ms[f32]:.6f}")

    results, req_ms = {}, {}
    recorded = {}
    real_nms, real_warp = kern.greedy_nms_mask_cuda, pipeline.warp_affine_u8

    def nms_spy(boxes, valid, threshold):
        keep = real_nms(boxes, valid, threshold)
        recorded.setdefault("nms", (boxes, valid, threshold, keep))
        return keep

    def warp_spy(*args, **kwargs):
        crops = real_warp(*args, **kwargs)
        recorded.setdefault("warp", (args, kwargs, crops))
        return crops

    for dt, pipe in pipes.items():
        pipe.process(reqs[0], c.resize_size)  # warm-up: pre_topk grows to its ceiling
        kern.launches = warp_kern.launches = 0
        seconds = []
        if dt == bf16:
            kern.greedy_nms_mask_cuda, pipeline.warp_affine_u8 = nms_spy, warp_spy
        try:
            for r, batch in enumerate(reqs[1:]):
                t0 = time.perf_counter()
                res = pipe.process(batch, c.resize_size)
                seconds.append((time.perf_counter() - t0) * 1e3)
                if r == 0:
                    results[dt] = res
                    kern.greedy_nms_mask_cuda, pipeline.warp_affine_u8 = real_nms, real_warp
        finally:
            kern.greedy_nms_mask_cuda, pipeline.warp_affine_u8 = real_nms, real_warp
        launches[f"compute_dtype_{str(dt).removeprefix('torch.')}"] = (kern.launches,
                                                                       warp_kern.launches)
        req_ms[dt] = float(np.median(seconds))
        log(f"  [{card}] (a) FusedPipeline.process {dt}, {len(seconds)} requests after a "
            f"warm-up (host clock, host copies included): median {req_ms[dt]:.6f} ms of "
            + ", ".join(f"{v:.6f}" for v in seconds)
            + f"; {n * len(seconds) / (sum(seconds) * 1e-3):.6f} faces/s; (K1, warp) "
            f"launches {(kern.launches, warp_kern.launches)}")
        if not rehearse and (kern.launches, warp_kern.launches) != (len(seconds),) * 2:
            raise SystemExit(f"FAIL: {dt} requests: (K1, warp) launches "
                             f"{(kern.launches, warp_kern.launches)}, expected one each per "
                             f"request ({len(seconds)})")
    (c32, lm32, i32), (c16, lm16, i16) = results[f32], results[bf16]
    d_lm = np.abs(lm16 - lm32).reshape(len(lm16), -1).max(axis=1) if len(i16) == len(i32) else None
    lv, share = level_diff(c16, c32) if c16.shape == c32.shape else (None, None)
    log(f"  [{card}] (a) one request, bf16 against f32: indices equal "
        f"{np.array_equal(i16, i32)}; landmarks max |diff| "
        f"{float(d_lm.max()) if d_lm is not None else float('nan'):.6f} px, median "
        f"{float(np.median(d_lm)) if d_lm is not None else float('nan'):.6f} px; crops max "
        f"|diff| {lv} levels, differing share {share}, mean |diff| "
        f"{float(np.abs(c16.astype(np.int16) - c32).mean()) if lv is not None else 0.0:.6f}")

    if cuda:  # the kernels of the bf16 request against their plain versions
        boxes, valid, threshold, keep = recorded["nms"]
        plain_keep = plain_nms.greedy_nms_mask(plain_nms.iou_matrix_plus1(boxes), valid,
                                               threshold)
        args, kwargs, crops = recorded["warp"]
        plain = to_uint8(warp_affine_batch(*args, **kwargs))
        ok = _finite_rows(args[1])
        warp_err = int((crops[ok].int() - plain[ok].int()).abs().max()) if int(ok.sum()) else 0
        nms_same = torch.equal(keep, plain_keep)
        log(f"  (a) the bf16 request's K1 keep mask ({tuple(keep.shape)}, boxes "
            f"{boxes.dtype}) bitwise equal to plain: {nms_same}; its warp ({len(crops)} crops "
            f"from {tuple(args[0].shape)} {args[0].dtype} sources) max |diff| against plain "
            f"{warp_err}")
        if not nms_same or warp_err:
            raise SystemExit("FAIL: a kernel of the bf16 request differs from its plain version")
    del recorded

    # One image: the card's bf16 network against the port's bf16 on the CPU.
    cpu = {dt: RetinaFace(strategy="largest", vis=-1.0, device="cpu", compute_dtype=dt)
           for dt in (f32, bf16)}
    for det in cpu.values():
        det.net.load_state_dict(sd)
    with torch.no_grad(), f32_precision():
        x1 = x32[:1].cpu()
        card_out = [t.cpu() for t in retinaface_forward(dets[bf16].net, x32[:1].to(bf16))]
        cpu16 = retinaface_forward(cpu[bf16].net, x1.to(bf16))
        cpu32 = retinaface_forward(cpu[f32].net, x1)
    log(f"  (a) one {resize}² image, the card's bf16 network against the CPU's bf16 "
        f"(the band of tests/test_torch_compute_dtype.py):")
    held = [outputs_held(name, a, b, r) for name, a, b, r in
            zip(("scores", "loc", "ldm"), card_out, cpu16, cpu32)]
    if not all(held):
        raise SystemExit("FAIL: the card's bf16 detector leaves the CPU's bf16 band")
    del x32, x1, cpu, card_out, cpu16, cpu32, pipes, dets
    crops16 = c16

    # (b) the parser: 16 crops at 512², phase 6's tamed weights and groups.
    groups_kw = dict(attr_groups=ATTR_GROUPS, mask_groups=MASK_GROUPS)
    pars = {dt: BiSeNet(max_batch_size=n, device=device, compute_dtype=dt, **groups_kw)
            for dt in (f32, bf16)}
    psd = tamed_parser_state_dict(pars[f32].net)
    conv_m, resize_m = parser_macs(pars[f32], n, out)
    dev_crops = torch.from_numpy(crops16).to(device)
    labels = {}
    par_ms = {}
    for dt, par in pars.items():
        par.net.load_state_dict(psd)
        log(f"  (b) BiSeNet(compute_dtype={dt}): {json.dumps(compute_precision(par))}")
        par_ms[dt], samples = median_ms(lambda: par.predict(crops16), device)
        peak = PEAK_F32_FLOPS if dt == f32 else PEAK_BF16_FLOPS
        log(f"  [{card}] (b) " + dtype_line(
            f"BiSeNet.predict {dt}, {n} crops of {out}² at 512² (upload, network, argmax, "
            "counts, masks, host copies)", par_ms[dt], samples, 2 * (conv_m + resize_m), peak))
        with torch.no_grad():
            labels[dt] = par._parse(dev_crops, out, out)[0].cpu().numpy()
    agree = float((labels[bf16] == labels[f32]).mean())
    log(f"  [{card}] (b) bf16 / f32 predict time {par_ms[bf16] / par_ms[f32]:.6f}; labels "
        f"equal on {agree:.6f} of the pixels")
    del pars, dev_crops

    # (c) the enhancer: one 1024² interim, phase 7's tamed weights.
    with torch.no_grad(), f32_precision():
        interim, _, _ = device_resize_pad(torch.from_numpy(reqs[1][:1]).to(device), c.resize_size)
    one = to_uint8(interim).contiguous()
    del interim, c
    enh_out, enh_ms = {}, {}
    for dt in (f32, bf16):
        enh = tame_enhancer(RRDBNet(device=device, num_blocks=blocks, compute_dtype=dt), blocks)
        log(f"  (c) RRDBNet(compute_dtype={dt}): {json.dumps(compute_precision(enh))}")
        if dt == f32:
            pixels = one.shape[1] * one.shape[2]
            flop = 2 * rrdb_macs_per_pixel(enh.net) * pixels
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        enh_ms[dt], samples = median_ms(lambda: enh.enhance_device(one), device, reps=2)
        peak_mem = torch.cuda.max_memory_allocated() if cuda else 0
        peak = PEAK_F32_FLOPS if dt == f32 else PEAK_BF16_FLOPS
        log(f"  [{card}] (c) " + dtype_line(
            f"enhance_device {dt}, one {one.shape[1]}x{one.shape[2]} interim, {blocks} RRDBs",
            enh_ms[dt], samples, flop, peak) + f"; peak device memory {peak_mem} B")
        enh_out[dt] = enh.enhance_device(one).cpu().numpy()
        del enh
    lv, share = level_diff(enh_out[bf16], enh_out[f32])
    log(f"  [{card}] (c) bf16 / f32 enhance time {enh_ms[bf16] / enh_ms[f32]:.6f}; output "
        f"bf16 against f32: max |diff| {lv} levels, differing share {share:.6f}, mean |diff| "
        f"{float(np.abs(enh_out[bf16].astype(np.int16) - enh_out[f32]).mean()):.6f}")
    log(f"  phase 12 wall time {time.perf_counter() - t_phase:.3f} s")
    return {"launches": launches}


def read_rgb(root, name):
    from face_crop_plus_tpu_torch.utils.io import imread_rgb

    return imread_rgb(os.path.join(root, os.path.splitext(name)[0] + ".png"))


#: f32 operations per output pixel of the warp (coordinates, floor and
#: fraction, four weights, 3 channels of 4 products and 3 sums, rounding).
WARP_OPS_PER_PIXEL = 48


def _rows(timings: dict) -> dict:
    return {f"{label} {key}": {k: t[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                                                    "library_ms")}
            for (label, key), t in timings.items()}


def warp_row(wtimings, max_err, launches_largest, launches_all, p5, p6, p7, p8, p9,
             p10, p11, p12) -> dict:
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
        "launches": launches_largest + launches_all + p5["warp"] + p6["warp"] + p6["dir_warp"]
        + p7["warp"] + p7["dir_warp"] + sum(v[1] for v in p8["launches"].values())
        + sum(v[1] for v in p9["launches"].values())
        + sum(v[1] for v in p10["launches"].values())
        + sum(v[1] for v in p11["launches"].values())
        + sum(v[1] for v in p12["launches"].values()),
        "launches_largest": launches_largest,
        "launches_all": launches_all,
        "launches_directory": p5["warp"],
        "launches_directory_staged": p5["staged_warp"],
        "launches_parse": p6["warp"],
        "launches_parse_directory": p6["dir_warp"],
        "launches_enhance": p7["warp"],
        "launches_enhance_directory": p7["dir_warp"],
        **{f"launches_{k}": v[1] for k, v in p8["launches"].items()},
        **{f"launches_{k}": v[1] for k, v in p9["launches"].items()},
        **{f"launches_{k}": v[1] for k, v in p10["launches"].items()},
        **{f"launches_{k}": v[1] for k, v in p11["launches"].items()},
        **{f"launches_{k}": v[1] for k, v in p12["launches"].items()},
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


def bn_act_row(t, launches_largest, launches) -> dict:
    """The ``kernels`` entry of bn_act: one forward's 69 epilogues (phase
    2c (c)), the launches of every phase."""
    return {
        "name": "bn_act",
        "route": "cuda",
        "source": "face_crop_plus_tpu_torch/csrc/bn_act.cu",
        "replaces": None,
        "replaces_none_because": "XLA fuses BN, the residual add and ReLU into the convolutions",
        "launches": launches,
        "launches_check": t["launches"],
        "launches_largest": launches_largest,
        "max_abs_err": 0.0,
        "bitwise_equal": True,
        "edge_cases": t["cases"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "bytes": t["bytes"],
        "library_ms": None,
        "shape": f"the 69 epilogues of one {t['shape']} RetinaFace forward, summed",
        "forward_ms": t["forward_ms"],
        "forward_plain_ms": t["forward_plain_ms"],
        "cases": t["rows"],
    }


def rrdb_act_row(t, launches, p7) -> dict:
    """The ``kernels`` entry of rrdb_act: one 1024² enhancer forward's 351
    epilogues (phase 7 (g) (c)), the launches of every phase and of phase
    7 (b)'s fused-gate requests (the main path)."""
    return {
        "name": "rrdb_act",
        "route": "cuda",
        "source": "face_crop_plus_tpu_torch/csrc/rrdb_act.cu",
        "replaces": None,
        "replaces_none_because": "XLA fuses the bias, LeakyReLU and the scaled residuals into "
                                 "the convolutions and lays out the dense blocks' concatenation",
        "launches": launches,
        "launches_check": t["launches"],
        "launches_fused_gate": p7["rrdb_fused_gate"],
        "gated_rows_fused_gate": p7["rrdb_gated_rows"],
        "max_abs_err": 0.0,
        "bitwise_equal": True,
        "edge_cases": t["cases"],
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": "bytes",
        "bytes": t["bytes"],
        "library_ms": None,
        "shape": f"the {t['epilogues']} epilogues of one {t['shape']} RRDBNet x4 forward, summed",
        "forward_ms": t["forward_ms"],
        "forward_before_ms": t["forward_before_ms"],
        "cases": t["rows"],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run the control flow on the CPU at tiny sizes")
    opts = ap.parse_args()
    rehearse = opts.rehearse_cpu
    # Look for no checkpoint on the network: the card's machine has none,
    # and the subprocess phases inherit this (phase 11 fetches from a
    # file:// root in its own scope).
    os.environ.setdefault("FCPT_NO_DOWNLOAD", "1")

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
    from face_crop_plus_tpu_torch.ops.cuda import bn_act as bn_kern
    from face_crop_plus_tpu_torch.ops.cuda import build
    from face_crop_plus_tpu_torch.ops.cuda import nms as kern
    from face_crop_plus_tpu_torch.ops.cuda import rrdb_act as rrdb_kern
    from face_crop_plus_tpu_torch.ops.cuda import warp as warp_kern

    # Cut phase 3b's timed requests, never its width, past this point.
    deadline = time.monotonic() + 780.0
    # Phases 3-7 hold the device path: crops by the warp kernel, as "auto"
    # gives on a card, in the CPU rehearsal too (phase 8 sets its own modes).
    os.environ["FCPT_HOST_CROP"] = "0"

    device = torch.device("cpu" if rehearse else "cuda")
    clock = Clock(device)

    # -- phase 0 -----------------------------------------------------------
    card = card_line(rehearse)
    log(f"phase 0: card: {card}")
    log(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    from face_crop_plus_tpu_torch.utils.device import compute_precision
    from face_crop_plus_tpu_torch.utils.io import codecs

    from face_crop_plus_tpu_torch.models import BiSeNet, RetinaFace, RRDBNet

    for model_cls in (RetinaFace, BiSeNet, RRDBNet):  # each model's default
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            model = model_cls(device=device)
        log(f"  {model_cls.__name__}() precision (as the package pins it): "
            f"{json.dumps(compute_precision(model))}")
        del model
    log(f"  process-wide flags outside it: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}, "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    for name, status in codecs().items():
        log(f"  codec {name}: {status if status is not None else 'absent'}")

    # -- phase 1 -----------------------------------------------------------
    if rehearse:
        log("phase 1: build skipped (rehearsal: no nvcc)")
    else:
        t0 = time.perf_counter()
        sources = ("nms.cu", "warp.cu", "bn_act.cu", "rrdb_act.cu")
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

    # -- phase 2c ----------------------------------------------------------
    log("phase 2c: the convolutions' epilogue (bn_act) vs plain: every epilogue of one "
        "forward, edge cases, times, the forward with and without the kernel")
    bn_t = phase2c_bn_act(device, clock, card, rehearse)

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
    bn_start = bn_kern.launches
    per_request = []
    warp_per_request = []
    bn_per_request = []
    seconds = []
    faces = []
    for r, batch in enumerate(batches[:5]):
        before = kern.launches
        before_warp = warp_kern.launches
        before_bn = bn_kern.launches
        t0 = time.perf_counter()
        crops, indices, groups = cropper.process_images(batch)
        seconds.append(time.perf_counter() - t0)
        per_request.append(kern.launches - before)
        warp_per_request.append(warp_kern.launches - before_warp)
        bn_per_request.append(bn_kern.launches - before_bn)
        faces.append(len(indices))
        if crops.shape != (n, out_size, out_size, 3) or crops.dtype != np.uint8:
            raise SystemExit(f"FAIL: request {r}: crops {crops.shape} {crops.dtype}")
        if not np.array_equal(indices, np.arange(n)) or groups != (None, None):
            raise SystemExit(f"FAIL: request {r}: indices {indices}")
    main_launches = kern.launches
    warp_main_launches = warp_kern.launches
    bn_main_launches = bn_kern.launches - bn_start
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    log(f"  K1 launches per request {per_request}, warp launches per request "
        f"{warp_per_request} (pre_topk now {cropper.det_model.pre_topk}); request seconds "
        + ", ".join(f"{s:.6f}" for s in seconds))
    log(f"  bn_act launches per request {bn_per_request}")
    if not rehearse and (min(per_request) < 1 or min(warp_per_request) < 1
                         or min(bn_per_request) < 69):
        raise SystemExit("FAIL: the NMS, warp or bn_act kernel did not launch on every request")
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

    # -- phase 6 -----------------------------------------------------------
    log(f"phase 6: parsing: RetinaFace ResNet-50 at {resize}² → {out_size}² crops → BiSeNet "
        f"at 512², 19 classes, batch {n}: process_images, card vs CPU, process_dir, the "
        "landmark-free CLI")
    p6 = phase6_parsing(batches, fps, p5, device, card, rehearse)

    # -- phase 7 -----------------------------------------------------------
    log(f"phase 7: enhancement: RRDBNet x4 (23 RRDBs, nf 64, gc 32) behind RetinaFace at "
        f"{resize}² → {out_size}² crops: card vs CPU, fused and staged gates, process_dir, "
        "the landmark-free CLI, a TF32 diagnostic")
    p7 = phase7_enhancement(batches, p5, device, card, rehearse)

    # -- phase 8 -----------------------------------------------------------
    log("phase 8: the host path: the landmark-file mode (process_dir, border modes, with "
        "BiSeNet, with RRDBNet), the forced host-crop mode, the packed 4:2:0 wire's device half")
    p8 = phase8_host_path(batches, fps, p5, device, card, rehearse)

    # -- phase 9 -----------------------------------------------------------
    log("phase 9: serving and sharding: process_images_stream at depths 1-3 (the default "
        "path, the host-crop mode with and without packed uploads, a mixed stream, parsing at "
        "collect), two -si auto processes on the one card")
    p9 = phase9_serving(batches, p5, device, card, rehearse)

    # -- phase 10 ----------------------------------------------------------
    log("phase 10: the in-process data mesh: Cropper(mesh=...) over one card, repeated cards "
        "(2, 4) and every card; 'largest', 'all', process_dir with every stage")
    p10 = phase10_mesh(batches, {"fps": fps, "peak": peak}, p5, device, card, rehearse)
    shutil.rmtree(p5["work"], ignore_errors=True)

    # -- phase 11 ----------------------------------------------------------
    log("phase 11: the weights' host path and the package surface: checkpoints fetched from "
        "a file:// root, converted and cached; the convert CLI; one request under trace(); "
        "the re-exports, as_device / as_numpy, host_speed_probe")
    p11 = phase11_weights_surface(batches, device, card, rehearse)

    # -- phase 12 ----------------------------------------------------------
    log("phase 12: the models' compute_dtype: RetinaFace, BiSeNet and RRDBNet in bfloat16 "
        "against float32 at full width; the bf16 request's kernels against plain; the card's "
        "bf16 against the CPU's")
    p12 = phase12_compute_dtype(device, card, rehearse)

    # -- phase 4 -----------------------------------------------------------
    t_main = timings[max(ks)]
    t_256 = timings.get(256, t_main)
    kernels = {"kernels": [{
        "name": "greedy_nms",
        "route": "cuda",
        "source": "face_crop_plus_tpu_torch/csrc/nms.cu",
        "replaces": "face_crop_plus_tpu/ops/pallas/nms_kernel.py:28",
        "redesigned": "PR 3",
        "launches": main_launches + all_nms + p5["nms"] + p6["nms"] + p6["dir_nms"]
        + p7["nms"] + p7["dir_nms"] + sum(v[0] for v in p8["launches"].values())
        + sum(v[0] for v in p9["launches"].values())
        + sum(v[0] for v in p10["launches"].values())
        + sum(v[0] for v in p11["launches"].values())
        + sum(v[0] for v in p12["launches"].values()),
        "launches_largest": main_launches,
        "launches_all": all_nms,
        "launches_directory": p5["nms"],
        "launches_directory_staged": p5["staged_nms"],
        "launches_parse": p6["nms"],
        "launches_parse_directory": p6["dir_nms"],
        "launches_enhance": p7["nms"],
        "launches_enhance_directory": p7["dir_nms"],
        **{f"launches_{k}": v[0] for k, v in p8["launches"].items()},
        **{f"launches_{k}": v[0] for k, v in p9["launches"].items()},
        **{f"launches_{k}": v[0] for k, v in p10["launches"].items()},
        **{f"launches_{k}": v[0] for k, v in p11["launches"].items()},
        **{f"launches_{k}": v[0] for k, v in p12["launches"].items()},
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
               all_warp, p5, p6, p7, p8, p9, p10, p11, p12),
        gather_row(gtimings, gather_launches),
        bn_act_row(bn_t, bn_main_launches, bn_kern.launches),
        rrdb_act_row(p7["rrdb_act"], rrdb_kern.launches, p7)]}
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
