"""``Cropper.process_images`` in a closed loop with one client, over a pool
of distinct request batches.

Traffic keys: ``request_images`` a request, ``image_hw``, ``content``
(:func:`gpubench.harness.inputs.images`), ``distinct_requests`` in the
pool (cycled), ``sample_requests`` judged after the window.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from gpubench.harness import inputs, judge
from gpubench.harness.cell import Cell


class Entry(Cell):

    def _make_inputs(self):
        self.pool = inputs.request_pool(self.traffic, self.seed, self.device)

    def _build(self):
        return self._make_cropper()

    def _warm_up(self):
        # The second request runs at the candidate cap the first one grew.
        for batch in self.pool[:2]:
            self.cropper.process_images(batch)

    def run(self, seconds: float):
        """The closed loop; every request's latency (inf when it failed)."""
        self.latencies, self.outputs = [], []
        n_pool = len(self.pool)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            batch = self.pool[self.attempted % n_pool]
            self.attempted += 1
            start = time.perf_counter()
            try:
                crops, indices, _ = self.cropper.process_images(batch)
            except Exception as e:  # noqa: BLE001 - a failed request is counted, not fatal
                self.failed += 1
                self.latencies.append(math.inf)
                self.outputs.append(None)
                print(f"request {self.attempted - 1} failed: {e!r}", flush=True)
                continue
            self.latencies.append(time.perf_counter() - start)
            self.faces += len(crops)
            self.outputs.append((crops, indices))
        self.window_s = time.perf_counter() - t0

    def images_done(self) -> list[tuple[int, int]]:
        h, w = self.traffic["image_hw"]
        done = len(self.latencies) - self.failed
        return [(h, w)] * (done * self.traffic["request_images"])

    def reference_outputs(self, nets: dict, batch: np.ndarray):
        """The reference's (crops, face→image indices) of one request, run
        in blocks of the cropper's batch size."""
        block = self.kw["batch_size"]
        crops, found = [], []
        for s in range(0, len(batch), block):
            imgs = torch.from_numpy(batch[s: s + block]).to(self.device)
            c, idx = self.reference_crops(nets, imgs)
            crops.append(c)
            found.append(idx + s)
        return np.concatenate(crops), np.concatenate(found)

    def control_outputs(self, nets: dict):
        n = min(len(self.pool), self.traffic["sample_requests"])
        self.outputs = [self.reference_outputs(nets, self.pool[i]) for i in range(n)]
        self.latencies = [0.0] * n

    def judge(self, limits: dict, nets: dict) -> tuple[bool, dict]:
        """A sample of finished requests, drawn from the seed, against the
        reference: each image's faces found or not, and each crop's bytes."""
        done = [i for i, o in enumerate(self.outputs) if o is not None]
        rng = np.random.default_rng([self.seed & ((1 << 63) - 1), 40])
        take = min(len(done), self.traffic["sample_requests"])
        sample = sorted(rng.choice(done, size=take, replace=False).tolist()) if take else []
        mismatched, worst = 0, 0.0
        for i in sample:
            crops, indices = self.outputs[i]
            ref_crops, ref_idx = self.reference_outputs(nets, self.pool[i % len(self.pool)])
            if len(indices) != len(ref_idx) or not np.array_equal(indices, ref_idx):
                mismatched += int(np.setxor1d(indices, ref_idx).size) or 1
                continue
            for a, b in zip(crops, ref_crops):
                worst = max(worst, judge.diff_share(a, b))
        checks = {
            "failed_requests": (self.failed, limits["failed_requests"]),
            "face_index_mismatches": (mismatched, limits["face_index_mismatches"]),
            "crop_diff_share": (worst, limits["crop_diff_share"]),
            "judged_requests": (len(sample), None),
        }
        return judge.verdict(checks), checks
