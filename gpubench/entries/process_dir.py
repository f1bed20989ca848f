"""``Cropper.process_dir`` over a directory written at set-up, pass after
pass into fresh output directories, in one client.

Traffic keys: ``files`` of ``image_hw`` and one file of each of
``other_sizes`` (:func:`gpubench.harness.inputs.directory_names`),
``content``, and the ``cropper``'s ``num_processes``.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

from gpubench.harness import inputs, judge
from gpubench.harness.cell import Cell


class Entry(Cell):

    def _make_inputs(self):
        shutil.rmtree(self.workdir, ignore_errors=True)
        self.in_dir = os.path.join(self.workdir, "in")
        self.names = inputs.write_directory(self.in_dir, self.traffic, self.seed, self.device)
        # Every device shape of a pass in two file batches: a full fused
        # group, and a fused group padded to the batch beside one staged
        # file (the largest; the staged detect runs one image at the
        # interim size, whatever the file's size).
        largest = max(self.traffic.get("other_sizes", []), key=lambda hw: hw[0] * hw[1],
                      default=None)
        warm = dict(self.traffic, files=2 * self.kw["batch_size"] - 1,
                    other_sizes=[largest] if largest else [])
        self.warm_dir = os.path.join(self.workdir, "warm_in")
        inputs.write_directory(self.warm_dir, warm, self.seed, self.device)

    def _build(self):
        return self._make_cropper()

    def _warm_up(self):
        self.cropper.process_dir(self.warm_dir, os.path.join(self.workdir, "warm"), desc=None)

    def run(self, seconds: float):
        """Whole passes until the window's time is up; the window ends with
        the last pass."""
        self.passes, self.pass_s = [], []
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            out = os.path.join(self.workdir, f"pass_{len(self.passes):04d}")
            self.attempted += 1
            start = time.perf_counter()
            try:
                self.cropper.process_dir(self.in_dir, out, desc=None)
            except Exception as e:  # noqa: BLE001 - a failed pass is counted, not fatal
                self.failed += 1
                print(f"pass {len(self.passes)} failed: {e!r}", flush=True)
                out = None
            self.pass_s.append(time.perf_counter() - start)
            self.passes.append(out)
        self.window_s = time.perf_counter() - t0
        self.listings = [judge.listing(p) if p else None for p in self.passes]
        self.faces = sum(len(ls) for ls in self.listings if ls)
        self.bytes_written = sum(judge.tree_bytes(p) for p in self.passes if p)
        print("passes: " + ", ".join(f"{s:.6f}" for s in self.pass_s) + " s")

    def images_done(self) -> list[tuple[int, int]]:
        done = len(self.passes) - self.failed
        return [hw for _, hw in inputs.directory_names(self.traffic)] * done

    def reference_tree(self, nets: dict) -> dict:
        """The reference's tree of the directory, {file name: crop}: files
        of the uniform shape as the fused path crops them (in blocks of the
        cropper's batch, padded by repeating the last), the others as the
        staged path does (resized on the host with cv2 into the interim,
        cropped from it in their window)."""
        import cv2

        from gpubench.reference.retinaface import interim_geometry

        ih = iw = self.kw["resize_size"]
        uniform = tuple(self.traffic["image_hw"])
        imgs = {n: cv2.cvtColor(cv2.imread(os.path.join(self.in_dir, n)), cv2.COLOR_BGR2RGB)
                for n in self.names}
        fused = [n for n in self.names if imgs[n].shape[:2] == uniform]
        block = self.kw["batch_size"]
        tree = {}
        for s in range(0, len(fused), block):
            chunk = fused[s: s + block]
            batch = np.stack([imgs[n] for n in chunk])
            if len(batch) < block:
                batch = np.concatenate([batch, np.repeat(batch[-1:], block - len(batch), axis=0)])
            crops, idx = self.reference_crops(nets, torch.from_numpy(batch).to(self.device))
            for c, i in zip(crops, idx):
                if i < len(chunk):
                    tree[chunk[i]] = c
        for n in self.names:
            if n in fused:
                continue
            h, w = imgs[n].shape[:2]
            _, (t, b, l, r) = interim_geometry(h, w, ih, iw)
            interp = cv2.INTER_CUBIC if max(h, w) <= max(ih, iw) else cv2.INTER_AREA
            rh, rw = ih - t - b, iw - l - r
            body = cv2.resize(imgs[n], (rw, rh), interpolation=interp)
            interim = cv2.copyMakeBorder(body, t, b, l, r, cv2.BORDER_CONSTANT)
            dev = torch.from_numpy(interim[None]).to(self.device)
            offset = torch.tensor([l, t], dtype=torch.float32, device=self.device)
            window = torch.tensor([[t, l, rh, rw]], dtype=torch.int32, device=self.device)
            crops, _ = self.reference_crops(nets, dev, offset, window)
            if len(crops):
                tree[n] = crops[0]
        return tree

    def control_outputs(self, nets: dict):
        out = os.path.join(self.workdir, "pass_0000")
        judge.write_tree(out, self.reference_tree(nets))
        self.passes, self.listings = [out], [judge.listing(out)]

    def judge(self, limits: dict, nets: dict) -> tuple[bool, dict]:
        """Every pass's listing against the reference's, and every file of
        a pass drawn from the seed against the reference's crop (encoded
        as the package encodes)."""
        rng = np.random.default_rng([self.seed & ((1 << 63) - 1), 41])
        done = [p for p in self.passes if p]
        tree = self.reference_tree(nets)
        expected = set(tree)
        mismatches = sum(len(set(ls) ^ expected) for ls in self.listings if ls is not None)
        worst = 0.0
        if done:
            root = done[int(rng.integers(len(done)))]
            for rel, ref in tree.items():
                got = judge.read_decoded(os.path.join(root, rel))
                worst = max(worst, judge.diff_share(got, judge.encoded(ref, rel)))
        checks = {
            "failed_passes": (self.failed, limits["failed_passes"]),
            "listing_mismatches": (mismatches, limits["listing_mismatches"]),
            "crop_diff_share": (worst, limits["crop_diff_share"]),
            "judged_files": (len(tree) if done else 0, None),
        }
        return judge.verdict(checks), checks
