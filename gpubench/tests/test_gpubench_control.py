"""The comparison that decides ``correct`` fails what it must fail.

* The control: the reference in TF32 in the package's place.  On the
  card, at each cell's own size, it must come out not correct; on the
  CPU, at the rehearsal's tiny size (TF32 emulated by rounding the
  operands), its numbers must read above a sound run's.
* The faults a run can have, planted in the package under a CPU
  rehearsal of the whole run: a crop altered where it is made, half of a
  batch left out, a file that never comes.
"""

import json
import os
import subprocess
import sys

import pytest

from gpubench.tests.helpers import ROOT, result, run_cell

ALTER_WARP = """
from face_crop_plus_tpu_torch import {module} as _m
_warp = _m.warp_affine_u8
def _bad(*a, **k):
    out = _warp(*a, **k)
    out[0] = 255 - out[0]
    return out
_m.warp_affine_u8 = _bad
"""

DROP_FILE = """
from face_crop_plus_tpu_torch import cropper as _c
_write = _c.imwrite
_c.imwrite = lambda path, image: True if "img_00003" in path else _write(path, image)
"""

# Half of each fused batch left out: its other images come back faceless.
DROP_HALF = """
from face_crop_plus_tpu_torch import cropper as _c
_fused = _c.Cropper._fused_process
def _half(self, batch, *a, **k):
    return _fused(self, batch[: max(1, len(batch) // 2)], *a, **k)
_c.Cropper._fused_process = _half
"""

FAULTS = [
    ("r50_largest_requests", ALTER_WARP.format(module="pipeline"), "crop_diff_share"),
    ("r50_largest_requests", DROP_HALF, "face_index_mismatches"),
    ("r50_largest_dir", ALTER_WARP.format(module="pipeline"), "crop_diff_share"),
    ("r50_largest_dir", DROP_HALF, "listing_mismatches"),
    ("r50_largest_dir", DROP_FILE, "listing_mismatches"),
]
CELLS = ["r50_largest_requests", "r50_largest_dir"]


@pytest.mark.parametrize("workload,fault,number", FAULTS,
                         ids=[f"{w}-{n}-{i}" for i, (w, _, n) in enumerate(FAULTS)])
def test_a_planted_fault_is_not_correct(workload, fault, number):
    rc, lines, err, _ = run_cell(workload, "--trace", "0", "--rehearse-cpu", prelude=fault)
    assert rc == 0, err[-3000:]
    out = result(lines)
    assert out["correct"] is False
    check = out["checks"][number]
    assert check["value"] > check["limit"], out["checks"]


def _control(workload: str, seeds: str, *extra: str) -> dict:
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "gpubench", "control.py"),
                           "--workload", workload, "--seeds", seeds, *extra],
                          capture_output=True, text=True, timeout=1800, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.splitlines()[-1])["control"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_reads_above_a_sound_run_on_the_cpu(workload):
    rc, lines, err, _ = run_cell(workload, "--trace", "0", "--rehearse-cpu")
    assert rc == 0, err[-3000:]
    sound = {k: v["value"] for k, v in result(lines)["checks"].items() if v["limit"] is not None}
    for reading in _control(workload, "2,3", "--rehearse-cpu").values():
        assert any(reading[k] > sound[k] for k in sound), (reading, sound)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct_on_the_card(card, workload):
    import gpubench.control as control
    from gpubench.harness import spec

    cell = spec.resolve(spec.load_benchmark(ROOT), workload, ROOT)
    for seed in (101, 102, 103):
        correct, checks = control.control(cell, seed, card, os.path.join(
            ROOT, ".gpubench", "control", workload))
        assert correct is False, checks
