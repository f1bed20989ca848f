"""The cell ``r50_rrdb_gated_requests`` on the CPU: its rehearsal is
correct, every judged request holds one gated image, its traced count is
the detector's images and the enhancer's rows, and the faults of a gated
enhancer come out not correct (one gated crop altered, the gated crops
taken from the un-enhanced interim, the enhanced rows truncated where they
are rounded); the TF32 control reads above a sound run; the pool's
calibration sets the share of its images whose one face is a gated one,
and a block without gated images exits 2."""

import json
import os
import re
import subprocess
import sys

import pytest

from gpubench.counts import retinaface as retinaface_counts
from gpubench.counts import rrdb as rrdb_counts
from gpubench.harness import spec
from gpubench.tests.helpers import ROOT, result, run_cell

CELL = "r50_rrdb_gated_requests"

FAULTS = {
    # The warp of the gated faces (from the enhanced rows, inside the
    # interim's window) returns its first crop inverted.
    "gated_crop_altered": """
from face_crop_plus_tpu_torch import pipeline as _p
_warp = _p.FusedPipeline._warp
def _bad(self, images, matrices, img_idx, *args):
    out = _warp(self, images, matrices, img_idx, *args)
    if len(args) > 1 and args[1] is not None and self.enh is not None:
        out[0] = 255 - out[0]
    return out
_p.FusedPipeline._warp = _bad
""",
    "gated_from_the_interim": """
from face_crop_plus_tpu_torch.models import enhancement as _e
_e.RRDBNet.enhance_device = lambda self, images: images.clone()
""",
    "enhanced_rows_truncated": """
import torch
from face_crop_plus_tpu_torch.models import enhancement as _e
_e.to_uint8 = lambda x: torch.clamp(x, 0, 255).to(torch.uint8)
""",
}


def _judged(err: str) -> list[tuple[int, int]]:
    return [(int(p), int(g)) for p, g in re.findall(r"rrdb_gated crops: (\d+) plain, (\d+) gated",
                                                   err)]


def test_the_rehearsal_is_correct_and_counted():
    rc, lines, err, _ = run_cell(CELL, "--trace", "1", "--rehearse-cpu")
    assert rc == 0, err[-3000:]
    out = result(lines)
    assert out["correct"] is True, out["checks"]
    cell = spec.resolve(spec.load_benchmark(ROOT), CELL, ROOT, rehearse=True)
    k = cell.traffic["request_images"]
    # Every judged request: one gated face and the rest plain.
    judged = _judged(err)
    assert len(judged) == out["checks"]["judged_requests"]["value"] >= 1
    assert judged == [(k - 1, 1)] * len(judged)
    saturation = re.findall(r"saturated share (\S+), mean \|enhanced - interim\| (\S+) levels",
                            err)
    assert saturation and all(float(s) < 0.05 and float(d) > 1.0 for s, d in saturation)
    # The gate counted one image a request, the enhancer ran one row each.
    (window,) = [x for x in lines if x.startswith("window: ")]
    found = re.match(r"window: \S+ s, (\d+) attempted, (\d+) failed, \d+ faces; stages (.*)$",
                     window)
    attempted, failed, stages = int(found[1]), int(found[2]), json.loads(found[3])
    done = attempted - failed
    assert stages["enh_gate"]["items"] == stages["enh_net"]["items"] == done >= 1
    assert stages["enh_gate"]["calls"] == done
    # The traced count: the detector's images and the enhancer's rows.
    (traced,) = [x for x in lines if x.startswith("traced: ")]
    interim = cell.config["cropper"]["resize_size"]
    h, w = cell.traffic["image_hw"]
    model = cell.config["model"]
    want = (done * k * retinaface_counts.image_flop(h, w, interim, interim, model)
            + done * rrdb_counts.row_flop(interim, interim, model["enhancer"]))
    assert int(re.search(r"counted (\d+) FLOP", traced)[1]) == want
    # No device seconds on the CPU: the enhancer's two metrics read nothing.
    assert "mfu" in out["metrics"]
    assert "enh_net_roofline" not in out["metrics"]
    assert "enh_ms_per_gated_image" not in out["metrics"]


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_of_the_gated_enhancer_is_not_correct(fault):
    rc, lines, err, _ = run_cell(CELL, "--trace", "0", "--rehearse-cpu", prelude=FAULTS[fault])
    assert rc == 0, err[-3000:]
    out = result(lines)
    assert out["correct"] is False
    check = out["checks"]["crop_diff_share"]
    assert check["value"] > check["limit"], out["checks"]


def test_the_control_reads_above_a_sound_run():
    rc, lines, err, _ = run_cell(CELL, "--trace", "0", "--rehearse-cpu")
    assert rc == 0, err[-3000:]
    sound = result(lines)["checks"]["crop_diff_share"]["value"]
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "gpubench", "control.py"),
                           "--workload", CELL, "--seeds", "2,3", "--rehearse-cpu"],
                          capture_output=True, text=True, timeout=1800, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    readings = json.loads(proc.stdout.splitlines()[-1])["control"]
    assert all(r["crop_diff_share"] > sound for r in readings.values()), readings


def _entry(seed: int = 7):
    import torch

    from gpubench.reference.nn import precision

    cell = spec.resolve(spec.load_benchmark(ROOT), CELL, ROOT, rehearse=True)
    run = spec.entry(cell, seed, torch.device("cpu"), os.path.join(ROOT, ".gpubench", "w"))
    with precision("float32"):
        run._make_weights()
    return run


def test_the_calibration_sets_the_gated_share():
    import numpy as np
    import torch

    from gpubench.entries import process_images_gated as gated
    from gpubench.harness import inputs
    from gpubench.reference.retinaface import RetinaFaceNet

    run = _entry()
    w = run.weights["retinaface"]
    constant = run.config["weights"]["retinaface"]["constant"]
    for key in ("LandmarkHead.2.conv1x1.bias", "BboxHead.2.conv1x1.bias"):
        np.testing.assert_allclose(w[key].numpy(), constant[key], rtol=1e-6)
    h, wd = run.traffic["image_hw"]
    block = inputs.images(7, gated.CANDIDATE_STREAM, gated.CALIBRATION_IMAGES, h, wd,
                          run.traffic["content"], "cpu")
    det = RetinaFaceNet(run.model)
    det.load_state_dict(w)
    with torch.no_grad():
        _, before = run._scores(det.eval(), block)
        run._calibrate(det, block)
        factors, after = run._scores(det, block)
    # The run's weights hold the calibration, for the package and the reference.
    assert all(torch.equal(v, w[k]) for k, v in det.state_dict().items())
    # One shift of the smaller anchors' logit: a quarter of the images lead with one.
    shift = after - before
    np.testing.assert_allclose(shift, shift[0], atol=1e-5)
    assert (after > 0).mean() == pytest.approx(gated.GATED_SHARE, abs=1 / len(block))
    # The image's one face is the leading anchor's: a 256 one below the threshold.
    threshold = run.kw["enh_threshold"]
    np.testing.assert_array_equal(factors < threshold, after > 0)


def test_a_block_without_gated_images_exits_2():
    run = _entry()
    run.kw["enh_threshold"] = 1e-6  # below every face factor
    with pytest.raises(SystemExit) as e:
        run._make_inputs()
    assert e.value.code == 2
