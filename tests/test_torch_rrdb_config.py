"""The port's gated RRDBNet x4 against the benchmark's plain reference
(``gpubench/reference/rrdb.py``, ``gpubench/reference/pipelines/
retinaface_rrdb_gated.py``) on the CPU, at small sizes.

* ``RRDBNetwork`` against the reference ``RRDBNet`` at the published
  ``nf`` 64 and ``gc`` 32, with 1, 2 and 23 blocks, one seeded state dict
  loaded into both;
* the uint8 enhancement (/255, network, bicubic x0.25, clip, round)
  against the reference's ``enhance``;
* ``Cropper(enh_threshold=...).process_images`` on the benchmark cell's
  CPU rehearsal (its configuration and traffic at their ``rehearse``
  sizes: requests of one gated and three plain images) against the
  reference pipeline's crops, and the port's ``enh_gate`` counter against
  the reference's gated count;
* the benchmark's counted multiply-adds of the network against forward
  hooks.
"""

import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from face_crop_plus_tpu_torch.models.enhancement import RRDBNet as PortEnhancer
from face_crop_plus_tpu_torch.models.enhancement import RRDBNetwork
from face_crop_plus_tpu_torch.utils import profiling
from face_crop_plus_tpu_torch.utils.device import f32_precision

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gpubench.counts import rrdb as rrdb_counts  # noqa: E402
from gpubench.harness import spec  # noqa: E402
from gpubench.harness.weights import tamed_state_dict  # noqa: E402
from gpubench.reference import rrdb  # noqa: E402
from gpubench.reference.nn import precision  # noqa: E402
from gpubench.reference.pipelines import retinaface_rrdb_gated as gated_pipeline  # noqa: E402
from gpubench.tests.test_gpubench_counts import hooked_macs  # noqa: E402

CELL = "r50_rrdb_gated_requests"
CONFIG = json.load(open(os.path.join(ROOT, "gpubench", "configs", "retinaface_r50_rrdb_x4.json")))
ENHANCER = CONFIG["model"]["enhancer"]
SEED = 4294967411


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # Hundreds of small convolutions: with the suite's workers sharing the
    # cores, one thread a worker runs them ~30x faster than torch's default.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(blocks: int, seed: int = SEED) -> dict:
    """The cell's tamed enhancer weights at ``blocks`` blocks."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in rrdb.RRDBNet(dict(ENHANCER, num_blocks=blocks)).state_dict().items()}
    recipe = CONFIG["weights"]["rrdb"]
    state = tamed_state_dict(shapes, recipe, seed, "cpu")
    for key, value in recipe["constant"].items():
        state[key].fill_(value)
    return state


def _pair(blocks: int):
    """(reference, port) networks holding one state dict."""
    state = _state(blocks)
    ref = rrdb.RRDBNet(dict(ENHANCER, num_blocks=blocks)).eval()
    port = RRDBNetwork(blocks).eval()
    ref.load_state_dict(state)
    port.load_state_dict(state)
    return ref, port


def test_the_reference_has_the_ports_parameters():
    ref, port = _pair(2)
    assert {k: v.shape for k, v in ref.state_dict().items()} == \
        {k: v.shape for k, v in port.state_dict().items()}
    assert list(ref.state_dict()) == list(port.state_dict())


@pytest.mark.parametrize("blocks,hw", [(1, (12, 16)), (2, (10, 14)), (23, (8, 8))])
def test_network_matches_the_reference(blocks, hw):
    # Float32 on both sides, the same convolutions in the same order: the
    # port only works in place where the reference allocates, so the 4x
    # outputs agree to float32 rounding of a different convolution
    # algorithm at most (1e-5 of outputs near 1); on this CPU bit for bit.
    ref, port = _pair(blocks)
    x = torch.rand(2, 3, *hw, generator=torch.Generator().manual_seed(blocks))
    with torch.no_grad(), f32_precision(), precision("float32"):
        want = ref(x)
        got = port(x.clone())
    assert got.shape == (2, 3, 4 * hw[0], 4 * hw[1])
    assert 0.1 < float(want.abs().max()) < 10.0  # tamed: neither vanished nor blown up
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("blocks,hw", [(2, (16, 20)), (23, (12, 12))])
def test_uint8_enhancement_matches_the_reference(blocks, hw):
    # The port's bicubic x0.25 sums its four taps rows first, then columns;
    # F.interpolate in its own order: the same filter to an ulp, so a level
    # may flip where x255 lands on a half.  At most 1 level, on at most 1 %
    # of the bytes.
    ref, _ = _pair(blocks)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the port's random init, replaced below
        port = PortEnhancer(device="cpu", num_blocks=blocks)
    port.net.load_state_dict(ref.state_dict())
    rows = (torch.rand(3, *hw, 3, generator=torch.Generator().manual_seed(5)) * 255).round()
    rows = rows.to(torch.uint8)
    with precision("float32"):
        got = port.enhance_device(rows)
        want = rrdb.enhance(ref, rows)
    assert got.dtype == want.dtype == torch.uint8 and got.shape == want.shape == rows.shape
    diff = (got.int() - want.int()).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) <= 0.01
    # The enhanced rows are real pixels: few clipped, far from the input.
    assert float(((want == 0) | (want == 255)).float().mean()) < 0.05
    assert float((want.float() - rows.float()).abs().mean()) > 1.0


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory, _one_thread):
    """The cell's entry at its CPU rehearsal sizes: seeded weights, the
    gated pool, the package's ``Cropper`` and the reference networks."""
    mp = pytest.MonkeyPatch()
    mp.setenv("FCPT_HOST_CROP", "0")
    mp.setenv("FCPT_NATIVE_WARP", "0")
    try:
        cell = spec.resolve(spec.load_benchmark(ROOT), CELL, ROOT, rehearse=True)
        run = spec.entry(cell, SEED, torch.device("cpu"), str(tmp_path_factory.mktemp("w")))
        with precision("float32"):
            run._make_weights()
        run._make_inputs()
        run.cropper = run._build()
        yield run, run.reference_nets()
    finally:
        mp.undo()


def test_each_request_holds_one_gated_image(rehearsal):
    run, nets = rehearsal
    interim = (run.kw["resize_size"],) * 2
    h, w = run.traffic["image_hw"]
    for batch in run.pool:
        lm, idx = gated_pipeline.faces(nets, run.model, torch.from_numpy(batch), interim,
                                       run.kw["det_threshold"])
        f = gated_pipeline.gate_factors(lm, h, w, interim).numpy()
        assert len(idx) == len(batch)
        # The configuration's threshold: the rehearsal's faces are a
        # sixteenth of their anchors in an interim a sixteenth as wide.
        threshold, margin = run.kw["enh_threshold"], run.traffic["gate_margin"]
        assert threshold == CONFIG["cropper"]["enh_threshold"] and margin > 0
        # One gated image and the rest plain, each beyond the margin.
        assert (f <= threshold * (1 - margin)).sum() == 1
        assert (f >= threshold * (1 + margin)).sum() == len(batch) - 1
        # Factors of a 256 and of a 512 anchor: the five-point template's
        # (right mouth - left eye) extent, in tenths of the anchor, over the
        # padded interim area; at the cell's size 0.0065 and 0.0262.
        lm = np.array(run.config["weights"]["retinaface"]["constant"]
                      ["LandmarkHead.2.conv1x1.bias"][:10]).reshape(5, 2)
        ex, ey = 0.1 * (lm[4] - lm[0])
        want = ex * ey * np.array(run.model["min_sizes"][2]) ** 2 / (interim[0] * interim[1])
        assert want[0] < threshold * (1 - margin) < threshold * (1 + margin) < want[1]
        near = np.abs(f[:, None] / want[None, :] - 1).min(axis=1)
        assert near.max() < 0.05, (f, want)


def test_process_images_matches_the_reference_pipeline(rehearsal, monkeypatch, capfd):
    # The device warp (the card's crop path), as the rehearsal runs it.
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    monkeypatch.setenv("FCPT_NATIVE_WARP", "0")
    run, nets = rehearsal
    profiling.take_timeline()
    for batch in run.pool:
        before = run.cropper.stats.as_dict().get("enh_gate", {"items": 0, "calls": 0})
        with profile(activities=[ProfilerActivity.CPU]):
            crops, indices, _ = run.cropper.process_images(batch)
        after = run.cropper.stats.as_dict()["enh_gate"]
        with precision("float32"):
            ref_crops, ref_idx = run.reference_outputs(nets, batch)
        np.testing.assert_array_equal(indices, ref_idx)
        assert crops.shape == ref_crops.shape
        # One gated image a request: its crop comes from the enhanced row.
        # Crops agree within a level; the port's bicubic may flip a level
        # of the enhanced row where F.interpolate's order lands on a half.
        diff = np.abs(crops.astype(int) - ref_crops.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
        # enh_gate: one call a batch, the images gated, of the real images.
        assert after["calls"] - before["calls"] == 1
        assert after["items"] - before["items"] == 1
        counts = [r for r in profiling.take_timeline()
                  if isinstance(r, profiling.Count) and r.name == "enh_gate"]
        assert [(c.items, c.args) for c in counts] == [(1, {"judged": len(batch)})]
    err = capfd.readouterr().err
    assert err.count(f"rrdb_gated crops: {len(batch) - 1} plain, 1 gated") == len(run.pool)
    assert "enh_gate" in run.cropper.stats.report()


def test_a_fault_in_the_enhancer_is_seen(rehearsal, monkeypatch):
    # The gated crop taken from the un-enhanced interim differs from the
    # reference's far beyond the level the sound comparison allows, on
    # most bytes it samples from the image (a crop may reach into the
    # constant border, equal on both sides).
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    monkeypatch.setenv("FCPT_NATIVE_WARP", "0")
    run, nets = rehearsal
    monkeypatch.setattr(run.cropper.enh_model, "enhance_device", lambda images: images)
    crops, indices, _ = run.cropper.process_images(run.pool[0])
    with precision("float32"):
        ref_crops, ref_idx = run.reference_outputs(nets, run.pool[0])
    np.testing.assert_array_equal(indices, ref_idx)
    far = np.abs(crops.astype(int) - ref_crops.astype(int)) > 1
    inside = ref_crops > 0
    assert max(far[i][inside[i]].mean() for i in range(len(crops)) if inside[i].any()) > 0.5


def test_predict_counts_the_gate():
    # The staged path's gate: the mean face factor of each image.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        enh = PortEnhancer(min_face_factor=0.05, device="cpu", num_blocks=1)
    images = np.zeros((3, 16, 16, 3), np.uint8)
    # Faces of extent 2x2 (factor 0.016), 8x8 (0.25) and none.
    lm = np.zeros((2, 5, 2), np.float32)
    lm[0, 4] = (2, 2)
    lm[1, 4] = (8, 8)
    profiling.take_timeline()
    with profile(activities=[ProfilerActivity.CPU]):
        enh.predict(images, lm, [0, 1])
        enh.predict(images, None, None)
    counts = [(r.items, r.args) for r in profiling.take_timeline()
              if isinstance(r, profiling.Count) and r.name == "enh_gate"]
    assert counts == [(1, {"judged": 3}), (3, {"judged": 3})]
    assert enh.stats.as_dict()["enh_gate"] == {"seconds": 0.0, "calls": 2, "items": 4}
    # Off the profiler nothing is kept.
    enh.predict(images, lm, [0, 1])
    assert enh.stats.as_dict()["enh_gate"]["calls"] == 2


@pytest.mark.parametrize("enhancer", [dict(ENHANCER, num_blocks=2),
                                      {"nf": 16, "gc": 8, "num_blocks": 3, "scale": 4}])
@pytest.mark.parametrize("hw", [(8, 8), (6, 10)])
def test_counts_match_forward_hooks(enhancer, hw):
    net = rrdb.RRDBNet(enhancer).eval()
    assert rrdb_counts.network_macs(*hw, enhancer) == hooked_macs(net, torch.zeros(1, 3, *hw))
    assert rrdb_counts.row_flop(*hw, enhancer) == 2 * rrdb_counts.network_macs(*hw, enhancer)


def test_count_at_the_cell_size():
    # 17,926,848 multiply-adds a pixel at the published widths: 37.6 TFLOP
    # a gated 1024² interim.
    assert rrdb_counts.network_macs(1, 1, ENHANCER) == 17_926_848
    assert rrdb_counts.row_flop(1024, 1024, ENHANCER) == 2 * 17_926_848 * 1024 * 1024
