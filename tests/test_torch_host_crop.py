"""Port parity: the host-crop mode and the packed 4:2:0 wire in detection
mode, and packed sources in the landmark-free mode.

The JAX ``Cropper`` and the port's run the same configuration with the
same tamed weights.  Tolerances:

* host crops (``FCPT_HOST_CROP`` 1 or auto, the native library built):
  equal indices, pixels within ±1 — both packages warp with the same
  native binary in 10-bit fixed point, from landmarks that differ by the
  detectors' float32 rounding;
* packed uploads (``FCPT_PACK_UPLOAD=1``): both detect on the same
  reconstruction (bit-equal, ``test_torch_yuv.py``): PNG trees within ±1;
* packed crop rows (packed fetches, the YUV-direct host crops), as the
  save step receives them: within ±1; the JPEG files they encode to
  against the port's own RGB tree, on smooth content: the raw-data
  encoder's band against cv2's encoder (``tests/test_yuv.py``), mean < 1.5
  and max ≤ 16 (the JAX package's 4:2:0 warp band, mean < 1.0 and max ≤ 8,
  holds for its own pairs, ``tests/test_yuv_crop.py``);
* enhanced packed sources: JPEG files within ±2 (enhanced pixels ±1).
"""

import os
import warnings
from collections import defaultdict

import numpy as np
import pytest
import torch

import face_crop_plus_tpu
import face_crop_plus_tpu_torch
import face_crop_plus_tpu_torch.cropper as port_cropper
from face_crop_plus_tpu_torch.pipeline import FusedPipeline
from face_crop_plus_tpu_torch.utils import native_io

from torch_parity import (
    cropper_pair,
    read_tree,
    small_enhancers,
    smooth_image,
    tree_max_diff,
    write_mixed_dir,
)

pytestmark = pytest.mark.skipif(
    not native_io.native_warp_available(), reason="the native host library did not build"
)
KW = dict(output_size=64, resize_size=64, det_threshold=-1.0, batch_size=4)
ENV = ("FCPT_HOST_CROP", "FCPT_PACK_UPLOAD", "FCPT_PACK_FETCH", "FCPT_YUV_CROP",
       "FCPT_NATIVE_WARP")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small parity runs share the machine's
    cores with the suite's other workers (see ``test_torch_enhancement.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def src(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("src"))
    write_mixed_dir(path)
    return path


@pytest.fixture(scope="module")
def smooth_src(tmp_path_factory):
    """Six smooth 72×60 JPEGs (the fused group) and one 50×90 (staged)."""
    from face_crop_plus_tpu_torch.utils.io import imwrite

    path = str(tmp_path_factory.mktemp("smooth"))
    rng = np.random.default_rng(10)
    for i in range(6):
        imwrite(os.path.join(path, f"s{i}.jpg"), smooth_image(rng, 72, 60, cell=24))
    imwrite(os.path.join(path, "t0.jpg"), smooth_image(rng, 50, 90, cell=24))
    return path


@pytest.fixture(scope="module")
def pairs():
    return {s: cropper_pair(strategy=s, max_faces=4, auto_grow=False, **KW)
            for s in ("largest", "all")}


@pytest.fixture()
def spies(monkeypatch):
    """Counts the port's detect-only passes, host warps and device warps."""
    counts = {"detect_only": 0, "host": 0, "device": 0}
    real_detect, real_host = FusedPipeline.detect_only, native_io.warp_affine_batch_native
    real_device = port_cropper.warp_affine_u8

    def detect_only(self, *a, **kw):
        counts["detect_only"] += 1
        return real_detect(self, *a, **kw)

    def host(*a, **kw):
        counts["host"] += 1
        return real_host(*a, **kw)

    def device(*a, **kw):
        counts["device"] += 1
        return real_device(*a, **kw)

    monkeypatch.setattr(FusedPipeline, "detect_only", detect_only)
    monkeypatch.setattr(native_io, "warp_affine_batch_native", host)
    monkeypatch.setattr(port_cropper, "warp_affine_u8", device)
    return counts


def _pair(pairs, strategy, **attrs):
    j, t = pairs[strategy]
    for c in (j, t):
        c._fused_shapes.clear()
        for k, v in {"output_format": None, **attrs}.items():
            setattr(c, k, v)
    return j, t


def _run(cropper, src, out):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cropper.process_dir(src, out, desc=None)
    return read_tree(out)


def _saved(monkeypatch) -> dict:
    """What each package's ``save_group`` receives, by output file name:
    {"jax": {name: face}, "port": {...}}."""
    saved = {"jax": {}, "port": {}}
    for key, cls in (("jax", face_crop_plus_tpu.Cropper),
                     ("port", face_crop_plus_tpu_torch.Cropper)):
        def spy(self, faces, file_names, output_dir, _real=cls.save_group, _out=saved[key]):
            seen = defaultdict(int)
            for face, source in zip(faces, file_names):
                _out[self._crop_file_name(source, seen[source])] = np.asarray(face)
                seen[source] += 1
            return _real(self, faces, file_names, output_dir)

        monkeypatch.setattr(cls, "save_group", spy)
    return saved


def _rows_within_one(saved) -> int:
    """Largest difference of the saved faces; packed rows where JAX saved
    rows (a batch with a fused group), RGB crops where it saved crops."""
    ours, ref = saved["port"], saved["jax"]
    assert sorted(ours) == sorted(ref) and ours
    assert all(ours[k].shape == ref[k].shape for k in ours)
    assert sum(v.ndim == 1 for v in ours.values()) >= 4
    return max(int(np.abs(ours[k].astype(np.int16) - ref[k]).max()) for k in ours)


def _band(a: dict, b: dict):
    """(mean, max) pixel difference of two trees with the same names."""
    assert sorted(a) == sorted(b) and a
    d = [np.abs(a[k].astype(np.int16) - b[k].astype(np.int16)) for k in a]
    return max(float(x.mean()) for x in d), max(int(x.max()) for x in d)


@pytest.mark.parametrize("env", [None, "0", "1"])
def test_host_crop_gates_match_jax(pairs, monkeypatch, env):
    j, t = _pair(pairs, "largest")
    if env is not None:
        monkeypatch.setenv("FCPT_HOST_CROP", env)
    try:
        for source in ("original", "interim"):
            j.crop_source = t.crop_source = source
            assert t._host_crop_enabled() == j._host_crop_enabled()
            assert t._host_crop_enabled() == (env != "0" and source == "original")
    finally:
        j.crop_source = t.crop_source = "original"


@pytest.mark.parametrize("env", [None, "auto", "1"])
def test_card_needs_explicit_host_warp_switches(pairs, monkeypatch, env):
    """On a card the port's "auto" turns no host warp on, though the native
    library is built: the host-crop mode, the landmark mode's host warp and
    its YUV-direct crops take ``FCPT_HOST_CROP=1`` / ``FCPT_YUV_CROP=1``
    there, and pixels already on a card never leave it for a host warp.  On
    the CPU "auto" keeps the JAX package's gates.  Only the gates run: the
    device is patched to "cuda" after construction, and a tensor on the
    "meta" device stands for one on the card."""
    if env is not None:
        monkeypatch.setenv("FCPT_HOST_CROP", env)
        monkeypatch.setenv("FCPT_YUV_CROP", env)
    _, t = _pair(pairs, "largest")
    rng = np.random.default_rng(7)
    images = np.stack([smooth_image(rng, 64, 64) for _ in range(2)])
    mats = np.tile(np.array([[1, 0, 0], [0, 1, 0]], np.float32), (2, 1, 1))
    idx = np.arange(2)
    pts = rng.uniform(8, 56, (2, 5, 2)).astype(np.float32)
    lm = face_crop_plus_tpu_torch.Cropper(output_size=64, device="cpu",
                                          landmarks=(pts, np.array(["a.jpg", "b.jpg"])))
    assert t._host_crop_enabled() and lm._yuv_crop_eligible()
    assert lm._native_warp(images, mats, idx, None) is not None
    for c in (t, lm):
        monkeypatch.setattr(c, "_device", torch.device("cuda"))
    forced = env == "1"
    assert t._host_crop_enabled() == forced and lm._host_crop_enabled() == forced
    assert lm._yuv_crop_eligible() == forced
    assert (lm._native_warp(images, mats, idx, None) is not None) == forced
    assert t._native_warp(images, mats, idx, None, force=True) is not None
    on_card = torch.empty(images.shape, dtype=torch.uint8, device="meta")
    assert lm._native_warp(on_card, mats, idx, None) is None
    assert t._native_warp(on_card, mats, idx, None, force=True) is None


@pytest.mark.parametrize("env", ["1", "auto"])
@pytest.mark.parametrize("ragged", [False, True])
def test_process_images_host_crop(pairs, spies, monkeypatch, env, ragged):
    """Uniform batches run the detect-only program and warp on the host;
    ragged batches take the staged path, whose crops warp on the host too."""
    monkeypatch.setenv("FCPT_HOST_CROP", env)
    j, t = _pair(pairs, "largest")
    rng = np.random.default_rng(4)
    shapes = [(72, 60), (50, 90), (72, 60), (64, 40)] if ragged else [(72, 60)] * 4
    images = [smooth_image(rng, *hw) for hw in shapes]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_crops, ref_idx, _ = j.process_images(images)
        crops, idx, groups = t.process_images(images)
    np.testing.assert_array_equal(idx, ref_idx)
    assert crops.shape == ref_crops.shape and len(idx) == 4 and groups == (None, None)
    assert np.abs(crops.astype(np.int16) - ref_crops).max() <= 1
    assert spies == {"detect_only": 0 if ragged else 1, "host": 1, "device": 0}


@pytest.mark.parametrize("env", ["1", "auto"])
@pytest.mark.parametrize("strategy", ["largest", "all"])
def test_process_dir_host_crop(pairs, src, spies, tmp_path, monkeypatch, env, strategy):
    """The mixed directory: the 72×60 group runs detect-only with host
    crops, the staged leftovers warp on the host; ±1 against JAX."""
    monkeypatch.setenv("FCPT_HOST_CROP", env)
    j, t = _pair(pairs, strategy, output_format="png")
    ref = _run(j, src, str(tmp_path / "jax"))
    ours = _run(t, src, str(tmp_path / "port"))
    assert tree_max_diff(ours, ref) <= 1
    assert len(ours) >= 10 and t._fused_shapes == {(72, 60, 3)}
    # Three batches: the fused group runs in the first two, staged files in
    # the last two; one host warp for each.
    assert spies["detect_only"] == 2 and spies["device"] == 0 and spies["host"] == 4


def test_pack_upload_tree(pairs, src, tmp_path, monkeypatch):
    """``FCPT_PACK_UPLOAD=1``, device crops: the JPEG group uploads packed
    and crops from the device reconstruction (PNG outputs, ±1 against
    JAX).  No band against the RGB upload: the random-weight detector
    moves its landmarks with the ~1-level reconstruction difference."""
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    monkeypatch.setenv("FCPT_PACK_UPLOAD", "1")
    j, t = _pair(pairs, "largest", output_format="png")
    assert t._packed_upload_eligible() and not t._packed_fetch_eligible(["a.jpg"])
    ref = _run(j, src, str(tmp_path / "jax"))
    ours = _run(t, src, str(tmp_path / "port"))
    assert tree_max_diff(ours, ref) <= 1
    assert t._fused_shapes == {("yuv420", 72, 60)}


@pytest.mark.parametrize("strategy", ["largest", "all"])
def test_pack_fetch_tree(pairs, smooth_src, tmp_path, monkeypatch, strategy):
    """``FCPT_PACK_FETCH=1``: JPEG-bound crops come down packed from the
    device (staged crops packed on the host) and feed the raw-data
    encoder: rows ±1 against JAX, the encoder's band against RGB fetches."""
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    monkeypatch.setenv("FCPT_PACK_FETCH", "1")
    j, t = _pair(pairs, strategy, output_format="jpg")
    assert t._packed_fetch_eligible(["a.png"]) and not t._packed_upload_eligible()
    saved = _saved(monkeypatch)
    _run(j, smooth_src, str(tmp_path / "jax"))
    ours = _run(t, smooth_src, str(tmp_path / "port"))
    assert _rows_within_one(saved) <= 1
    monkeypatch.setenv("FCPT_PACK_FETCH", "0")
    rgb = _run(_pair(pairs, strategy, output_format="jpg")[1], smooth_src,
               str(tmp_path / "rgb"))
    mean, worst = _band(ours, rgb)
    assert mean < 1.5 and worst <= 16


def test_host_crop_packed_rows(pairs, smooth_src, spies, tmp_path, monkeypatch):
    """Host crops with packed uploads and JPEG outputs warp the stored
    planes straight into packed rows (the RGB groups and staged crops are
    packed on the host): rows ±1 against JAX; with ``FCPT_YUV_CROP=0``
    the host warps the RGB reconstruction and cv2 encodes: the encoder's
    band's mean."""
    monkeypatch.setenv("FCPT_HOST_CROP", "1")
    monkeypatch.setenv("FCPT_PACK_UPLOAD", "1")
    j, t = _pair(pairs, "all", output_format="jpg")
    assert t._host_yuv_rows_ok(["a.jpg"])
    saved = _saved(monkeypatch)
    _run(j, smooth_src, str(tmp_path / "jax"))
    ours = _run(t, smooth_src, str(tmp_path / "port"))
    assert _rows_within_one(saved) <= 1
    assert spies["detect_only"] == 2 and spies["device"] == 0
    monkeypatch.setenv("FCPT_YUV_CROP", "0")
    rgb = _run(_pair(pairs, "all", output_format="jpg")[1], smooth_src,
               str(tmp_path / "rgb"))
    # Mean only: a crop whose border meets sharp content differs there by
    # tens of levels (4:2:0 chroma at the edge), in either encoder.
    mean, _ = _band(ours, rgb)
    assert mean < 1.5


@pytest.fixture(scope="module")
def uniform_src(tmp_path_factory):
    """Five 4:2:0 JPEGs of one even shape (the landmark-free mode's parse
    needs one shape)."""
    from face_crop_plus_tpu_torch.utils.io import imwrite

    path = str(tmp_path_factory.mktemp("uniform"))
    rng = np.random.default_rng(9)
    for i in range(5):
        imwrite(os.path.join(path, f"u{i}.jpg"), smooth_image(rng, 48, 40))
    return path


def test_landmark_free_packed_parse(uniform_src, tmp_path, monkeypatch):
    """Packed sources parsed as rows (reconstructed on the device) and
    written back through the raw-data encoder as their stored samples: the
    JAX tree's names, its originals byte for byte (the labels' parity is
    ``test_torch_parsing.py``'s; JPEG masks blur a near-tie flip)."""
    from face_crop_plus_tpu.models import parsing as jp
    from face_crop_plus_tpu_torch.models import parsing as tp

    for module in (jp, tp):
        monkeypatch.setattr(module, "_INFER_SIZE", 128)
    monkeypatch.setenv("FCPT_PACK_UPLOAD", "1")
    j, t = cropper_pair(det_threshold=None, batch_size=4, attr_groups={"p3": [3]},
                        mask_groups={"face": [1, 2, 3]})
    assert t._packed_upload_eligible()
    seen = []
    real = t.par_model.predict
    monkeypatch.setattr(t.par_model, "predict",
                        lambda im, *a, **kw: seen.append(kw.get("src_hw")) or real(im, *a, **kw))
    ref = _run(j, uniform_src, str(tmp_path / "jax"))
    ours = _run(t, uniform_src, str(tmp_path / "port"))
    assert seen == [(48, 40), (48, 40)]
    assert sorted(ours) == sorted(ref)
    originals = [k for k in ours if "_mask" not in k]
    assert len(originals) >= 5
    for name in originals:
        with open(os.path.join(tmp_path, "port", name), "rb") as a, \
                open(os.path.join(tmp_path, "jax", name), "rb") as b:
            assert a.read() == b.read(), name


def test_landmark_free_packed_enhance(uniform_src, tmp_path, monkeypatch):
    """Packed sources enhanced on the device and packed there for the
    raw-data encoder (``pack_out``): ±2 against JAX, and every image
    enhanced."""
    small_enhancers(monkeypatch)
    monkeypatch.setenv("FCPT_PACK_UPLOAD", "1")
    j, t = cropper_pair(det_threshold=None, batch_size=4, enh_threshold=1.0)
    ref = _run(j, uniform_src, str(tmp_path / "jax"))
    ours = _run(t, uniform_src, str(tmp_path / "port"))
    assert tree_max_diff(ours, ref) <= 2 and len(ours) == 5
    from face_crop_plus_tpu_torch.utils.io import imread_rgb

    orig = imread_rgb(os.path.join(uniform_src, "u0.jpg"))
    assert np.abs(ours["u0.jpg"][..., ::-1].astype(np.int16) - orig).max() > 8
