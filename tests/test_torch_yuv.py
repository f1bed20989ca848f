"""Port parity: the packed 4:2:0 wire (``ops/yuv.py``, the native codecs and
host warps, packed I/O, and the packed programs of the fused pipeline).

Tolerances:

* the torch packing and reconstruction against the numpy twins, the JAX
  functions and the native reconstruction: bit-equal (each step rounds to
  float32 once in the same order);
* the native bindings against the JAX package's: bit-equal (one binary,
  one source);
* the fused pipeline on packed rows against the same pipeline on their
  reconstruction: bit-equal, and packed fetches bit-equal to the numpy
  packing of the RGB crops; against the JAX pipeline on the same rows:
  equal indices, crops within ±1 (the detector's f32 sums round
  differently, see ``test_torch_cropper.py``);
* the reconstruction against ``cv2.imread`` of the same JPEG: within 2
  levels (libjpeg's fixed-point upsampler; ~1 level typically).
"""

import os
import warnings

import numpy as np
import pytest
import torch

from face_crop_plus_tpu.ops import yuv as jy
from face_crop_plus_tpu.utils import io as jio
from face_crop_plus_tpu.utils import native_io as jn
from face_crop_plus_tpu_torch.ops import yuv as ty
from face_crop_plus_tpu_torch.utils import io as tio
from face_crop_plus_tpu_torch.utils import native_io as tn

from torch_parity import cropper_pair, smooth_image, write_oriented_jpeg

needs_native = pytest.mark.skipif(
    not tn.native_warp_available(), reason="the native host library did not build"
)
SHAPES = [(1, 2, 2), (3, 6, 10), (2, 8, 12), (2, 64, 48)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small parity runs share the machine's
    cores with the suite's other workers (see ``test_torch_enhancement.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_matches_jax_and_twin(shape):
    crops = np.random.default_rng(sum(shape)).integers(0, 256, shape + (3,), dtype=np.uint8)
    rows = ty.rgb_to_yuv420(torch.from_numpy(crops)).numpy()
    assert rows.dtype == np.uint8 and rows.shape == (shape[0], ty.packed_length(shape[2:0:-1]))
    np.testing.assert_array_equal(rows, ty.rgb_to_yuv420_np(crops))
    np.testing.assert_array_equal(rows, jy.rgb_to_yuv420_np(crops))
    np.testing.assert_array_equal(rows, np.asarray(jy.rgb_to_yuv420(crops)))


@pytest.mark.parametrize("shape", SHAPES)
def test_reconstruction_matches_jax_twin_and_native(shape):
    n, h, w = shape
    rows = np.random.default_rng(sum(shape) + 1).integers(
        0, 256, (n, ty.packed_length((w, h))), dtype=np.uint8)
    rgb = ty.yuv420_to_rgb(torch.from_numpy(rows), h, w).numpy()
    assert rgb.dtype == np.uint8 and rgb.shape == (n, h, w, 3)
    np.testing.assert_array_equal(rgb, ty.yuv420_to_rgb_np(rows, h, w))
    np.testing.assert_array_equal(rgb, jy.yuv420_to_rgb_np(rows, h, w))
    np.testing.assert_array_equal(rgb, np.asarray(jy.yuv420_to_rgb(rows, h, w)))
    np.testing.assert_array_equal(ty.yuv420_to_rgb_np(rows[0], h, w), rgb[0])
    if tn.available():
        np.testing.assert_array_equal(tn.yuv420_to_rgb_native(rows, h, w), rgb)
        np.testing.assert_array_equal(tn.yuv420_to_rgb_native(rows[0], h, w), rgb[0])


def test_odd_sizes_raise():
    """Packing needs even sides, in the port as in the JAX twin."""
    odd = np.zeros((1, 5, 4, 3), np.uint8)
    with pytest.raises(RuntimeError):
        ty.rgb_to_yuv420(torch.from_numpy(odd))
    for fn in (ty.rgb_to_yuv420_np, jy.rgb_to_yuv420_np):
        with pytest.raises(ValueError):
            fn(odd)
    assert tn.yuv420_to_rgb_native(np.zeros((1, 20), np.uint8), 5, 4) is None


def test_unpack_planes_match_jax():
    rows = np.random.default_rng(2).integers(0, 256, (2, ty.packed_length((10, 6))),
                                             dtype=np.uint8)
    planes = ty.unpack_yuv420(rows, (10, 6))
    ref = jy.unpack_yuv420(rows, (10, 6))
    assert [p.shape for p in planes] == [(2, 6, 10), (2, 3, 5), (2, 3, 5)]
    for a, b in zip(planes, ref):
        np.testing.assert_array_equal(a, b)
    crops = np.random.default_rng(3).integers(0, 256, (2, 6, 10, 3), dtype=np.uint8)
    y, cb, cr = ty.unpack_yuv420(ty.rgb_to_yuv420_np(crops), (10, 6))
    luma = (crops.astype(np.float32) @ np.float32([0.299, 0.587, 0.114])).round()
    assert np.abs(y.astype(np.int16) - luma).max() <= 1
    assert cb.dtype == cr.dtype == np.uint8


def test_packed_image_and_unpack_images():
    rows = np.random.default_rng(4).integers(0, 256, (ty.packed_length((10, 6)),),
                                             dtype=np.uint8)
    ours, ref = tio.PackedYUVImage(rows, 6, 10), jio.PackedYUVImage(rows, 6, 10)
    assert ours.shape == ref.shape == (6, 10, 3)
    assert ours.group_key == ref.group_key == ("yuv420", 6, 10)
    np.testing.assert_array_equal(ours.to_rgb(), ref.to_rgb())
    rgb = np.zeros((4, 4, 3), np.uint8)
    out = tio.unpack_images([ours, rgb])
    assert out[1] is rgb and isinstance(out[0], np.ndarray)
    np.testing.assert_array_equal(out[0], ref.to_rgb())


@needs_native
def test_imwrite_yuv420_round_trip(tmp_path):
    import cv2

    img = smooth_image(np.random.default_rng(5), 48, 64)
    row = ty.rgb_to_yuv420_np(img[None])[0]
    ours, ref = str(tmp_path / "ours.jpg"), str(tmp_path / "ref.jpg")
    assert tio.imwrite_yuv420(ours, row, (64, 48)) and jio.imwrite_yuv420(ref, row, (64, 48))
    assert open(ours, "rb").read() == open(ref, "rb").read()
    assert not any(".tmp-" in f for f in os.listdir(tmp_path))
    decoded = tn.decode_jpeg_yuv420(ours)
    ref_decoded = jn.decode_jpeg_yuv420(ours)
    assert decoded[1:] == ref_decoded[1:] == (48, 64)
    np.testing.assert_array_equal(decoded[0], ref_decoded[0])
    recon = ty.yuv420_to_rgb_np(decoded[0], 48, 64)
    read = cv2.cvtColor(cv2.imread(ours), cv2.COLOR_BGR2RGB)
    assert np.abs(recon.astype(np.int16) - read).max() <= 2
    assert not tio.imwrite_yuv420(str(tmp_path / "odd.jpg"), row, (63, 48))
    paths = [str(tmp_path / f"b{i}.jpg") for i in range(3)]
    rows = np.stack([row] * 3)
    assert tn.encode_jpeg_yuv420_batch(paths, rows, (64, 48)) == [True] * 3
    assert all(open(p, "rb").read() == open(ours, "rb").read() for p in paths)


def _packed_dir(path):
    """4:2:0 JPEGs (one at an odd size), an EXIF-rotated JPEG, a grayscale
    JPEG, a PNG and a corrupt file."""
    import cv2

    rng = np.random.default_rng(6)
    os.makedirs(path)
    for i, hw in enumerate([(40, 32), (40, 32), (41, 33), (96, 128)]):
        tio.imwrite(os.path.join(path, f"p{i}.jpg"), smooth_image(rng, *hw))
    write_oriented_jpeg(os.path.join(path, "r.jpg"), smooth_image(rng, 40, 32), 6)
    cv2.imwrite(os.path.join(path, "g.jpg"), smooth_image(rng, 40, 32)[..., 0])
    tio.imwrite(os.path.join(path, "q.png"), smooth_image(rng, 40, 32))
    with open(os.path.join(path, "z.jpg"), "wb") as f:
        f.write(b"\xff\xd8 broken")
    return sorted(os.listdir(path))


@needs_native
@pytest.mark.parametrize("target_max", [None, 40])
def test_read_images_want_packed_matches_jax(tmp_path, target_max):
    """Plain upright 4:2:0 JPEGs decode packed, the rest RGB, as in the JAX
    package, except a file that decodes at a reduced DCT scale: the native
    planar decoder's chroma is wrong there, so the port decodes it RGB."""
    src = str(tmp_path / "src")
    names = _packed_dir(src)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours, ours_names = tio.read_images(names, src, target_max, want_packed=True)
        ref, ref_names = jio.read_images(names, src, target_max, want_packed=True)
        plain, _ = tio.read_images(names, src, target_max)
    np.testing.assert_array_equal(ours_names, ref_names)
    assert "z.jpg" not in ours_names and len(ours) == len(names) - 1
    packed = set()
    for name, a, b, c in zip(ours_names, ours, ref, plain):
        if name == "p3.jpg" and target_max:
            assert isinstance(b, jio.PackedYUVImage) and b.shape == c.shape == (48, 64, 3)
            np.testing.assert_array_equal(a, c)
            # The luma plane of the reduced-scale planar decode is right.
            luma = (c.astype(np.float32) @ np.float32([0.299, 0.587, 0.114])).round()
            assert np.abs(b.packed[: 48 * 64].reshape(48, 64) - luma).max() <= 1
            continue
        assert type(a).__name__ == type(b).__name__
        if isinstance(a, tio.PackedYUVImage):
            assert (a.h, a.w) == (b.h, b.w)
            np.testing.assert_array_equal(a.packed, b.packed)
            packed.add(name)
            a = a.to_rgb()
        else:
            np.testing.assert_array_equal(a, b)
        assert a.shape == c.shape and np.abs(a.astype(np.int16) - c).max() <= 2
    assert {"p0.jpg", "p1.jpg"} <= packed and ("p3.jpg" in packed) == (target_max is None)
    assert not packed & {"p2.jpg", "r.jpg", "g.jpg", "q.png"}


@needs_native
@pytest.mark.parametrize("mode", ["constant", "replicate", "reflect", "wrap", "reflect_101"])
def test_native_warps_match_jax(mode):
    rng = np.random.default_rng(7)
    images = rng.integers(0, 256, (3, 40, 32, 3), dtype=np.uint8)
    ang = rng.uniform(-0.5, 0.5, 9)
    sc = rng.uniform(0.6, 1.6, 9)
    mats = np.zeros((9, 2, 3), np.float32)
    mats[:, 0, 0], mats[:, 0, 1] = sc * np.cos(ang), -sc * np.sin(ang)
    mats[:, 1, 0], mats[:, 1, 1] = sc * np.sin(ang), sc * np.cos(ang)
    mats[:, :, 2] = rng.uniform(-20, 20, (9, 2))
    idx = rng.integers(0, 3, 9).astype(np.int32)
    windows = np.tile(np.int32([[2, 3, 30, 24]]), (9, 1))
    for exact in (True, False):
        for win in (None, windows):
            ours = tn.warp_affine_batch_native(images, mats, idx, (24, 20), mode, win,
                                               n_threads=2, exact=exact)
            ref = jn.warp_affine_batch_native(images, mats, idx, (24, 20), mode, win,
                                              n_threads=2, exact=exact)
            assert ours.shape == (9, 20, 24, 3)
            np.testing.assert_array_equal(ours, ref)
    rows = ty.rgb_to_yuv420_np(images)
    for exact in (True, False):
        ours = tn.warp_yuv420_batch_native(rows, (40, 32), mats, idx, (24, 20), mode,
                                           n_threads=2, exact=exact)
        ref = jn.warp_yuv420_batch_native(rows, (40, 32), mats, idx, (24, 20), mode,
                                          n_threads=2, exact=exact)
        assert ours.shape == (9, ty.packed_length((24, 20)))
        np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(tn.chroma_conjugate_affine(mats),
                                  jn.chroma_conjugate_affine(mats))
    assert tn.warp_yuv420_batch_native(rows, (40, 32), mats, idx, (23, 20), mode) is None
    assert tn.warp_affine_batch_native(images, mats, idx, (24, 20), "nearest") is None
    # Indices and windows are checked before they reach the native code.
    with pytest.raises(ValueError, match="img_idx"):
        tn.warp_affine_batch_native(images, mats, idx + 3, (24, 20), mode)
    with pytest.raises(ValueError, match="img_idx"):
        tn.warp_yuv420_batch_native(rows, (40, 32), mats, idx[:5], (24, 20), mode)
    with pytest.raises(ValueError, match="windows"):
        tn.warp_affine_batch_native(images, mats, idx, (24, 20), mode, windows[:3])


@pytest.mark.parametrize("strategy", ["largest", "all"])
def test_fused_packed_matches_rgb_and_jax(monkeypatch, strategy):
    """``FusedPipeline.process(packed_hw=...)`` detects and crops on the
    device reconstruction: equal to the RGB call on the numpy twin's
    reconstruction, bit for bit; ``pack_crops`` rows equal the numpy
    packing of the RGB crops; ``detect_only`` on rows equals it on the
    reconstruction; the JAX package's packed program agrees within ±1."""
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    kw = dict(output_size=64, resize_size=64, det_threshold=-1.0, batch_size=4,
              strategy=strategy, max_faces=4, auto_grow=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j, t = cropper_pair(**kw)
        rng = np.random.default_rng(8)
        rgb = np.stack([smooth_image(rng, 72, 60) for _ in range(4)])
        rows = ty.rgb_to_yuv420_np(rgb)
        recon = ty.yuv420_to_rgb_np(rows, 72, 60)
        crops, lm, idx = t._fused.process(rows, (64, 64), packed_hw=(72, 60))
        ref_crops, ref_lm, ref_idx = t._fused.process(recon, (64, 64))
        packed, _, p_idx = t._fused.process(rows, (64, 64), pack_crops=True, packed_hw=(72, 60))
        d_lm, d_idx = t._fused.detect_only(rows, (64, 64), packed_hw=(72, 60))
        r_lm, r_idx = t._fused.detect_only(recon, (64, 64))
        j_crops, _, j_idx = j._fused.process(rows, (64, 64), packed_hw=(72, 60))
    np.testing.assert_array_equal(crops, ref_crops)
    np.testing.assert_array_equal(lm, ref_lm)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_array_equal(packed, ty.rgb_to_yuv420_np(crops))
    np.testing.assert_array_equal(p_idx, idx)
    np.testing.assert_array_equal(d_lm, r_lm)
    np.testing.assert_array_equal(d_idx, r_idx)
    assert len(idx) >= 4 and (strategy == "all") == (len(idx) > 4)
    np.testing.assert_array_equal(idx, j_idx)
    assert np.abs(crops.astype(np.int16) - j_crops).max() <= 1
