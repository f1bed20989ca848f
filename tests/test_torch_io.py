"""Port parity: host I/O — decode, encode, host batching, names, stats.

The port's ``utils`` copies are held against the JAX package's modules on
the same files.  Decoding is bitwise: both sides decode JPEGs with a build
of the same ``native/fcpt_io.cpp`` (the port's own, under ``_build/``) and
everything else with the same cv2, so pixels must be identical, DCT-scaled
decodes and EXIF transposes included.  ``as_batch`` is bitwise too.
"""

import os
import shutil
import threading
import warnings

import numpy as np
import pytest

from face_crop_plus_tpu.utils import batching as jax_batching
from face_crop_plus_tpu.utils import io as jax_io
from face_crop_plus_tpu.utils import names as jax_names
from face_crop_plus_tpu.utils import native_io as jax_native
from face_crop_plus_tpu.utils.profiling import PipelineStats as JaxStats
from face_crop_plus_tpu_torch.utils import batching, io, names, native_io
from face_crop_plus_tpu_torch.utils.profiling import PipelineStats

from torch_parity import nfkd_ascii, smooth_image, write_mixed_dir, write_oriented_jpeg


def _assert_same_read(a, b):
    (imgs_a, names_a), (imgs_b, names_b) = a, b
    assert list(names_a) == list(names_b)
    assert len(imgs_a) == len(imgs_b) == len(names_a)
    for x, y in zip(imgs_a, imgs_b):
        assert x.dtype == y.dtype == np.uint8 and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("mixed"))
    return path, write_mixed_dir(path)


@pytest.mark.parametrize("target_max", [None, 64, 40])
@pytest.mark.parametrize("native", [True, False])
def test_read_images_matches_jax(mixed, monkeypatch, target_max, native):
    """JPEG (DCT-scaled under ``target_max``), PNG, EXIF and corrupt files,
    through the native decoder or with it switched off on both sides."""
    path, files = mixed
    if not native:
        monkeypatch.setattr(native_io, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    elif not native_io.available():
        pytest.fail(f"the port's native decoder did not build: {native_io.build_status()}")
    with pytest.warns(UserWarning, match="z_bad.jpg"):
        ours = io.read_images(files, path, target_max)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = jax_io.read_images(files, path, target_max)
    _assert_same_read(ours, ref)
    assert "z_bad.jpg" not in list(ours[1]) and len(ours[0]) == len(files) - 1
    shapes = dict(zip(ours[1], (im.shape for im in ours[0])))
    assert shapes["b3.jpg"] == (56, 44, 3)  # EXIF 6: transposed upright
    denom = {None: 1, 64: 2, 40: 4}[target_max] if native else 1
    assert shapes["b1.jpg"] == (-(-150 // denom), -(-200 // denom), 3)  # DCT-scaled


@pytest.mark.parametrize("orientation", [1, 2, 3, 4, 5, 6, 7, 8])
def test_exif_orientations_match_jax(tmp_path, orientation):
    img = smooth_image(np.random.default_rng(orientation), 24, 40)
    p = str(tmp_path / "x.jpg")
    write_oriented_jpeg(p, img, orientation)
    assert io.jpeg_exif_orientation(p) == jax_io.jpeg_exif_orientation(p) == orientation
    np.testing.assert_array_equal(
        io.apply_exif_orientation(img, orientation),
        jax_io.apply_exif_orientation(img, orientation),
    )
    _assert_same_read(io.read_images(["x.jpg"], str(tmp_path)),
                      jax_io.read_images(["x.jpg"], str(tmp_path)))


def test_exif_parse_failures_are_orientation_1(tmp_path):
    p = tmp_path / "x.jpg"
    p.write_bytes(b"\xff\xd8\xff\xe1\x00\x10Exif\x00\x00XX\x00\x00")
    assert io.jpeg_exif_orientation(str(p)) == jax_io.jpeg_exif_orientation(str(p)) == 1
    assert io.jpeg_exif_orientation(str(tmp_path / "missing.jpg")) == 1


@pytest.mark.parametrize(
    "shapes,size,mode",
    [
        ([(72, 60), (50, 90), (64, 64)], (64, 64), "constant"),
        ([(150, 200), (40, 40), (3, 400)], (64, 48), "constant"),  # 1-px clamp
        ([(61, 47), (47, 61)], (96, 128), "reflect_101"),
        ([(20, 30)], (32, 32), "replicate"),
    ],
)
def test_as_batch_matches_jax(shapes, size, mode):
    rng = np.random.default_rng(len(shapes))
    imgs = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in shapes]
    ours = batching.as_batch(imgs, size, mode)
    ref = jax_batching.as_batch(imgs, size, mode)
    for x, y in zip(ours, ref):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert batching.PADDING_MODES == jax_batching.PADDING_MODES


def test_native_decoder_builds_into_build_dir(tmp_path, monkeypatch):
    """Built from ``native/fcpt_io.cpp`` into ``_build/`` (here a temp dir);
    ``native/`` untouched; a binary tagged for another host is rebuilt."""
    native_dir = os.path.dirname(native_io._SOURCE)
    before = {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns for f in os.listdir(native_dir)}
    monkeypatch.setattr(native_io, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_build_attempted", False)
    monkeypatch.setattr(native_io, "_status", native_io._status)
    so = native_io._so_path()
    assert os.path.dirname(so) == str(tmp_path)
    with open(so, "wb") as f:
        f.write(b"not a library")
    with open(so + ".hosttag", "w") as f:
        f.write("other-host:0")
    assert native_io.available()
    assert native_io.build_status() == "built"
    assert native_io._read_tag(so) == native_io._host_tag()
    after = {f: os.stat(os.path.join(native_dir, f)).st_mtime_ns for f in os.listdir(native_dir)}
    assert after == before
    # The next process finds its host's tag and reuses the binary.
    monkeypatch.setattr(native_io, "_lib", None)
    assert native_io.available() and native_io.build_status() == "reused"


def test_decode_helpers_match_jax(mixed):
    path, _ = mixed
    p = os.path.join(path, "b1.jpg")
    assert native_io.jpeg_dims(p) == jax_native.jpeg_dims(p) == (150, 200)
    for denom in (1, 2, 4):
        np.testing.assert_array_equal(native_io.decode_jpeg(p, denom), jax_native.decode_jpeg(p, denom))
    assert native_io.decode_jpeg(os.path.join(path, "z_bad.jpg")) is None
    for hw, t in [((150, 200), 64), ((150, 200), 24), ((4000, 3000), 1024), ((10, 10), 64)]:
        assert native_io.pick_scale_denom(hw, t) == jax_native.pick_scale_denom(hw, t)


def test_codecs_report():
    got = io.codecs()
    assert got["native_jpeg_decoder"] in ("built", "reused")
    assert got["cv2"] is not None and got["PIL"] is not None
    assert io.encoder_available()


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_imwrite_matches_jax_and_leaves_no_temp(tmp_path, ext):
    img = smooth_image(np.random.default_rng(5), 33, 47)
    assert io.imwrite(str(tmp_path / f"ours.{ext}"), img)
    assert jax_io.imwrite(str(tmp_path / f"ref.{ext}"), img)
    assert (tmp_path / f"ours.{ext}").read_bytes() == (tmp_path / f"ref.{ext}").read_bytes()
    gray = img[..., 0]
    assert io.imwrite(str(tmp_path / f"gray.{ext}"), gray)
    assert sorted(os.listdir(tmp_path)) == sorted(f"{s}.{ext}" for s in ("gray", "ours", "ref"))
    if ext == "png":
        np.testing.assert_array_equal(io.imread_rgb(str(tmp_path / "ours.png")), img)
    assert not any(".tmp-" in f for f in os.listdir(tmp_path))


def test_clean_names_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(names, "_to_ascii", nfkd_ascii)
    monkeypatch.setattr(jax_names, "_to_ascii", nfkd_ascii)
    src = tmp_path / "src"
    src.mkdir()
    for n in ["ä.jpg", "a.jpg", "A?b.png", "x:y.jpg", "x;y.jpg", "ok.png"]:
        (src / n).write_bytes(n.encode())
    for mode in ("copy", "inplace"):
        ours, ref = tmp_path / f"ours_{mode}", tmp_path / f"ref_{mode}"
        shutil.copytree(src, ours)
        shutil.copytree(src, ref)
        if mode == "copy":
            names.clean_names(str(ours), str(ours) + "_out", desc=None)
            jax_names.clean_names(str(ref), str(ref) + "_out", desc=None)
            ours, ref = tmp_path / f"ours_{mode}_out", tmp_path / f"ref_{mode}_out"
        else:
            names.clean_names(str(ours), desc=None)
            jax_names.clean_names(str(ref), desc=None)
        got = {f: (ours / f).read_bytes() for f in os.listdir(ours)}
        want = {f: (ref / f).read_bytes() for f in os.listdir(ref)}
        assert got == want


def test_pipeline_stats_matches_jax():
    ours, ref = PipelineStats(), JaxStats()
    for stats in (ours, ref):
        with stats.stage("read", 3):
            pass
        with stats.stage("read", 2):
            pass
        with stats.stage("save"):
            pass
    assert {k: (v["calls"], v["items"]) for k, v in ours.as_dict().items()} == {
        k: (v["calls"], v["items"]) for k, v in ref.as_dict().items()
    }
    assert ours.report().splitlines()[0] == ref.report().splitlines()[0]


def test_pipeline_stats_threads():
    stats = PipelineStats()

    def work():
        for _ in range(200):
            with stats.stage("x", 1):
                pass

    threads = [threading.Thread(target=work) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert stats.calls["x"] == stats.items["x"] == 3200


@pytest.mark.parametrize("valid,n", [(3, 8), (8, 8), (0, 4), (1, 16)])
def test_pad_batch_to_matches_jax(valid, n):
    batch = np.random.default_rng(valid).integers(0, 256, (valid, 5, 4, 3), dtype=np.uint8)
    ours, ref = batching.pad_batch_to(batch, n), jax_batching.pad_batch_to(batch, n)
    assert ours[1] == ref[1] == valid
    np.testing.assert_array_equal(ours[0], ref[0])
    with pytest.raises(ValueError):
        batching.pad_batch_to(batch, valid - 1)
