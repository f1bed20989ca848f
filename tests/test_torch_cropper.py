"""Port parity: the whole slice, ``Cropper.process_images`` in detection mode.

The JAX ``Cropper`` and the port's run the same configuration on the same
uint8 batch with the same (tamed, transplanted) detector weights.  Face
indices must match exactly and uint8 crops within ±1 level: the network
outputs agree to f32 rounding (different conv summation orders), which can
move a landmark by a tiny fraction of a pixel and a rounded crop pixel by
one level.  Batches below the fused-shape budget's count and ragged
batches take the staged path (host resize, crops from the interim) in both
packages.
"""

import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

import face_crop_plus_tpu_torch

from torch_parity import cropper_pair


def _pair(monkeypatch, **kw):
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    return cropper_pair(**kw)


@pytest.mark.parametrize(
    "strategy,padding,resize,shape",
    [
        ("largest", "constant", 64, (4, 72, 60, 3)),
        ("best", "reflect_101", 64, (3, 50, 70, 3)),
        ("largest", "replicate", 128, (2, 64, 64, 3)),  # caps grow: A = 672
    ],
)
def test_process_images_matches_jax(monkeypatch, strategy, padding, resize, shape):
    j, t = _pair(
        monkeypatch, output_size=64, resize_size=resize, strategy=strategy,
        padding=padding, det_threshold=-1.0, batch_size=4,
    )
    batch = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_crops, ref_idx, ref_groups = j.process_images(batch)
        crops, idx, groups = t.process_images(batch)
    np.testing.assert_array_equal(idx, ref_idx)
    assert idx.dtype == np.int64 and len(idx) == shape[0]
    assert crops.dtype == np.uint8 and crops.shape == ref_crops.shape
    diff = np.abs(crops.astype(np.int16) - ref_crops.astype(np.int16))
    assert diff.max() <= 1
    assert groups == ref_groups == (None, None)
    assert t.det_model.pre_topk == j.det_model.pre_topk


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        face_crop_plus_tpu_torch.Cropper()


@pytest.mark.parametrize("kw", [dict(mesh=object()), dict(mesh=[torch.device("cpu")] * 2)])
def test_unported_paths_raise(kw):
    """Meshes are ported; a ``mesh`` that is not the port's ``Mesh`` (a JAX
    mesh, a bare device list) raises ``TypeError``."""
    with pytest.raises(TypeError, match="Mesh"):
        face_crop_plus_tpu_torch.Cropper(device="cpu", **kw)


def test_landmarks_argument_matches_jax(tmp_path):
    """``landmarks=``: a file is parsed at construction, the detector is
    suppressed whatever ``det_threshold`` says, and ``crop_align`` gives
    the JAX package's crops."""
    import face_crop_plus_tpu

    path = tmp_path / "lm.txt"
    path.write_text("a.jpg 20 25 40 25 30 35 22 45 38 45\nb.jpg 10 12 20 12 15 18 11 22 19 22\n")
    t = face_crop_plus_tpu_torch.Cropper(device="cpu", landmarks=str(path), output_size=32)
    j = face_crop_plus_tpu.Cropper(device="cpu", landmarks=str(path), output_size=32)
    assert t.det_model is None and t._fused is None and j.det_model is None
    np.testing.assert_array_equal(t.landmarks[0], j.landmarks[0])
    np.testing.assert_array_equal(t.landmarks[1], j.landmarks[1])
    batch = np.random.default_rng(1).integers(0, 256, (2, 60, 50, 3), dtype=np.uint8)
    crops = t.crop_align(batch, None, [0, 1], t.landmarks[0])
    np.testing.assert_array_equal(crops, j.crop_align(batch, None, [0, 1], j.landmarks[0]))
    assert crops.shape == (2, 32, 32, 3)


@pytest.mark.parametrize(
    "kw",
    [
        dict(attr_groups={"p3": [3], "no3": [-3], "p15": [15]}),
        dict(det_threshold=None),
        dict(enh_threshold=1.0),
    ],
)
def test_ported_paths_run(monkeypatch, tmp_path, kw):
    """Parsing, the landmark-free mode and enhancement, once refused, run
    as JAX's do.

    Both parsers run at a 128² inference size (the 512² parse is held in
    ``tests/test_torch_parsing.py``), both enhancers with 2 RRDBs (the
    gate's parity is held in ``tests/test_torch_enhance_path.py``)."""
    from face_crop_plus_tpu.models import parsing as jp
    from face_crop_plus_tpu_torch.models import parsing as tp
    from face_crop_plus_tpu_torch.utils.io import imwrite

    from torch_parity import read_tree, small_enhancers, smooth_image, tree_max_diff

    for module in (jp, tp):
        monkeypatch.setattr(module, "_INFER_SIZE", 128)
    small_enhancers(monkeypatch)

    j, t = _pair(monkeypatch, **{**dict(output_size=64, resize_size=64, det_threshold=-1.0,
                                        batch_size=4, output_format="png"), **kw})
    rng = np.random.default_rng(13)
    batch = np.stack([smooth_image(rng, 72, 60) for _ in range(4)])
    if t.det_model is None:
        assert t._fused is None and t.par_model is None
        for c in (j, t):
            with pytest.raises(ValueError, match="active detector"):
                c.process_images(batch)
        for i, im in enumerate(batch):
            imwrite(str(tmp_path / f"{i}.png"), im)
        trees = {}
        for name, c in (("jax", j), ("port", t)):
            c.process_dir(str(tmp_path), str(tmp_path / name), desc=None)
            trees[name] = read_tree(str(tmp_path / name))
        assert len(trees["port"]) == 4 and tree_max_diff(trees["port"], trees["jax"]) == 0
        return
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = j.process_images(batch)
        ours = t.process_images(batch)
    np.testing.assert_array_equal(ours[1], ref[1])
    diff = int(np.abs(ours[0].astype(np.int16) - ref[0].astype(np.int16)).max())
    if t.enh_model is not None:
        # Every face is gated: crops sample the enhanced interim (±2).
        assert ours[2] == ref[2] == (None, None) and diff <= 2 and len(ours[1]) == 4
        return
    assert ours[2] == ref[2] and ours[2][1] is None and ours[2][0]["p3"] == [0, 1, 2, 3]
    assert diff <= 1


@pytest.mark.parametrize("var", ["FCPT_HOST_CROP", "FCPT_PACK_UPLOAD", "FCPT_PACK_FETCH"])
def test_env_switches_match_jax(monkeypatch, var):
    """Switches once refused: each forced on gives the JAX package's gates
    and ``process_images`` within ±1 of it (the host-crop mode warps on
    the host; the packed wire is the directory pipeline's, see
    ``tests/test_torch_host_crop.py``)."""
    for other in ("FCPT_HOST_CROP", "FCPT_PACK_UPLOAD", "FCPT_PACK_FETCH"):
        monkeypatch.delenv(other, raising=False)
    monkeypatch.setenv(var, "1")
    j, t = cropper_pair(output_size=64, resize_size=64, det_threshold=-1.0, batch_size=4)
    names = ["a.jpg", "b.jpg"]
    assert t._host_crop_enabled() == j._host_crop_enabled()
    assert t._packed_upload_eligible() == j._packed_upload_eligible()
    assert t._packed_fetch_eligible(names) == j._packed_fetch_eligible(names)
    batch = np.random.default_rng(2).integers(0, 256, (4, 72, 60, 3), dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = j.process_images(batch)
        ours = t.process_images(batch)
    np.testing.assert_array_equal(ours[1], ref[1])
    assert np.abs(ours[0].astype(np.int16) - ref[0]).max() <= 1


def _images_parity(monkeypatch, images, **kw):
    j, t = _pair(monkeypatch, output_size=64, resize_size=64, det_threshold=-1.0, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref_crops, ref_idx, _ = j.process_images(images)
        crops, idx, groups = t.process_images(images)
    np.testing.assert_array_equal(idx, ref_idx)
    assert crops.dtype == np.uint8 and crops.shape == ref_crops.shape
    assert int(np.abs(crops.astype(np.int16) - ref_crops.astype(np.int16)).max()) <= 1
    assert groups == (None, None)
    return j, t, crops, idx


def test_ragged_batch_raises(monkeypatch):
    """Ragged batches, once refused, take the staged path and match JAX."""
    rng = np.random.default_rng(11)
    imgs = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in [(40, 30), (30, 40), (72, 60), (150, 200), (72, 60)]]
    for strategy in ("largest", "all"):
        j, t, crops, idx = _images_parity(monkeypatch, imgs, strategy=strategy, batch_size=4)
        assert t._fused_shapes == j._fused_shapes == set()
        assert len(set(idx.tolist())) == len(imgs)
    crops, idx, _ = t.process_images([])
    assert crops.shape == (0, 64, 64, 3) and idx.shape == (0,)


@pytest.mark.parametrize("strategy", ["largest", "all"])
def test_small_uniform_batch_takes_staged_path(monkeypatch, strategy):
    """One 72×60 image with batch_size 8: below max(2, 8 // 2), so both
    packages crop from the host-resized interim (the fused path's crops
    from the original pixels differed from JAX's by up to 147 levels)."""
    img = np.random.default_rng(0).integers(0, 256, (1, 72, 60, 3), dtype=np.uint8)
    j, t, crops, idx = _images_parity(monkeypatch, img, strategy=strategy, batch_size=8)
    assert t._fused_shapes == set() and len(idx) >= 1
    # Four images reach the count: the shape is granted, and stays granted.
    batch = np.repeat(img, 4, axis=0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = j.process_images(batch)
        ours = t.process_images(batch)
        np.testing.assert_array_equal(ours[1], ref[1])
        assert t._fused_shapes == j._fused_shapes == {(72, 60, 3)}
        ref1, ours1 = j.process_images(img), t.process_images(img)
    np.testing.assert_array_equal(ours1[1], ref1[1])
    assert int(np.abs(ours1[0].astype(np.int16) - ref1[0].astype(np.int16)).max()) <= 1


def test_f32_precision_pins_and_restores():
    import torch

    from face_crop_plus_tpu_torch.utils import device

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        for flags in [(True, True), (True, False), (False, True)]:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
            assert device.compute_precision() == {
                "dtype": "float32", "cudnn_allow_tf32": False, "matmul_allow_tf32": False}
            with device.f32_precision():
                with device.f32_precision():
                    pass
                assert not torch.backends.cudnn.allow_tf32
            assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == flags
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_f32_precision_threads():
    """Overlapping holders in many threads: TF32 stays off while any holds
    it, and the caller's setting comes back when the last one leaves."""
    import torch

    from face_crop_plus_tpu_torch.utils import device

    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    switch = sys.getswitchinterval()
    seen_on = []
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True

    def work():
        for _ in range(300):
            with device.f32_precision():
                if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
                    seen_on.append(1)

    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work) for _ in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert not seen_on
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        sys.setswitchinterval(switch)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_detector_forward_runs_in_f32(monkeypatch):
    """The network runs with TF32 off; the caller's flags are left alone."""
    import torch

    import face_crop_plus_tpu_torch.models.detection as det

    seen = []
    real = det.retinaface_forward

    def spy(net, x):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return real(net, x)

    monkeypatch.setattr(det, "retinaface_forward", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with pytest.warns(UserWarning):
        c = face_crop_plus_tpu_torch.Cropper(device="cpu", resize_size=64, output_size=32,
                                             det_threshold=-1.0, batch_size=2)
    img = np.zeros((1, 40, 30, 3), np.uint8)
    c.process_images(img)  # staged
    c.process_images(np.repeat(img, 2, axis=0))  # fused
    assert seen == [(False, False)] * 2 and torch.backends.cudnn.allow_tf32


def test_import_pulls_in_no_jax():
    code = (
        "import sys, face_crop_plus_tpu_torch, face_crop_plus_tpu_torch.pipeline\n"
        "import face_crop_plus_tpu_torch.ops.cuda.nms, face_crop_plus_tpu_torch.ops.cuda.warp\n"
        "import face_crop_plus_tpu_torch.cropper, face_crop_plus_tpu_torch.__main__\n"
        "import face_crop_plus_tpu_torch.models.parsing\n"
        "import face_crop_plus_tpu_torch.utils.io, face_crop_plus_tpu_torch.utils.native_io\n"
        "import face_crop_plus_tpu_torch.utils.names, face_crop_plus_tpu_torch.utils.profiling\n"
        "from face_crop_plus_tpu_torch.utils import native_io\n"
        "assert native_io.available() and '/_build/' in native_io._so_path()\n"
        "libs = [l for l in open('/proc/self/maps').read().split() if 'libfcpt_io' in l]\n"
        "assert libs and not any(l.endswith('native/libfcpt_io.so') for l in libs), libs\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('jaxlib') or m.startswith('face_crop_plus_tpu.')"
        " or m == 'face_crop_plus_tpu']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
