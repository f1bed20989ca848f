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


@pytest.mark.parametrize(
    "kw",
    [
        dict(landmarks="lm.txt"),
        dict(enh_threshold=0.01),
        dict(attr_groups={"g": [1]}),
        dict(det_threshold=None),
        dict(mesh=object()),
    ],
)
def test_unported_paths_raise(kw):
    with pytest.raises(NotImplementedError):
        face_crop_plus_tpu_torch.Cropper(device="cpu", **kw)


@pytest.mark.parametrize("var", ["FCPT_HOST_CROP", "FCPT_PACK_UPLOAD", "FCPT_PACK_FETCH"])
def test_unported_env_switches_raise(monkeypatch, var):
    monkeypatch.setenv(var, "1")
    with pytest.raises(NotImplementedError, match=var):
        face_crop_plus_tpu_torch.Cropper(device="cpu")


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
