"""Port parity: strategy "all", ``crop_source="interim"`` and the warp kernel.

The JAX package and the port run the same configuration on the same
numpy-seeded uint8 batch with the same (tamed, transplanted) detector
weights; the JAX Cropper warps on the device (``FCPT_HOST_CROP=0``).
Tolerances: face indices exact and uint8 crops within ±1 level — the
network outputs agree to f32 rounding (other conv summation orders), which
can move a landmark by a tiny fraction of a pixel and a rounded crop pixel
by one level; detect-only landmarks within 1e-4 px for the same reason.

Two choices keep that bound meaningful for strategy "all", which crops
every one of the random detector's hundreds of candidates:

* The JAX side runs op by op (``jax.disable_jit()``), as
  ``test_torch_geometry`` does: under jit XLA:CPU fuses the fit and the
  warp and rounds a sample coordinate differently in two of its uses, which
  moves a rare pixel by up to ~20 levels against the JAX package's own
  unfused warp.
* Sources are smooth, photo-like images (bilinear upsampling of an 8×
  coarser random grid, gradients up to ~32 levels/px).  Some random
  candidates' fits minify 20-50×, so their crops sample hundreds of pixels
  outside the image, where a 1e-5 relative landmark difference moves a
  sample by ~1e-2 px: on per-pixel noise (255 levels/px) that alone is
  2 levels.

The warp kernel's wrapper (``ops/cuda/warp.py``) runs its plain version on
CPU tensors, which must equal ``to_uint8(warp_affine_batch(...))`` exactly;
``gather2d`` must equal the TPU probe's Pallas kernel in interpret mode.
The ``gpu``-marked tests hold the kernels against their plain versions on a
card, bitwise, and skip here.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import face_crop_plus_tpu_torch
from face_crop_plus_tpu.ops import warp as jwarp
from face_crop_plus_tpu_torch.ops import warp as twarp
from face_crop_plus_tpu_torch.ops.cuda import warp as cuda_warp
from face_crop_plus_tpu_torch.ops.transform import invert_affine
from face_crop_plus_tpu_torch.pipeline import device_resize_pad

from torch_parity import cropper_pair


def _pair(monkeypatch, **kw):
    monkeypatch.setenv("FCPT_HOST_CROP", "0")
    return cropper_pair(**kw)


def _batch(shape, seed=None, cell=8):
    """Smooth uint8 (N, H, W, 3) images: a coarse random grid, upsampled."""
    rng = np.random.default_rng(sum(shape) if seed is None else seed)
    n, h, w, c = shape
    coarse = rng.uniform(0, 255, (n, c, h // cell + 2, w // cell + 2)).astype(np.float32)
    up = torch.nn.functional.interpolate(
        torch.from_numpy(coarse), size=(h, w), mode="bilinear", align_corners=False
    )
    return np.clip(np.rint(up.permute(0, 2, 3, 1).numpy()), 0, 255).astype(np.uint8)


def _run_both(j, t, batch):
    with warnings.catch_warnings(), jax.disable_jit():
        warnings.simplefilter("ignore")
        ref = j.process_images(batch)
    return ref, t.process_images(batch)


def _assert_same(ref, ours):
    ref_crops, ref_idx, ref_groups = ref
    crops, idx, groups = ours
    np.testing.assert_array_equal(idx, ref_idx)
    assert idx.dtype == np.int64
    assert crops.dtype == np.uint8 and crops.shape == ref_crops.shape
    if len(crops):
        diff = np.abs(crops.astype(np.int16) - ref_crops.astype(np.int16))
        assert diff.max() <= 1
    assert groups == ref_groups == (None, None)


def _same_caps(j, t):
    assert t.det_model.pre_topk == j.det_model.pre_topk
    assert t.det_model.max_faces == j.det_model.max_faces


# ---------------------------------------------------------------------------
# The slice through Cropper.process_images
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padding", twarp.BORDER_MODES)
@pytest.mark.parametrize("crop_source", ["original", "interim"])
def test_all_matches_jax(monkeypatch, crop_source, padding):
    shape = (4, 72, 60, 3) if crop_source == "original" else (3, 50, 70, 3)
    j, t = _pair(
        monkeypatch, output_size=48, resize_size=64, strategy="all",
        padding=padding, det_threshold=-1.0, batch_size=4, crop_source=crop_source,
    )
    ref, ours = _run_both(j, t, _batch(shape))
    assert len(ours[1]) > shape[0]  # several faces per image
    _assert_same(ref, ours)
    _same_caps(j, t)


def test_all_chunked_warps_match_jax(monkeypatch):
    # Chunks of 48 faces: several chunks, each padded to a bucket of 64 by
    # repeating its last kept slot.
    j, t = _pair(
        monkeypatch, output_size=32, resize_size=64, strategy="all",
        padding="reflect", det_threshold=-1.0, batch_size=4, crop_source="interim",
    )
    j._fused.max_warp_chunk = 48
    t._fused.max_warp_chunk = 48
    ref, ours = _run_both(j, t, _batch((3, 72, 60, 3), seed=5))
    assert len(ours[1]) > 2 * 48
    _assert_same(ref, ours)


def test_all_max_faces_grows_like_jax(monkeypatch):
    j, t = _pair(
        monkeypatch, output_size=32, resize_size=64, strategy="all",
        det_threshold=-1.0, batch_size=4, max_faces=2,
    )
    ref, ours = _run_both(j, t, _batch((4, 64, 64, 3), seed=6))
    _assert_same(ref, ours)
    _same_caps(j, t)
    assert t.det_model.max_faces > 2
    assert np.bincount(ours[1]).max() > 2


@pytest.mark.parametrize("padding", ["constant", "reflect_101"])
def test_largest_interim_matches_jax(monkeypatch, padding):
    j, t = _pair(
        monkeypatch, output_size=64, resize_size=64, strategy="largest",
        padding=padding, det_threshold=-1.0, batch_size=4, crop_source="interim",
    )
    ref, ours = _run_both(j, t, _batch((4, 72, 60, 3)))
    assert len(ours[1]) == 4
    _assert_same(ref, ours)


def test_detect_only_matches_jax(monkeypatch):
    j, t = _pair(
        monkeypatch, output_size=32, resize_size=64, strategy="all",
        det_threshold=-1.0, batch_size=4,
    )
    batch = _batch((4, 60, 72, 3))
    with warnings.catch_warnings(), jax.disable_jit():
        warnings.simplefilter("ignore")
        ref_lm, ref_idx = j._fused.detect_only(batch, (64, 64), valid_n=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lm, idx = t._fused.detect_only(batch, (64, 64), valid_n=3)
        lm2, idx2 = t._fused.detect_only_finish(
            t._fused.detect_only_async(batch, (64, 64), valid_n=3)
        )
    np.testing.assert_array_equal(idx, ref_idx)
    assert idx.max() == 2 and lm.dtype == np.float32 and lm.shape == (len(idx), 5, 2)
    np.testing.assert_allclose(lm, ref_lm, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(idx2, idx)
    np.testing.assert_array_equal(lm2, lm)


@pytest.mark.parametrize("strategy", ["all", "largest"])
def test_device_crops_handle_matches_host_crops(monkeypatch, strategy):
    j, t = _pair(
        monkeypatch, output_size=32, resize_size=64, strategy=strategy,
        det_threshold=-1.0, batch_size=4,
    )
    batch = _batch((3, 72, 60, 3), seed=8)
    with warnings.catch_warnings(), jax.disable_jit():
        warnings.simplefilter("ignore")
        rc, _rlm, ridx, rhandle = j._fused.process(batch, (64, 64), return_device_crops=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        crops, lm, idx, handle = t._fused.process(batch, (64, 64), return_device_crops=True)
    np.testing.assert_array_equal(idx, ridx)
    assert lm.shape == (len(idx), 5, 2)
    assert handle is not None and rhandle is not None
    assert tuple(handle.shape) == tuple(rhandle.shape)
    handle = handle.numpy()
    np.testing.assert_array_equal(handle[: len(crops)], crops)
    np.testing.assert_array_equal(handle[len(crops) :], np.broadcast_to(
        crops[-1], (len(handle) - len(crops),) + crops.shape[1:]
    ))
    assert np.abs(crops.astype(np.int16) - rc.astype(np.int16)).max() <= 1


def test_all_without_faces_returns_empty(monkeypatch):
    j, t = _pair(
        monkeypatch, output_size=32, resize_size=64, strategy="all",
        det_threshold=0.999999, batch_size=4,
    )
    ref, ours = _run_both(j, t, _batch((2, 64, 64, 3)))
    assert ours[0].shape == (0, 32, 32, 3) and ours[1].shape == (0,)
    _assert_same(ref, ours)


def test_unknown_crop_source_raises():
    with pytest.raises(ValueError, match="crop_source"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            face_crop_plus_tpu_torch.Cropper(
                device="cpu", output_size=32, resize_size=64, crop_source="enhanced"
            )


# ---------------------------------------------------------------------------
# The warp kernel's wrapper and its plain version
# ---------------------------------------------------------------------------


def _warp_inputs(rng, windows: bool, n=3, h=40, w=36, f=9):
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    img_idx = rng.integers(0, n, f).astype(np.int32)
    ang = rng.uniform(-0.8, 0.8, f)
    sc = rng.uniform(0.4, 2.5, f)
    tx = rng.uniform(-40, 40, f)  # some faces sample well outside
    ty = rng.uniform(-40, 40, f)
    m = np.stack(
        [np.stack([sc * np.cos(ang), -sc * np.sin(ang), tx], -1),
         np.stack([sc * np.sin(ang), sc * np.cos(ang), ty], -1)], 1
    ).astype(np.float32)
    win = None
    if windows:
        top = rng.integers(0, 8, f)
        left = rng.integers(0, 8, f)
        win = np.stack(
            [top, left, rng.integers(1, h - 8, f), rng.integers(1, w - 8, f)], -1
        ).astype(np.int32)
        win[0, 2:] = (1, 1)  # 1-pixel window
        win[1] = (h - 1, w - 1, 1, 1)  # 1-pixel window flush with the far edge
    return images, m, img_idx, win


def _torch_args(images, m, img_idx, win):
    return (
        torch.from_numpy(images), torch.from_numpy(m), torch.from_numpy(img_idx),
        None if win is None else torch.from_numpy(win),
    )


@pytest.mark.parametrize("windows", [False, True])
@pytest.mark.parametrize("mode", twarp.BORDER_MODES)
def test_warp_wrapper_on_cpu_is_plain_version(mode, windows):
    rng = np.random.default_rng(10 + 2 * twarp.BORDER_MODES.index(mode) + windows)
    images, m, idx, win = _torch_args(*_warp_inputs(rng, windows))
    before = cuda_warp.launches
    ours = cuda_warp.warp_affine_u8(images, m, idx, (24, 20), mode, win)
    plain = twarp.to_uint8(twarp.warp_affine_batch(images, m, idx, (24, 20), mode, win))
    assert cuda_warp.launches == before  # the kernel did not launch
    assert ours.dtype == torch.uint8 and ours.shape == (9, 20, 24, 3)
    assert torch.equal(ours, plain)


@pytest.mark.parametrize("windows", [False, True])
@pytest.mark.parametrize("mode", twarp.BORDER_MODES)
def test_warp_u8_matches_jax(mode, windows):
    rng = np.random.default_rng(30 + 2 * twarp.BORDER_MODES.index(mode) + windows)
    images, m, idx, win = _warp_inputs(rng, windows)
    # Op by op, as in test_torch_geometry: under jit XLA:CPU contracts the
    # inverse's a*d - b*c into an FMA.
    with jax.disable_jit():
        ref = np.asarray(jwarp.to_uint8(jwarp.warp_affine_batch(
            jnp.asarray(images), jnp.asarray(m), jnp.asarray(idx), (24, 20), mode,
            None if win is None else jnp.asarray(win),
        )))
    t_images, t_m, t_idx, t_win = _torch_args(images, m, idx, win)
    ours = cuda_warp.warp_affine_u8(t_images, t_m, t_idx, (24, 20), mode, t_win).numpy()
    # Float remainders may round by an ulp, which can move a rounded level.
    assert np.abs(ours.astype(np.int16) - ref.astype(np.int16)).max() <= 1


def test_interim_uint8_source_is_lossless():
    # crop_source="interim" hands the kernel the rounded interim as uint8:
    # clip(rint(interim)) holds exact integers, so the warp of the uint8
    # copy equals the warp of the float source the JAX package uses.
    images = torch.from_numpy(_batch((2, 50, 70, 3), seed=11))
    interim, _, _ = device_resize_pad(images, (64, 64))
    rounded = torch.clamp(torch.round(interim), 0, 255)
    as_u8 = twarp.to_uint8(interim)
    assert torch.equal(as_u8.to(torch.float32), rounded)
    images_f, m, idx, win = _torch_args(*_warp_inputs(np.random.default_rng(12), True, 2, 64, 64))
    for mode in twarp.BORDER_MODES:
        a = twarp.warp_affine_batch(rounded, m, idx, (24, 20), mode, win)
        b = twarp.warp_affine_batch(as_u8, m, idx, (24, 20), mode, win)
        assert torch.equal(a, b)


def test_kernel_inverse_model_matches_invert_affine():
    # The warp kernel inverts each face's matrix itself (csrc/warp.cu:
    # load_face): every operation in f32 and rounded on its own, the
    # |det| < 1e-12 test in f32 and the sign-preserving epsilon.  A numpy
    # model of those steps must equal the plain invert_affine bit for bit.
    rng = np.random.default_rng(15)
    m = rng.normal(size=(64, 2, 3)).astype(np.float32)
    m = _edge_matrices(m)
    m[10, :, :2] = [[1e-12, 0.0], [0.0, 1.0]]  # det exactly f32(1e-12)
    m[11, :, :2] = [[-1e-12, 0.0], [0.0, 1.0]]
    m[12, :, :2] = 0.0
    m[13, :, :2] = -0.0
    m[14] = np.nan
    m[15, 0, 2] = np.inf
    m[16, 1, 1] = np.inf
    with np.errstate(all="ignore"):
        a, b, tx = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
        c, d, ty = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
        det = a * d - b * c
        eps = np.where(det < 0, np.float32(-1e-12), np.float32(1e-12))
        det = np.where(np.abs(det) < np.float32(1e-12), eps, det)
        ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
        model = np.stack([np.stack([ia, ib, -(ia * tx + ib * ty)], -1),
                          np.stack([ic, id_, -(ic * tx + id_ * ty)], -1)], 1)
    ref = invert_affine(torch.from_numpy(m)).numpy()
    assert model.dtype == ref.dtype == np.float32
    nan = np.isnan(ref)  # a NaN's sign bit depends on the operation that made it
    np.testing.assert_array_equal(np.isnan(model), nan)
    np.testing.assert_array_equal(model.view(np.int32)[~nan], ref.view(np.int32)[~nan])


def test_warp_wrapper_rejects_float_source():
    images, m, idx, _ = _torch_args(*_warp_inputs(np.random.default_rng(13), False))
    with pytest.raises(TypeError):
        cuda_warp.warp_affine_u8(images.float(), m, idx, (24, 20))
    # What the kernel does not take raises on the CPU too.
    with pytest.raises(ValueError, match="contiguous"):
        cuda_warp.warp_affine_u8(images[:, :, ::2], m, idx, (24, 20))
    with pytest.raises(TypeError):
        cuda_warp.warp_affine_u8(images, m, idx.long(), (24, 20))
    with pytest.raises(ValueError):
        cuda_warp.warp_affine_u8(images, m[:3], idx, (24, 20))
    with pytest.raises(ValueError):
        cuda_warp.warp_affine_u8(images, m, idx, (24, 20), "mirror")


#: The TPU probe's cases (tools/mosaic_gather_probe.py:58-64): (h, w, axis).
PROBE_CASES = [
    (8, 128, 0), (8, 256, 0), (8, 512, 0), (16, 128, 0), (64, 128, 0), (256, 256, 0),
    (8, 128, 1), (8, 256, 1), (16, 256, 1), (256, 256, 1),
]


def _probe_inputs(h, w, axis, seed=0):
    # As the probe draws them: indices uniform over the gathered axis.
    rng = np.random.default_rng(seed + h + w + axis)
    hi = h if axis == 0 else w
    return (rng.random((h, w)).astype(np.float32),
            rng.integers(0, hi, (h, w)).astype(np.int32))


@pytest.mark.parametrize("h,w,axis", PROBE_CASES)
def test_gather2d_matches_pallas_probe_interpret(h, w, axis):
    src, idx = _probe_inputs(h, w, axis)

    def kern(idx_ref, src_ref, out_ref):  # the probe's kernel body
        out_ref[...] = jnp.take_along_axis(src_ref[...], idx_ref[...], axis=axis)

    ref = np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((h, w), jnp.float32), interpret=True
    )(jnp.asarray(idx), jnp.asarray(src)))
    before = cuda_warp.gather2d_launches
    ours = cuda_warp.gather2d(torch.from_numpy(src), torch.from_numpy(idx), axis).numpy()
    assert cuda_warp.gather2d_launches == before
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _finite_rows(m: np.ndarray) -> np.ndarray:
    return np.isfinite(m.reshape(len(m), -1)).all(axis=1)


@pytest.mark.gpu
@pytest.mark.parametrize("windows", [False, True])
@pytest.mark.parametrize("mode", twarp.BORDER_MODES)
def test_warp_kernel_matches_plain_on_gpu(mode, windows):
    dev = _cuda()
    rng = np.random.default_rng(50 + 2 * twarp.BORDER_MODES.index(mode) + windows)
    images, m, idx, win = _warp_inputs(rng, windows, n=4, h=218, w=178, f=64)
    m[3] = np.nan  # degenerate rows must not fault; they are not compared
    m[5, 0, 2] = np.inf
    args = [torch.from_numpy(a).to(dev) for a in (images, m, idx)]
    w_t = None if win is None else torch.from_numpy(win).to(dev)
    before = cuda_warp.launches
    ours = cuda_warp.warp_affine_u8(*args, (96, 112), mode, w_t)
    torch.cuda.synchronize()
    assert cuda_warp.launches == before + 1
    plain = twarp.to_uint8(twarp.warp_affine_batch(*args, (96, 112), mode, w_t))
    rows = torch.from_numpy(_finite_rows(m)).to(dev)
    assert torch.equal(ours[rows], plain[rows])


def _edge_matrices(m):
    """Near-singular (|det| below, at and above 1e-12) and mirrored fits."""
    m[1, :, :2] = [[1e-6, 0.0], [0.0, 1e-6]]
    m[2, :, :2] = [[1e-6, 0.0], [0.0, -1e-6]]
    m[3, :, :2] = [[2e-6, 1e-6], [4e-6, 2.0000002e-6]]
    m[4, :, :2] = [[3e-7, 0.0], [0.0, 3e-7]]
    m[6::3, 0, :2] *= -1.0
    return m


@pytest.mark.gpu
@pytest.mark.parametrize("windows", [False, True])
@pytest.mark.parametrize("mode", twarp.BORDER_MODES)
def test_warp_kernel_odd_size_singular_mirrored_on_gpu(mode, windows):
    # 61x97 crops: tiles whose bytes start off a 16-byte boundary.
    dev = _cuda()
    rng = np.random.default_rng(70 + 2 * twarp.BORDER_MODES.index(mode) + windows)
    images, m, idx, win = _warp_inputs(rng, windows, n=4, h=218, w=178, f=64)
    m = _edge_matrices(m)
    args = [torch.from_numpy(a).to(dev) for a in (images, m, idx)]
    w_t = None if win is None else torch.from_numpy(win).to(dev)
    ours = cuda_warp.warp_affine_u8(*args, (61, 97), mode, w_t)
    plain = twarp.to_uint8(twarp.warp_affine_batch(*args, (61, 97), mode, w_t))
    rows = torch.from_numpy(_finite_rows(m)).to(dev)
    assert rows.all() and torch.equal(ours[rows], plain[rows])


@pytest.mark.gpu
@pytest.mark.parametrize("windows", [False, True])
def test_warp_kernel_faces_past_grid_rows_on_gpu(windows):
    # 70,000 faces: more than the grid's 65,535 rows, so blocks loop.
    dev = _cuda()
    images, m, idx, win = _warp_inputs(np.random.default_rng(90 + windows), windows,
                                       n=4, h=64, w=64, f=70000)
    args = [torch.from_numpy(a).to(dev) for a in (images, m, idx)]
    w_t = None if win is None else torch.from_numpy(win).to(dev)
    mode = "reflect" if windows else "constant"
    ours = cuda_warp.warp_affine_u8(*args, (8, 8), mode, w_t)
    assert torch.equal(ours, twarp.to_uint8(twarp.warp_affine_batch(*args, (8, 8), mode, w_t)))


@pytest.mark.gpu
@pytest.mark.parametrize("h,w,axis", PROBE_CASES)
def test_gather2d_kernel_bitwise_on_gpu(h, w, axis):
    dev = _cuda()
    src, idx = _probe_inputs(h, w, axis, seed=1)
    s, i = torch.from_numpy(src).to(dev), torch.from_numpy(idx).to(dev)
    before = cuda_warp.gather2d_launches
    ours = cuda_warp.gather2d(s, i, axis)
    torch.cuda.synchronize()
    assert cuda_warp.gather2d_launches == before + 1
    assert torch.equal(ours, torch.gather(s, axis, i.long()))


@pytest.mark.gpu
def test_warp_wrapper_rejects_device_mix_on_gpu():
    dev = _cuda()
    images, m, idx, _ = _torch_args(*_warp_inputs(np.random.default_rng(14), False))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_warp.warp_affine_u8(images.to(dev), m, idx, (24, 20))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_warp.gather2d(torch.zeros(8, 8, device=dev), torch.zeros(8, 8, dtype=torch.int32), 0)


@pytest.mark.gpu
def test_detect_only_async_on_gpu(monkeypatch):
    dev = _cuda()
    from face_crop_plus_tpu_torch.models.weights import from_jax_params
    from torch_parity import tamed_params

    # f32 convolutions on the card, as the CPU computes them.
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    kw = dict(output_size=32, resize_size=64, strategy="largest", det_threshold=-1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pair = [face_crop_plus_tpu_torch.Cropper(device=d, **kw) for d in (str(dev), "cpu")]
    for c in pair:
        c.det_model.net.load_state_dict(from_jax_params(tamed_params(), c.det_model.net))
    batch = _batch((4, 60, 72, 3))
    handle = pair[0]._fused.detect_only_async(batch, (64, 64), valid_n=3)
    assert handle["event"] is not None and all(t.is_pinned() for t in handle["out"])
    lm, idx = pair[0]._fused.detect_only_finish(handle)
    ref_lm, ref_idx = pair[1]._fused.detect_only(batch, (64, 64), valid_n=3)
    np.testing.assert_array_equal(idx, ref_idx)
    np.testing.assert_allclose(lm, ref_lm, rtol=0, atol=1e-3)
