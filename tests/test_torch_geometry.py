"""Port parity: transform fits (ops/transform.py) and warping (ops/warp.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_crop_plus_tpu.ops import transform as jtf
from face_crop_plus_tpu.ops import warp as jwarp
from face_crop_plus_tpu.utils.landmarks import make_target_landmarks as j_target
from face_crop_plus_tpu_torch.ops import transform as ttf
from face_crop_plus_tpu_torch.ops import warp as twarp
from face_crop_plus_tpu_torch.utils.landmarks import make_target_landmarks


def _landmarks(rng, f):
    src = rng.uniform(10, 90, (f, 5, 2)).astype(np.float32)
    src[0] = 42.0  # coincident points: degenerate
    src[1, :, 1] = 2.0 * src[1, :, 0] + 1.0  # collinear: degenerate affine
    return src


@pytest.mark.parametrize("fit", ["estimate_similarity", "estimate_affine"])
def test_fits_match_jax(fit):
    rng = np.random.default_rng(0)
    src = _landmarks(rng, 12)
    dst = make_target_landmarks((64, 64), 0.65)
    m, ok = getattr(ttf, fit)(torch.from_numpy(src), torch.from_numpy(dst))
    rm, rok = getattr(jtf, fit)(jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(rok))
    good = np.asarray(rok)
    # Closed-form f32 fits; reductions may sum in another order.
    np.testing.assert_allclose(m.numpy()[good], np.asarray(rm)[good], rtol=1e-5, atol=1e-5)


def test_invert_affine_matches_jax():
    rng = np.random.default_rng(1)
    m = rng.normal(size=(16, 2, 3)).astype(np.float32)
    m[0, :, :2] = 0.0  # singular: sign-preserving epsilon
    m[1, :, :2] = [[1e-7, 0.0], [0.0, -1e-7]]  # tiny negative det
    ours = ttf.invert_affine(torch.from_numpy(m)).numpy()
    ref = np.asarray(jtf.invert_affine(jnp.asarray(m)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5)


def test_target_landmarks_exact():
    for size, ff in [((256, 256), 0.65), ((64, 48), 0.8)]:
        np.testing.assert_array_equal(make_target_landmarks(size, ff), j_target(size, ff))


def _warp_inputs(rng, windows: bool):
    n, h, w = 3, 40, 36
    images = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    f = 7
    img_idx = rng.integers(0, n, f).astype(np.int32)
    ang = rng.uniform(-0.6, 0.6, f)
    sc = rng.uniform(0.5, 2.5, f)
    tx = rng.uniform(-30, 30, f)
    ty = rng.uniform(-30, 30, f)
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


@pytest.mark.parametrize("windows", [False, True])
@pytest.mark.parametrize("mode", twarp.BORDER_MODES)
def test_warp_affine_batch_matches_jax(mode, windows):
    rng = np.random.default_rng(2 * twarp.BORDER_MODES.index(mode) + windows)
    images, m, img_idx, win = _warp_inputs(rng, windows)
    size = (24, 20)
    # Op by op: under jit XLA:CPU contracts the inverse's a*d - b*c into an
    # FMA, which moves sample coordinates by ~4e-6 px and strong-gradient
    # outputs by ~2e-3.  Unfused, both packages do the same f32 arithmetic.
    with jax.disable_jit():
        ref = np.asarray(jwarp.warp_affine_batch(
            jnp.asarray(images), jnp.asarray(m), jnp.asarray(img_idx), size, mode,
            None if win is None else jnp.asarray(win),
        ))
    ours = twarp.warp_affine_batch(
        torch.from_numpy(images), torch.from_numpy(m), torch.from_numpy(img_idx),
        size, mode, None if win is None else torch.from_numpy(win),
    ).numpy()
    assert ours.shape == ref.shape == (7, 20, 24, 3)
    # Same f32 operations; float remainders may round differently by an ulp.
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-3)


def test_to_uint8_rounds_half_to_even_and_saturates():
    x = np.array([-3.0, 0.5, 1.5, 2.5, 254.5, 255.5, 300.0, 127.49], np.float32)
    ours = twarp.to_uint8(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jwarp.to_uint8(jnp.asarray(x))))
    assert ours.tolist() == [0, 0, 2, 2, 254, 255, 255, 127]
