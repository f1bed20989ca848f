"""Port parity: the RRDBNet enhancer, ``models/enhancement.py``.

The JAX package's functions and the port's run on the same numpy-seeded
inputs with the same tamed weights (``torch_parity.tamed_rrdb_params``,
carried across by ``from_jax_params``) at 2 RRDBs and small images.
Tolerances: the upsample exact; the bicubic x0.25 filter within 1e-6 of the
JAX function and of ``F.interpolate``; the network's f32 output within 1e-4
(other conv summation orders); enhanced uint8 images within ±1 level, at
most 1 % of their values differing; the gate's factors and gated sets
exact, ungated images bitwise unchanged.
"""

import os
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from face_crop_plus_tpu.models import enhancement as je
from face_crop_plus_tpu.ops import nn as jnn
from face_crop_plus_tpu_torch.models import enhancement as te
from face_crop_plus_tpu_torch.models.weights import from_jax_params, random_state_dict
from face_crop_plus_tpu_torch.ops import nn as tnn

from torch_parity import (
    TEST_RRDB_BLOCKS,
    jax_params,
    jax_rrdb_params,
    smooth_image,
    tamed_rrdb_params,
    torch_rrdb,
)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these small parity runs share the machine's
    cores with the suite's other workers, where 8 threads each oversubscribe
    it (a 2 s test took 40 s in the 6-worker run)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def _pair(monkeypatch, **kw):
    """A JAX and a port ``RRDBNet`` on the CPU with the tamed weights."""
    monkeypatch.setenv("FCPT_CACHE_DIR", "/nonexistent-fcpt-cache")
    p = tamed_rrdb_params()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = je.RRDBNet(num_blocks=TEST_RRDB_BLOCKS, **kw)
        t = te.RRDBNet(num_blocks=TEST_RRDB_BLOCKS, device="cpu", **kw)
    j.params = jax_params(p)
    t.net.load_state_dict(from_jax_params(p, t.net), strict=True)
    return j, t


def _images(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([smooth_image(rng, h, w) for _ in range(n)])


def _assert_levels(ours: np.ndarray, ref: np.ndarray, what: str):
    d = np.abs(ours.astype(np.int16) - ref.astype(np.int16))
    share = float((d > 0).mean())
    print(f"{what}: max |diff| {int(d.max())}, differing share {share:.6f}")
    assert d.max() <= 1 and share <= 0.01


# ---------------------------------------------------------------------------
# ops/nn.py
# ---------------------------------------------------------------------------


def test_upsample2x_nearest_exact():
    x = np.random.default_rng(0).normal(size=(2, 5, 7, 3)).astype(np.float32)
    ref = np.asarray(jnn.upsample2x_nearest(jnp.asarray(x)))
    ours = _nhwc(tnn.upsample2x_nearest(_nchw(x)))
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (1, 8, 4, 64)])
def test_downscale4x_bicubic(shape):
    x = np.random.default_rng(1).uniform(0, 1, shape).astype(np.float32)
    ours = tnn.downscale4x_bicubic(_nchw(x))
    ref = np.asarray(jnn.downscale4x_bicubic(jnp.asarray(x)))
    lib = torch.nn.functional.interpolate(_nchw(x), scale_factor=0.25, mode="bicubic",
                                          align_corners=False)
    assert np.abs(_nhwc(ours) - ref).max() <= 1e-6
    assert (ours - lib).abs().max() <= 1e-6


# ---------------------------------------------------------------------------
# The network and its weights
# ---------------------------------------------------------------------------


def test_weight_names_shapes_and_init_match_jax():
    """Module paths give JAX's names and (transposed) shapes, and the seeded
    random init draws JAX's values."""
    ref = jax_rrdb_params(TEST_RRDB_BLOCKS)
    net = te.RRDBNetwork(TEST_RRDB_BLOCKS)
    sd = net.state_dict()
    assert list(sd) == list(ref)  # creation order too
    init = random_state_dict(net, seed=te._INIT_SEED)
    for k, v in ref.items():
        ours = init[k].numpy()
        if v.ndim == 4:
            ours = ours.transpose(2, 3, 1, 0)  # OIHW → HWIO
        np.testing.assert_array_equal(ours, v, err_msg=k)
    assert len(te.RRDBNetwork().state_dict()) == 2 * (1 + 23 * 3 * 5 + 5)


@pytest.mark.parametrize("hw", [(32, 32), (40, 64)])
def test_network_matches_jax(hw):
    p = tamed_rrdb_params()
    x = _images(1, *hw, seed=sum(hw)).astype(np.float32) / 255.0
    forward = jax.jit(lambda params, x: je.rrdbnet_forward(jnn.Params(params), x,
                                                          TEST_RRDB_BLOCKS))
    ref = np.asarray(forward(jax_params(p), jnp.asarray(x)))
    ours = _nhwc(torch_rrdb(p)(_nchw(x)))
    assert ours.shape == ref.shape == (1, 4 * hw[0], 4 * hw[1], 3)
    assert np.abs(ours - ref).max() <= 1e-4


@pytest.mark.parametrize("hw", [(29, 16), (40, 7)])
def test_tail_strips_equal_whole_tail(hw):
    """The row-stripped tail computes the whole tail's function (its halo
    holds the rows a cut edge spoils), also for a short last strip."""
    net = torch_rrdb(tamed_rrdb_params())
    fea = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 64, *hw)).astype(np.float32))
    whole = net._tail(fea)
    net.tail_max_pixels = 8 * hw[1]  # strips of 8 rows (the last one shifted)
    stripped = net._tail_strips(fea)
    assert stripped.shape == whole.shape
    assert (stripped - whole).abs().max() <= 1e-5


def test_load_or_init_reads_npz_and_pth(monkeypatch, tmp_path):
    p = tamed_rrdb_params()
    np.savez(tmp_path / "rrdb.npz", **p)
    ours = te.RRDBNet(num_blocks=TEST_RRDB_BLOCKS, weights_dir=str(tmp_path), device="cpu")
    assert ours.pretrained
    want = from_jax_params(p, ours.net)
    for k, v in ours.net.state_dict().items():
        assert torch.equal(v, want[k]), k
    os.remove(tmp_path / "rrdb.npz")
    torch.save({k: v.clone() for k, v in want.items()}, tmp_path / "bsrgan_x4_enhancer.pth")
    again = te.RRDBNet(num_blocks=TEST_RRDB_BLOCKS, weights_dir=str(tmp_path), device="cpu")
    assert again.pretrained
    assert all(torch.equal(v, want[k]) for k, v in again.net.state_dict().items())


# ---------------------------------------------------------------------------
# The wrapper: gate, sub-batches, predict
# ---------------------------------------------------------------------------


def test_mean_face_factor_matches_jax():
    rng = np.random.default_rng(4)
    lm = rng.uniform(0, 64, (7, 5, 2)).astype(np.float32)
    indices = [0, 0, 2, 3, 3, 3, 5]  # images 1 and 4 have no face
    ref = je.mean_face_factor(lm, indices, 6, (64, 48))
    ours = te.mean_face_factor(lm, indices, 6, (64, 48))
    np.testing.assert_array_equal(ours, ref)
    assert np.isnan(ours[[1, 4]]).all() and np.isfinite(ours[[0, 2, 3, 5]]).all()
    assert np.isnan(te.mean_face_factor(lm[:0], [], 3, (64, 48))).all()


def test_enhance_images_matches_jax(monkeypatch):
    j, t = _pair(monkeypatch)
    images = _images(3, 40, 48)
    ref = j.enhance_images(images)
    ours = t.enhance_images(images)
    assert ours.dtype == np.uint8 and ours.shape == images.shape
    _assert_levels(ours, ref, "enhance_images")
    inside = float(((ours > 0) & (ours < 255)).mean())
    assert inside >= 0.5 and np.abs(ours.astype(np.int16) - images).mean() > 5


def test_enhance_device_pads_short_tail(monkeypatch):
    """Sub-batches of ``enh_batch_size``; a short last one repeats its last
    row, and only real rows come back."""
    j, t = _pair(monkeypatch, enh_batch_size=2)
    images = _images(3, 24, 32, seed=5)
    seen = []
    real = t._sr_uint8

    def spy(x):
        seen.append(x.clone())
        return real(x)

    monkeypatch.setattr(t, "_sr_uint8", spy)
    ours = t.enhance_device(torch.from_numpy(images))
    assert [len(x) for x in seen] == [2, 2]
    assert torch.equal(seen[1][0], seen[1][1]) and torch.equal(seen[1][0], torch.from_numpy(images[2]))
    ref = np.asarray(j.enhance_device(jnp.asarray(images)))
    assert ours.shape == images.shape
    _assert_levels(ours.numpy(), ref, "enhance_device (batch 2, padded tail)")
    _assert_levels(t.enhance_images(images), ref, "enhance_images (batch 2, padded tail)")


def _factors_and_landmarks(n, h, w, seed):
    """Per-image random faces (image 1 has none) and a threshold midway
    between the 2nd and 3rd smallest finite factors."""
    rng = np.random.default_rng(seed)
    indices = [0, 0, 2] + list(range(3, n))
    lm = rng.uniform(0, min(h, w), (len(indices), 5, 2)).astype(np.float32)
    f = np.sort(je.mean_face_factor(lm, indices, n, (h, w)))
    f = f[np.isfinite(f)]
    return lm, indices, float(f[1] + f[2]) / 2


def test_predict_matches_jax(monkeypatch):
    j, t = _pair(monkeypatch)
    images = _images(5, 24, 32, seed=6)
    lm, indices, thr = _factors_and_landmarks(5, 24, 32, seed=7)
    j.min_face_factor = t.min_face_factor = thr
    factors = te.mean_face_factor(lm, indices, 5, (24, 32))
    gated = np.nonzero(factors <= thr)[0]
    assert len(gated) == 2 and 1 not in gated

    ref = j.predict(images, lm, indices)
    ours = t.predict(images, lm, indices)
    assert ours is not images and ours.shape == images.shape
    ungated = np.setdiff1d(np.arange(5), gated)
    np.testing.assert_array_equal(ours[ungated], images[ungated])
    np.testing.assert_array_equal(ref[ungated], images[ungated])
    assert (ours[gated] != images[gated]).any()
    _assert_levels(ours[gated], ref[gated], "predict, uniform")

    # A device tensor stays a tensor, with the same gate and pixels.
    dev = t.predict(torch.from_numpy(images), lm, indices)
    assert torch.is_tensor(dev)
    np.testing.assert_array_equal(dev.numpy()[ungated], images[ungated])
    _assert_levels(dev.numpy()[gated], ref[gated], "predict, tensor")

    # No landmarks: every image; nothing gated and no image: unchanged.
    _assert_levels(t.predict(images, None, None), j.predict(images, None, None),
                   "predict, no landmarks")
    t.min_face_factor = -np.inf
    assert t.predict(images, lm, indices) is images
    assert t.predict([], None, None) == []


def test_predict_ragged_list_matches_jax(monkeypatch):
    """A ragged list is bucketed by shape; the gate reads the first image's
    shape, as the reference's does."""
    j, t = _pair(monkeypatch)
    rng = np.random.default_rng(8)
    shapes = [(24, 32), (20, 16), (24, 32), (20, 16)]
    images = [smooth_image(rng, *hw) for hw in shapes]
    ref = j.predict(list(images), None, None)
    ours = t.predict(list(images), None, None)
    assert isinstance(ours, list) and [o.shape[:2] for o in ours] == shapes
    for k in range(4):
        _assert_levels(ours[k], ref[k], f"predict, ragged image {k}")
    lm = np.zeros((1, 5, 2), np.float32)
    lm[0, 4] = (4, 4)  # one small face on image 2: gated; the rest faceless
    t.min_face_factor = j.min_face_factor = 1e-2
    ours = t.predict(list(images), lm, [2])
    assert all(ours[k] is images[k] for k in (0, 1, 3))
    _assert_levels(ours[2], j.predict(list(images), lm, [2])[2], "predict, ragged gated")
