"""Shared helpers for the port's parity tests (JAX package vs PyTorch port).

Not a test module.  Inputs are made from a seed with numpy and handed to
both packages as numpy arrays; JAX runs on the CPU (``tests/conftest.py``
forces it) and the port is asked for ``device="cpu"``.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=1)
def jax_retinaface_params() -> dict[str, np.ndarray]:
    """The JAX package's RetinaFace random-init dict (key set and shapes)."""
    from face_crop_plus_tpu.models.detection import RetinaFace

    return RetinaFace._random_init()


#: Gain and BN scale of :func:`tamed_params`.  The random-init detector
#: (gain 2, BN scale 1) saturates: scores are exactly 0 or 1 and box
#: regressions reach ~1e5, so exp() overflows and parity would be checked on
#: ties, infs and NaNs only.  These values keep scores spread over (0, 1)
#: and |loc| below ~10 on 64² inputs.
TAMED_GAIN = 1.0
TAMED_BN_SCALE = 0.7


@functools.lru_cache(maxsize=4)
def tamed_params(seed: int = 1) -> dict[str, np.ndarray]:
    """JAX-layout RetinaFace params with the random-init key set, tamed.

    Conv kernels are normal with variance ``TAMED_GAIN / fan_in``, BN scales
    are ``TAMED_BN_SCALE``, biases small normal values.
    """
    rng = np.random.default_rng(seed)
    out = {}
    for key, val in jax_retinaface_params().items():
        if val.ndim == 4:
            fan_in = int(np.prod(val.shape[:3]))
            w = rng.normal(size=val.shape) * np.sqrt(TAMED_GAIN / fan_in)
            out[key] = w.astype(np.float32)
        elif key.endswith(".scale"):
            out[key] = np.full(val.shape, TAMED_BN_SCALE, np.float32)
        else:
            out[key] = (rng.normal(size=val.shape) * 0.01).astype(np.float32)
    return out


def torch_net(params: dict[str, np.ndarray]):
    """A port :class:`RetinaFaceNet` on the CPU holding ``params``."""
    from face_crop_plus_tpu_torch.models.detection import RetinaFaceNet
    from face_crop_plus_tpu_torch.models.weights import from_jax_params

    net = RetinaFaceNet()
    net.load_state_dict(from_jax_params(params, net), strict=True)
    return net.eval().requires_grad_(False)


def jax_params(params: dict[str, np.ndarray]):
    """``params`` as a JAX pytree for ``face_crop_plus_tpu`` forwards."""
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in params.items()}


def cropper_pair(**kw):
    """A JAX ``Cropper`` and a port ``Cropper`` on the CPU, same tamed weights.

    The caller sets ``FCPT_HOST_CROP=0`` first: by default the JAX Cropper
    warps on the host when its native kernel is built, and the port
    reproduces the device warp.
    """
    import warnings

    import face_crop_plus_tpu
    import face_crop_plus_tpu_torch
    from face_crop_plus_tpu_torch.models.weights import from_jax_params

    p = tamed_params()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = face_crop_plus_tpu.Cropper(device="cpu", **kw)
        t = face_crop_plus_tpu_torch.Cropper(device="cpu", **kw)
    j.det_model.params = jax_params(p)
    net = t.det_model.net
    net.load_state_dict(from_jax_params(p, net), strict=True)
    return j, t


def sorted_boxes(rng, n: int, k: int, lo: float = 0.0, hi: float = 80.0):
    """(n, k, 4) random corner boxes and score-style (n, k) validity."""
    scores = np.sort(rng.uniform(0, 1, (n, k)).astype(np.float32))[:, ::-1]
    x1 = rng.uniform(lo, hi, (n, k))
    y1 = rng.uniform(lo, hi, (n, k))
    w = rng.uniform(5, 40, (n, k))
    h = rng.uniform(5, 40, (n, k))
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    return boxes, np.ascontiguousarray(scores > 0.3)
