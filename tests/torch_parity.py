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


def smooth_image(rng, h: int, w: int, cell: int = 8) -> np.ndarray:
    """A smooth, photo-like uint8 (h, w, 3) image: a coarse random grid,
    bilinearly upsampled.  JPEG keeps such images within a few levels, and
    small landmark shifts move a crop pixel by little."""
    import cv2

    coarse = rng.uniform(0, 255, (h // cell + 2, w // cell + 2, 3)).astype(np.float32)
    up = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR)
    return np.clip(np.rint(up), 0, 255).astype(np.uint8)


def write_oriented_jpeg(path: str, img: np.ndarray, orientation: int):
    """Writes ``img`` as a JPEG whose EXIF orientation tag is ``orientation``."""
    from PIL import Image

    exif = Image.Exif()
    exif[0x0112] = orientation
    Image.fromarray(img).save(path, quality=95, exif=exif.tobytes())


#: The mixed directory of the directory tests: (file name, (h, w)).  Six
#: 72×60 JPEGs form the fused group; the rest are single shapes, which take
#: the staged path: a 150×200 JPEG that decodes at 1/2 DCT scale under a
#: 64² interim, an EXIF-rotated JPEG, a PNG, and a corrupt file.
MIXED_DIR = [(f"a{i:02d}.jpg", (72, 60)) for i in range(6)] + [
    ("b0.jpg", (50, 90)),
    ("b1.jpg", (150, 200)),
    ("b2.jpeg", (40, 40)),
    ("b3.jpg", (44, 56)),  # EXIF orientation 6
    ("c0.png", (61, 47)),
    ("z_bad.jpg", None),  # corrupt
]


def write_mixed_dir(path: str, seed: int = 0) -> list[str]:
    """Writes :data:`MIXED_DIR` into ``path``; returns the file names."""
    import os

    from face_crop_plus_tpu_torch.utils.io import imwrite

    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    for name, hw in MIXED_DIR:
        full = os.path.join(path, name)
        if hw is None:
            with open(full, "wb") as f:
                f.write(b"\xff\xd8\xff\xe0 not really a jpeg")
        elif name == "b3.jpg":
            write_oriented_jpeg(full, smooth_image(rng, *hw), 6)
        else:
            imwrite(full, smooth_image(rng, *hw))
    return [name for name, _ in MIXED_DIR]


def read_tree(root: str) -> dict[str, np.ndarray]:
    """Every file under ``root`` by relative path, decoded unchanged by cv2."""
    import os

    import cv2

    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    return out


def tree_max_diff(a: dict, b: dict) -> int:
    """Largest pixel difference of two trees with the same names and shapes."""
    assert sorted(a) == sorted(b), (sorted(set(a) ^ set(b)))
    worst = 0
    for k in a:
        assert a[k] is not None and b[k] is not None and a[k].shape == b[k].shape, k
        worst = max(worst, int(np.abs(a[k].astype(np.int16) - b[k].astype(np.int16)).max()))
    return worst


def write_tamed_npz(weights_dir: str) -> str:
    """Writes :func:`tamed_params` as ``retinaface.npz`` (both packages read it)."""
    import os

    os.makedirs(weights_dir, exist_ok=True)
    path = os.path.join(weights_dir, "retinaface.npz")
    np.savez(path, **tamed_params())
    return path


def nfkd_ascii(s: str) -> str:
    """NFKD transliteration to ASCII, both packages' fallback when
    ``unidecode`` is absent.  Tests pin it on both sides: another test
    helper (``tests/refcompat.py``) may leave a passthrough ``unidecode``
    stub in ``sys.modules``, which a package imported after it would use."""
    import unicodedata

    return unicodedata.normalize("NFKD", s).encode("ascii", "ignore").decode("ascii")
