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


@functools.lru_cache(maxsize=1)
def jax_bisenet_params() -> dict[str, np.ndarray]:
    """The JAX package's BiSeNet random-init dict (key set and shapes)."""
    from face_crop_plus_tpu.models.parsing import BiSeNet

    return BiSeNet._random_init()


#: Settings of :func:`tamed_bisenet_params`: conv gain, BN scale, bias
#: spread and the gain of the final 1x1 class conv.  The random-init parser
#: (gain 2, BN scale 1, zero biases) gives logits whose top two often tie
#: within the two packages' rounding; these values spread the logits to
#: |x| ~ 10 over ~10 classes a face, with the top-2 margin above 1e-3 at
#: 99.9 % of pixels, far above the packages' logit difference (< 1.3e-5).
TAMED_BISENET = dict(gain=2.0, bn_scale=0.7, bias=0.3, head_gain=16.0)


@functools.lru_cache(maxsize=2)
def tamed_bisenet_params(seed: int = 1) -> dict[str, np.ndarray]:
    """JAX-layout BiSeNet params with the random-init key set, tamed."""
    rng = np.random.default_rng(seed)
    t = TAMED_BISENET
    out = {}
    for key, val in jax_bisenet_params().items():
        if val.ndim == 4:
            gain = t["head_gain"] if key == "conv_out.conv_out.weight" else t["gain"]
            w = rng.normal(size=val.shape) * np.sqrt(gain / np.prod(val.shape[:3]))
            out[key] = w.astype(np.float32)
        elif key.endswith(".scale"):
            out[key] = np.full(val.shape, t["bn_scale"], np.float32)
        else:
            out[key] = (rng.normal(size=val.shape) * t["bias"]).astype(np.float32)
    return out


def torch_bisenet(params: dict[str, np.ndarray]):
    """A port :class:`BiSeNetNet` on the CPU holding ``params``."""
    from face_crop_plus_tpu_torch.models.parsing import BiSeNetNet
    from face_crop_plus_tpu_torch.models.weights import from_jax_params

    net = BiSeNetNet()
    net.load_state_dict(from_jax_params(params, net), strict=True)
    return net.eval().requires_grad_(False)


@functools.lru_cache(maxsize=2)
def jax_rrdb_params(num_blocks: int) -> dict[str, np.ndarray]:
    """The JAX package's RRDBNet random-init dict (key set, shapes, values)
    at ``num_blocks``, as its ``RRDBNet._init_fn`` draws it."""
    from face_crop_plus_tpu.models.enhancement import rrdbnet_forward
    from face_crop_plus_tpu.ops.nn import init_structure

    return init_structure(rrdbnet_forward, (1, 16, 16, 3), 2, num_blocks)


#: RRDB blocks of the parity tests' enhancer (the network's 23 in full).
TEST_RRDB_BLOCKS = 2

#: Settings of :func:`tamed_rrdb_params`: conv gain, bias spread, the gain of
#: ``conv_last`` and its bias.  Each RRDB returns ~1.2x its input (0.2 x the
#: dense chain, itself ~ its input, plus the input), so the random-init trunk
#: grows ~1.2^num_blocks and saturates every output pixel; ``trunk_conv``'s
#: gain is 1.44^-num_blocks to undo that, and ``conv_last`` centres the
#: output on mid-grey: enhanced images spread over ~±40 levels (2 blocks)
#: and ~±20 (23 blocks), unsaturated.
TAMED_RRDB = dict(gain=1.0, bias=0.01, last_gain=0.5, last_bias=0.5)


@functools.lru_cache(maxsize=2)
def tamed_rrdb_params(num_blocks: int = TEST_RRDB_BLOCKS, seed: int = 1) -> dict[str, np.ndarray]:
    """JAX-layout RRDBNet params with the random-init key set, tamed."""
    rng = np.random.default_rng(seed)
    t = TAMED_RRDB
    out = {}
    for key, val in jax_rrdb_params(num_blocks).items():
        if val.ndim == 4:
            gain = {"conv_last.weight": t["last_gain"],
                    "trunk_conv.weight": 1.44 ** -num_blocks}.get(key, t["gain"])
            w = rng.normal(size=val.shape) * np.sqrt(gain / np.prod(val.shape[:3]))
            out[key] = w.astype(np.float32)
        elif key == "conv_last.bias":
            out[key] = np.full(val.shape, t["last_bias"], np.float32)
        else:
            out[key] = (rng.normal(size=val.shape) * t["bias"]).astype(np.float32)
    return out


def torch_rrdb(params: dict[str, np.ndarray]):
    """A port :class:`RRDBNetwork` on the CPU holding ``params`` (its block
    count read from their keys)."""
    from face_crop_plus_tpu_torch.models.enhancement import RRDBNetwork
    from face_crop_plus_tpu_torch.models.weights import from_jax_params

    blocks = {k.split(".")[1] for k in params if k.startswith("RRDB_trunk.")}
    net = RRDBNetwork(len(blocks))
    net.load_state_dict(from_jax_params(params, net), strict=True)
    return net.eval().requires_grad_(False)


def small_enhancers(monkeypatch, num_blocks: int = TEST_RRDB_BLOCKS):
    """Both packages' Croppers (and CLIs) build ``num_blocks``-block
    enhancers: ``RRDBNet`` is looked up at model init, so a partial with the
    block count stands in for it."""
    from face_crop_plus_tpu.models import enhancement as je
    from face_crop_plus_tpu_torch.models import enhancement as te

    for module in (je, te):
        monkeypatch.setattr(module, "RRDBNet",
                            functools.partial(module.RRDBNet, num_blocks=num_blocks))


def compute_dtype_models(monkeypatch, jax_dtype, torch_dtype):
    """Both packages' Croppers build RetinaFace, BiSeNet and RRDBNet with
    the given ``compute_dtype`` (a Cropper has no such argument, as in the
    JAX package): each class is looked up at model init, so a partial
    stands in for it.  The weight-shape caches are filled first, since
    they build the classes themselves."""
    from face_crop_plus_tpu.models import detection as jd
    from face_crop_plus_tpu.models import enhancement as je
    from face_crop_plus_tpu.models import parsing as jp
    from face_crop_plus_tpu_torch.models import detection as td
    from face_crop_plus_tpu_torch.models import enhancement as te
    from face_crop_plus_tpu_torch.models import parsing as tp

    jax_retinaface_params()
    jax_bisenet_params()
    for module, name, dtype in ((jd, "RetinaFace", jax_dtype), (jp, "BiSeNet", jax_dtype),
                                (je, "RRDBNet", jax_dtype), (td, "RetinaFace", torch_dtype),
                                (tp, "BiSeNet", torch_dtype), (te, "RRDBNet", torch_dtype)):
        monkeypatch.setattr(module, name,
                            functools.partial(getattr(module, name), compute_dtype=dtype))


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
    reproduces the device warp.  Each model either Cropper has (detector,
    enhancer, parser) gets its tamed weights; enhancers need
    :func:`small_enhancers` first.
    """
    import warnings

    import face_crop_plus_tpu
    import face_crop_plus_tpu_torch
    from face_crop_plus_tpu_torch.models.weights import from_jax_params

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = face_crop_plus_tpu.Cropper(device="cpu", **kw)
        t = face_crop_plus_tpu_torch.Cropper(device="cpu", **kw)
    models = [(j.det_model, t.det_model, tamed_params),
              (j.enh_model, t.enh_model, tamed_rrdb_params),
              (j.par_model, t.par_model, tamed_bisenet_params)]
    for jm, tm, params in models:
        if jm is not None:
            p = params()
            jm.params = jax_params(p)
            tm.net.load_state_dict(from_jax_params(p, tm.net), strict=True)
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
    """Writes :func:`tamed_params` as ``retinaface.npz``,
    :func:`tamed_bisenet_params` as ``bisenet.npz`` and the
    :data:`TEST_RRDB_BLOCKS`-block :func:`tamed_rrdb_params` as
    ``rrdb.npz`` (both packages read them); returns the detector's path."""
    import os

    os.makedirs(weights_dir, exist_ok=True)
    np.savez(os.path.join(weights_dir, "bisenet.npz"), **tamed_bisenet_params())
    np.savez(os.path.join(weights_dir, "rrdb.npz"), **tamed_rrdb_params())
    path = os.path.join(weights_dir, "retinaface.npz")
    np.savez(path, **tamed_params())
    return path


def label_margins(logits: np.ndarray) -> np.ndarray:
    """Top-1 minus top-2 logit along the last axis."""
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


#: Near-tie margin for labels of crops that may differ by ±1 level between
#: the packages: a one-level change of a few input pixels moved the JAX
#: logits' top-2 margin by up to 3e-3 (strategy "all", 351 crops of 64²).
EPS_CROPS = 1e-2


def jax_margins(images: np.ndarray, batch: int = 8) -> np.ndarray:
    """JAX top-2 logit margins of the tamed parser's logits (at its
    inference size, 512²) at each label pixel of uint8 RGB ``images``
    (N, H, W, 3): the nearest resize back to (H, W) that
    ``BiSeNet._parse`` applies to the labels."""
    import jax.numpy as jnp
    import torch

    from face_crop_plus_tpu.models import parsing as jp
    from face_crop_plus_tpu.ops import nn as jnn
    from face_crop_plus_tpu_torch.ops.nn import resize_nearest

    params = jnn.Params(jax_params(tamed_bisenet_params()))
    out = []
    for s in range(0, len(images), batch):
        x = jnp.asarray(images[s : s + batch], jnp.float32) / 255.0
        x = jnn.resize_bilinear(x, (jp._INFER_SIZE, jp._INFER_SIZE))
        x = (x - jnp.array(jp._MEAN, jnp.float32)) / jnp.array(jp._STD, jnp.float32)
        m = label_margins(np.asarray(jp.bisenet_forward(params, x)))
        out.append(resize_nearest(torch.from_numpy(m)[:, None], images.shape[1:3])[:, 0].numpy())
    return np.concatenate(out)


def check_parse_tree(ours: dict, ref: dict, eps: float = EPS_CROPS) -> int:
    """Holds a parse tree (:func:`read_tree` of PNGs) against the JAX one.

    Names must be equal, RGB files within ±1, and every 2-D mask file equal
    to JAX's except at near-tie pixels of its face: where the JAX margin
    on the JAX tree's crop (the same name in the ``<mask>`` sibling) is at
    most ``eps``.  Returns the number of mask pixels that differ.
    """
    import os

    assert sorted(ours) == sorted(ref), sorted(set(ours) ^ set(ref))
    masks = sorted(k for k, v in ref.items() if v.ndim == 2)
    crops = [k for k in ref if k not in masks]
    assert tree_max_diff({k: ours[k] for k in crops}, {k: ref[k] for k in crops}) <= 1
    if not masks:
        return 0
    faces, row = [], {}  # a face in several cells is one crop: one forward
    for k in masks:
        d, name = os.path.split(k)
        assert d.endswith("_mask"), k
        face = ref[os.path.join(d[: -len("_mask")], name)][..., ::-1]  # BGR → RGB
        row[k] = row.setdefault(face.tobytes() + bytes(str(face.shape), "ascii"), len(faces))
        if row[k] == len(faces):
            faces.append(face)
    margins = jax_margins(np.stack(faces))
    near = {k: margins[row[k]] <= eps for k in masks}
    differ = 0
    for k in masks:
        assert set(np.unique(ours[k])) <= {0, 255}, k
        d = ours[k] != ref[k]
        assert not (d & ~near[k]).any(), k
        differ += int(d.sum())
    return differ


def nfkd_ascii(s: str) -> str:
    """NFKD transliteration to ASCII, both packages' fallback when
    ``unidecode`` is absent.  Tests pin it on both sides: another test
    helper (``tests/refcompat.py``) may leave a passthrough ``unidecode``
    stub in ``sys.modules``, which a package imported after it would use."""
    import unicodedata

    return unicodedata.normalize("NFKD", s).encode("ascii", "ignore").decode("ascii")
