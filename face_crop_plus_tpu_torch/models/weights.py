"""Pretrained-weight loading and random initialization (PyTorch).

Counterpart of ``face_crop_plus_tpu.models.weights``.  Two on-disk forms
are read, in the JAX package's search order:

* ``<model>.npz`` — the JAX package's converted archive: HWIO conv kernels,
  BatchNorm folded to ``<prefix>.scale``/``<prefix>.bias``
  (:func:`from_jax_params` turns it into a state dict);
* the reference's ``.pth`` checkpoint (``retinaface_detector.pth``,
  ``bsrgan_x4_enhancer.pth``, ``bise_parser.pth``) — a raw torch state
  dict whose BatchNorms are folded here (:func:`convert_state_dict`);
  conv kernels are already OIHW.  Keys the network does not have (a
  training-time auxiliary head) are dropped, as the JAX package never
  reads them; a missing key raises at load.

Each is looked for in ``weights_dir`` first, then in ``FCPT_CACHE_DIR`` (or
``~/.cache/face_crop_plus_tpu``).  The port never downloads: when nothing
is found, the model falls back to random initialization with a warning.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
from torch import nn

#: Upstream release that hosts the pretrained checkpoints.
UPSTREAM_URL_ROOT = (
    "https://github.com/mantasu/face-crop-plus/releases/download/v1.0.0/"
)

#: Reference checkpoint filenames per model.
PTH_FILENAMES = {
    "retinaface": "retinaface_detector.pth",
    "rrdb": "bsrgan_x4_enhancer.pth",
    "bisenet": "bise_parser.pth",
}

BN_EPS = 1e-5


def default_cache_dir() -> str:
    return os.environ.get(
        "FCPT_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "face_crop_plus_tpu"),
    )


def convert_state_dict(sd: dict) -> dict[str, torch.Tensor]:
    """Folds a raw torch checkpoint's BatchNorms (conv kernels stay OIHW)."""
    arrays = {
        k: torch.as_tensor(v).detach().cpu()
        for k, v in sd.items()
        if not k.endswith("num_batches_tracked")
    }
    bn_prefixes = {
        k[: -len(".running_mean")] for k in arrays if k.endswith(".running_mean")
    }

    out: dict[str, torch.Tensor] = {}
    for key, val in arrays.items():
        prefix, _, leaf = key.rpartition(".")
        if prefix in bn_prefixes:
            if leaf != "weight":
                continue  # emit once per module, from the gamma entry
            gamma = arrays[f"{prefix}.weight"].double()
            beta = arrays[f"{prefix}.bias"].double()
            mean = arrays[f"{prefix}.running_mean"].double()
            var = arrays[f"{prefix}.running_var"].double()
            scale = gamma / torch.sqrt(var + BN_EPS)
            out[f"{prefix}.scale"] = scale.float()
            out[f"{prefix}.bias"] = (beta - mean * scale).float()
        else:
            out[key] = val.float()
    return out


def from_jax_params(
    params: dict[str, np.ndarray], model: nn.Module
) -> dict[str, torch.Tensor]:
    """Turns a JAX-layout parameter dict into ``model``'s state dict.

    HWIO conv kernels become OIHW; folded BN ``scale``/``bias`` and conv
    biases are kept as they are.

    Raises:
        KeyError: If the key set differs from the model's.
        ValueError: If a converted shape differs from the model's.
    """
    expected = model.state_dict()
    missing = sorted(set(expected) - set(params))
    extra = sorted(set(params) - set(expected))
    if missing or extra:
        raise KeyError(
            f"parameter keys differ from the model's: missing {missing[:5]}, "
            f"unexpected {extra[:5]} ({len(missing)} / {len(extra)} in all)"
        )
    out = {}
    for key, ref in expected.items():
        val = np.asarray(params[key], np.float32)
        if val.ndim == 4:
            val = np.transpose(val, (3, 2, 0, 1))  # HWIO → OIHW
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError(
                f"{key}: shape {tuple(val.shape)} != model's {tuple(ref.shape)}"
            )
        out[key] = torch.from_numpy(np.ascontiguousarray(val))
    return out


def random_state_dict(model: nn.Module, seed: int = 0) -> dict[str, torch.Tensor]:
    """Random-init state dict: He-normal convs, zero biases, unit BN scale.

    Conv kernels are drawn as HWIO from ``np.random.default_rng(seed)`` in
    state-dict order and transposed to OIHW.  Modules register their
    children in the order the JAX forward first touches each parameter, so
    the draws equal the JAX package's random init for the same seed.
    """
    rng = np.random.default_rng(seed)
    out = {}
    for key, ref in model.state_dict().items():
        if key.endswith(".weight") and ref.ndim == 4:
            o, i, kh, kw = ref.shape
            val = rng.normal(size=(kh, kw, i, o)) * np.sqrt(2.0 / (kh * kw * i))
            val = np.transpose(np.asarray(val, np.float32), (3, 2, 0, 1))
        elif key.endswith(".scale"):
            val = np.ones(ref.shape, np.float32)
        else:
            val = np.zeros(ref.shape, np.float32)
        out[key] = torch.from_numpy(np.ascontiguousarray(val))
    return out


def find_weights(
    model_name: str, weights_dir: str | None, model: nn.Module
) -> dict[str, torch.Tensor] | None:
    """Probes for local weights; returns ``model``'s state dict or None.

    Search order: ``<model>.npz`` then the reference ``.pth`` filename,
    fully within ``weights_dir`` before the default cache dir — an
    explicitly supplied checkpoint is never shadowed by a cached one.
    """
    dirs = [d for d in (weights_dir, default_cache_dir()) if d]
    for d in dirs:
        npz = os.path.join(d, f"{model_name}.npz")
        if os.path.isfile(npz):
            with np.load(npz) as z:
                return from_jax_params({k: z[k] for k in z.files}, model)
        pth = os.path.join(d, PTH_FILENAMES.get(model_name, f"{model_name}.pth"))
        if os.path.isfile(pth):
            sd = torch.load(pth, map_location="cpu", weights_only=True)
            if isinstance(sd, dict) and "state_dict" in sd:
                sd = sd["state_dict"]
            wanted = model.state_dict()
            return {k: v for k, v in convert_state_dict(sd).items() if k in wanted}
    return None


def load_or_init(
    model_name: str, model: nn.Module, weights_dir: str | None, seed: int = 0
) -> bool:
    """Loads pretrained weights into ``model``, or random init + warning.

    Returns whether pretrained weights were found.
    """
    found = find_weights(model_name, weights_dir, model)
    if found is not None:
        model.load_state_dict(found, strict=True)
        return True
    warnings.warn(
        f"No pretrained weights found for '{model_name}' "
        f"(looked in {weights_dir or '<unset>'} and {default_cache_dir()}; "
        f"place {PTH_FILENAMES.get(model_name)} or {model_name}.npz there — "
        f"upstream: {UPSTREAM_URL_ROOT}). Falling back to random "
        f"initialization: outputs will not be meaningful."
    )
    model.load_state_dict(random_state_dict(model, seed), strict=True)
    return False
