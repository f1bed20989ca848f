"""Pretrained weights: fetch, convert, cache and load (PyTorch).

Counterpart of ``face_crop_plus_tpu.models.weights``; both packages read
and write one archive format and share one cache directory
(``FCPT_CACHE_DIR``, else ``~/.cache/face_crop_plus_tpu``):

* ``<model>.npz`` — the JAX layout: HWIO conv kernels, BatchNorm folded in
  float64 to ``<prefix>.scale``/``<prefix>.bias``, every key of the
  checkpoint kept, ``num_batches_tracked`` dropped
  (:func:`convert_pth_file`, :func:`to_jax_params`, :func:`save_npz`);
* the reference's ``.pth`` checkpoint (``retinaface_detector.pth``,
  ``bsrgan_x4_enhancer.pth``, ``bise_parser.pth``) — a raw torch state
  dict, converted once and cached as ``<model>.npz`` next to it.

:func:`find_weights` looks for each form in ``weights_dir`` first, then in
the cache dir; when neither holds one, it fetches the released ``.pth``
from ``FCPT_WEIGHTS_URL`` (default :data:`UPSTREAM_URL_ROOT`; ``file://``
roots work) into the cache dir, as the reference's ``torch.hub`` download
does, converts and caches it.  ``FCPT_NO_DOWNLOAD=1`` turns the fetch off
and ``FCPT_DOWNLOAD_TIMEOUT`` sets its timeout (15 s).  Keys the network
does not have (a training-time auxiliary head) are dropped at load, as
the JAX models never read them; a missing key raises.  When nothing is
found, the model falls back to seeded random initialization with a
warning.
"""

from __future__ import annotations

import contextlib
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


def to_jax_params(state_dict: dict) -> dict[str, np.ndarray]:
    """A state dict in the JAX package's layout; the inverse of
    :func:`from_jax_params`.

    4-D ``weight`` tensors (conv kernels) go OIHW → HWIO, as the JAX
    converter's rule has it; every value becomes float32 numpy; keys keep
    their order.
    """
    out = {}
    for key, val in state_dict.items():
        val = val.detach().cpu().numpy()
        if key.rpartition(".")[2] == "weight" and val.ndim == 4:
            out[key] = np.transpose(val, (2, 3, 1, 0)).astype(np.float32)
        else:
            out[key] = val.astype(np.float32)
    return out


def _from_hwio(val) -> torch.Tensor:
    val = np.asarray(val, np.float32)
    if val.ndim == 4:
        val = np.transpose(val, (3, 2, 0, 1))  # HWIO → OIHW
    return torch.from_numpy(np.ascontiguousarray(val))


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
        out[key] = _from_hwio(params[key])
        if tuple(out[key].shape) != tuple(ref.shape):
            raise ValueError(
                f"{key}: shape {tuple(out[key].shape)} != model's {tuple(ref.shape)}"
            )
    return out


def convert_pth_file(pth_path: str) -> dict[str, np.ndarray]:
    """Loads a torch ``.pth`` checkpoint and converts it to the JAX layout."""
    sd = torch.load(pth_path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return to_jax_params(convert_state_dict(sd))


def save_npz(params: dict[str, np.ndarray], path: str):
    """Writes ``params`` to ``path`` (``.npz`` appended when missing, as
    ``np.savez`` does) through a temp file and a rename, so a process that
    reads the cache meanwhile finds no half-written archive."""
    if not path.endswith(".npz"):
        path += ".npz"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    try:
        np.savez(tmp, **{k: np.asarray(v) for k, v in params.items()})
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.unlink(tmp)
        raise


def load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


#: URL roots that already failed once this process — skipped on retry so a
#: network-less machine pays the connect timeout at most once.
_failed_url_roots: set = set()


def download_pth(
    model_name: str,
    dest_dir: str | None = None,
    url_root: str | None = None,
    timeout: float | None = None,
) -> str | None:
    """Fetches the reference's released ``.pth`` checkpoint into the cache.

    Downloads ``<url_root>/<pth filename>`` to ``dest_dir`` (default
    :func:`default_cache_dir`) through a temp file and a rename, so
    concurrent processes see either nothing or a complete file.  Returns
    the local path (at once when it exists), or None when the file cannot
    be fetched (no network, HTTP error; a warning says why) or
    ``FCPT_NO_DOWNLOAD=1``.  ``url_root`` defaults to ``FCPT_WEIGHTS_URL``,
    else :data:`UPSTREAM_URL_ROOT`; ``file://`` roots work (weight mirrors
    on machines without network).  A root that failed once is not tried
    again in this process.
    """
    if os.environ.get("FCPT_NO_DOWNLOAD", "0") == "1":
        return None
    fname = PTH_FILENAMES.get(model_name)
    if fname is None:
        return None
    dest_dir = dest_dir or default_cache_dir()
    dest = os.path.join(dest_dir, fname)
    if os.path.isfile(dest):
        return dest

    root = url_root or os.environ.get("FCPT_WEIGHTS_URL", UPSTREAM_URL_ROOT)
    if not root.endswith("/"):
        root += "/"
    if root in _failed_url_roots:
        return None
    url = root + fname
    if timeout is None:
        timeout = float(os.environ.get("FCPT_DOWNLOAD_TIMEOUT", "15"))
    import tempfile
    import urllib.request

    try:
        os.makedirs(dest_dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=dest_dir, suffix=".part")
        try:
            with os.fdopen(fd, "wb") as out, urllib.request.urlopen(
                url, timeout=timeout
            ) as resp:
                while chunk := resp.read(1 << 20):
                    out.write(chunk)
            os.replace(tmp, dest)
        except BaseException:
            with contextlib.suppress(OSError):
                os.unlink(tmp)
            raise
    except Exception as e:  # no network / 404 / permission — soft-fail
        _failed_url_roots.add(root)
        warnings.warn(f"Could not download {url}: {e}")
        return None
    return dest


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


def _state_dict_of(params: dict[str, np.ndarray], model: nn.Module) -> dict[str, torch.Tensor]:
    """``model``'s keys of a JAX-layout dict, as a state dict.  Keys the
    network lacks are dropped; a key it has but ``params`` lacks raises at
    the strict ``load_state_dict``."""
    wanted = model.state_dict()
    return {k: _from_hwio(v) for k, v in params.items() if k in wanted}


def _convert_and_cache(pth: str, model_name: str, cache_dir: str, model: nn.Module):
    params = convert_pth_file(pth)
    try:
        save_npz(params, os.path.join(cache_dir, f"{model_name}.npz"))
    except OSError:  # a read-only directory: the next run converts again
        pass
    return _state_dict_of(params, model)


def find_weights(
    model_name: str,
    weights_dir: str | None,
    model: nn.Module,
    auto_download: bool = True,
) -> dict[str, torch.Tensor] | None:
    """Probes for weights in the JAX package's order; returns ``model``'s
    state dict, or None when nothing is found anywhere.

    Search order: ``<model>.npz`` then the reference ``.pth`` filename,
    fully within ``weights_dir`` before the default cache dir — an
    explicitly supplied checkpoint is never shadowed by a cached one.  A
    ``.pth`` is converted and cached as ``<model>.npz`` next to it, so a
    checkpoint from an explicit ``weights_dir`` never leaks into the
    global cache.  When nothing local is found and ``auto_download`` is
    set, the released checkpoint is fetched (:func:`download_pth`),
    converted and cached in the default cache dir.
    """
    for d in [d for d in (weights_dir, default_cache_dir()) if d]:
        npz = os.path.join(d, f"{model_name}.npz")
        if os.path.isfile(npz):
            return _state_dict_of(load_npz(npz), model)
        pth = os.path.join(d, PTH_FILENAMES.get(model_name, f"{model_name}.pth"))
        if os.path.isfile(pth):
            return _convert_and_cache(pth, model_name, d, model)
    if auto_download:
        pth = download_pth(model_name)
        if pth is not None:
            return _convert_and_cache(pth, model_name, default_cache_dir(), model)
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
