"""ctypes bindings for the native host library (``native/fcpt_io.cpp``).

Counterpart of ``face_crop_plus_tpu.utils.native_io``.  The repo's
``native/fcpt_io.cpp`` provides multithreaded libjpeg decoding with
DCT-domain downscaling (1/2, 1/4, 1/8), decoding to the stored YCbCr 4:2:0
planes, the raw-data JPEG encoder for packed 4:2:0 rows, the threaded
YCbCr→RGB reconstruction, and the host warps (RGB, and per plane on packed
rows).  The port compiles that source unchanged with ``g++ … -ljpeg`` into
``face_crop_plus_tpu_torch/_build/`` (listed in ``.gitignore``) at first
use, never writes into ``native/`` and never loads
``native/libfcpt_io.so``.  When the compiler or libjpeg is missing,
:func:`load_library` returns None and :func:`build_status` says why; every
function then returns None (or False, or a list of them), and callers take
the JAX package's fallbacks: cv2/PIL codecs, RGB decodes, the device warp.

The library is compiled ``-march=native``, so a binary built on another
host (a copied checkout) may not run here.  A sidecar tag with the host's
ISA fingerprint is written beside it at build time, and a binary whose tag
differs is rebuilt, never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(os.path.dirname(_PKG_DIR), "native", "fcpt_io.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

#: The flags of ``native/Makefile``.
CXX_FLAGS = ("-O3", "-march=native", "-funroll-loops", "-fPIC", "-std=c++17", "-Wall")
LD_FLAGS = ("-shared", "-ljpeg", "-lpthread")

_lib = None
_lib_lock = threading.Lock()
_build_attempted = False
#: How the library came to be (or not): "built", "reused", or the reason it
#: is unavailable, with the compiler's message when the build failed.
_status = "not loaded"


def _so_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LD_FLAGS).encode())
    if os.path.isfile(_SOURCE):
        with open(_SOURCE, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libfcpt_io_{digest.hexdigest()[:16]}.so")


def _host_tag() -> str:
    """Fingerprint of this host's ISA surface (machine + cpu flags hash)."""
    import platform

    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    flags = line
                    break
    except OSError:  # pragma: no cover - non-procfs platforms
        pass
    digest = hashlib.sha256(flags.encode()).hexdigest()[:16]
    return f"{platform.machine()}:{digest}"


def _read_tag(so_path: str) -> str | None:
    try:
        with open(so_path + ".hosttag") as f:
            return f.read().strip()
    except OSError:
        return None


def _try_build(so_path: str) -> bool:
    """Builds ``so_path`` unless a binary tagged for this host is there."""
    global _build_attempted, _status
    if os.path.isfile(so_path) and _read_tag(so_path) == _host_tag():
        _status = "reused"
        return True
    if _build_attempted:
        return False
    _build_attempted = True
    if not os.path.isfile(_SOURCE):
        _status = f"source {_SOURCE} not found"
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build to a temp name and rename: a process that has the old .so
    # mapped keeps its inode.
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, _SOURCE, "-o", tmp, *LD_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        _status = f"build failed: {e}"
        return False
    if proc.returncode != 0:
        _status = f"build failed: {(proc.stdout + proc.stderr).strip()}"
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False
    os.replace(tmp, so_path)
    with open(so_path + ".hosttag", "w") as f:
        f.write(_host_tag())
    _status = "built"
    return True


_U8P = ctypes.POINTER(ctypes.c_ubyte)
_INTP = ctypes.POINTER(ctypes.c_int)
_F32P = ctypes.POINTER(ctypes.c_float)


def _bind_host_path(lib):
    """Argument types of the 4:2:0 codecs and the host warps."""
    c_int = ctypes.c_int
    lib.fcpt_warp_affine_u8.argtypes = [
        _U8P, c_int, c_int, c_int, c_int,  # images, n, h, w, c
        _F32P, _INTP, _INTP,  # inverse matrices, img_idx, windows (nullable)
        c_int, c_int, c_int,  # f, oh, ow
        c_int, c_int, c_int,  # border mode, exact, n_threads
        _U8P,  # out
    ]
    lib.fcpt_warp_affine_u8.restype = c_int
    lib.fcpt_warp_yuv420.argtypes = [
        _U8P, c_int, c_int, c_int,  # packed source rows, n, h, w
        _F32P, _F32P, _INTP,  # inverse luma and chroma matrices, img_idx
        c_int, c_int, c_int,  # f, oh, ow
        c_int, c_int, c_int,  # border mode, exact, n_threads
        _U8P,  # out packed rows
    ]
    lib.fcpt_warp_yuv420.restype = c_int
    lib.fcpt_yuv420_to_rgb.argtypes = [_U8P, c_int, c_int, c_int, c_int, _U8P]
    lib.fcpt_yuv420_to_rgb.restype = c_int
    lib.fcpt_jpeg_encode_yuv420.argtypes = [
        _U8P, _U8P, _U8P, c_int, c_int, c_int, ctypes.c_char_p,  # y, cb, cr, h, w, q, path
    ]
    lib.fcpt_jpeg_encode_yuv420.restype = c_int
    lib.fcpt_encode_yuv420_batch.argtypes = [
        _U8P, c_int, c_int, c_int, c_int,  # packed, n, h, w, quality
        ctypes.POINTER(ctypes.c_char_p), c_int, _INTP,  # paths, n_threads, oks
    ]
    lib.fcpt_encode_yuv420_batch.restype = c_int
    lib.fcpt_decode_jpeg_yuv420.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(_U8P), _INTP, _INTP, c_int,
    ]
    lib.fcpt_decode_jpeg_yuv420.restype = c_int
    lib.fcpt_decode_yuv420_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), c_int, ctypes.POINTER(_U8P),
        _INTP, _INTP, _INTP, c_int, c_int,  # hs, ws, oks, scale_denom, n_threads
    ]
    lib.fcpt_decode_yuv420_batch.restype = c_int


def load_library():
    """Loads (building if needed) the native library; None when unavailable."""
    global _lib, _status
    with _lib_lock:
        if _lib is not None:
            return _lib
        so_path = _so_path()
        if not _try_build(so_path):
            return None
        try:
            lib = ctypes.CDLL(so_path)
        except OSError as e:
            _status = f"load failed: {e}"
            return None
        lib.fcpt_decode_jpeg.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.fcpt_decode_jpeg.restype = ctypes.c_int
        lib.fcpt_jpeg_dims.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.fcpt_jpeg_dims.restype = ctypes.c_int
        lib.fcpt_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
        lib.fcpt_free.restype = None
        lib.fcpt_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.fcpt_decode_batch.restype = ctypes.c_int
        _bind_host_path(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return load_library() is not None


def build_status() -> str:
    """"built" or "reused" when the decoder is loaded, else why it is not."""
    load_library()
    return _status


def decode_jpeg(path: str, scale_denom: int = 1, fast: bool = False) -> np.ndarray | None:
    """Decodes one JPEG to an RGB uint8 array (None on failure).

    ``fast=False`` (default) decodes with accurate IDCT + fancy chroma
    upsampling, pixel-identical to ``cv2.imread``; ``fast=True`` trades a
    few intensity levels on chroma-subsampled files for throughput.
    """
    lib = load_library()
    if lib is None:
        return None
    buf = ctypes.POINTER(ctypes.c_ubyte)()
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.fcpt_decode_jpeg(
        path.encode(), ctypes.byref(buf), ctypes.byref(h), ctypes.byref(w),
        scale_denom, int(fast),
    )
    if rc != 0:
        return None
    try:
        arr = np.ctypeslib.as_array(buf, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.fcpt_free(buf)
    return arr


def jpeg_dims(path: str) -> tuple[int, int] | None:
    """Full-resolution (height, width) from the JPEG header only."""
    lib = load_library()
    if lib is None:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.fcpt_jpeg_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def decode_batch(
    paths: list[str], scale_denom: int = 1, n_threads: int = 8, fast: bool = False
) -> list[np.ndarray | None]:
    """Decodes many JPEGs in parallel native threads (None per failure)."""
    lib = load_library()
    if lib is None:
        return [None] * len(paths)
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    outs = (ctypes.POINTER(ctypes.c_ubyte) * n)()
    hs = (ctypes.c_int * n)()
    ws = (ctypes.c_int * n)()
    oks = (ctypes.c_int * n)()
    lib.fcpt_decode_batch(
        c_paths, n, outs, hs, ws, oks, scale_denom, n_threads, int(fast)
    )
    results: list[np.ndarray | None] = []
    for i in range(n):
        if oks[i] == 0 and outs[i]:
            arr = np.ctypeslib.as_array(outs[i], shape=(hs[i], ws[i], 3)).copy()
            lib.fcpt_free(outs[i])
            results.append(arr)
        else:
            results.append(None)
    return results


def pick_scale_denom(src_hw: tuple[int, int], target_max: int) -> int:
    """Largest DCT downscale that keeps max(dim) >= the pipeline target."""
    m = max(src_hw)
    for d in (8, 4, 2):
        if m // d >= target_max:
            return d
    return 1


# ---------------------------------------------------------------------------
# The host path: 4:2:0 codecs, the reconstruction and the host warps
# ---------------------------------------------------------------------------

#: Border-mode names → native enum (must match fcpt_io.cpp's map_index).
_BORDER_ENUM = {"constant": 0, "replicate": 1, "reflect": 2, "wrap": 3, "reflect_101": 4}


def _ptr(a: np.ndarray, ctype=ctypes.c_ubyte):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _threads(n_threads: int) -> int:
    return n_threads if n_threads >= 1 else min(4, os.cpu_count() or 1)


def _invert_affine_np(m: np.ndarray) -> np.ndarray:
    """Numpy mirror of ``ops.transform.invert_affine`` (sign-preserving eps)."""
    m = np.asarray(m, np.float32)
    a, b, tx = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    c, d, ty = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    det = a * d - b * c
    det = np.where(np.abs(det) < 1e-12, np.where(det < 0, -1e-12, 1e-12), det)
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return np.stack(
        [np.stack([ia, ib, itx], axis=-1), np.stack([ic, id_, ity], axis=-1)], axis=1
    ).astype(np.float32)


def _packed_size(h: int, w: int) -> int:
    return h * w + 2 * (h // 2) * (w // 2)


def _face_index(img_idx, f: int, n: int) -> np.ndarray:
    """``img_idx`` as contiguous int32 (f,), each in [0, n): the native
    warps index the sources with it unchecked."""
    idx = np.ascontiguousarray(np.asarray(img_idx, np.int32).reshape(-1))
    if idx.shape != (f,) or (f and (idx.min() < 0 or idx.max() >= n)):
        raise ValueError(f"img_idx must hold {f} indices in [0, {n})")
    return idx


def decode_jpeg_yuv420(path: str, scale_denom: int = 1) -> tuple[np.ndarray, int, int] | None:
    """Decodes a 4:2:0 JPEG to its stored planar YCbCr samples.

    Entropy decode and IDCT only: no chroma upsample, no color conversion.
    Returns ``(packed_1d, h, w)``, or None when the file is not plain
    4:2:0 YCbCr (grayscale, 4:4:4, odd dimensions, decode errors) or the
    library is missing; callers then decode to RGB.
    """
    lib = load_library()
    if lib is None:
        return None
    buf = _U8P()
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = lib.fcpt_decode_jpeg_yuv420(path.encode(), ctypes.byref(buf), ctypes.byref(h),
                                     ctypes.byref(w), scale_denom)
    if rc != 0:
        return None
    try:
        arr = np.ctypeslib.as_array(buf, shape=(_packed_size(h.value, w.value),)).copy()
    finally:
        lib.fcpt_free(buf)
    return arr, h.value, w.value


def decode_yuv420_batch(
    paths: list[str], scale_denom: int = 1, n_threads: int = 8
) -> list[tuple[np.ndarray, int, int] | None]:
    """:func:`decode_jpeg_yuv420` of many files in parallel native threads
    (None per file that is unreadable or not plain 4:2:0)."""
    lib = load_library()
    n = len(paths)
    if lib is None or n == 0:
        return [None] * n
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    outs = (_U8P * n)()
    hs, ws, oks = (ctypes.c_int * n)(), (ctypes.c_int * n)(), (ctypes.c_int * n)()
    lib.fcpt_decode_yuv420_batch(c_paths, n, outs, hs, ws, oks, scale_denom, n_threads)
    results: list[tuple[np.ndarray, int, int] | None] = []
    for i in range(n):
        arr = None
        if oks[i] == 0 and outs[i]:
            arr = np.ctypeslib.as_array(outs[i], shape=(_packed_size(hs[i], ws[i]),)).copy()
        if outs[i]:
            lib.fcpt_free(outs[i])
        results.append(None if arr is None else (arr, hs[i], ws[i]))
    return results


def yuv_encoder_available() -> bool:
    """True when the native raw-data JPEG encoder (and the 4:2:0 decoder)
    can be called."""
    return load_library() is not None


def _even_dims(h: int, w: int) -> bool:
    return h >= 2 and w >= 2 and h % 2 == 0 and w % 2 == 0


def encode_jpeg_yuv420(
    path: str, packed: np.ndarray, output_size: tuple[int, int], quality: int = 95
) -> bool:
    """Encodes one packed 4:2:0 row (planes Y|Cb|Cr) of an even (width,
    height) ``output_size`` to a baseline JPEG file.

    ``quality`` is cv2.imwrite's JPEG default, so files compare with the
    RGB path's.  The GIL is released during the encode.  False on failure.
    """
    lib = load_library()
    w, h = output_size
    if lib is None or not _even_dims(h, w):
        return False
    packed = np.ascontiguousarray(packed, np.uint8).reshape(-1)
    ylen, clen = h * w, (h // 2) * (w // 2)
    if packed.size != ylen + 2 * clen:
        return False
    rc = lib.fcpt_jpeg_encode_yuv420(_ptr(packed), _ptr(packed[ylen:]),
                                     _ptr(packed[ylen + clen :]), h, w, quality, path.encode())
    return rc == 0


def encode_jpeg_yuv420_batch(
    paths: list[str],
    packed: np.ndarray,
    output_size: tuple[int, int],
    quality: int = 95,
    n_threads: int = 0,
) -> list[bool]:
    """Encodes many packed 4:2:0 rows in parallel native threads."""
    lib = load_library()
    n = len(paths)
    w, h = output_size
    if lib is None or n == 0 or not _even_dims(h, w):
        return [False] * n
    packed = np.ascontiguousarray(packed, np.uint8).reshape(n, -1)
    if packed.shape[1] != _packed_size(h, w):
        return [False] * n
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    oks = (ctypes.c_int * n)()
    rc = lib.fcpt_encode_yuv420_batch(_ptr(packed), n, h, w, quality, c_paths,
                                      _threads(n_threads), oks)
    if rc != 0:
        return [False] * n
    return [oks[i] == 0 for i in range(n)]


def yuv420_to_rgb_native(
    packed: np.ndarray, h: int, w: int, n_threads: int = 0
) -> np.ndarray | None:
    """Threaded C++ twin of ``ops.yuv.yuv420_to_rgb_np`` (bit-identical:
    the same float32 expression order, fp-contract off); None when the
    library is missing or the shapes are invalid."""
    lib = load_library()
    if lib is None or not _even_dims(h, w):
        return None
    packed = np.ascontiguousarray(packed, np.uint8)
    squeeze = packed.ndim == 1
    if squeeze:
        packed = packed[None]
    if packed.shape[1] != _packed_size(h, w):
        return None
    n = packed.shape[0]
    out = np.empty((n, h, w, 3), np.uint8)
    if lib.fcpt_yuv420_to_rgb(_ptr(packed), n, h, w, _threads(n_threads), _ptr(out)) != 0:
        return None
    return out[0] if squeeze else out


def native_warp_available(border_mode: str = "constant") -> bool:
    """True when :func:`warp_affine_batch_native` can serve this mode."""
    return border_mode in _BORDER_ENUM and load_library() is not None


def warp_affine_batch_native(
    images: np.ndarray,
    matrices: np.ndarray,
    img_idx: np.ndarray,
    output_size: tuple[int, int],
    border_mode: str = "constant",
    windows: np.ndarray | None = None,
    n_threads: int = 0,
    exact: bool = True,
) -> np.ndarray | None:
    """Host warp of F faces to uint8 crops (F, Ho, Wo, C).

    The contract of ``ops.warp.warp_affine_batch`` followed by the uint8
    cast: forward (F, 2, 3) transforms (inverted here), optional int32
    (F, 4) per-face windows, cv2 border semantics.  ``exact=True`` samples
    in float (round half to even); ``exact=False`` in 10-bit fixed point,
    within one intensity level of exact.  The GIL is released for the
    call.  None when the library is missing or the mode is unknown.
    """
    if not native_warp_available(border_mode):
        return None
    lib = load_library()
    images = np.ascontiguousarray(images, np.uint8)
    n, h, w, c = images.shape
    f = int(np.shape(matrices)[0])
    wo, ho = output_size
    out = np.empty((f, ho, wo, c), np.uint8)
    if f == 0:
        return out
    inv = np.ascontiguousarray(_invert_affine_np(matrices).reshape(f, 6))
    idx = _face_index(img_idx, f, n)
    win_ptr = None
    if windows is not None:
        win = np.ascontiguousarray(np.asarray(windows, np.int32))
        if win.shape != (f, 4):
            raise ValueError(f"windows must be (F, 4) = ({f}, 4), got {win.shape}")
        win_ptr = _ptr(win, ctypes.c_int)
    rc = lib.fcpt_warp_affine_u8(
        _ptr(images), n, h, w, c, _ptr(inv, ctypes.c_float), _ptr(idx, ctypes.c_int), win_ptr,
        f, ho, wo, _BORDER_ENUM[border_mode], int(exact), _threads(n_threads), _ptr(out),
    )
    return out if rc == 0 else None


def chroma_conjugate_affine(matrices: np.ndarray) -> np.ndarray:
    """Maps full-resolution affine transforms onto the 4:2:0 chroma grid.

    Chroma sample (i, j) sits at full-resolution pixel-center coordinate
    (2i + 0.5, 2j + 0.5) (JFIF centered siting, the convention of the
    ``ops.yuv`` upsample).  Conjugating by that grid map keeps the linear
    part and shifts the translation: ``t' = (A·[.5, .5] + t − [.5, .5]) / 2``.
    Applies identically to forward and inverse matrices.  float32 (F, 2, 3).
    """
    m = np.asarray(matrices, np.float32)
    a, t = m[:, :, :2], m[:, :, 2]
    half = np.array([0.5, 0.5], np.float32)
    tc = (a @ half + t - half) / 2.0
    return np.concatenate([a, tc[:, :, None]], axis=2).astype(np.float32)


def warp_yuv420_available(border_mode: str = "constant") -> bool:
    """True when :func:`warp_yuv420_batch_native` can serve this mode."""
    return native_warp_available(border_mode)


def warp_yuv420_batch_native(
    packed: np.ndarray,
    src_hw: tuple[int, int],
    matrices: np.ndarray,
    img_idx: np.ndarray,
    output_size: tuple[int, int],
    border_mode: str = "constant",
    n_threads: int = 0,
    exact: bool = False,
) -> np.ndarray | None:
    """Warps faces straight from packed 4:2:0 source rows to packed crop rows.

    Y warps at full resolution; Cb and Cr on the half-resolution chroma
    grid through :func:`chroma_conjugate_affine`, with a 128 (neutral)
    constant border.  Full-size RGB is never made, and the rows feed the
    raw-data encoder.  Crops sit within the RGB path's 4:2:0 band.

    Args:
        packed: (N, L) uint8 source rows.
        src_hw: Source (H, W), both even.
        matrices: Forward (F, 2, 3) full-resolution transforms.
        img_idx: (F,) source row of each face.
        output_size: (Wo, Ho), both even.
        border_mode: A cv2-family border name.
        n_threads: Worker threads (0: up to 4).
        exact: Float sampling instead of 10-bit fixed point.

    Returns:
        (F, Lo) uint8 packed crop rows, or None when the library is missing
        or the shapes are invalid.
    """
    if not native_warp_available(border_mode):
        return None
    lib = load_library()
    h, w = int(src_hw[0]), int(src_hw[1])
    wo, ho = int(output_size[0]), int(output_size[1])
    if not (_even_dims(h, w) and _even_dims(ho, wo)):
        return None
    packed = np.ascontiguousarray(packed, np.uint8)
    if packed.ndim != 2 or packed.shape[1] != _packed_size(h, w):
        return None
    f = int(np.shape(matrices)[0])
    out = np.empty((f, _packed_size(ho, wo)), np.uint8)
    if f == 0:
        return out
    # Conjugate the forward transform, then invert: the JAX package's op
    # order (conjugation and inversion commute exactly, not in float32).
    inv_y = np.ascontiguousarray(_invert_affine_np(matrices).reshape(f, 6))
    inv_c = np.ascontiguousarray(_invert_affine_np(chroma_conjugate_affine(matrices)).reshape(f, 6))
    idx = _face_index(img_idx, f, packed.shape[0])
    rc = lib.fcpt_warp_yuv420(
        _ptr(packed), packed.shape[0], h, w, _ptr(inv_y, ctypes.c_float),
        _ptr(inv_c, ctypes.c_float), _ptr(idx, ctypes.c_int), f, ho, wo,
        _BORDER_ENUM[border_mode], int(exact), _threads(n_threads), _ptr(out),
    )
    return out if rc == 0 else None
