"""ctypes bindings for the native batch JPEG decoder, decode half only.

Counterpart of ``face_crop_plus_tpu.utils.native_io`` (``:36-328``): the
repo's ``native/fcpt_io.cpp`` provides multithreaded libjpeg decoding with
DCT-domain downscaling (1/2, 1/4, 1/8).  The port compiles that source with
``g++ … -ljpeg`` into ``face_crop_plus_tpu_torch/_build/`` (listed in
``.gitignore``) at first use, never writes into ``native/`` and never loads
``native/libfcpt_io.so``, and binds only the decode symbols.  When the
compiler or libjpeg is missing, :func:`load_library` returns None, and
:func:`build_status` says why; callers then decode with cv2/PIL, the JAX
package's own order.

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
