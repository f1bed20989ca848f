"""Builds the package's CUDA sources into shared libraries at first use.

Each source under ``face_crop_plus_tpu_torch/csrc/`` exports a plain C
interface, is compiled by ``nvcc`` into ``_build/`` (listed in
``.gitignore``) under a name keyed on a hash of the source and the flags,
and is loaded with ``ctypes``.  A rebuilt source gets a new file; an
unchanged one is loaded from the earlier build.  Nothing is built when this
module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

#: No fast math: IEEE division; no FMA contraction, so every product and sum
#: rounds on its own as in the plain PyTorch version.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_source_locks: dict[str, threading.Lock] = {}
#: Per source: {"seconds": build time (0.0 when reused), "log": nvcc output}.
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels of "
            "face_crop_plus_tpu_torch are built from source at first use"
        )
    return path


def load_library(source: str) -> ctypes.CDLL:
    """Builds ``csrc/<source>`` if needed and returns the loaded library.

    Calls for different sources may run at once from several threads (one
    ``nvcc`` each); calls for the same source wait for one build.
    """
    with _lock:
        lock = _source_locks.setdefault(source, threading.Lock())
    with lock:
        if source in _libs:
            return _libs[source]
        src_path = os.path.join(CSRC_DIR, source)
        with open(src_path, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(source)[0]
        out = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
        info = {"seconds": 0.0, "log": ""}
        if not os.path.isfile(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, src_path],
                capture_output=True,
                text=True,
            )
            info = {
                "seconds": time.perf_counter() - t0,
                "log": proc.stdout + proc.stderr,
            }
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source}:\n{info['log']}")
            os.replace(tmp, out)
        build_info[source] = info
        lib = ctypes.CDLL(out)
        _libs[source] = lib
        return lib
