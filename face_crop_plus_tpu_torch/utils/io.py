"""Host-side image I/O: decode, encode, directory reading.

Counterpart of ``face_crop_plus_tpu.utils.io``.  Codecs are host work.  JPEG files decode through the native libjpeg decoder
(:mod:`.native_io`) when it builds; everything else, and every file it
fails on, through OpenCV, then Pillow: the JAX package's order.
Unreadable files warn and are skipped while index alignment is kept; color
images are saved via BGR (OpenCV's convention); masks are single-channel.

Packed 4:2:0 sources: ``read_images(want_packed=True)`` decodes plain
EXIF-upright 4:2:0 JPEGs to their stored planes (:class:`PackedYUVImage`),
which the device reconstructs (:func:`..ops.yuv.yuv420_to_rgb`), and
:func:`imwrite_yuv420` writes packed rows through the raw-data encoder.
"""

from __future__ import annotations

import os
import struct
import warnings
from multiprocessing.pool import ThreadPool

import numpy as np

from . import native_io

try:  # pragma: no cover - environment dependent
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    cv2 = None
    _HAS_CV2 = False

try:  # pragma: no cover - environment dependent
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    Image = None
    _HAS_PIL = False


def codecs() -> dict[str, str | None]:
    """Which codecs this process has: the native decoder's build status and
    the cv2 / PIL versions (None when absent)."""
    pil = None
    if _HAS_PIL:
        import PIL

        pil = PIL.__version__
    return {
        "native_jpeg_decoder": native_io.build_status(),
        "cv2": cv2.__version__ if _HAS_CV2 else None,
        "PIL": pil,
    }


def encoder_available() -> bool:
    """Whether :func:`imwrite` has an encoder (cv2 or PIL)."""
    return _HAS_CV2 or _HAS_PIL


def imread_rgb(path: str) -> np.ndarray | None:
    """Decodes one image file to an RGB uint8 (H, W, 3) array, or None.

    EXIF orientation is applied (``cv2.imread`` semantics); the PIL
    fallback transposes explicitly to match.
    """
    if _HAS_CV2:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            return None
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if _HAS_PIL:
        try:
            from PIL import ImageOps

            with Image.open(path) as im:
                return np.asarray(ImageOps.exif_transpose(im).convert("RGB"))
        except Exception:  # noqa: BLE001 - any decoder error means unreadable
            return None
    raise RuntimeError("No image decoding backend available (cv2 or PIL).")


def _tiff_orientation(d: bytes) -> int:
    """Orientation from a TIFF block (EXIF APP1 payload past 'Exif\\0\\0')."""
    bo = d[:2]
    if bo == b"II":
        u16, u32 = "<H", "<I"
    elif bo == b"MM":
        u16, u32 = ">H", ">I"
    else:
        return 1
    (ifd_off,) = struct.unpack(u32, d[4:8])
    (count,) = struct.unpack(u16, d[ifd_off : ifd_off + 2])
    for e in range(count):
        ent = ifd_off + 2 + 12 * e
        (tag,) = struct.unpack(u16, d[ent : ent + 2])
        if tag != 0x0112:
            continue
        # Orientation is normally SHORT (3), but writers emitting LONG (4)
        # exist; any other type is unparseable rather than misread.
        (typ,) = struct.unpack(u16, d[ent + 2 : ent + 4])
        (cnt,) = struct.unpack(u32, d[ent + 4 : ent + 8])
        if cnt != 1:
            return 1
        if typ == 3:
            (val,) = struct.unpack(u16, d[ent + 8 : ent + 10])
        elif typ == 4:
            (val,) = struct.unpack(u32, d[ent + 8 : ent + 12])
        else:
            return 1
        return val if 1 <= val <= 8 else 1
    return 1


def jpeg_exif_orientation(path: str) -> int:
    """Reads the EXIF orientation tag (1-8) from a JPEG header, 1 on any
    parse failure.

    The native libjpeg decoder ignores EXIF, so its output is transposed
    to keep pixel parity with ``cv2.imread`` (which auto-orients).  Segment
    headers are streamed with seeks, so an APP1 after large APPn segments
    is still found; non-Exif APP1 segments (XMP) are skipped.
    """
    try:
        with open(path, "rb") as f:
            if f.read(2) != b"\xff\xd8":
                return 1
            while True:
                b = f.read(1)
                if not b or b[0] != 0xFF:
                    return 1
                m = f.read(1)
                while m == b"\xff":  # fill bytes before a marker
                    m = f.read(1)
                if not m:
                    return 1
                marker = m[0]
                if marker == 0x01 or 0xD0 <= marker <= 0xD9:
                    continue  # standalone markers carry no length
                if marker == 0xDA:  # start of scan: no Exif APP1 seen
                    return 1
                ln = f.read(2)
                if len(ln) < 2:
                    return 1
                (seg_len,) = struct.unpack(">H", ln)
                if seg_len < 2:
                    return 1
                if marker == 0xE1:
                    payload = f.read(seg_len - 2)
                    if payload[:6] == b"Exif\x00\x00":
                        return _tiff_orientation(payload[6:])
                    continue  # other APP1 (e.g. XMP): keep scanning
                f.seek(seg_len - 2, 1)
    except (OSError, struct.error):
        return 1


def apply_exif_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Transposes a decoded raster upright per its EXIF orientation (the
    transforms PIL's ``exif_transpose`` / cv2's auto-orient apply)."""
    if orientation == 2:
        return np.ascontiguousarray(img[:, ::-1])
    if orientation == 3:
        return np.ascontiguousarray(img[::-1, ::-1])
    if orientation == 4:
        return np.ascontiguousarray(img[::-1, :])
    if orientation == 5:
        return np.ascontiguousarray(img.transpose(1, 0, 2))
    if orientation == 6:
        return np.ascontiguousarray(img.transpose(1, 0, 2)[:, ::-1])
    if orientation == 7:
        return np.ascontiguousarray(img.transpose(1, 0, 2)[::-1, ::-1])
    if orientation == 8:
        return np.ascontiguousarray(img.transpose(1, 0, 2)[::-1, :])
    return img


def imwrite(path: str, image: np.ndarray) -> bool:
    """Encodes an RGB (H, W, 3) or grayscale (H, W) uint8 array to a file.

    The encode goes to a temp file in the destination directory followed by
    an atomic rename, so a crash mid-write never leaves a truncated image:
    a file's existence is its completeness marker for
    ``process_dir(skip_existing=True)``.  Returns False when the encode
    fails (cv2's convention).
    """
    image = np.ascontiguousarray(image)
    base, ext = os.path.splitext(path)
    tmp = f"{base}.tmp-{os.getpid()}{ext}"
    try:
        if _HAS_CV2:
            if image.ndim == 3:
                image = cv2.cvtColor(image, cv2.COLOR_RGB2BGR)
            if not cv2.imwrite(tmp, image):
                return False
        elif _HAS_PIL:
            try:
                Image.fromarray(image).save(tmp)
            except (OSError, ValueError, KeyError):
                return False
        else:
            raise RuntimeError("No image encoding backend available (cv2 or PIL).")
        os.replace(tmp, path)
        return True
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:  # pragma: no cover
                pass


def imwrite_yuv420(path: str, packed: np.ndarray, output_size: tuple[int, int]) -> bool:
    """Writes one packed YCbCr 4:2:0 row of an (width, height) crop as a JPEG.

    The rows come from :func:`..ops.yuv.rgb_to_yuv420` (or the host warp
    of packed sources); the native raw-data encoder takes them with cv2's
    JPEG defaults (quality 95, 4:2:0).  The same temp file and atomic
    rename as :func:`imwrite`.  False when the native encoder is missing or
    the encode fails.
    """
    base, ext = os.path.splitext(path)
    tmp = f"{base}.tmp-{os.getpid()}{ext}"
    try:
        if not native_io.encode_jpeg_yuv420(tmp, packed, output_size):
            return False
        os.replace(tmp, path)
        return True
    finally:
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:  # pragma: no cover
                pass


class PackedYUVImage:
    """A JPEG source decoded to its stored YCbCr 4:2:0 planes (host side).

    ``packed`` is the (L,) row of planes Y|Cb|Cr at 1.5 bytes a pixel.
    ``shape`` serves the Cropper's shape bookkeeping, ``group_key`` keeps
    packed sources out of RGB groups of the same dimensions, and
    :meth:`to_rgb` gives the numpy twin of the device reconstruction.
    """

    __slots__ = ("packed", "h", "w")

    def __init__(self, packed: np.ndarray, h: int, w: int):
        self.packed = packed
        self.h = h
        self.w = w

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.h, self.w, 3)

    @property
    def group_key(self):
        """Fused-group key: packed sources never mix with RGB arrays."""
        return ("yuv420", self.h, self.w)

    def to_rgb(self) -> np.ndarray:
        from ..ops.yuv import yuv420_to_rgb_np

        return yuv420_to_rgb_np(self.packed, self.h, self.w)


def unpack_images(images: list) -> list:
    """Replaces any :class:`PackedYUVImage` entries with RGB arrays."""
    return [im.to_rgb() if isinstance(im, PackedYUVImage) else im for im in images]


def _pool_map(fn, items: list, n_threads: int) -> list:
    """``map`` over a thread pool when there is more than one item."""
    if len(items) > 1 and n_threads > 1:
        with ThreadPool(min(n_threads, len(items))) as pool:
            return pool.map(fn, items)
    return [fn(x) for x in items]


def read_images(
    file_names: list[str],
    input_dir: str,
    target_max: int | None = None,
    n_threads: int = 8,
    want_packed: bool = False,
) -> tuple[list[np.ndarray], np.ndarray]:
    """Reads a batch of images from a directory.

    Unreadable images produce a warning and are dropped; the returned file
    name array only holds names of images that decoded.

    JPEG files decode through the native multithreaded decoder when it is
    available; with ``target_max`` set, oversized sources decode directly
    at 1/2–1/8 scale in the DCT domain, never below ``target_max``.
    Non-JPEG files and native-decode failures go to cv2/PIL, also decoded
    in parallel (both release the GIL in their codecs).  Native decode
    matches ``cv2.imread`` (accurate IDCT, fancy chroma upsampling, EXIF
    transpose); ``FCPT_FAST_DECODE=1`` trades a few intensity levels on
    chroma-subsampled files for throughput.

    With ``want_packed``, plain 4:2:0 JPEGs that are EXIF-upright and
    decode at full scale decode to :class:`PackedYUVImage` (entropy decode
    and IDCT only); rotated files, other samplings, files decoded at a
    reduced DCT scale and non-JPEG files still decode to RGB.

    Returns:
        Tuple of a list of RGB uint8 (H, W, 3) arrays (and, with
        ``want_packed``, :class:`PackedYUVImage` entries) and the
        corresponding (N,) file name array.
    """
    fast = os.environ.get("FCPT_FAST_DECODE", "0") == "1"
    paths = [os.path.join(input_dir, f) for f in file_names]
    results: list[np.ndarray | None] = [None] * len(paths)

    native_ok: set[int] = set()
    jpg_ids = [i for i, p in enumerate(paths) if p.lower().endswith((".jpg", ".jpeg"))]
    if jpg_ids and native_io.available():
        by_denom: dict[int, list[int]] = {1: jpg_ids}
        if target_max:
            # Group by the DCT scale chosen from header dims.
            all_dims = _pool_map(native_io.jpeg_dims, [paths[i] for i in jpg_ids], n_threads)
            by_denom = {}
            for i, dims in zip(jpg_ids, all_dims):
                denom = native_io.pick_scale_denom(dims, target_max) if dims else 1
                by_denom.setdefault(denom, []).append(i)
        for denom, ids in by_denom.items():
            if want_packed and denom == 1:
                # Rotated files keep the RGB path (orientation transforms
                # on subsampled planes are lossy); the header scan runs
                # before any decode, so no file is entropy-decoded twice.
                # Files that decode at a reduced DCT scale keep it too: the
                # native planar decoder's chroma is wrong there (luma is
                # right), where the JAX package packs them all the same.
                orients = _pool_map(jpeg_exif_orientation, [paths[i] for i in ids], n_threads)
                upright = [i for i, o in zip(ids, orients) if o == 1]
                ids = [i for i, o in zip(ids, orients) if o != 1]
                packed = native_io.decode_yuv420_batch(
                    [paths[i] for i in upright], scale_denom=denom, n_threads=n_threads
                )
                for i, res in zip(upright, packed):
                    if res is None:
                        ids.append(i)
                    else:
                        results[i] = PackedYUVImage(*res)
                        native_ok.add(i)
            decoded = native_io.decode_batch(
                [paths[i] for i in ids], scale_denom=denom, n_threads=n_threads, fast=fast
            )
            for i, img in zip(ids, decoded):
                if img is not None:
                    results[i] = apply_exif_orientation(img, jpeg_exif_orientation(paths[i]))
                    native_ok.add(i)

    fallback_ids = [i for i in range(len(paths)) if i not in native_ok]
    for i, img in zip(fallback_ids, _pool_map(imread_rgb, [paths[i] for i in fallback_ids],
                                              n_threads)):
        results[i] = img

    images, kept = [], []
    for i, path in enumerate(paths):
        if results[i] is None:
            warnings.warn(f"Could not read the image {path}")
            continue
        images.append(results[i])
        kept.append(i)
    return images, np.array(file_names)[kept]
