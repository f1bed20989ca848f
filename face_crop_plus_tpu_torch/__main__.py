"""Command-line interface: ``python -m face_crop_plus_tpu_torch -i <dir> …``.

Counterpart of ``face_crop_plus_tpu.__main__`` (``:23-239``) with the same
flags: every Cropper setting is a flag, a JSON config file gives defaults
that explicit flags override (``-c/--config``), negative thresholds mean
"disabled", and filename cleaning runs as a pre-pass into a temp directory
(``-cn``) or in place (``-ci``).  ``-d`` defaults to the card ("auto" means
"cuda"); ``-d cpu`` runs on the CPU.  Flags for paths the port does not
have yet (landmarks, enhancement, parsing, ``-hc 1``, ``-pu 1``,
``-pf 1``) reach ``Cropper`` and raise ``NotImplementedError`` there;
``-si auto`` (multi-GPU sharding) raises here.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Any

from .cropper import Cropper
from .utils.names import clean_names


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="face-crop-plus-tpu-torch",
        description="Face cropping on an NVIDIA GPU (PyTorch/CUDA port).",
    )
    p.add_argument("-c", "--config", type=str, default=None,
                   help="Path to a JSON file with argument defaults; "
                        "command-line flags override entries of the same name.")
    p.add_argument("-i", "--input_dir", type=str,
                   help="Path to input directory with image files.")
    p.add_argument("-o", "--output-dir", type=str,
                   help="Output directory for extracted faces (default: "
                        "input_dir + '_faces').")
    p.add_argument("-cn", "--clean-names", action="store_true",
                   help="Copy files to a temp dir with OS-safe names before "
                        "processing.")
    p.add_argument("-ci", "--clean-names-inplace", action="store_true",
                   help="Rename files to OS-safe names in place (overrides -cn).")
    p.add_argument("-s", "--output-size", type=int, nargs="+", default=[256, 256],
                   help="Crop output size (width height). Default 256 256.")
    p.add_argument("-f", "--output-format", type=str,
                   help="Output image format (e.g. jpg, png); default keeps "
                        "each source extension.")
    p.add_argument("-r", "--resize-size", type=int, nargs="+", default=[1024, 1024],
                   help="Interim batching size (width height). Default 1024 1024.")
    p.add_argument("-ff", "--face-factor", type=float, default=0.65,
                   help="Fraction of the output image occupied by the face.")
    p.add_argument("-st", "--strategy", type=str, default="largest",
                   choices=["all", "best", "largest"],
                   help="Face extraction strategy per image.")
    p.add_argument("-p", "--padding", type=str, default="constant",
                   choices=["constant", "replicate", "reflect", "wrap", "reflect_101"],
                   help="Border mode for out-of-image crop regions.")
    p.add_argument("-a", "--allow-skew", action="store_true",
                   help="Allow full-affine (skewed) alignment.")
    p.add_argument("-l", "--landmarks", type=str,
                   help="Path to a landmarks file (json/csv/txt) to skip detection "
                        "(not ported yet).")
    p.add_argument("-ag", "--attr-groups", type=json.loads,
                   help='JSON dict of attribute groups, e.g. \'{"glasses": [6]}\' '
                        "(not ported yet).")
    p.add_argument("-mg", "--mask-groups", type=json.loads,
                   help='JSON dict of mask groups, e.g. \'{"eyes": [4, 5]}\' '
                        "(not ported yet).")
    p.add_argument("-dt", "--det-threshold", type=float, default=0.6,
                   help="Face detection confidence threshold; negative disables "
                        "detection.")
    p.add_argument("-et", "--enh-threshold", type=float, default=-1,
                   help="Enhancement face-factor threshold; negative disables "
                        "enhancement.")
    p.add_argument("-b", "--batch-size", type=int, default=8,
                   help="Images per processing batch.")
    p.add_argument("-n", "--num-processes", type=int, default=1,
                   help="Host worker threads overlapping I/O with device compute.")
    p.add_argument("-d", "--device", type=str, default="auto",
                   help="Compute device: 'auto' (= 'cuda'), 'cuda', 'cuda:N' or 'cpu'.")
    p.add_argument("-mf", "--max-faces", type=int, default=64,
                   help="Per-image face cap for strategy 'all'.")
    p.add_argument("-pt", "--pre-topk", type=int, default=256,
                   help="Per-image candidate cap before NMS.")
    p.add_argument("-ng", "--no-auto-grow", action="store_true",
                   help="Disable growing pre-topk/max-faces on demand when "
                        "a crowd image overflows them (a binding cap then "
                        "warns).")
    p.add_argument("-mfs", "--max-fused-shapes", type=int, default=4,
                   help="How many distinct source-image shapes may take the "
                        "fused path (device resize, crops from the original "
                        "pixels); other shapes take the staged path.")
    p.add_argument("-w", "--weights-dir", type=str, default=None,
                   help="Directory with converted model weights (.npz or the "
                        "reference .pth files).")
    p.add_argument("-si", "--shard-index", type=str, default=None,
                   help="File sharding: this process's shard index (int); "
                        "'auto' (from a process topology) is not ported yet.")
    p.add_argument("-ns", "--num-shards", type=int, default=None,
                   help="File sharding: total number of shards (each process "
                        "handles files[shard_index::num_shards]).")
    p.add_argument("-se", "--skip-existing", action="store_true",
                   help="Resume an interrupted run: skip source files whose "
                        "crop already exists in the output directory.")
    p.add_argument("-cs", "--crop-source", type=str, default="original",
                   choices=["original", "interim"],
                   help="Pixels the fused path's crops sample: 'original' "
                        "(full source resolution; higher quality) or "
                        "'interim' (detector resolution; reference parity).")
    p.add_argument("-pu", "--pack-upload", type=str, default="auto",
                   choices=["auto", "1", "0"],
                   help="Packed YCbCr 4:2:0 uploads ('1' is not ported yet).")
    p.add_argument("-pf", "--pack-fetch", type=str, default="auto",
                   choices=["auto", "1", "0"],
                   help="Packed YCbCr 4:2:0 crop fetches ('1' is not ported yet).")
    p.add_argument("-hc", "--host-crop", type=str, default="auto",
                   choices=["auto", "1", "0"],
                   help="Warp crops on the host ('1' is not ported yet; the "
                        "port warps on the device).")
    return p


def parse_args(argv: list[str] | None = None) -> dict[str, Any]:
    """Parses CLI args with JSON-config defaults merged underneath.

    The config file (if given) updates the parser's defaults before the
    final parse, so explicit flags always win.
    """
    argv = sys.argv[1:] if argv is None else list(argv)
    parser = build_parser()

    pre, _ = parser.parse_known_args(argv)
    if pre.config:
        with open(pre.config) as f:
            defaults = json.load(f)
        # Only real option defaults: SUPPRESS-default actions (-h) never
        # leak into the kwargs.
        known = {a.dest for a in parser._actions if a.default is not argparse.SUPPRESS}
        parser.set_defaults(**{k: v for k, v in defaults.items() if k in known})

    kwargs = vars(parser.parse_args(argv))
    kwargs.pop("config", None)

    if kwargs.get("input_dir") is None:
        raise ValueError("Input directory must be specified.")

    for key in ("det_threshold", "enh_threshold"):
        if kwargs[key] is not None and kwargs[key] < 0:
            kwargs[key] = None

    kwargs["auto_grow"] = not kwargs.pop("no_auto_grow")

    # The wire and host-crop flags map onto the environment switches the
    # Cropper reads (an explicit flag wins over a pre-set variable).
    for flag, env in (("pack_upload", "FCPT_PACK_UPLOAD"),
                      ("pack_fetch", "FCPT_PACK_FETCH"),
                      ("host_crop", "FCPT_HOST_CROP")):
        val = kwargs.pop(flag)
        if val != "auto":
            os.environ[env] = val

    if kwargs.get("shard_index") == "auto":
        raise NotImplementedError(
            "-si auto (shards from a multi-GPU process topology) is not ported "
            "yet: pass -si <index> -ns <count>"
        )
    if kwargs.get("shard_index") is not None:
        kwargs["shard_index"] = int(kwargs["shard_index"])
    return kwargs


def main(argv: list[str] | None = None):
    kwargs = parse_args(argv)

    # '<dir>/' + '_temp' would nest the scratch dir inside the input dir.
    input_dir = os.path.normpath(kwargs.pop("input_dir"))
    output_dir = kwargs.pop("output_dir")
    needs_clean = kwargs.pop("clean_names")
    is_inplace = kwargs.pop("clean_names_inplace")

    if needs_clean or is_inplace:
        cn_output_dir = None if is_inplace else input_dir + "_temp"
        clean_names(input_dir=input_dir, output_dir=cn_output_dir)

    if needs_clean and not is_inplace:
        output_dir = input_dir + "_faces" if output_dir is None else output_dir
        input_dir += "_temp"

    shard_index = kwargs.pop("shard_index", None)
    num_shards = kwargs.pop("num_shards", None)
    skip_existing = kwargs.pop("skip_existing", False)

    cropper = Cropper(**kwargs)
    cropper.process_dir(
        input_dir,
        output_dir,
        shard_index=shard_index,
        num_shards=num_shards,
        skip_existing=skip_existing,
    )

    if needs_clean and not is_inplace:
        shutil.rmtree(input_dir)


if __name__ == "__main__":
    main()
