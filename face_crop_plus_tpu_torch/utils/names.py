"""OS-safe filename cleaning (the CLI's ``-cn``/``-ci`` pre-pass).

Counterpart of ``face_crop_plus_tpu.utils.names.clean_names`` (``:34``):
transliterate non-ASCII names, strip reserved characters, truncate to a
path budget and deduplicate case-insensitively with ``-N`` suffixes.  Uses
``unidecode`` when installed, otherwise an NFKD-based ASCII
transliteration.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import unicodedata

try:  # pragma: no cover - optional dependency
    import unidecode as _unidecode

    def _to_ascii(s: str) -> str:
        return _unidecode.unidecode(s)

except ImportError:  # pragma: no cover

    def _to_ascii(s: str) -> str:
        out = unicodedata.normalize("NFKD", s)
        return out.encode("ascii", "ignore").decode("ascii")


DEFAULT_EXCLUDE = set("\00!@#$%^&*?={}:;'<>,.?/\\|" + '"')


def clean_names(
    input_dir: str,
    output_dir: str | None = None,
    max_chars: int = 250,
    exclude: set | None = None,
    desc: str | None = "Cleaning file names",
):
    """Renames (in place) or copies files in a directory to OS-safe names.

    Args:
        input_dir: Directory containing only files to process.
        output_dir: If given, cleaned copies are written here; otherwise
            files are renamed in place.
        max_chars: Maximum number of characters per file *path*.
        exclude: Characters to strip from the base name (not the extension).
        desc: Progress bar description; None disables the progress bar.

    Raises:
        RuntimeError: If the directory path leaves fewer than 6 characters
            of name budget.
    """
    if exclude is None:
        exclude = DEFAULT_EXCLUDE

    # Budget against the directory the files will actually land in.
    dest_dir = input_dir if output_dir is None else output_dir
    max_chars -= len(dest_dir)
    filename_counts = collections.defaultdict(int)  # base name -> last suffix
    taken: set[str] = set()  # names assigned this run (case-insensitive)

    if max_chars <= 5:
        raise RuntimeError(
            f"Directory path length is too long ({len(dest_dir)}) Either "
            f"reduce the length of the directory name or increase `max_chars`."
        )

    if output_dir is not None:
        os.makedirs(output_dir, exist_ok=True)

    filenames = os.listdir(input_dir)
    # Names not yet processed, as a multiset of lowercased keys: an in-place
    # rename must never land on one of these (os.rename would replace the
    # other file's contents on POSIX), and two case-differing files share a
    # key until both are processed.
    pending = collections.Counter(f.lower() for f in filenames)

    if desc is not None:
        try:
            import tqdm

            filenames = tqdm.tqdm(filenames, desc=desc)
        except ImportError:  # pragma: no cover
            pass

    for filename in filenames:
        key = filename.lower()
        if pending[key] <= 1:
            del pending[key]
        else:
            pending[key] -= 1
        name, ext = os.path.splitext(filename)

        if not name.isascii():
            name = _to_ascii(name)

        bad = set(name) & exclude
        if bad:
            name = re.sub(f"[{re.escape(''.join(bad))}]", "", name)

        # Truncate the *cleaned* name: transliteration can lengthen it.
        if len(name + ext) > max_chars:
            name = name[: max_chars - len(ext)]

        # Case-insensitive dedup: the first claimant keeps the plain name,
        # later ones get -1, -2, ... in encounter order.  A name is not free
        # when already assigned this run or, for in-place renames, still
        # held by a not-yet-processed file; only the colliding file is
        # suffixed.
        def _free(candidate: str) -> bool:
            k = (candidate + ext).lower()
            if k in taken:
                return False
            return not (output_dir is None and k in pending)

        if not _free(name):
            i = filename_counts[(name + ext).lower()] + 1
            while not _free(f"{name}-{i}"):
                i += 1
            filename_counts[(name + ext).lower()] = i
            name = f"{name}-{i}"
        taken.add((name + ext).lower())

        if output_dir is not None:
            shutil.copy(
                os.path.join(input_dir, filename),
                os.path.join(output_dir, name + ext),
            )
        elif name + ext != filename:
            os.rename(
                os.path.join(input_dir, filename),
                os.path.join(input_dir, name + ext),
            )
