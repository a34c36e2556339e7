"""File readers of the data layer with the standard library and NumPy.

The JAX package reads its tables with pandas and its slides with PIL or
OpenCV; a machine with only numpy, scipy and torch has none of those, so the
port reads them itself:

* ``read_table``: a TSV/CSV (gzipped by its ``.gz`` suffix) with the
  semantics of ``pandas.read_csv`` that the readers rely on: the first line
  a header (or none), an index column, empty header names as "Unnamed: i",
  duplicate names made unique as "name.1", "name.2", ..., rows shorter than
  the header filled with NaN, pandas' NA strings read as NaN, and a row one
  field longer than the header giving the index (pandas' implicit index);
* ``open_text`` / ``gzip_in_place``: ``.gz`` files by name;
* ``read_ppm`` / ``write_ppm``: binary PPM (P6, maxval 255), detected by its
  magic bytes, not its name, as PIL and OpenCV detect formats;
* ``load_slide``: an RGB slide; PPM natively, every other format through PIL,
  imported when needed (``ImportError`` naming the package if absent).
"""

from __future__ import annotations

import csv
import dataclasses
import gzip
import os
import shutil
from typing import Dict, List, Optional, Sequence

import numpy as np

# pandas.read_csv's default NA strings
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})


def _dedup(names: Sequence[str]) -> List[str]:
    """pandas' renaming of duplicate column names: "a", "a.1", "a.2", ..."""
    names = list(names)
    counts: Dict[str, int] = {}
    for i, col in enumerate(names):
        cur = counts.get(col, 0)
        while cur > 0:
            counts[col] = cur + 1
            col = f"{col}.{cur}"
            cur = counts.get(col, 0)
        names[i] = col
        counts[col] = cur + 1
    return names


@dataclasses.dataclass(frozen=True)
class Table:
    """A parsed table: column names, the index (or None) and the data rows
    as strings, converted on request."""

    columns: List[str]
    rows: List[List[str]]
    index: Optional[List[str]] = None

    def __len__(self) -> int:
        return len(self.rows)

    def col(self, name: str) -> int:
        try:
            return self.columns.index(name)
        except ValueError:
            raise KeyError(name) from None

    def strings(self, name: str) -> np.ndarray:
        """One column as an object array of str, NA strings as NaN."""
        j = self.col(name)
        return np.asarray([np.nan if r[j] in NA_STRINGS else r[j] for r in self.rows],
                          dtype=object)

    def numeric(self, names: Optional[Sequence[str]] = None) -> np.ndarray:
        """(rows, len(names)) float64 of the named columns (all by default);
        NA strings read as NaN."""
        if names is None:
            cols, fields = range(len(self.columns)), self.rows
        else:
            cols = [self.col(n) for n in names]
            fields = [[r[j] for j in cols] for r in self.rows]
        try:
            return np.asarray(fields, dtype=np.str_).reshape(len(fields), len(cols)).astype(
                np.float64)
        except ValueError:  # NA strings: convert field by field
            return np.asarray([[np.nan if f in NA_STRINGS else float(f) for f in row]
                               for row in fields], dtype=np.float64).reshape(len(fields),
                                                                             len(cols))


def open_text(path: str):
    """A text file for reading, gunzipped when its name ends in ``.gz``."""
    if path.endswith(".gz"):
        return gzip.open(path, "rt", newline="", encoding="utf-8")
    return open(path, newline="", encoding="utf-8")


def read_table(path: str, sep: str = "\t", index_col: Optional[int] = None,
               header: bool = True) -> Table:
    """``pandas.read_csv(path, sep=sep, index_col=index_col, header=0 or
    None)`` as a ``Table`` (``index_col`` None or 0). Without a header the
    columns are named "0", "1", ..."""
    with open_text(path) as f:
        lines = [row for row in csv.reader(f, delimiter=sep) if row]
    if header:
        names, body = lines[0], lines[1:]
    else:
        width = max((len(r) for r in lines), default=0)
        names, body = [str(j) for j in range(width)], lines
    implicit = bool(body) and len(body[0]) == len(names) + 1
    names = _dedup([n if n != "" else f"Unnamed: {j}" for j, n in enumerate(names)])
    if implicit:  # the first field of each row is the index, the header names the rest
        columns, take_index = names, True
    elif index_col == 0:
        columns, take_index = names[1:], True
    elif index_col is None:
        columns, take_index = names, False
    else:
        raise ValueError(f"index_col must be None or 0, got {index_col!r}")
    width = len(columns) + take_index
    rows, index = [], [] if take_index else None
    for r in body:
        if len(r) > width:
            raise ValueError(f"{path}: a row of {len(r)} fields under {width} names")
        r = r + [""] * (width - len(r))
        if take_index:
            index.append(r[0])
            r = r[1:]
        rows.append(r)
    return Table(columns=columns, rows=rows, index=index)


def gzip_in_place(path: str) -> str:
    """Replace a file by its gzipped copy ``path + ".gz"``; returns the new path."""
    with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
        shutil.copyfileobj(f, g)
    os.unlink(path)
    return path + ".gz"


# ------------------------------------------------------------------ slides --

_PPM_MAGIC = b"P6"


def _ppm_header(head: bytes):
    """(width, height, maxval, data offset) of a P6 header, or None."""
    if not head.startswith(_PPM_MAGIC):
        return None
    tokens, pos = [], len(_PPM_MAGIC)
    while len(tokens) < 3:
        while pos < len(head) and head[pos:pos + 1].isspace():
            pos += 1
        if head[pos:pos + 1] == b"#":  # a comment runs to the end of its line
            while pos < len(head) and head[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(head) and head[pos:pos + 1].isdigit():
            pos += 1
        if pos == start or pos >= len(head):
            return None
        tokens.append(int(head[start:pos]))
    if not head[pos:pos + 1].isspace():
        return None
    return tokens[0], tokens[1], tokens[2], pos + 1  # one whitespace byte ends the header


def read_ppm(path: str) -> Optional[np.ndarray]:
    """(H, W, 3) uint8 RGB of a binary PPM with maxval 255, or None when the
    file is no such PPM."""
    with open(path, "rb") as f:
        head = f.read(4096)
    parsed = _ppm_header(head)
    if parsed is None or parsed[2] != 255:
        return None
    w, h, _, offset = parsed
    data = np.fromfile(path, dtype=np.uint8, count=h * w * 3, offset=offset)
    if data.size != h * w * 3:
        raise ValueError(f"{path}: PPM of {w}x{h} holds {data.size} of {h * w * 3} bytes")
    return data.reshape(h, w, 3)


def write_ppm(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as binary PPM."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"PPM holds (H, W, 3) images, got {img.shape}")
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        img.tofile(f)


def load_slide(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB slide: binary PPM read natively, any other format
    through PIL (``Image.open(path).convert("RGB")``, truncated files and
    huge images allowed, as the JAX package reads them)."""
    img = read_ppm(path)
    if img is not None:
        return img
    try:
        from PIL import Image, ImageFile
    except ImportError as e:
        raise ImportError(f"reading {os.path.basename(path)} needs Pillow (PIL): only "
                          "binary PPM slides are read without it") from e
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    Image.MAX_IMAGE_PIXELS = None
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))
