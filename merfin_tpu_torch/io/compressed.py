"""Transparent compressed file IO.

Equivalent of the reference's compressedFileReader/Writer (utility
submodule; consumed at merfin-globals.C:34, merfin-variants.C:150,330):
picks gzip/bz2/xz by file suffix, otherwise plain.
"""

from __future__ import annotations

import bz2
import gzip
import io
import lzma
from typing import IO


def open_read(path: str) -> IO[bytes]:
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    if path.endswith(".bz2"):
        return bz2.open(path, "rb")
    if path.endswith(".xz"):
        return lzma.open(path, "rb")
    return open(path, "rb")


def open_read_text(path: str) -> IO[str]:
    return io.TextIOWrapper(open_read(path), encoding="ascii", errors="replace")


def open_write(path: str) -> IO[bytes]:
    if path.endswith(".gz"):
        return gzip.open(path, "wb", compresslevel=1)
    if path.endswith(".bz2"):
        return bz2.open(path, "wb")
    if path.endswith(".xz"):
        return lzma.open(path, "wb")
    return open(path, "wb")


def open_write_text(path: str) -> IO[str]:
    return io.TextIOWrapper(open_write(path), encoding="ascii")
