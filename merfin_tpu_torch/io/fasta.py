"""FASTA/FASTQ sequence input — streaming, bounded-memory.

Equivalent of the reference's dnaSeqFile/dnaSeq (consumed at merfin.C:38,45
and merfin-variants.C:208): sequential sequence loading with transparent
compression, identifiers cut at the first whitespace, and region copy.
Like dnaSeqFile::loadSequence the whole file is never materialized: bytes
stream through fixed windows (native C++ state machine when available,
pure-Python fallback otherwise), so a 100+ GB FASTQ.gz parses in O(window)
memory.  Multi-line FASTQ, CRLF and truncated trailing records are
tolerated (merfin.C:38 tolerance contract).

Three access layers:
  * ``__iter__``          -> whole Sequence (raw bytes; variants mode needs
                             exact region copies)
  * ``iter_coded()``      -> whole CodedSequence (2-bit codes; hist/dump)
  * ``iter_packed(k)``    -> fixed-window packed code blocks with k-1
                             separators/overlap (the counter's data plane;
                             memory stays bounded even for one huge record)
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

from merfin_tpu_torch.io.compressed import open_read
from merfin_tpu_torch.kcore.pack import encode_bases
from merfin_tpu_torch.utils.spans import span

DEFAULT_WINDOW = 1 << 26   # 64 MB windows through the parser
PAD_CODE = 4


@dataclasses.dataclass
class Sequence:
    ident: str            # name up to first whitespace (dnaSeq::ident())
    bases: bytes          # raw sequence bytes, original case

    def __len__(self) -> int:
        return len(self.bases)

    @property
    def length(self) -> int:
        return len(self.bases)

    def codes(self) -> np.ndarray:
        """2-bit codes with 4 for non-ACGT."""
        return encode_bases(self.bases)

    def copy_region(self, start: int, end: int) -> bytes | None:
        """dnaSeq::copy(buf, start, end, true): [start, end) slice.

        Returns None when the region is invalid, triggering the caller's
        PANIC-skip (merfin-variants.C:208-211).
        """
        if start >= end or end > len(self.bases):
            return None
        return self.bases[start:end]


@dataclasses.dataclass
class CodedSequence:
    """A sequence already in 2-bit code form (native fast path)."""

    ident: str
    _codes: np.ndarray

    @property
    def length(self) -> int:
        return int(self._codes.shape[0])

    def codes(self) -> np.ndarray:
        return self._codes


class PyStreamParser:
    """Pure-Python fallback with the native StreamParser's contract.

    feed(block, is_final) -> (names, codes, piece_offsets, piece_new).
    Piece boundaries may differ from the native parser (it cuts at window
    edges mid-line; this one carries partial lines) but concatenated
    record codes and names are identical.

    ``raw=True`` keeps original sequence bytes (uint8 char codes, case
    preserved) instead of 2-bit codes — the variants path needs exact
    region copies; one state machine serves both (no third parser).
    """

    def __init__(self, raw: bool = False):
        self._encode = (lambda s: np.frombuffer(s, dtype=np.uint8)) if raw \
            else encode_bases
        self._carry = b""
        self._fastq: bool | None = None
        self._phase = "start"          # start | seq | qual
        self._seq_len = 0
        self._qual_seen = 0
        self._open = False             # a record is open
        self._piece_is_new = False

    def feed(self, block: bytes, is_final: bool = False):
        data = self._carry + block
        if is_final:
            self._carry = b""
            lines = data.split(b"\n")
            if lines and lines[-1] == b"":
                lines.pop()
        else:
            cut = data.rfind(b"\n")
            if cut < 0:
                self._carry = data
                lines = []
            else:
                self._carry = data[cut + 1:]
                lines = data[:cut].split(b"\n")

        names: list[str] = []
        parts: list[np.ndarray] = []          # all codes this feed
        offsets: list[int] = [0]
        flags: list[bool] = []
        cur_len = 0                            # codes in the open piece

        def close_piece():
            nonlocal cur_len
            flags.append(self._piece_is_new)
            offsets.append(offsets[-1] + cur_len)
            self._piece_is_new = False
            cur_len = 0

        def open_record(header: bytes):
            word = header[1:].split()
            names.append(word[0].decode("ascii", "replace") if word else "")
            self._open = True
            self._piece_is_new = True
            self._seq_len = 0
            self._qual_seen = 0

        for line in lines:
            line = line.rstrip(b"\r")
            if self._phase == "start":
                if not line.strip():
                    continue
                if self._fastq is None:
                    if line[:1] == b">":
                        self._fastq = False
                    elif line[:1] == b"@":
                        self._fastq = True
                    else:
                        raise ValueError("not FASTA or FASTQ")
                want = b"@" if self._fastq else b">"
                if line[:1] != want:
                    raise ValueError("not FASTA or FASTQ")
                open_record(line)
                self._phase = "seq"
            elif self._phase == "seq":
                if not self._fastq and line[:1] == b">":
                    close_piece()
                    self._open = False
                    open_record(line)
                elif self._fastq and line[:1] == b"+":
                    self._phase = "qual"
                    if self._qual_seen >= self._seq_len:
                        close_piece()
                        self._open = False
                        self._phase = "start"
                else:
                    seq = line.replace(b" ", b"").replace(b"\t", b"")
                    if seq:
                        parts.append(self._encode(seq))
                        cur_len += len(seq)
                        self._seq_len += len(seq)
            else:  # qual
                self._qual_seen += len(line)
                if self._qual_seen >= self._seq_len:
                    close_piece()
                    self._open = False
                    self._phase = "start"

        if self._open and (cur_len or self._piece_is_new):
            close_piece()
        codes = (np.concatenate(parts) if parts
                 else np.zeros(0, dtype=np.uint8))
        return (names, codes, np.asarray(offsets, dtype=np.int64),
                np.asarray(flags, dtype=bool))


def _make_stream_parser():
    from merfin_tpu_torch import native

    try:
        return native.StreamParser()
    except Exception:
        return PyStreamParser()


class SeqFile:
    """Streaming FASTA/FASTQ reader (gz/bz2/xz transparent)."""

    def __init__(self, path: str):
        self.path = path

    def _stream(self, window: int):
        """Yield (names, codes, piece_offsets, piece_new) per byte window."""
        parser = _make_stream_parser()
        with open_read(self.path) as f:
            first = True
            while True:
                block = f.read(window)
                if not block:
                    if first:
                        return
                    out = parser.feed(b"", is_final=True)
                    if len(out[3]):
                        yield out
                    return
                first = False
                try:
                    out = parser.feed(block, is_final=False)
                except ValueError:
                    raise ValueError(f"{self.path}: not FASTA or FASTQ")
                if len(out[3]):
                    yield out

    def iter_coded(self, window: int | None = None):
        """Yield whole sequences with .ident/.codes(), streaming.

        Memory: O(window + largest single sequence) — the dnaSeqFile
        contract (one sequence held at a time, merfin.C:30-53).
        """
        cur_name: str | None = None
        parts: list[np.ndarray] = []
        for names, codes, offsets, flags in self._stream(window or DEFAULT_WINDOW):
            ni = 0
            for i in range(len(flags)):
                if flags[i]:
                    if cur_name is not None:
                        yield CodedSequence(cur_name, _cat(parts))
                    cur_name = names[ni]
                    ni += 1
                    parts = []
                parts.append(codes[offsets[i]: offsets[i + 1]])
        if cur_name is not None:
            yield CodedSequence(cur_name, _cat(parts))

    def iter_packed(self, k: int, window: int | None = None):
        """Yield packed code blocks: records separated by k-1 PAD codes,
        records spanning windows carried with a k-1 code overlap.  Every
        length-k window of every record appears in exactly one block (and
        no spurious windows exist) — treat each block as an independent
        sequence for k-mer counting.  Memory is O(window) regardless of
        record sizes: the counter's genome-scale data plane.
        """
        carry = np.zeros(0, dtype=np.uint8)
        for _, codes, offsets, flags in self._stream(window or DEFAULT_WINDOW):
            n = len(flags)
            lengths = np.diff(offsets)
            gaps = np.where(flags, np.int64(k - 1), np.int64(0))
            lead = 0 if flags[0] else carry.shape[0]
            # output start of each piece
            piece_out = lead + np.cumsum(gaps) + (offsets[:-1] - 0)
            total_out = int(piece_out[-1] + lengths[-1])
            out = np.full(total_out, PAD_CODE, dtype=np.uint8)
            if lead:
                out[:lead] = carry
            if offsets[-1]:
                seq_of = np.repeat(np.arange(n, dtype=np.int64), lengths)
                shift = piece_out - offsets[:-1]
                out[np.arange(int(offsets[-1]), dtype=np.int64)
                    + shift[seq_of]] = codes[: offsets[-1]]
            carry = out[-(k - 1):].copy() if out.shape[0] >= k - 1 \
                else out.copy()
            yield CodedSequence("__packed__", out)


    def __iter__(self) -> Iterator[Sequence]:
        """Whole sequences with raw bases (original case), streaming."""
        yield from _iter_bytes(self.path)


def _cat(parts: list[np.ndarray]) -> np.ndarray:
    if len(parts) == 1:
        return parts[0]
    if not parts:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(parts)


def _joined(name: str, parts: list[np.ndarray]) -> Sequence:
    with span("fasta.parse"):
        return Sequence(name, _cat(parts).tobytes())


def _iter_bytes(path: str, window: int = DEFAULT_WINDOW) -> Iterator[Sequence]:
    """Streaming whole-record reader keeping raw bytes (for region copy)
    — drives PyStreamParser in raw mode (ONE state machine, no third
    parser to keep in sync).  The read, parse and join of each window
    are the span "fasta.parse" (counts: the sequence bytes, and the
    windows under the parser's kind), never the time it is suspended."""
    parser = PyStreamParser(raw=True)
    cur_name: str | None = None
    parts: list[np.ndarray] = []
    with open_read(path) as f:
        while True:
            with span("fasta.parse") as h:
                block = f.read(window)
                try:
                    names, raw, offsets, flags = parser.feed(
                        block, is_final=not block)
                except ValueError:
                    raise ValueError(f"{path}: not FASTA or FASTQ")
                h.count("bytes", raw.shape[0])
                h.count("python", 1)
            ni = 0
            for i in range(len(flags)):
                if flags[i]:
                    if cur_name is not None:
                        yield _joined(cur_name, parts)
                    cur_name = names[ni]
                    ni += 1
                    parts = []
                parts.append(raw[offsets[i]: offsets[i + 1]])
            if not block:
                if cur_name is not None:
                    yield _joined(cur_name, parts)
                return
