"""2-bit k-mer packing and canonicalization (host/numpy side).

Replaces the reference's rolling ``kmerIterator`` (consumed at
merfin-dump.C:44-61, varMer.C:76): instead of a scalar rolling window, the
whole sequence chunk is vectorized — every k-mer start position produces a
packed uint64 forward mer, reverse-complement mer, and a validity flag
(window free of non-ACGT bases).

Encoding: A=0, C=1, G=2, T=3 (alphabetical; case-insensitive), anything
else = 4 (invalid).  Forward mers pack the first base into the most
significant bits so that integer order == lexicographic ACGT order.
Canonical mer = min(fmer, rmer), stored once, like a canonical meryl DB.

The torch device equivalents live in merfin_tpu_torch/ops/.
"""

from __future__ import annotations

import numpy as np

# Base -> 2-bit code lookup table over raw bytes.  4 marks invalid.
_CODE = np.full(256, 4, dtype=np.uint8)
for i, b in enumerate(b"ACGT"):
    _CODE[b] = i
for i, b in enumerate(b"acgt"):
    _CODE[b] = i

CODE_A, CODE_C, CODE_G, CODE_T, CODE_N = 0, 1, 2, 3, 4


def encode_bases(seq: bytes | str | np.ndarray) -> np.ndarray:
    """Encode a DNA sequence into uint8 codes (0-3 = ACGT, 4 = invalid)."""
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    if isinstance(seq, (bytes, bytearray)):
        raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    else:
        raw = np.asarray(seq, dtype=np.uint8)
    return _CODE[raw]


def revcomp_np(mers: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement packed mers (vectorized)."""
    m = np.asarray(mers, dtype=np.uint64)
    out = np.zeros_like(m)
    comp = ~m  # complement of every 2-bit code: 0<->3, 1<->2
    for _ in range(k):
        out = (out << np.uint64(2)) | (comp & np.uint64(3))
        comp >>= np.uint64(2)
    return out


def kmers_from_codes_np(
    codes: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All k-mers of a code array.

    Returns (fmer, rmer, valid) arrays of length ``len(codes) - k + 1``
    (empty if the sequence is shorter than k).  ``valid[i]`` is False when
    the window ``codes[i:i+k]`` contains a non-ACGT base, mirroring
    kmerIterator::isValid() (merfin-histogram.C:55).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0] - k + 1
    if n <= 0:
        e = np.zeros(0, dtype=np.uint64)
        return e, e.copy(), np.zeros(0, dtype=bool)

    # native single-pass rolling extractor (the numpy fallback below does
    # 2k full-array passes with uint64 temporaries — ~30x slower)
    from merfin_tpu_torch import native

    out = native.kmers_from_codes(codes, k)
    if out is not None:
        return out

    good = codes < 4
    c = np.where(good, codes, 0).astype(np.uint64)

    # fmer: rolling big-endian pack via prefix windows.
    fmer = np.zeros(n, dtype=np.uint64)
    rmer = np.zeros(n, dtype=np.uint64)
    for j in range(k):
        fmer = (fmer << np.uint64(2)) | c[j : j + n]
        rmer |= ((np.uint64(3) - c[j : j + n]) << np.uint64(2 * j))

    # validity: window all-good via prefix sums of the bad mask
    bad = (~good).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    return fmer, rmer, valid


def canonical_np(fmer: np.ndarray, rmer: np.ndarray) -> np.ndarray:
    """Canonical representation: min(fmer, rmer)."""
    return np.minimum(fmer, rmer)


def pack_transfer_np(codes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack uint8 codes for the host->device link: 2-bit base planes plus
    a validity bitmask (3 bits/base instead of 8 — 2.7x less input
    bandwidth per dispatch).

    codes: uint8 [..., L] with 0-3 = ACGT and >=4 invalid.
    Returns (planes uint8 [..., ceil(L/4)] — 4 bases/byte, LSB-first;
    vbits uint8 [..., ceil(L/8)] — 1 validity bit/base, LSB-first).
    The device inverse is merfin_tpu_torch.ops.kmer_ops.unpack_transfer.
    """
    codes = np.asarray(codes, dtype=np.uint8)
    L = codes.shape[-1]
    p4 = (L + 3) // 4

    if codes.ndim <= 2 and codes.flags.c_contiguous and L:
        from merfin_tpu_torch.native import get_lib

        lib = get_lib()
        if lib is not None and hasattr(lib, "mt_pack_transfer"):
            import ctypes

            rows = codes.shape[0] if codes.ndim == 2 else 1
            p8 = (L + 7) // 8
            planes = np.empty(codes.shape[:-1] + (p4,), np.uint8)
            vbits = np.empty(codes.shape[:-1] + (p8,), np.uint8)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.mt_pack_transfer(
                codes.ctypes.data_as(u8p), rows, L,
                planes.ctypes.data_as(u8p), vbits.ctypes.data_as(u8p))
            return planes, vbits

    c = np.where(codes < 4, codes, 0).astype(np.uint8)
    if p4 * 4 != L:
        pad = np.zeros(codes.shape[:-1] + (p4 * 4 - L,), np.uint8)
        c = np.concatenate([c, pad], axis=-1)
    c = c.reshape(codes.shape[:-1] + (p4, 4))
    planes = (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
              | (c[..., 3] << 6)).astype(np.uint8)
    vbits = np.packbits(codes < 4, axis=-1, bitorder="little")
    return planes, vbits
