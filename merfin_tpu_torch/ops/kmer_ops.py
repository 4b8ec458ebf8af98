"""Device-side k-mer extraction (port of ``merfin_tpu/ops/kmer_ops.py``).

Codes are uint8: 0..3 = ACGT, >= 4 = invalid (N etc.).

Unsigned 64-bit mers live in int64 tensors as their bit patterns: k=32
keys use bit 63 and the invalid-window sentinel is u64::MAX (-1 here), so
every ORDER on mers goes through ``bias`` (x ^ 2^63 maps unsigned order
onto signed order).  Shifts and bitwise ops are order-free and wrap the
same way in both types.
"""

from __future__ import annotations

import torch

U64_MAX = -1                    # u64::MAX as an int64 bit pattern
_SIGN = -(1 << 63)              # 0x8000_0000_0000_0000


def bias(x: torch.Tensor) -> torch.Tensor:
    """u64 bit patterns -> int64 whose signed order is the unsigned one
    (an involution: bias(bias(x)) == x)."""
    return x ^ _SIGN


def umin(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise unsigned minimum of u64 bit patterns."""
    return torch.where(bias(a) < bias(b), a, b)


def kmer_windows(codes: torch.Tensor, k: int):
    """All k-mer windows along the last axis.

    codes: uint8 [..., L] with L >= k.
    Returns (fmer, rmer, valid): int64 (u64 bits) / int64 / bool tensors
    [..., L - k + 1].
    """
    L = codes.shape[-1]
    n = L - k + 1
    assert n >= 1, "codes shorter than k"

    good = codes < 4
    c = torch.where(good, codes, torch.zeros_like(codes)).to(torch.int64)
    fmer = torch.zeros(codes.shape[:-1] + (n,), dtype=torch.int64,
                       device=codes.device)
    rmer = torch.zeros_like(fmer)
    bad = torch.zeros(fmer.shape, dtype=torch.bool, device=codes.device)
    for j in range(k):
        cj = c[..., j: j + n]
        fmer = (fmer << 2) | cj
        rmer = rmer | ((3 - cj) << (2 * j))
        bad = bad | ~good[..., j: j + n]
    return fmer, rmer, ~bad


def _unpack_bits(packed: torch.Tensor, width: int, per_byte: int,
                 L: int) -> torch.Tensor:
    sh = torch.arange(per_byte, dtype=torch.uint8,
                      device=packed.device) * width
    x = (packed[..., :, None] >> sh) & ((1 << width) - 1)
    return x.reshape(packed.shape[:-1] + (packed.shape[-1] * per_byte,))[..., :L]


def unpack_transfer(planes: torch.Tensor, vbits: torch.Tensor,
                    L: int) -> torch.Tensor:
    """Device inverse of ``merfin_tpu.kcore.pack.pack_transfer_np``.

    planes: uint8 [..., ceil(L/4)] (4 bases/byte, LSB-first);
    vbits: uint8 [..., ceil(L/8)] (1 validity bit/base, LSB-first).
    Returns codes uint8 [..., L] with invalid bases restored to 4.
    """
    c = _unpack_bits(planes, 2, 4, L)
    v = _unpack_bits(vbits, 1, 8, L)
    return torch.where(v == 1, c, torch.full_like(c, 4))


def seg_from_marks(marks_bits: torch.Tensor, base: torch.Tensor,
                   C: int) -> torch.Tensor:
    """Per-window segment ids from boundary marks.

    marks_bits: uint8 [..., ceil(C/8)], bit p set where a sequence's first
    window sits at window position p of the row; base: int32 [...], the
    number of marks in earlier rows.  Returns int64 [..., C]: the id of
    the last sequence started at or before each position.
    """
    m = _unpack_bits(marks_bits, 1, 8, C)
    return (base.to(torch.int64)[..., None]
            + torch.cumsum(m.to(torch.int64), dim=-1) - 1)


def canonical_and_mult(fmer: torch.Tensor, rmer: torch.Tensor):
    """Canonical mer (unsigned min) and the fmer+rmer lookup multiplier:
    merfin sums both orientations' lookups (merfin-globals.C:107-108),
    which against a canonical DB doubles palindromes (fmer == rmer, even
    k only)."""
    canon = umin(fmer, rmer)
    mult = torch.where(fmer == rmer, 2, 1).to(torch.int64)
    return canon, mult
