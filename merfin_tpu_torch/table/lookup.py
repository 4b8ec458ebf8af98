"""Exact k-mer lookup tables (port of ``merfin_tpu/table/lookup.py``).

The reference keeps a prefix-indexed bit-packed table in host RAM and
does one pointer-chasing probe per k-mer (kmers-exact.C via
merfin-globals.C:107-108).  ``DeviceLookup`` is the JAX package's gather
table: two flat device arrays (sorted canonical keys, values) plus a
prefix-bucket offset index, probed by a batched bucketized search in
plain torch ops on the table's device.  ``HostLookup`` is the numpy
table with the same semantics.

``value(mer) == 0`` for absent mers, matching merylExactLookup.
-min/-max filtering (read DB only, merfin-globals.C:136) happens at
build by dropping rows, so filtered mers read as absent.

Keys are u64 bit patterns in int64 tensors (k=32 keys use bit 63): the
bucket of a query is its unsigned prefix, so the arithmetic ``>>`` of
int64 is masked back to the prefix's bits, and the binary search
compares through ``bias``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from merfin_tpu_torch.device import get_device
from merfin_tpu_torch.io.mkdb import KmerDB
from merfin_tpu_torch.ops.kmer_ops import bias


@dataclasses.dataclass
class HostLookup:
    """Numpy fallback with identical semantics (used by tests/tools)."""

    keys: np.ndarray   # uint64 sorted
    vals: np.ndarray   # uint32

    def __call__(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.uint64)
        if self.keys.size == 0:
            return np.zeros(q.shape, dtype=np.uint64)
        idx = np.searchsorted(self.keys, q)
        idx_c = np.minimum(idx, self.keys.size - 1)
        hit = self.keys[idx_c] == q
        return np.where(hit, self.vals[idx_c].astype(np.uint64), np.uint64(0))


_COPY_ROWS = 1 << 24     # rows a host->device copy of a table's placement


def _pick_bucket_bits(n: int, k: int) -> int:
    if n <= 0:
        return 1
    b = int(math.ceil(math.log2(n + 1)))
    return max(1, min(b, 22, 2 * k))


class DeviceLookup:
    """Sorted-array + prefix-bucket exact lookup on one device.

    Strategy "block" (the default): one gather of the bucket offset,
    then ``rows`` adjacent ``window``-wide key blocks from there, an
    equality compare across them and the sum of the matching values.
    Bucket bits grow until every bucket fits in a few blocks; a table
    too skewed for that (``rows > 4``) takes the binary search
    ("bsearch").  "slice" gathers one window from the bucket start, so,
    as in the JAX package, it misses the keys of a bucket past its first
    ``window``; nothing selects it by default.

    Candidates for query q all live in [off[b], off[b+1]) where b is q's
    prefix; entries outside that range have another prefix and never
    compare equal, so the equality-only window test needs no span check.

    Placement is lazy: the keys and values go to the device at the first
    probe (``tree()``) and are padded there.  ``keys_np``/``vals_np``
    (the host rows) serve the union-table builders, so a run on the
    sorted joins never places a gather table.
    """

    WINDOW = 16          # block width; lookups fetch 2 adjacent blocks
    STRATEGY = "block"   # "block" | "slice" | "bsearch"

    def __init__(self, keys: np.ndarray, vals: np.ndarray, k: int,
                 device=None, window: int | None = None,
                 strategy: str | None = None):
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        vals = np.ascontiguousarray(vals, dtype=np.uint32)
        assert keys.shape == vals.shape
        self.k = int(k)
        self.n = int(keys.size)
        self.window = int(window or self.WINDOW)
        self.strategy = strategy or self.STRATEGY
        self.device = torch.device(device) if device is not None \
            else get_device()

        top = min(24, 2 * self.k)
        bits = _pick_bucket_bits(self.n, self.k)
        # Keys a bucket at the finest prefix the growth may reach, in one
        # pass over the keys: a coarser level's buckets are sums of
        # adjacent finer ones, so each level costs 2^top adds, not a
        # pass over the keys (the JAX package searches the keys a level).
        fine = self._bucket_counts(keys, self.k, top)
        counts = fine.reshape(1 << bits, -1).sum(axis=1)
        # grow the bucket index until buckets fit a small number of blocks
        while counts.max(initial=0) > 2 * self.window and bits < top:
            bits += 1
            counts = fine.reshape(1 << bits, -1).sum(axis=1)
        max_bucket = int(counts.max(initial=0))
        offsets = np.zeros((1 << bits) + 1, np.int32)
        np.cumsum(counts, out=offsets[1:])
        self.bits = bits
        self.shift = max(0, 2 * self.k - bits)
        # rows to fetch so W*R >= (W-1) + max_bucket (worst alignment)
        self.rows = max(2, -(-(max_bucket + self.window - 1) // self.window))
        self.windowed = self.rows <= 4
        if not self.windowed:
            self.strategy = "bsearch"
        self.search_iters = (
            max(1, math.ceil(math.log2(max_bucket + 1))) if max_bucket else 0
        )

        # The device table is padded so row fetches past the last key stay
        # in bounds (pad keys are 0 with value 0: a query of 0, the poly-A
        # mer, sums its real value and zeros; any other query never
        # matches a pad), to a power of two as the JAX package does.
        W = max(1, self.window)
        pad_to = ((self.n + W - 1) // W + 4) * W   # spare blocks for row fetch
        pad_to = max(4 * W, 1 << (pad_to - 1).bit_length())
        self.nblocks = pad_to // W
        # the rows placed at the head of the padded device table
        self._host = (keys.view(np.int64), vals.view(np.int32), offsets)
        self._tree = None
        # host rows, for the union-table builders
        self.keys_np = keys
        self.vals_np = vals

    @staticmethod
    def _bucket_counts(keys: np.ndarray, k: int, bits: int) -> np.ndarray:
        """Keys in each of the 2^bits prefix buckets (sorted keys: the
        JAX package's offsets are this histogram's prefix sums)."""
        prefixes = (keys >> np.uint64(max(0, 2 * k - bits))).view(np.int64)
        return np.bincount(prefixes, minlength=1 << bits)[: 1 << bits]

    def memory_bytes(self) -> int:
        return self.n * 12 + ((1 << self.bits) + 1) * 4

    @property
    def placed(self) -> bool:
        """True once the table is on its device."""
        return self._tree is not None

    def tree(self):
        """(keys int64, vals int32, offsets int32) on the device, the keys
        and values padded: placed at the first call."""
        if self._tree is None:
            padded = self.nblocks * self.window
            tree = []
            for x, dtype, size in zip(self._host, (torch.int64, torch.int32,
                                                   torch.int32),
                                      (padded, padded, 0)):
                t = torch.zeros(max(size, x.size), dtype=dtype,
                                device=self.device)
                # a chunk at a time: no host copy of a memmapped DB
                for lo in range(0, x.size, _COPY_ROWS):
                    part = np.array(x[lo: lo + _COPY_ROWS])
                    t[lo: lo + part.size].copy_(torch.from_numpy(part))
                tree.append(t)
            self._tree = tuple(tree)
            self._host = None
        return self._tree


    def lookup_np(self, q: np.ndarray) -> np.ndarray:
        """Numpy u64 in, numpy u64 out (the host scorer's probe)."""
        q = np.ascontiguousarray(q, dtype=np.uint64)
        if q.size == 0:
            return np.zeros(q.shape, dtype=np.uint64)
        out = self.lookup(torch.from_numpy(q.view(np.int64)).to(self.device))
        return out.cpu().numpy().astype(np.uint64)

    def lookup(self, q: torch.Tensor) -> torch.Tensor:
        """Values (u32, as int64) of int64 mers (u64 bit patterns) of any
        shape; 0 where absent."""
        keys, vals, offsets = self.tree()
        if self.n == 0:
            return torch.zeros(q.shape, dtype=torch.int64, device=q.device)
        qs = q.reshape(-1)
        # the unsigned prefix: mask off the sign bits that int64's
        # arithmetic shift copies in (mers are < 4^k, so b < 2^bits; the
        # clamp keeps any other query in the last bucket, where it misses)
        b = qs >> self.shift
        if self.shift:
            b = b & ((1 << (64 - self.shift)) - 1)
        b = b.clamp(0, (1 << self.bits) - 1)
        lo = offsets[b].to(torch.int64)

        # A window of a query is a row of an overlapping view of the
        # table (``unfold``), so one ``index_select`` copies every
        # query's window.
        if self.strategy == "block":
            W, R = self.window, self.rows
            r = torch.clamp(lo // W, max=self.nblocks - R)
            kwin = keys.unfold(0, R * W, W).index_select(0, r)   # [M, R*W]
            match = kwin == qs[:, None]
            # the u32 sum of the matches: int32 bit patterns summed in
            # int64 agree with it mod 2^32
            vwin = torch.where(match, vals.unfold(0, R * W, W)
                               .index_select(0, r), 0)
            out = vwin.sum(dim=1, dtype=torch.int64) & 0xFFFFFFFF
            return out.reshape(q.shape)

        if self.strategy == "slice":
            W = self.window
            start = lo.clamp(max=keys.shape[0] - W)
            win = keys.unfold(0, W, 1).index_select(0, start)    # [M, W]
            match = win == qs[:, None]
            found = match.any(dim=1)
            pos = match.to(torch.uint8).argmax(dim=1)      # first match
            idx = (lo + pos).clamp(max=keys.shape[0] - 1)
            out = torch.where(found, vals[idx].to(torch.int64) & 0xFFFFFFFF, 0)
            return out.reshape(q.shape)

        end = offsets[b + 1].to(torch.int64)
        hi = end
        qb = bias(qs)
        for _ in range(max(self.search_iters, 1)):
            mid = (lo + hi) >> 1
            go_right = bias(keys[mid]) < qb
            lo, hi = torch.where(go_right, mid + 1, lo), \
                torch.where(go_right, hi, mid)
        idx = lo.clamp(max=self.n - 1)
        hit = (keys[idx] == qs) & (lo < end)
        out = torch.where(hit, vals[idx].to(torch.int64) & 0xFFFFFFFF, 0)
        return out.reshape(q.shape)


def build_lookup(
    db: KmerDB,
    min_v: int = 0,
    max_v: int = 2**64 - 1,
    device=None,
    host: bool = False,
) -> DeviceLookup | HostLookup:
    """Load an MKDB into a lookup table, applying value filters.

    Mirrors merylExactLookup::load(db, mem, 0, minV, maxV)
    (merfin-globals.C:156-159): entries outside [min_v, max_v] are absent.
    """
    keys = np.asarray(db.keys)
    vals = np.asarray(db.vals)
    if min_v > 0 or max_v < 2**64 - 1:
        m = (vals >= min_v) & (vals <= max_v)
        keys, vals = keys[m], vals[m]
    if host:
        return HostLookup(keys.astype(np.uint64), vals.astype(np.uint32))
    return DeviceLookup(keys, vals, db.k, device=device)
