"""Sharded k-mer lookup across a D x T device mesh (port of
``merfin_tpu/parallel/sharded.py``).

The tables are range-partitioned by raw row bounds over the mesh's "t"
(table) axis: shard t is one ``SortedJoinTable`` (``ops/sorted_join.py``)
on each distinct device of column t, so every shard probe on a card is
the v4 kernel ``merfin_sorted_join`` and on the CPU its plain version.
A probe of d-row r sorts the row's queries once, probes every shard of
the row and sums the partial values over t in int64 (zero everywhere
but the owner shard; a query outside every shard's range, or a u64::MAX
sentinel, gives 0).  Rows of the "d" (data) axis carry separate query
batches.

JAX's "plane" format (``jnp.searchsorted`` rows, the CPU default there)
has no counterpart: the plain version of the sorted join already serves
the CPU.

A mesh may span processes (``parallel/multihost.py:make_global_mesh``):
each process then holds only its entries' shards and computes only the
rows it holds an entry of (``Mesh.rows``); a row's partial sums add over
the processes holding its entries (``Mesh.row_sum_``: gloo on the CPU,
NCCL on cards), and the holder of the row's (r, 0) entry alone folds
its results into the state, which then adds over every process once
(``Mesh.all_reduce_``).  The replicated lookups (``lookup``,
``lookup_np``, the variant scorer's probes) probe row 0 on every process
and sum over all of them, so every process gets the values.
"""

from __future__ import annotations

import numpy as np
import torch

from merfin_tpu_torch import device as _device
from merfin_tpu_torch.io.mkdb import KmerDB
from merfin_tpu_torch.ops.kmer_ops import U64_MAX, bias, umin
from merfin_tpu_torch.ops.sorted_join import SortedJoinTable
from merfin_tpu_torch.ops.union_join import u32_to_int64

PAD_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)


class Mesh:
    """A ("d", "t") grid of ``torch.device``s, which may repeat a device.

    ``ranks[r, t]`` is the process that holds entry (r, t) and ``rank``
    this process (all 0 for a single-process mesh).  ``group`` is the
    process group a host-spanning mesh on cards sums over (None: the
    default gloo group), ``row_groups[r]`` the group of the processes
    holding row r's entries, for each row this process shares with
    others."""

    def __init__(self, devices, ranks=None, rank: int = 0, group=None,
                 row_groups=None):
        rows = [list(row) for row in devices]
        D, T = len(rows), len(rows[0]) if rows else 0
        if D == 0 or T == 0 or any(len(row) != T for row in rows):
            raise ValueError("a mesh needs a non-empty D x T grid")
        self.devices = np.empty((D, T), dtype=object)
        for r, row in enumerate(rows):
            for t, dev in enumerate(row):
                self.devices[r, t] = torch.device(dev)
        self.ranks = (np.zeros((D, T), np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(D, T))
        self.rank = int(rank)
        self.group = group
        self.row_groups = row_groups or {}
        # the d-rows this process computes: those it holds an entry of
        self.rows = [r for r in range(D) if (self.ranks[r] == self.rank).any()]
        if not self.rows:
            raise ValueError(f"process {rank} holds no device of the mesh")
        self.home = self.row_device(self.rows[0])

    @property
    def shape(self) -> dict:
        D, T = self.devices.shape
        return {"d": D, "t": T}

    @property
    def spans_hosts(self) -> bool:
        return bool((self.ranks != self.rank).any())

    def is_local(self, r: int, t: int) -> bool:
        return self.ranks[r, t] == self.rank

    def owns_row(self, r: int) -> bool:
        """Row r's results belong to the process holding (r, 0)."""
        return self.is_local(r, 0)

    def row_device(self, r: int) -> torch.device:
        """Where this process computes row r: its first local entry of
        the row, else (a row it holds nothing of) the device of its
        first row."""
        for t in range(self.shape["t"]):
            if self.is_local(r, t):
                return self.devices[r, t]
        return self.home

    def row_sum_(self, x: torch.Tensor, r: int) -> torch.Tensor:
        """Sum ``x`` in place over the processes holding row r's entries
        (a no-op when this process holds them all)."""
        if r in self.row_groups:
            import torch.distributed as dist

            dist.all_reduce(x, group=self.row_groups[r])
        return x

    def all_reduce_(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (or, with ``op="max"``, take the maximum of) ``x`` in place
        over every process of the mesh (a no-op unless it spans
        processes)."""
        if self.spans_hosts:
            import torch.distributed as dist

            dist.all_reduce(x, op=dist.ReduceOp.MAX if op == "max"
                            else dist.ReduceOp.SUM,
                            group=self.group if x.is_cuda else None)
        return x


def split_grid(items: list, data: int | None = None) -> list:
    """``items`` as ``data`` rows of equal length, in order; ``data``
    defaults to the first of 4, 2, 1 that divides their count (favouring
    table sharding)."""
    n = len(items)
    if data is None:
        data = next(c for c in (4, 2, 1) if n % c == 0)
    if n == 0 or n % data:
        raise ValueError(f"{n} devices do not split into {data} rows")
    table = n // data
    return [items[r * table: (r + 1) * table] for r in range(data)]


def make_mesh(n_devices: int | None = None, data: int | None = None,
              devices=None) -> Mesh:
    """A ("d", "t") mesh over ``devices`` (default ``device.devices()``,
    cut to ``n_devices``).  A 2-D ``devices`` is the grid itself; a flat
    list splits into rows by ``split_grid``."""
    if devices is not None and len(devices) and isinstance(
            devices[0], (list, tuple)):
        return Mesh(devices)
    devs = list(_device.devices() if devices is None else devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(split_grid(devs, data))


def partition_rows(keys: np.ndarray, vals: np.ndarray, shards: int):
    """Split sorted rows into ``shards`` contiguous, equal-padded blocks.

    Returns (keys[D, M], vals[D, M]) with u64::MAX key padding (matches
    no real k-mer, which needs <= 62 bits for k <= 31)."""
    n = keys.shape[0]
    bounds = [round(i * n / shards) for i in range(shards + 1)]
    m = max(1, max(bounds[i + 1] - bounds[i] for i in range(shards)))
    out_k = np.full((shards, m), PAD_KEY, dtype=np.uint64)
    out_v = np.zeros((shards, m), dtype=np.uint32)
    for i in range(shards):
        a, b = bounds[i], bounds[i + 1]
        out_k[i, : b - a] = keys[a:b]
        out_v[i, : b - a] = vals[a:b]
    return out_k, out_v


class ShardedLookup:
    """Exact lookup (value 0 for absent keys) over the mesh's "t" axis.

    ``shards[t]`` maps each distinct local device of column t to shard
    t's ``SortedJoinTable`` there; ``n`` counts the rows kept by the
    -min/-max filter over all shards."""

    def __init__(self, mesh: Mesh, shards: list, n: int, k: int):
        self.mesh = mesh
        self.shards = shards
        self.n = int(n)
        self.k = int(k)

    @classmethod
    def build(cls, db_or_arrays, mesh: Mesh, min_v: int = 0,
              max_v: int = 2**64 - 1):
        """Build the sharded table; a process reads only the rows of the
        shards it holds (memmapped MKDB slices read lazily).

        -min/-max (read DB only, merfin-globals.C:136) applies per shard
        row: shards stay range-partitioned by the raw row bounds (a
        filtered shard may be empty, and answers 0), and only the value
        stream is scanned, in 2^24-row chunks, for the filtered count."""
        if isinstance(db_or_arrays, KmerDB):
            keys, vals, k = db_or_arrays.keys, db_or_arrays.vals, \
                db_or_arrays.k
        else:
            keys, vals, k = db_or_arrays
        filt = min_v > 0 or max_v < 2**64 - 1

        T = mesh.shape["t"]
        n_raw = keys.shape[0]
        bounds = [round(i * n_raw / T) for i in range(T + 1)]
        n = n_raw
        if filt:
            n = 0
            for lo in range(0, n_raw, 1 << 24):
                vv = np.asarray(vals[lo: min(lo + (1 << 24), n_raw)])
                n += int(np.count_nonzero((vv >= min_v) & (vv <= max_v)))

        shards = []
        for t in range(T):
            devs = list(dict.fromkeys(
                mesh.devices[r, t] for r in range(mesh.shape["d"])
                if mesh.is_local(r, t)))
            tables = {}
            if devs:
                a, b = bounds[t], bounds[t + 1]
                kk = np.asarray(keys[a:b])
                vv = np.asarray(vals[a:b])
                if filt:
                    sel = (vv >= min_v) & (vv <= max_v)
                    kk, vv = kk[sel], vv[sel]
                tables = {dev: SortedJoinTable(kk, vv, dev) for dev in devs}
            shards.append(tables)
        return cls(mesh, shards, n, k)

    def table(self, r: int, t: int) -> SortedJoinTable:
        return self.shards[t][self.mesh.devices[r, t]]

    def probe_row(self, r: int, qs: torch.Tensor) -> torch.Tensor:
        """This process's partial sum over t of row r's shard probes of
        the SORTED int64 query stream ``qs`` (u64 order): int64 on qs's
        device, to be summed over the other processes holding entries of
        the row (``Mesh.row_sum_``), or of the mesh (``Mesh.all_reduce_``)."""
        out = torch.zeros(qs.shape, dtype=torch.int64, device=qs.device)
        for t in range(self.mesh.shape["t"]):
            if not self.mesh.is_local(r, t):
                continue
            table = self.table(r, t)
            v = table.lookup_sorted(qs.to(table.device, non_blocking=True))
            out += u32_to_int64(v).to(qs.device, non_blocking=True)
        return out

    def _probe_psum(self, r: int, q: torch.Tensor) -> torch.Tensor:
        """Any-order probe of row r: sort, probe, unsort, sum over t and
        over every process (replicated out)."""
        flat = q.reshape(-1)
        keys_s, order = torch.sort(bias(flat))
        vs = self.mesh.all_reduce_(self.probe_row(r, bias(keys_s)))
        out = torch.empty_like(vs)
        out[order] = vs
        return out.reshape(q.shape)

    def lookup(self, q: torch.Tensor) -> torch.Tensor:
        """Replicated-in, replicated-out lookup of an int64 (u64 bits)
        query tensor: u32 values as int64."""
        return self._probe_psum(0, q.to(self.mesh.row_device(0)))

    def lookup_np(self, q: np.ndarray) -> np.ndarray:
        """Numpy u64 in, u64 out (the host scorer's contract,
        variants/score.py)."""
        q = np.ascontiguousarray(q, dtype=np.uint64)
        if q.size == 0:
            return np.zeros(q.shape, dtype=np.uint64)
        out = self.lookup(torch.from_numpy(q.view(np.int64)))
        return out.cpu().numpy().astype(np.uint64)

    def lookup_sharded(self, qs: list) -> list:
        """Lookup of queries split along "d": ``qs[r]`` is row r's
        tensor on ``row_device(r)``; one result tensor per row, on every
        process."""
        return [self._probe_psum(r, q) for r, q in enumerate(qs)]


def dual_probe_local(read_lookup: ShardedLookup, asm_lookup: ShardedLookup,
                     r: int, fmer, rmer, valid, k: int, carries=(),
                     positional: bool = False, replicated: bool = False):
    """Both tables' probes of row r's windows.

    Returns FLAT (read_v int64, asm_v int64, valid, carries...) after the
    sum over t, with the fmer+rmer palindrome doubling of even k applied
    after that sum (merfin-globals.C:101-110).  Invalid windows become
    u64::MAX sentinels and ONE sort orders the queries: the results come
    back in sorted order (reduction consumers; ``valid`` and the
    ``carries`` follow the sort's permutation) or, with
    ``positional=True``, in window order (-dump, the variant scorer).
    The t-sum runs over the processes holding row r's entries (each
    calls this for its own rows), or, with ``replicated=True``, over
    every process of the mesh, each of which calls it with the same
    windows."""
    mesh = read_lookup.mesh
    canon = torch.where(valid, umin(fmer, rmer),
                        torch.full_like(fmer, U64_MAX)).reshape(-1)
    keys_s, order = torch.sort(bias(canon))
    qs = bias(keys_s)
    vals = torch.stack([read_lookup.probe_row(r, qs),
                        asm_lookup.probe_row(r, qs)])
    vals = mesh.all_reduce_(vals) if replicated else mesh.row_sum_(vals, r)
    even = k % 2 == 0
    flat = [x.reshape(-1) for x in (fmer, rmer, valid, *carries)]
    if positional:
        out = torch.empty_like(vals)
        out[:, order] = vals
        read_v, asm_v = out
        if even:
            mult = 1 + (flat[0] == flat[1]).to(torch.int64)
            read_v, asm_v = read_v * mult, asm_v * mult
        return (read_v, asm_v, flat[2], *flat[3:])
    read_v, asm_v = vals
    if even:
        mult = 1 + (flat[0] == flat[1])[order].to(torch.int64)
        read_v, asm_v = read_v * mult, asm_v * mult
    return (read_v, asm_v, qs != U64_MAX, *[c[order] for c in flat[3:]])


def put_global(arr: np.ndarray, mesh: Mesh) -> list:
    """Split a host array along its first ("d") axis onto the mesh: row r
    on ``mesh.row_device(r)`` for each row this process computes
    (``mesh.rows``), None for the others.  Every process of a
    host-spanning mesh must hold the same values."""
    return [torch.from_numpy(np.ascontiguousarray(arr[r])).to(
                mesh.row_device(r), non_blocking=True)
            if r in mesh.rows else None
            for r in range(mesh.shape["d"])]
