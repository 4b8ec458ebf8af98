"""Text interop with meryl databases (a copy of
``merfin_tpu/io/meryl_text.py``).

``meryl print <db>`` emits one "KMER<tab>count" line per canonical k-mer.
These helpers convert that text form to/from MKDB so real meryl databases
(built outside this environment) can be imported, and our outputs can be
diffed against meryl's (the reference scripts rely on `meryl print`,
e.g. scripts/qv.sh:41).
"""

from __future__ import annotations

import numpy as np

from merfin_tpu_torch.io.compressed import open_read_text, open_write_text
from merfin_tpu_torch.io.mkdb import KmerDB
from merfin_tpu_torch.kcore.pack import encode_bases

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def decode_kmer(key: int, k: int) -> str:
    out = bytearray(k)
    for i in range(k - 1, -1, -1):
        out[i] = _BASES[key & 3]
        key >>= 2
    return out.decode("ascii")


def encode_kmer(s: str) -> int:
    codes = encode_bases(s)
    assert np.all(codes < 4), f"invalid base in k-mer '{s}'"
    key = 0
    for c in codes:
        key = (key << 2) | int(c)
    return key


def encode_kmers_batch(mers: np.ndarray, k: int) -> np.ndarray:
    """Vectorized pack of an [N, k] uint8 base-byte matrix into uint64."""
    codes = encode_bases(mers.reshape(-1)).reshape(mers.shape)
    assert codes.max(initial=0) < 4, "invalid base in k-mer input"
    keys = np.zeros(mers.shape[0], dtype=np.uint64)
    for i in range(k):
        keys = (keys << np.uint64(2)) | codes[:, i].astype(np.uint64)
    return keys


def import_text(
    text_path: str,
    db_path: str,
    k: int | None = None,
    canonicalize: bool = True,
    batch_lines: int = 1 << 20,
    memory_gb: float | None = None,
) -> KmerDB:
    """Build an MKDB from 'KMER<tab>count' lines — streaming.

    Lines flow through fixed batches (vectorized packing, no Python
    per-k-mer loop) into the counter's hierarchical accumulator, which
    spills to disk past ``memory_gb`` — a multi-GB `meryl print` dump of a
    human read set imports in bounded memory.

    meryl may use a different canonical convention than ours; when
    ``canonicalize`` we re-canonicalize each k-mer (min of fwd/rc under
    A<C<G<T packing) and re-sort, summing duplicates.
    """
    from merfin_tpu_torch.count.counter import _Accumulator
    from merfin_tpu_torch.kcore.pack import revcomp_np

    acc: _Accumulator | None = None

    def flush(mer_rows: list[bytes], counts: list[int]):
        nonlocal acc
        assert k is not None
        if acc is None:
            # same semantics as count_files: None = unbounded, a number
            # (including 0) = spill budget in GB
            budget = int(memory_gb * 1024**3) if memory_gb is not None else None
            acc = _Accumulator(k=k, budget_bytes=budget)
        mat = np.frombuffer(b"".join(mer_rows), dtype=np.uint8)
        karr = encode_kmers_batch(mat.reshape(len(mer_rows), k), k)
        varr = np.asarray(counts, dtype=np.uint64)
        if canonicalize:
            karr = np.minimum(karr, revcomp_np(karr, k))
        order = np.argsort(karr, kind="stable")
        karr, varr = karr[order], varr[order]
        boundary = np.empty(karr.size, dtype=bool)
        boundary[0] = True
        boundary[1:] = karr[1:] != karr[:-1]
        start = np.flatnonzero(boundary)
        acc.add(karr[start], np.add.reduceat(varr, start))

    mer_rows: list[bytes] = []
    counts: list[int] = []
    with open_read_text(text_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) != 2:
                continue
            mer, cnt = parts
            if k is None:
                k = len(mer)
            assert len(mer) == k, "mixed k-mer lengths in input"
            mer_rows.append(mer.encode("ascii"))
            counts.append(int(cnt))
            if len(mer_rows) >= batch_lines:
                flush(mer_rows, counts)
                mer_rows, counts = [], []
    if mer_rows:
        flush(mer_rows, counts)
    assert k is not None and acc is not None, "empty input"

    if acc.store is not None:
        from merfin_tpu_torch.count.spill import merge_to_mkdb

        return merge_to_mkdb(db_path, k, acc.store, acc.mem_parts(), acc.total)
    keys, vals, total = acc.result()
    return KmerDB.create(db_path, k, keys, vals.astype(np.uint32), total=total)


def export_text(db: KmerDB, text_path: str) -> None:
    with open_write_text(text_path) as f:
        for i in range(db.distinct):
            f.write(f"{decode_kmer(int(db.keys[i]), db.k)}\t{int(db.vals[i])}\n")
