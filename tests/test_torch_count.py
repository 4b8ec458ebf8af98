"""The port's counter (merfin_tpu_torch/count/) against the JAX package's
on the same numpy-seeded inputs, exactly: count_sequences, the device
accumulator's collapses and host overflow, count_files in RAM and with
a spilling budget (MKDB files byte for byte, and the k-mers of
tests/refmodel.py:count_canonical), text import with and without spills,
and the host packers.  The JAX side runs on its CPU backend with
``use_device=True`` (its device accumulator), the port on torch's CPU."""

import gzip
import os

import numpy as np
import pytest

import chip_smoke as cs
from merfin_tpu.count import counter as j_counter
from merfin_tpu.io import meryl_text as j_text
from merfin_tpu.io.fasta import CodedSequence as JCoded
from merfin_tpu.io.fasta import Sequence as JSequence
from merfin_tpu_torch.count import counter as p_counter
from merfin_tpu_torch.io import meryl_text as p_text
from merfin_tpu_torch.io.fasta import CodedSequence as PCoded
from merfin_tpu_torch.io.fasta import Sequence as PSequence
from tests import refmodel

@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")


def _dna(rng, n: int, with_n: float = 0.0) -> str:
    s = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)]
    if with_n:
        s = s.copy()
        s[rng.random(n) < with_n] = ord("N")
    return s.tobytes().decode()


def _as_dict(keys, vals, k: int) -> dict:
    return {p_text.decode_kmer(int(x), k): int(v) for x, v in zip(keys, vals)}


# ------------------------------------------------------- count_sequences

def _seqs_short(rng):
    return 9, 256, [_dna(rng, int(rng.integers(5, 40))) for _ in range(300)]


def _seqs_long(rng):
    return 11, 512, [_dna(rng, 5000, with_n=0.01)]


def _seqs_k31(rng):
    return 31, 512, [_dna(rng, int(rng.integers(20, 900))) for _ in range(12)]


def _seqs_k32(rng):
    return 32, 512, [_dna(rng, int(rng.integers(20, 900))) for _ in range(12)]


SEQ_CASES = {"short_reads": _seqs_short, "long_chunked_n": _seqs_long,
             "k31": _seqs_k31, "k32": _seqs_k32}


@pytest.mark.parametrize("use_device", [True, False])
@pytest.mark.parametrize("case", sorted(SEQ_CASES))
def test_count_sequences_matches_jax(case, use_device):
    k, chunk, strs = SEQ_CASES[case](np.random.default_rng(len(case)))
    out = []
    for mod, seq in ((j_counter, JSequence), (p_counter, PSequence)):
        seqs = [seq(f"s{i}", s.encode()) for i, s in enumerate(strs)]
        out.append(mod.count_sequences(iter(seqs), k, chunk=chunk,
                                       use_device=use_device))
    (jk, jv, jt), (pk, pv, pt) = out
    np.testing.assert_array_equal(jk, pk)
    np.testing.assert_array_equal(jv.astype(np.uint64), pv)
    assert jt == pt
    expect = refmodel.count_canonical(strs, k)
    assert _as_dict(pk, pv, k) == expect and pt == sum(expect.values())
    if k >= 31:      # keys with their top bit set: 2^61 (k=31), 2^63 (k=32)
        assert int(pk.max()) >= 1 << (2 * k - 1)


# ------------------------------------------- device accumulator internals

ACC_CASES = {
    # (k, chunk, collapse_runs, _MIN_CAP, max_entries)
    "collapses_r2": (9, 256, 2, 64, None),
    "collapses_r3": (9, 256, 3, 128, None),
    "collapses_k32": (32, 256, 2, 64, None),
    "host_overflow": (9, 128, 2, None, 256),
}


@pytest.mark.parametrize("case", sorted(ACC_CASES))
def test_device_accumulator_matches_jax(case):
    k, chunk, R, min_cap, max_entries = ACC_CASES[case]
    rng = np.random.default_rng(11)
    codes = []
    for i in range(40):
        c = rng.integers(0, 4, size=int(rng.integers(5, 900))).astype(np.uint8)
        if i % 3 == 0 and c.size > 10:      # invalid bases
            c[rng.integers(0, c.size, size=3)] = 4
        codes.append(c)
    out = []
    for mod, coded in ((j_counter, JCoded), (p_counter, PCoded)):
        dacc = mod._DeviceCountAcc(k, chunk, collapse_runs=R)
        if min_cap is not None:
            dacc._MIN_CAP = min_cap
        if max_entries is not None:
            dacc.max_entries = max_entries
        caps = set()
        for buf in mod._packed_chunks(
                (coded(f"s{i}", c) for i, c in enumerate(codes)), k, chunk):
            dacc.add_codes(buf)
            caps |= set(dacc.buckets)
        overflowed = dacc._host_keys.size > 0
        out.append((dacc.drain(), sorted(caps), overflowed))
    (jr, jcaps, jover), (pr, pcaps, pover) = out
    np.testing.assert_array_equal(jr[0], pr[0])
    np.testing.assert_array_equal(jr[1].astype(np.uint64), pr[1])
    assert jr[2] == pr[2]
    assert jcaps == pcaps and jover == pover
    if max_entries is None:
        assert len(pcaps) > 2         # collapses ran, at several capacities
    else:
        assert pover                  # the host overflow ran
    hacc = p_counter._Accumulator()
    p_counter._count_into(hacc, (PCoded(f"s{i}", c)
                                 for i, c in enumerate(codes)), k,
                          chunk=chunk, use_device=False)
    hk, hv, ht = hacc.result()
    np.testing.assert_array_equal(pr[0], hk)
    np.testing.assert_array_equal(pr[1], hv)
    assert pr[2] == ht


# ------------------------------------------------------------ count_files

def _write_fasta(path, seqs):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">q{i}\n{s}\n")


def _write_fastq_gz(path, seqs):
    with gzip.open(path, "wt") as f:
        for i, s in enumerate(seqs):
            f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")


def _files_mixed(d, rng):
    seqs = [_dna(rng, 900, with_n=0.02), _dna(rng, 40), _dna(rng, 6),
            _dna(rng, 301)]
    _write_fasta(d / "in.fasta", seqs)
    return 7, [str(d / "in.fasta")], seqs, dict(chunk=128)


def _files_windows(d, rng):
    """A record far larger than the stream window, through 256-byte
    windows (tests/test_stream.py:test_count_files_window_parity)."""
    seqs = [_dna(rng, 5000)] + [_dna(rng, 40) for _ in range(50)]
    _write_fastq_gz(d / "reads.fq.gz", seqs)
    return 11, [str(d / "reads.fq.gz")], seqs, dict(window=256, chunk=1024)


def _files_two(d, rng):
    a = [_dna(rng, int(rng.integers(30, 400))) for _ in range(40)]
    b = [_dna(rng, 2000, with_n=0.01)]
    _write_fasta(d / "a.fasta", a)
    _write_fastq_gz(d / "b.fq.gz", b)
    return 21, [str(d / "a.fasta"), str(d / "b.fq.gz")], a + b, \
        dict(chunk=512)


def _files_spill(d, rng):
    """tests/test_spill.py's reads, a 32 KB budget: many spills."""
    seqs = [_dna(rng, int(rng.integers(25, 80))) for _ in range(300)]
    _write_fastq_gz(d / "reads.fq.gz", seqs)
    return 13, [str(d / "reads.fq.gz")], seqs, dict(
        chunk=1 << 12, window=2048, memory_gb=32 * 1024 / 1024**3)


FILE_CASES = {"mixed": _files_mixed, "windows": _files_windows,
              "two_files": _files_two, "spill": _files_spill}


@pytest.mark.parametrize("use_device", [True, False])
@pytest.mark.parametrize("case", sorted(FILE_CASES))
def test_count_files_matches_jax(case, use_device, tmp_path, capsys):
    k, paths, strs, kw = FILE_CASES[case](tmp_path, np.random.default_rng(3))
    dbs = {}
    for tag, mod in (("jax", j_counter), ("port", p_counter)):
        extra = {}
        if "memory_gb" in kw:
            extra["spill_dir"] = str(tmp_path / f"runs_{tag}")
        dbs[tag] = mod.count_files(paths, k, str(tmp_path / tag),
                                   use_device=use_device, **kw, **extra)
    cs._same_mkdb(str(tmp_path / "jax"), str(tmp_path / "port"))
    db = dbs["port"]
    expect = refmodel.count_canonical(strs, k)
    assert _as_dict(np.asarray(db.keys), np.asarray(db.vals), k) == expect
    assert db.total == sum(expect.values())
    if "memory_gb" in kw:
        # the spill path ran, cleaned its runs, and equals the in-RAM DB
        assert "count: merging" in capsys.readouterr().err
        assert os.listdir(tmp_path / "runs_port") == []
        p_counter.count_files(paths, k, str(tmp_path / "mem"),
                              use_device=use_device, chunk=kw["chunk"])
        cs._same_mkdb(str(tmp_path / "mem"), str(tmp_path / "port"))


@pytest.mark.parametrize("spill", [False, True])
def test_import_matches_jax(spill, tmp_path):
    """export_text then import_text (re-canonicalized, duplicates summed),
    in RAM and through 64-line batches with a 16 KB spill budget."""
    rng = np.random.default_rng(5)
    k = 9
    strs = [_dna(rng, int(rng.integers(25, 80))) for _ in range(300)]
    _write_fastq_gz(tmp_path / "reads.fq.gz", strs)
    db = p_counter.count_files([str(tmp_path / "reads.fq.gz")], k,
                               str(tmp_path / "db"), use_device=False)
    txt = tmp_path / "dump.txt"
    p_text.export_text(db, str(txt))
    # a meryl-style dump: forward (non-canonical) spellings, repeated
    with open(txt, "a") as f:
        for key, v in zip(np.asarray(db.keys)[:50], np.asarray(db.vals)[:50]):
            mer = p_text.decode_kmer(int(key), k)
            rc = mer[::-1].translate(str.maketrans("ACGT", "TGCA"))
            f.write(f"{rc}\t{int(v)}\n")
    kw = dict(batch_lines=64, memory_gb=16 * 1024 / 1024**3) if spill else {}
    j_text.import_text(str(txt), str(tmp_path / "jax"), **kw)
    imp = p_text.import_text(str(txt), str(tmp_path / "port"), **kw)
    cs._same_mkdb(str(tmp_path / "jax"), str(tmp_path / "port"))
    vals = np.asarray(db.vals).astype(np.int64)
    vals[:50] *= 2
    np.testing.assert_array_equal(np.asarray(imp.keys), np.asarray(db.keys))
    np.testing.assert_array_equal(np.asarray(imp.vals), vals)


# ---------------------------------------------------------------- packers

@pytest.mark.parametrize("k,chunk", [(5, 64), (21, 256), (32, 1000)])
def test_packers_match_jax(k, chunk):
    rng = np.random.default_rng(k)
    lens = rng.integers(0, 3 * chunk, size=30)
    codes = [rng.integers(0, 5, size=int(n)).astype(np.uint8) for n in lens]
    j = list(j_counter._packed_chunks(
        (JCoded(f"s{i}", c) for i, c in enumerate(codes)), k, chunk))
    p = list(p_counter._packed_chunks(
        (PCoded(f"s{i}", c) for i, c in enumerate(codes)), k, chunk))
    assert len(j) == len(p) > 3
    for a, b in zip(j, p):
        np.testing.assert_array_equal(a, b)
    flat = np.concatenate(codes)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    np.testing.assert_array_equal(j_counter.pack_stream(flat, offsets, k),
                                  p_counter.pack_stream(flat, offsets, k))
