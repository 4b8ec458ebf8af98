"""The port's own copies of the JAX package's host modules give the same
results as the originals (exact): one case per copied module, the same
numpy-seeded inputs through both."""

import io
import os
import shutil

import numpy as np
import pytest

import chip_smoke as cs
import merfin_tpu.config as j_config
import merfin_tpu.io.fasta as j_fasta
import merfin_tpu.modes.variants as j_mvar
import merfin_tpu_torch.config as p_config
import merfin_tpu_torch.io.fasta as p_fasta
import merfin_tpu_torch.modes.variants as p_mvar
from merfin_tpu import native as j_native
from merfin_tpu.io import compressed as j_comp
from merfin_tpu.io import mkdb as j_mkdb
from merfin_tpu.io import prob as j_prob
from merfin_tpu.io import vcf as j_vcf
from merfin_tpu.kcore import pack as j_pack
from merfin_tpu.score import bin_table as j_bin
from merfin_tpu.score import kover as j_kover
from merfin_tpu.score import kstar as j_kstar
from merfin_tpu.score import value_map as j_vm
from merfin_tpu.table import lookup as j_lookup
from merfin_tpu.tools import genomescope as j_gs
from merfin_tpu.count import spill as j_spill
from merfin_tpu.utils import checkpoint as j_ckpt
from merfin_tpu.utils import partmerge as j_pm
from merfin_tpu.utils import prefetch as j_pre
from merfin_tpu.variants import enumerate as j_enum
from merfin_tpu.variants import enumerate_fast as j_fast
from merfin_tpu.variants import score as j_score
from merfin_tpu_torch import native as p_native
from merfin_tpu_torch.io import compressed as p_comp
from merfin_tpu_torch.io import mkdb as p_mkdb
from merfin_tpu_torch.io import prob as p_prob
from merfin_tpu_torch.io import vcf as p_vcf
from merfin_tpu_torch.kcore import pack as p_pack
from merfin_tpu_torch.score import bin_table as p_bin
from merfin_tpu_torch.score import kover as p_kover
from merfin_tpu_torch.score import kstar as p_kstar
from merfin_tpu_torch.score import value_map as p_vm
from merfin_tpu_torch.table import lookup as p_lookup
from merfin_tpu_torch.tools import genomescope as p_gs
from merfin_tpu_torch.count import spill as p_spill
from merfin_tpu_torch.utils import checkpoint as p_ckpt
from merfin_tpu_torch.utils import partmerge as p_pm
from merfin_tpu_torch.utils import prefetch as p_pre
from merfin_tpu_torch.variants import enumerate as p_enum
from merfin_tpu_torch.variants import enumerate_fast as p_fast
from merfin_tpu_torch.variants import score as p_score


def _write_fasta(path, seqs, wrap=60):
    with p_comp.open_write(str(path)) as f:
        for name, s in seqs:
            f.write(f">{name} desc\r\n".encode())
            for i in range(0, len(s), wrap):
                f.write(s[i: i + wrap].encode() + b"\n")


def _seqs(rng):
    bases = np.frombuffer(b"ACGTNacgtRY", np.uint8)
    return [(f"s{i}", bases[rng.integers(0, 11, size=int(n))].tobytes()
             .decode()) for i, n in enumerate(rng.integers(0, 5000, 12))]


def _fasta(tmp_path, suffix, python, monkeypatch):
    rng = np.random.default_rng(1)
    path = tmp_path / f"x.fa{suffix}"
    _write_fasta(path, _seqs(rng))
    if python:       # the pure-Python parser in both packages
        monkeypatch.setattr(j_fasta, "_make_stream_parser",
                            j_fasta.PyStreamParser)
        monkeypatch.setattr(p_fasta, "_make_stream_parser",
                            p_fasta.PyStreamParser)
    else:
        assert p_native.get_lib() is not None
    out = []
    for mod in (j_fasta, p_fasta):
        f = mod.SeqFile(str(path))
        coded = [(s.ident, s.codes().tobytes())
                 for s in f.iter_coded(window=4096)]
        raw = [(s.ident, s.bases) for s in f]
        packed = [s.codes().tobytes() for s in f.iter_packed(21, window=4096)]
        out.append((coded, raw, packed))
    assert out[0][0] and out[0] == out[1]


def case_fasta_native(tmp_path, monkeypatch):
    _fasta(tmp_path, "", False, monkeypatch)


def case_fasta_gz_native(tmp_path, monkeypatch):
    _fasta(tmp_path, ".gz", False, monkeypatch)


def case_fasta_python(tmp_path, monkeypatch):
    _fasta(tmp_path, "", True, monkeypatch)


def case_fasta_gz_python(tmp_path, monkeypatch):
    _fasta(tmp_path, ".gz", True, monkeypatch)


def _kmers(monkeypatch, python):
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 5, size=20_000).astype(np.uint8)
    if python:
        monkeypatch.setattr(j_native, "kmers_from_codes", lambda c, k: None)
        monkeypatch.setattr(p_native, "kmers_from_codes", lambda c, k: None)
    for k in (1, 15, 21, 32):
        a = j_pack.kmers_from_codes_np(codes, k)
        b = p_pack.kmers_from_codes_np(codes, k)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(j_pack.revcomp_np(a[0], 32),
                                  p_pack.revcomp_np(a[0], 32))
    for x, y in zip(j_pack.pack_transfer_np(codes.reshape(4, -1)),
                    p_pack.pack_transfer_np(codes.reshape(4, -1))):
        np.testing.assert_array_equal(x, y)
    seq = "ACGTNacgtx" * 30
    np.testing.assert_array_equal(j_pack.encode_bases(seq),
                                  p_pack.encode_bases(seq))


def case_kmers_native(tmp_path, monkeypatch):
    _kmers(monkeypatch, False)


def case_kmers_python(tmp_path, monkeypatch):
    _kmers(monkeypatch, True)


def case_dump_rows(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    cols = [rng.integers(0, 40, size=500).astype(np.float64) / 3
            for _ in range(3)]
    cols[0][::7] = 0.0
    assert (j_native.format_dump_rows("chr1", 17, *cols)
            == p_native.format_dump_rows("chr1", 17, *cols))


def case_mkdb_round_trip(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    keys = np.unique(rng.integers(0, 1 << 42, size=5000, dtype=np.uint64))
    vals = rng.integers(1, 1 << 31, size=keys.size).astype(np.uint32)
    for w, r, tag in ((p_mkdb, j_mkdb, "pj"), (j_mkdb, p_mkdb, "jp")):
        path = str(tmp_path / tag)
        w.KmerDB.create(path, 21, keys, vals)
        a, b = w.KmerDB(path), r.KmerDB(path)
        assert a.meta == b.meta and a.estimate_memory_gb() == \
            b.estimate_memory_gb()
        for i in (0, 17, 63):
            for x, y in zip(a.slice(i), b.slice(i)):
                np.testing.assert_array_equal(x, y)
    assert p_mkdb.is_mkdb(path) and p_mkdb.SLICES == j_mkdb.SLICES


def case_prob_table(tmp_path, monkeypatch):
    path = tmp_path / "prob.txt"
    path.write_text("1,0.931\n1,0.871\nbad line\n2,x\n2,0.597\r\n3,0.401\n")
    logs = [io.StringIO(), io.StringIO()]
    a = j_prob.load_prob_table(str(path), log=logs[0])
    b = p_prob.load_prob_table(str(path), log=logs[1])
    np.testing.assert_array_equal(a.copy_k, b.copy_k)
    np.testing.assert_array_equal(a.copy_p, b.copy_p)
    assert logs[0].getvalue() == logs[1].getvalue()
    with pytest.raises(SystemExit):
        p_prob.load_prob_table(str(tmp_path / "absent"), log=io.StringIO())


def _vcf_world(tmp_path):
    world = cs.parity_world(7, 30_000)
    argv = cs.materialize(world, str(tmp_path))
    return world, argv, str(tmp_path / "calls.vcf")


def _clusters(vcf):
    return {c: [(p.chrom, p.r_start, p.r_end,
                 [(g.pos, g.ref_len, g.qual, g.alleles, g.record.save())
                  for g in p.gts]) for p in v]
            for c, v in vcf.by_chrom.items()}


def case_vcf(tmp_path, monkeypatch):
    _, _, path = _vcf_world(tmp_path)
    out = []
    for mod in (j_vcf, p_vcf):
        log = io.StringIO()
        v = mod.VcfFile(path, log=log)
        v.merge_clusters(21, 3, False, log=log)
        out.append((v.headers, _clusters(v), log.getvalue()))
    assert out[0][1] and out[0] == out[1]


def case_kstar(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    v = rng.integers(0, 200, size=3000).astype(np.uint64)
    a = rng.integers(0, 9, size=3000).astype(np.uint64)
    prob = [m.ProbTable(np.asarray([1, 1, 2], np.uint32),
                        np.asarray([0.9, 0.8, 0.7])) for m in (j_kstar, p_kstar)]
    for peak in (0.0, 2.0, 30.5):
        for pt in ((None, None), prob):
            x = j_kstar.get_k_np(v, a, peak, pt[0])
            y = p_kstar.get_k_np(v, a, peak, pt[1])
            for u, w in zip(x, y):
                np.testing.assert_array_equal(u, w)
            np.testing.assert_array_equal(j_kstar.k_metric_np(x[0], x[1]),
                                          p_kstar.k_metric_np(y[0], y[1]))
    assert j_kstar.histo_qv(45, 1986, 15) == p_kstar.histo_qv(45, 1986, 15)
    for x, y in zip(j_kstar.hist_bin_np(x[0], x[1]),
                    p_kstar.hist_bin_np(y[0], y[1])):
        np.testing.assert_array_equal(x, y)


def case_score_tables(tmp_path, monkeypatch):
    prob = [m.ProbTable(np.asarray([1, 1, 2, 3], np.uint32),
                        np.asarray([0.9, 0.8, 0.7, 0.6]))
            for m in (j_kstar, p_kstar)]
    for pt, mx, exact in (((None, None), 1000, True), (prob, 70, False)):
        a = j_vm.ValueMap(2.5, pt[0], mx, exact_max=exact)
        b = p_vm.ValueMap(2.5, pt[1], mx, exact_max=exact)
        np.testing.assert_array_equal(a.read_k_host, b.read_k_host)
        np.testing.assert_array_equal(a.prob_host, b.prob_host)
        for f in ("vcap", "never_overflows", "has_prob"):
            assert getattr(a, f) == getattr(b, f)
        assert (a.fits_u32(21), a.f32_map_ok(), a.readk_bound(),
                a.int_scorer_ok()) == (b.fits_u32(21), b.f32_map_ok(),
                                       b.readk_bound(), b.int_scorer_ok())
    ta, tb = j_bin.BinTable(), p_bin.BinTable()
    np.testing.assert_array_equal(ta.undr_host, tb.undr_host)
    np.testing.assert_array_equal(ta.over_host, tb.over_host)
    rng = np.random.default_rng(6)
    vmaxp = j_kover.kover_vmaxp(prob[0])
    assert vmaxp == p_kover.kover_vmaxp(prob[1])
    C = rng.integers(0, 9, size=vmaxp * 101)
    N, R = rng.integers(0, 9, size=101), rng.integers(0, 50, size=101)
    assert (j_kover.finish_kover(C, N, R, 0.25, prob[0], vmaxp, 100)
            == p_kover.finish_kover(C, N, R, 0.25, prob[1], vmaxp, 100))


def case_host_lookup(tmp_path, monkeypatch):
    rng = np.random.default_rng(7)
    keys = np.unique(rng.integers(0, 1 << 30, size=4000, dtype=np.uint64))
    vals = rng.integers(0, 50, size=keys.size).astype(np.uint32)
    p_mkdb.KmerDB.create(str(tmp_path / "db"), 15, keys, vals)
    q = np.concatenate([keys[::3], rng.integers(0, 1 << 30, size=999,
                                                dtype=np.uint64)])
    for lo, hi in ((0, 2**64 - 1), (5, 40)):
        a = j_lookup.build_lookup(j_mkdb.KmerDB(str(tmp_path / "db")),
                                  min_v=lo, max_v=hi, host=True)
        b = p_lookup.build_lookup(p_mkdb.KmerDB(str(tmp_path / "db")),
                                  min_v=lo, max_v=hi, host=True)
        np.testing.assert_array_equal(a(q), b(q))
    assert p_lookup.HostLookup(keys[:0], vals[:0])(q).sum() == 0


def _cluster_args(tmp_path):
    world, _, path = _vcf_world(tmp_path)
    seqs = dict(world["scaffolds"])
    vcf = j_vcf.VcfFile(path, log=io.StringIO())
    vcf.merge_clusters(21, 15, False, log=io.StringIO())
    out = []
    for chrom, clusters in vcf.by_chrom.items():
        seq = j_fasta.Sequence(chrom, seqs[chrom].encode())
        for pos_gt in clusters:
            r = j_mvar.prepare_cluster_args(seq, pos_gt, 21, 15,
                                            log=io.StringIO())
            if r is not None:
                out.append(r[2])
    assert len(out) > 10
    return out


def case_enumerate(tmp_path, monkeypatch):
    for args in _cluster_args(tmp_path):
        a, b = j_enum.enumerate_paths(*args), p_enum.enumerate_paths(*args)
        assert [vars(x) for x in a] == [vars(y) for y in b]
        x, y = j_fast.build_path_block_fast(*args, 21), \
            p_fast.build_path_block_fast(*args, 21)
        for f in ("stream", "starts", "nis", "lens", "gtp", "adjust"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def case_host_scorer_and_selectors(tmp_path, monkeypatch):
    """enumerate, score_path_groups (host scorer), the five selectors and
    the array-native selection, each package end to end on its own
    objects; equal texts and scores."""
    world, argv, path = _vcf_world(tmp_path)
    read = p_mkdb.KmerDB(argv[4])
    asm = p_mkdb.KmerDB(argv[6])
    lk = [p_lookup.HostLookup(np.asarray(d.keys), np.asarray(d.vals))
          for d in (read, asm)]
    seqs = dict(world["scaffolds"])
    texts = []
    for vmod, fmod, mvar, smod in ((j_vcf, j_fasta, j_mvar, j_score),
                                   (p_vcf, p_fasta, p_mvar, p_score)):
        vcf = vmod.VcfFile(path, log=io.StringIO())
        vcf.merge_clusters(21, 15, False, log=io.StringIO())
        out = []
        for chrom, clusters in vcf.by_chrom.items():
            seq = fmod.Sequence(chrom, seqs[chrom].encode())
            for pos_gt in clusters:
                r = mvar.prepare_cluster_args(seq, pos_gt, 21, 15,
                                              log=io.StringIO())
                if r is None:
                    continue
                paths = mvar._enumerate_task(r[2])
                scores = smod.score_path_groups([paths], 21, *lk, 2.0,
                                                None)[0]
                out.append([(s.num_m, float(np.sum(s.dkstr))) for s in scores])
                for mode in ("polish", "better", "strict", "loose", "filter"):
                    out.append(mvar._select_task(
                        (mode, paths, scores, pos_gt, 21)))
                block = mvar._enumerate_block_task((r[2], 21))
                nm = np.asarray([s.num_m for s in scores], np.int64)
                td = np.asarray([np.sum(s.dkstr) for s in scores])
                out.append(mvar._select_block_task(
                    ("polish", block, (nm, td), pos_gt, 21)))
        texts.append(out)
    assert len(texts[0]) > 50 and texts[0] == texts[1]


def case_checkpoint(tmp_path, monkeypatch):
    for mod in (j_ckpt, p_ckpt):
        out = str(tmp_path / mod.__name__)
        with open(out, "wb") as f:
            f.write(b"x" * 100)
        ck = mod.Checkpoint(out, "hist")
        ck.save(3, 40, {"kasm": 7})
        st = mod.Checkpoint(out, "hist").load()
        assert mod.Checkpoint(out, "dump").load() is None
        mod.truncate_to(out, st["output_offset"])
        assert os.path.getsize(out) == 40
        ck.done()
        assert not os.path.exists(out + ".ckpt.json")
        assert st == {"mode": "hist", "seqs_done": 3, "output_offset": 40,
                      "accum": {"kasm": 7}}


def case_partmerge(tmp_path, monkeypatch):
    """Part files written, flushed, truncated back to a checkpoint and
    merged in sequence order by both copies: the same merged bytes, and
    the same resume verdicts."""
    rng = np.random.default_rng(8)
    rows = [(int(i), rng.bytes(int(rng.integers(0, 300))))
            for i in rng.permutation(40)]
    out = []
    for mod in (j_pm, p_pm):
        name = str(tmp_path / mod.__name__)
        for pid in range(3):
            w = mod.PartWriter(name, pid)
            for idx, data in rows[pid::3][:5]:
                w.write_seq(idx, data)
            w.flush_idx()
            state = (len(w.extents), w.offset)
            w.write_seq(99 + pid, b"torn")
            w.close()
            verdicts = (mod.can_resume_part(name, pid, *state),
                        mod.can_resume_part(name, pid, state[0], 1 << 30),
                        mod.can_resume_part(name, pid, 0, 0))
            w = mod.PartWriter(name, pid, resume_state=state)
            for idx, data in rows[pid::3][5:]:
                w.write_seq(idx, data)
            w.close()
        mod.merge_parts(name, 3, header=b"#h\n")
        with open(name, "rb") as f:
            out.append((f.read(), verdicts))
        assert not list(tmp_path.glob(f"{mod.__name__}.part*"))
    assert out[0] == out[1] and out[0][1] == (True, False, True)
    assert out[0][0] == b"#h\n" + b"".join(d for _, d in sorted(rows))


def case_spill_gather(tmp_path, monkeypatch):
    """SpillStore.gather over two ranks' run directories (the multi-host
    count's merge): the same runs, slices and merged DB as the JAX
    package's."""
    rng = np.random.default_rng(9)
    dirs = []
    for r in range(2):
        d = str(tmp_path / f"rank{r}")
        store = j_spill.SpillStore(d, 21)
        for _ in range(2):
            keys = np.unique(rng.integers(0, 1 << 42, size=700,
                                          dtype=np.uint64))
            store.spill(keys, rng.integers(1, 9, size=keys.size)
                        .astype(np.uint64))
        dirs.append(d)
    # the merge consumes a store's runs: the port gathers a copy
    copies = [str(tmp_path / f"copy{r}") for r in range(2)]
    for d, c in zip(dirs, copies):
        shutil.copytree(d, c)
    a, b = j_spill.SpillStore.gather(dirs, 21), \
        p_spill.SpillStore.gather(copies, 21)
    assert [os.path.basename(r[0]) for r in a.runs] == \
        [os.path.basename(r[0]) for r in b.runs]
    assert len(a.runs) == 4
    for s in (0, 40, 63):
        for i in range(len(a.runs)):
            for x, y in zip(a.run_slice(i, s), b.run_slice(i, s)):
                np.testing.assert_array_equal(x, y)
    j_spill.merge_to_mkdb(str(tmp_path / "j.mkdb"), 21, a, [], 1234)
    p_spill.merge_to_mkdb(str(tmp_path / "p.mkdb"), 21, b, [], 1234)
    for name in ("keys.npy", "vals.npy", "mkdb.json"):
        assert (tmp_path / "j.mkdb" / name).read_bytes() == \
            (tmp_path / "p.mkdb" / name).read_bytes()


def case_prefetch_and_config(tmp_path, monkeypatch):
    assert list(p_pre.prefetch_iter(range(50), 3)) == \
        list(j_pre.prefetch_iter(range(50), 3))
    with pytest.raises(ValueError):
        list(p_pre.prefetch_iter((1 / (2 - i) if i < 2 else int("x")
                                  for i in range(5))))
    assert vars(p_config.MerfinConfig()) == vars(j_config.MerfinConfig())


def case_genomescope(tmp_path, monkeypatch):
    """tests/test_genomescope.py's synthetic histogram through both
    tools' main: the same -prob lookup table, byte for byte."""
    x = np.arange(1, 300, dtype=np.float64)
    y, _ = j_gs.model_4peak(x, 0.05, 0.004, 30.0, 0.6, 2e6, 21)
    y = y + 3e6 * np.exp(-x / 1.5)
    hist = np.vstack([np.stack([x, np.round(y)], axis=1), [300.0, 12345.0]])
    path = tmp_path / "hist.tsv"
    np.savetxt(path, hist, fmt="%d", delimiter="\t")
    out = []
    for mod in (j_gs, p_gs):
        prefix = str(tmp_path / mod.__name__)
        stdout = io.StringIO()
        monkeypatch.setattr("sys.stdout", stdout)
        assert mod.main([str(path), "21", prefix]) == 0
        with open(f"{prefix}.lookup_table.txt", "rb") as f:
            out.append((f.read(), stdout.getvalue().replace(prefix, "P")))
    assert out[0][0].count(b"\n") > 100 and out[0][0] == out[1][0]
    assert out[1][1] == out[0][1].replace("merfin-tpu ", "merfin-tpu-torch ")


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_copy_matches_jax_package(case, tmp_path, monkeypatch):
    CASES[case](tmp_path, monkeypatch)
