"""The fused scorer's f64 totdK, summed in merfin's order (getTotdK,
varMer.C:648-659), and -polish with a -prob table on the fused scorer.

On the CPU, at a tiny diploid world made from a seed: two haplotype
assemblies (maternal, paternal) of one genome that differ at het SNVs
and indels, reads of both haplotypes at varying depth, a 99-row table of
fractional probabilities, and a VCF with 0/1 calls at het sites (a
deletion and an insertion among them), fixes, 1/2 sites and a het tie.
The fused scorer's per-path totdK equals the host scorer's and the plain
reference's (``portbench/reference/polish_prob.py``) bit for bit; the
records of -polish equal the reference's for every cluster; the CLI
takes the fused scorer for -polish -prob.  The card's kernel is held to
the same order in tests/test_torch_gpu.py.
"""

import io
import math
import os
import sys

import numpy as np
import pytest
import torch

import chip_smoke as cs
from merfin_tpu_torch.ops import path_sum
from merfin_tpu_torch.variants import device_score as pds

K = 21
PEAK = 20.0


def _in_order(values, b_start, b_end):
    """getTotdK over each range: one add at a time from 0.0."""
    out = np.zeros(len(b_start))
    for i, (a, b) in enumerate(zip(b_start, b_end)):
        s = 0.0
        for v in values[a:b]:
            s += float(v)
        out[i] = s
    return out


def _two_level(values, b_start, b_end):
    """The earlier f64 reduction (the JAX package's): a prefix
    difference over 512-wide row cumsums and their row totals."""
    at = pds._prefix(values, torch.float64)
    return at(b_end) - at(b_start)


def test_path_sums_plain_is_getTotdK_order():
    rng = np.random.default_rng(5)
    n = 512 * 8
    vals = rng.normal(size=n) * rng.choice([1e-3, 1.0, 1e4], size=n)
    cuts = np.sort(rng.choice(n, size=60, replace=False))
    b_start = np.concatenate([[0], cuts])
    b_end = np.concatenate([cuts, [n]])
    b_end[7] = b_start[7]                         # an empty path
    got = path_sum.path_sums(torch.from_numpy(vals),
                             torch.from_numpy(b_start),
                             torch.from_numpy(b_end)).numpy()
    assert got.tobytes() == _in_order(vals, b_start, b_end).tobytes()


def _tie_stream():
    """Paths 1 and 2 hold the same 21 table probabilities (a het tie);
    path 3's values sum to 21 exactly in order; path 0 before them makes
    a large prefix, as a heavy cluster does in a shared stream."""
    rng = np.random.default_rng(11)
    probs = 1.0 - rng.random(21) * 3e-3
    big = rng.normal(size=1500) * 1e3
    vals = np.concatenate([big, np.zeros(20), probs, np.zeros(437), probs,
                           np.zeros(20), np.full(42, 0.5), np.zeros(5)])
    vals = np.concatenate([vals, np.zeros(-vals.size % 512)])
    starts = [0, 1520, 1978, 2019]
    lens = [1500, 21, 21, 42]
    return (vals, np.asarray(starts, np.int64),
            np.asarray(starts, np.int64) + np.asarray(lens, np.int64))


def test_two_level_sum_breaks_what_the_in_order_sum_keeps():
    """On a constructed path set the earlier two-level prefix sum breaks
    a tie and drops a path below an integer (-polish orders by int and
    writes a het record only on equal doubles); the in-order sum keeps
    both."""
    vals, b_start, b_end = _tie_stream()
    t = [torch.from_numpy(x) for x in (vals, b_start, b_end)]
    old = _two_level(*t).numpy()
    new = path_sum.path_sums(*t).numpy()
    want = _in_order(vals, b_start, b_end)
    assert new.tobytes() == want.tobytes()
    assert new[1] == new[2] and new[3] == 21.0
    assert old[1] != old[2] or int(old[3]) != 21
    assert (old != want).any()


# ----------------------------------------------------- the diploid world

def _table() -> str:
    """A GenomeScope2-like table: rows 1-99, the argmax copy number 0-4
    under errors at counts 1-3 and Poisson(20 j), and its posterior."""
    rows = []
    for c in range(1, 100):
        post = [3e5 / 3 if c <= 3 else 0.0]
        for j, w in zip(range(1, 5), (2e3, 1e5, 2e3, 1e3)):
            post.append(w * math.exp(c * math.log(PEAK * j) - PEAK * j
                                     - math.lgamma(c + 1)))
        j = int(np.argmax(post))
        rows.append(f"{j},{post[j] / sum(post)!r}\n")
    return "".join(rows)


def dip_world() -> dict:
    """Two haplotype assemblies, their reads at varying depth, a table
    and a VCF of both sequences (chip_smoke.materialize's format)."""
    rng = np.random.default_rng(2024)
    m = cs._dna(rng, 4000)
    alt = cs.ALT_OF
    # paternal: SNVs at 500 and 3000, 3 bases deleted after 1200, 2
    # inserted after 2000
    p = (m[:500] + alt[m[500]] + m[501:1201] + m[1204:2001] + "GT"
         + m[2001:3000] + alt[m[3000]] + m[3001:])
    pp = {500: 500, 1200: 1200, 2000: 1997, 3000: 2999}
    x = 3500                        # a tie site on the maternal haplotype
    y, z = alt[m[x]], alt[alt[m[x]]]
    reads = []
    for hap in (m, p):              # ~20x a haplotype, depth varying
        for _ in range(200):
            a = int(rng.integers(0, len(hap) - 150))
            reads.append(hap[a: a + int(rng.integers(150, 600))])
    for b in (y, z):                # both ALTs of the tie at one count
        reads += [m[x - 60: x] + b + m[x + 1: x + 61]] * 20
    asm_m = m[:800] + alt[m[800]] + m[801:]
    asm_p = p[:2600] + alt[p[2600]] + p[2601:]
    vcf = [("chrM", 500, m[500], p[500], "40", "0/1"),
           ("chrM", 800, asm_m[800], m[800], "40", "1/1"),
           ("chrM", 1200, m[1200:1204], m[1200], "40", "0/1"),
           ("chrM", 2000, m[2000], m[2000] + "GT", "40", "0/1"),
           ("chrM", 2500, m[2500], f"{alt[m[2500]]},{alt[alt[m[2500]]]}",
            "20", "1/2"),
           ("chrM", x, m[x], f"{y},{z}", "50", "1/2"),
           ("chrP", pp[500], p[pp[500]], m[500], "40", "0/1"),
           ("chrP", pp[1200], p[pp[1200]], m[1200:1204], "40", "0/1"),
           ("chrP", pp[2000], p[pp[2000]: pp[2000] + 3], p[pp[2000]], "40",
            "0/1"),
           ("chrP", 2600, asm_p[2600], p[2600], "40", "1/1"),
           ("chrP", pp[3000], p[pp[3000]], m[3000], "40", "0/1")]
    return dict(k=K, peak=PEAK, scaffolds=[("chrM", asm_m), ("chrP", asm_p)],
                reads=reads, prob=_table(), vcf=vcf)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from merfin_tpu_torch.io.mkdb import KmerDB
    from merfin_tpu_torch.io.prob import load_prob_table
    from merfin_tpu_torch.table.lookup import build_lookup

    w = dip_world()
    d = str(tmp_path_factory.mktemp("dip"))
    argv = cs.materialize(w, d)
    rdb = KmerDB(argv[argv.index("-readmers") + 1])
    adb = KmerDB(argv[argv.index("-seqmers") + 1])
    prob = load_prob_table(argv[argv.index("-prob") + 1], log=io.StringIO())
    return dict(w=w, argv=argv, d=d, rdb=rdb, adb=adb, prob=prob,
                rl=build_lookup(rdb, device="cpu"),
                al=build_lookup(adb, device="cpu"))


def _reference(world):
    """The reference's ProbScorer on the world's DB arrays."""
    from portbench.reference.polish_prob import ProbScorer

    return ProbScorer(K, PEAK, world["rdb"].keys, world["rdb"].vals,
                      world["adb"].keys, world["adb"].vals, world["w"]["prob"],
                      torch.device("cpu"))


def _clusters(world):
    """(cluster, sequence) of the reference's cluster list."""
    from portbench.reference.polish import clusters_of

    with open(os.path.join(world["d"], "calls.vcf")) as f:
        cl = clusters_of(f.read(), K, 15)
    seqs = dict(world["w"]["scaffolds"])
    return [(c, seqs[c["chrom"]]) for c in cl]


def _scorer(world):
    from merfin_tpu_torch.modes.variants import make_scorer

    return make_scorer(world["rl"], world["al"], K, PEAK, world["prob"],
                       int(world["rdb"].vals.max()), log=io.StringIO())


def test_fused_f64_totdk_is_host_and_reference_bit_for_bit(world):
    from merfin_tpu_torch.variants.enumerate import enumerate_paths
    from merfin_tpu_torch.variants.score import (build_path_block,
                                                 score_blocks,
                                                 score_path_groups)
    from merfin_tpu_torch.variants.select import tot_dk

    from portbench.reference import refmodel
    from portbench.reference.polish import window

    scorer = _scorer(world)
    assert not scorer.int_path           # the f64 branch
    ref = _reference(world)
    n_paths = 0
    for c, seq in _clusters(world):
        r0, r1 = window(c, K, len(seq))
        args = (seq[r0:r1], [g[1] - r0 for g in c["gts"]],
                [g[4] for g in c["gts"]], [g[3] for g in c["gts"]])
        paths = enumerate_paths(*args)
        host = [tot_dk(s) for s in score_path_groups(
            [paths], K, world["rl"].lookup_np, world["al"].lookup_np, PEAK,
            world["prob"])[0]]
        _, fused = score_blocks([build_path_block(paths, K)], scorer, K)[0]
        rpaths = refmodel.traverse_paths(*args)
        assert [p.seq for p in paths] == [p[0] for p in rpaths]
        _, want = ref.score(rpaths)
        assert np.asarray(fused).tobytes() == np.asarray(host).tobytes() \
            == np.asarray(want).tobytes(), (c, fused, host, want)
        n_paths += len(paths)
    scorer.close()
    assert n_paths >= 20


def test_polish_records_match_reference(world, tmp_path):
    """run_variants -polish with the table, on the fused scorer and on
    the host scorer: records equal the reference's for every cluster,
    and the tie writes a 1/2 record; the recorder counts the fused run's
    f64 dispatches, path sums and het records."""
    from merfin_tpu_torch.io.fasta import SeqFile
    from merfin_tpu_torch.io.vcf import VcfFile
    from merfin_tpu_torch.modes.variants import het_records, run_variants
    from merfin_tpu_torch.utils import spans

    from portbench.reference.polish import expected_records

    ref = _reference(world)
    want = "".join(expected_records(c, seq, ref) for c, seq in
                   _clusters(world))
    assert "\tGT\t1/2\n" in want                        # the het tie
    assert "chrM\t801\t" in want and "chrP\t2601\t" in want  # the fixes
    fasta = world["argv"][world["argv"].index("-sequence") + 1]
    for tag, scorer in (("fused", _scorer(world)), ("host", None)):
        vcf = VcfFile(os.path.join(world["d"], "calls.vcf"),
                      log=io.StringIO())
        vcf.merge_clusters(K, 15, False, log=io.StringIO())
        out = str(tmp_path / tag)
        spans.clear()
        spans.enable()
        try:
            run_variants("polish", SeqFile(fasta), vcf, K,
                         world["rl"].lookup_np, world["al"].lookup_np, PEAK,
                         world["prob"], out, log=io.StringIO(),
                         scorer=scorer)
        finally:
            spans.disable()
        tot = spans.totals()
        spans.clear()
        if scorer is not None:
            scorer.close()
            # the recorder's sites of the f64 branch
            assert tot["scorer.dispatch"]["counts"]["f64"] == \
                tot["scorer.dispatch"]["calls"] >= 1
            assert tot["scorer.path_sum"]["counts"]["paths"] > 0
            assert tot["variants.select"]["counts"]["het_records"] == \
                het_records(want) >= 1
        with open(f"{out}.polish.vcf") as f:
            body = "".join(ln for ln in f if not ln.startswith("#"))
        assert body == want, (tag, body, want)


def test_cli_polish_prob_takes_fused_scorer(world, tmp_path, monkeypatch):
    from merfin_tpu_torch import cli

    argv = cs.vcf_argv(world["argv"], "polish") + ["-threads", "1",
                                                   "-output", "out"]
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")
    monkeypatch.chdir(tmp_path)
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    assert cli.main(argv) == 0
    assert "-- Using fused device scoring (-devscore)." in err.getvalue()
    assert "-- Loading probability table" in err.getvalue()
    assert cs.vcf_records((tmp_path / "out.polish.vcf").read_bytes()) > 0
