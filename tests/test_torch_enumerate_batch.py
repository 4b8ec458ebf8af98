"""The fused path's builder (enumerate_fast.build_path_blocks), over
runs of clusters and runs of one, against the JAX package's
build_path_block_fast, cluster by cluster, bit for bit; the dispatched
stream of runs against the same clusters' reference blocks; and the
build task."""

import random

import numpy as np
import pytest

from merfin_tpu.variants.enumerate_fast import build_path_block_fast
from merfin_tpu_torch.modes import variants as mv
from merfin_tpu_torch.utils import spans
from merfin_tpu_torch.variants.enumerate_fast import build_path_blocks
from merfin_tpu_torch.variants.score import dispatch_blocks, fetch_blocks

FIELDS = ("stream", "starts", "nis", "lens", "gtp", "adjust")


def assert_block_equal(got, want, ctx=""):
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, (ctx, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{ctx} {f}")


def _dna(rng, n):
    return "".join(rng.choice("ACGT") for _ in range(n))


def random_cluster(rng, k):
    """One light cluster as prepare_cluster_args gives it: 1-5 variants,
    0-4 alleles each (none: a ./. record), ALTs equal to the REF or to
    each other, deletions reaching over the next variant, insertions;
    now and then a template shorter than k (a sequence end)."""
    short = rng.random() < 0.1
    L = rng.randint(3, k - 1) if short else rng.randint(k + 4, 2 * k + 30)
    template = _dna(rng, L)
    V = rng.randint(1, 5)
    pos = sorted(rng.randrange(0, max(1, L - 1)) for _ in range(V))
    ref_idx, ref_len, haps = [], [], []
    for p in pos:
        rl = rng.choice((0, 1, 1, 1, 2, 3, 5))
        ref = template[p: p + rl]
        n_alt = rng.choice((0, 1, 1, 2, 3))
        if rng.random() < 0.08:
            alleles = []                      # ./.: no alleles at all
        else:
            alts = []
            for _ in range(n_alt):
                u = rng.random()
                if u < 0.1:
                    alts.append(ref)          # ALT equal to REF
                elif u < 0.2 and alts:
                    alts.append(alts[-1])     # two equal ALTs
                elif u < 0.45:
                    alts.append(ref[:1])      # deletion
                elif u < 0.65:
                    alts.append(ref + _dna(rng, rng.randint(1, 4)))
                else:
                    alts.append(_dna(rng, rng.randint(0, 3)))
            alleles = [ref] + alts
        ref_idx.append(p)
        ref_len.append(len(ref))
        haps.append(alleles)
    return template, ref_idx, ref_len, haps


def random_run(rng, k, n):
    run = [random_cluster(rng, k) for _ in range(n)]
    for i in range(n):
        if rng.random() < 0.05:
            run[i] = None                     # a PANIC-skipped cluster
    return run


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("k", [7, 21])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_batch_equals_single_builds(k, seed, native, monkeypatch):
    """With the native library and with its numpy fallbacks (assembly
    and the adjust plane) on both sides."""
    from merfin_tpu import native as j_nat
    from merfin_tpu_torch import native as nat

    assert nat.get_lib() is not None
    if not native:
        monkeypatch.setattr(nat, "get_lib", lambda: None)
        monkeypatch.setattr(j_nat, "get_lib", lambda: None)
    rng = random.Random(1000 * k + seed)
    n_paths = dedups = 0
    for trial in range(40):
        run = random_run(rng, k, rng.randint(1, 40))
        batch = build_path_blocks(run, k)
        assert batch.cl_off.shape == (len(run) + 1,)
        for i, args in enumerate(run):
            ctx = f"seed {seed} trial {trial} cluster {i}: {args}"
            got = batch.cluster(i)
            if args is None:
                assert got.nis.shape[0] == 0, ctx
                continue
            want = build_path_block_fast(*args, k)
            assert_block_equal(got, want, ctx)
            n_paths += want.nis.shape[0]
            dedups += want.nis.shape[0] < np.prod(
                [max(1, len(h)) for h in args[3]])
    assert n_paths > 1000 and dedups > 10


def test_batch_edge_runs():
    k = 7
    t = "ACGTACGTACGTACGTACGTACGT"
    runs = [
        [],
        [None, None],
        [("ACGTACGTAC", [], [], [])],                   # no variants
        [("ACGTACGTAC", [3], [1], [[]])],               # every branch dies
        [("ACG", [1], [1], [["C", "T"]]), None,         # shorter than k
         (t, [5, 8], [5, 1], [[t[5:10], "A"], [t[8], "C"]])],
        [(t, [3, 4, 5], [4, 1, 1], [[t[3:7], ""], [t[4], "G"], [t[5], "T"]]),
         (t, [5, 5], [2, 4], [[t[5:7], ""], [t[5:9], "GT"]])],
        # one cluster twice: dedup stays inside each cluster
        [(t, [4, 9], [1, 1], [[t[4], "C", "C"], [t[9], "G"]])] * 2,
        # positions out of order (no VCF cluster has them)
        [(t, [4, 9], [1, 1], [[t[4], "C"], [t[9], "G"]]),
         (t, [9, 4, 6], [1, 3, 1], [[t[9], "A"], [t[4:7], "C"], [t[6], ""]])],
    ]
    for run in runs:
        batch = build_path_blocks(run, k)
        assert batch.cl_off.shape == (len(run) + 1,)
        for i, args in enumerate(run):
            one = build_path_blocks([args], k)
            assert one.cl_off.shape == (2,)
            if args is not None:
                want = build_path_block_fast(*args, k)
                assert_block_equal(batch.cluster(i), want, str(args))
                assert_block_equal(one.cluster(0), want, str(args))
            else:
                assert batch.cluster(i).nis.shape[0] == 0
                assert one.cluster(0).nis.shape[0] == 0


class Recorder:
    """A scorer that keeps what dispatch_paths was given and returns
    per-path numbers from fetch_paths."""

    def dispatch_paths(self, stream, adjust, starts, nis):
        return stream, adjust, starts, nis

    def fetch_paths(self, token):
        P = token[3].shape[0]
        return np.arange(P, dtype=np.int64) * 3, np.arange(P) * 0.5


@pytest.mark.parametrize("k", [7, 21])
def test_batch_dispatch_equals_single_blocks(k):
    rng = random.Random(k)
    run_a, run_b = random_run(rng, k, 30), random_run(rng, k, 17)
    heavy = random_cluster(rng, k)
    units = [build_path_blocks(run_a, k),
             build_path_blocks([heavy], k),
             build_path_blocks(run_b, k)]
    singles = [None if a is None else build_path_block_fast(*a, k)
               for a in run_a + [heavy] + run_b]
    sc = Recorder()
    got = dispatch_blocks(units, sc, k)[1]
    want = dispatch_blocks(singles, sc, k)[1]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    res_u = fetch_blocks(dispatch_blocks(units, sc, k), sc)
    res_s = fetch_blocks(dispatch_blocks(singles, sc, k), sc)
    per_cluster = []
    for blk, (nm, td), n in zip(units, res_u, (len(run_a), 1, len(run_b))):
        for i in range(n):
            r = blk.rows(i)
            per_cluster.append((nm[r], td[r]))
    assert len(per_cluster) == len(res_s)
    for (a, b), (c, d) in zip(per_cluster, res_s):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_enumerate_block_task_single_and_batch_forms():
    """The task's one form, ``(enum_args[lo:hi], k)``: a heavy unit of
    one and a run."""
    single = ("ACGTACGTAC", [3], [1], [["T", "G"]])
    run = [single, None, ("ACGTACGTACGT", [2, 6], [1, 2],
                          [["G", "A"], ["AC", "A", "ACT"]])]
    spans.clear()
    spans.enable()
    try:
        one = mv._enumerate_block_task(([single], 5))
        many = mv._enumerate_block_task((run, 5))
    finally:
        spans.disable()
    assert one.cl_off.tolist() == [0, 2] and one.n_var.tolist() == [1]
    assert_block_equal(one.cluster(0), build_path_block_fast(*single, 5))
    assert_block_equal(many.cluster(0), one.cluster(0))
    assert_block_equal(many.cluster(2), build_path_block_fast(*run[2], 5))
    assert mv._enumerate_block_task(None) is None
    got = [s.counts for s in spans.records() if s.name == "variants.enumerate"]
    assert got == [{"clusters": 1, "paths": 2}, {"clusters": 2, "paths": 8}]
