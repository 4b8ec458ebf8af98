"""-polish of a haplotype-resolved diploid assembly with a GenomeScope2
-prob table: each pass is one shard job's variant loop over a
chromosome pair, run as the CLI runs it (``cli.py:_run_variant_mode``):
the shard's VCF (``VcfFile``, clusters merged at -comb), the FASTA of
both haplotypes parsed once, the scorer chosen by the port's own
``modes/variants.py:make_scorer`` (the fused device scorer, on its f64
branch under the table), and ``run_variants("polish", ...)`` with the
table read by ``io/prob.py`` as the CLI reads it.

Set-up builds, from the world's haplotype (``world.true``'s first
sequence), what ``world.py`` does not make (``diploid_s``): the second
haplotype with het variants, both assembled haplotypes with their
errors, the diploid read and assembly DBs, the VCF and the table; then
the DB handles, ``build_lookup`` and the table (``load_s``) and the
scorer with its union table (``union_build_s``).  A pass's work is the
VCF's clusters.  A sample of them, drawn from the seed (heavy ones,
het-site ``0/1`` calls and tie sites among them), is checked in every
pass against ``reference/polish_prob.py``: each sampled cluster's
records in the pass's output, and its paths' totdK as the program
fetched them (``TotdkCapture``), bit for bit against the reference's
float64 in-order sums.

The world (``build_diploid``), for a config of two sequences of equal
length (maternal, paternal):

* maternal truth: ``world.true``'s first sequence; paternal truth: the
  maternal one with het variants, one in each ``HET_STRIDE`` bp, 80%
  SNVs and 20% 1-5 bp indels (as many bases inserted as deleted, so
  both have the config's length);
* assembly errors: each haplotype's share of ``world.subs`` (one in
  each equal stratum), each moved to the next position clear of the
  het sites, plus one a heavy cluster;
* read DB: both truths' k-mers at Poisson(peak x copies), ``world``'s
  own error k-mers (its read keys that are no k-mer of its genome, at
  their counts), and the k-mers of the error-supported calls' ALT
  alleles at counts 1-3 (read errors that made the caller's call);
* assembly DB: both assembled haplotypes' k-mers;
* the table: rows 1 to 5 * peak - 1, each the argmax copy number 0-4
  and its posterior under the world's model (error k-mers uniform at
  counts 1-3; Poisson(peak * j) for copy number j = 1-4, weighted by
  the world's distinct k-mers at each copy number);
* the VCF of each haplotype, in the order of the mix's ``dip_vcf``:
  ``fixes`` (1/1, every error), ``het_calls`` (0/1 at het sites, the
  other haplotype's allele), ``spurious`` (0/1 SNVs whose ALT k-mers
  the reads carry only at error counts), ``multi`` (1/2 sites, two
  unsupported ALTs), ``ties`` (1/2 sites whose two ALT alleles the
  reads carry at one count drawn per site, so their paths tie to the
  last bit and -polish writes a het record) and ``heavy`` clusters of
  ``heavy_vars`` variants ``heavy_spacing`` apart in the SNP / SNP /
  1/2 / insertion cycle, each opened by a fix.
"""

from __future__ import annotations

import io
import math
import os
import time

import numpy as np
import torch

from merfin_tpu_torch.modes.variants import het_records, make_scorer

from portbench.drivers import polish as haploid
from portbench.drivers.polish import compare
from portbench.memdb import MemDB
from portbench.world import ACGT, ALT_OF, _strata, canonical_kmers

RATE = ("polish_clusters_per_s", "clusters/s")
HET_STRIDE = 1000          # one het site a kb (human heterozygosity)
SNV_SHARE = 0.8
INDEL_MAX = 5
COPIES = 4                 # copy numbers of the table's model


class PathSumWork:
    """Bytes the path-sum kernel must move (8 B a path window read, 8 B
    a path written, 16 B of its bounds read), from each call's bounds:
    recorded in the warm pass, then each window call counts the
    recorded bytes of its place in the cycle (every pass makes the same
    calls), stamped with its host time."""

    def __init__(self):
        self.recording = True
        self.recorded: list[int] = []
        self.calls = 0
        self.log: list[tuple[float, int]] = []
        self.saved = None           # the entry this wrap replaced


def wrap(spans) -> None:
    """The haploid driver's wraps (the fused scorer's entry methods;
    run_variants' steps, to name the trace's idle gaps), and the
    path-sum kernel's entry, for its bytes (``spans.path_sum_work``,
    read by ``path_sum_roofline.polish_dip``)."""
    from merfin_tpu_torch.ops.path_sum import PathSumKernel

    haploid.wrap(spans)
    work = spans.path_sum_work = PathSumWork()
    fn = work.saved = PathSumKernel.__call__

    def call(kernel, values, b_start, b_end):
        if work.recording:
            work.recorded.append(8 * int((b_end - b_start).sum())
                                 + 24 * b_start.numel())
        elif work.recorded:
            work.log.append((time.perf_counter(),
                             work.recorded[work.calls % len(work.recorded)]))
            work.calls += 1
        return fn(kernel, values, b_start, b_end)

    PathSumKernel.__call__ = call


def unwrap(spans) -> None:
    from merfin_tpu_torch.ops.path_sum import PathSumKernel

    PathSumKernel.__call__ = spans.path_sum_work.saved
    spans.unwrap()


class TotdkCapture:
    """The sampled clusters' per-path totdK as the program fetched them
    (``fetch_paths``, split per cluster by ``_score_fused``), in every
    pass: a wrap of ``modes/variants.py:_score_fused`` from set-up to
    ``close``.  ``want`` maps (the sequence's place among the pass's
    sequences with clusters, the cluster's index there) to the sampled
    cluster; ``got`` maps each sampled cluster to its f64 [paths]."""

    def __init__(self, want: dict[tuple[int, int], int]):
        from merfin_tpu_torch.modes import variants

        self.by_seq: dict[int, list[tuple[int, int]]] = {}
        for (s, idx), i in want.items():
            self.by_seq.setdefault(s, []).append((idx, i))
        self.got: dict[int, np.ndarray] = {}
        self.seq = 0
        fn = self.saved = variants._score_fused

        def score_fused(*args, **kw):
            res = fn(*args, **kw)
            scores = res[1]
            for idx, i in self.by_seq.get(self.seq, ()):
                if scores[idx] is not None:
                    self.got[i] = np.array(scores[idx][1], np.float64)
            self.seq += 1
            return res

        variants._score_fused = score_fused

    def start(self) -> None:
        self.got, self.seq = {}, 0

    def close(self) -> None:
        from merfin_tpu_torch.modes import variants

        variants._score_fused = self.saved


# ------------------------------------------------------------ the world

def _clear(sorted_bad: np.ndarray, p: int, lo: int, hi: int) -> bool:
    j = np.searchsorted(sorted_bad, p - lo)
    return j >= sorted_bad.size or sorted_bad[j] >= p + hi


def _place(rng, n: int, lo: int, hi: int, bad: np.ndarray, m: int,
           width: int = 1) -> np.ndarray:
    """``n`` sites in [lo, hi), each ``m`` clear of ``bad`` and of the
    others (a site covers ``width`` bases), one in each of as many equal
    strata, moved forward until clear."""
    out = []
    bad = np.sort(bad)
    for p in _strata(rng, lo, hi - width - m, n, 0):
        p = int(p)
        while not _clear(bad, p, m, width + m):
            p += 37
            if p >= hi - width - m:
                raise ValueError("no room for a clear site")
        out.append(p)
        bad = np.insert(bad, np.searchsorted(bad, p), np.arange(p, p + width))
    return np.asarray(out, np.int64)


def _paternal(rng, mat: np.ndarray, k: int):
    """(paternal truth, het sites): at maternal positions ``pos``, of
    ``kind`` 0 SNV / 1 insertion of ``ln`` bases after pos / 2 deletion
    of the ``ln`` bases after pos, and each site's paternal position
    ``ppos``."""
    L = mat.size
    pos = _strata(rng, k, L - k - INDEL_MAX, L // HET_STRIDE, 2 * k)
    n = pos.size
    kind = np.zeros(n, np.int64)
    n_indel = int(round((1 - SNV_SHARE) * n)) // 2 * 2
    pick = rng.permutation(n)[:n_indel]
    kind[pick[: n_indel // 2]] = 1
    kind[pick[n_indel // 2:]] = 2
    lens = rng.integers(1, INDEL_MAX + 1, n_indel // 2)
    ln = np.zeros(n, np.int64)
    ln[pick[: n_indel // 2]] = lens
    ln[pick[n_indel // 2:]] = rng.permutation(lens)   # as many bases out
    pat = mat.copy()
    snv = pos[kind == 0]
    pat[snv] = (pat[snv] + rng.integers(1, 4, snv.size)) % 4
    keep = np.ones(L, bool)
    for p, m in zip(pos[kind == 2], ln[kind == 2]):
        keep[p + 1: p + 1 + m] = False
    ins_at = np.repeat(pos[kind == 1] + 1, ln[kind == 1])
    ins = rng.integers(0, 4, ins_at.size).astype(np.uint8)
    pat = np.insert(pat, ins_at, ins)[np.insert(keep, ins_at, True)]
    # paternal position of each site's anchor: inserted bases before it
    # added, deleted bases before it taken away
    shift = np.zeros(L + 1, np.int64)
    np.add.at(shift, pos[kind == 1] + 1, ln[kind == 1])
    np.add.at(shift, pos[kind == 2] + 1, -ln[kind == 2])
    ppos = pos + np.cumsum(shift)[pos]
    return pat, dict(pos=pos, ppos=ppos, kind=kind, ln=ln)


def _het_rows(own, other, het, idx, paternal: bool):
    """0/1 calls at het sites ``idx``: REF this haplotype's allele, ALT
    the other's."""
    base = "ACGT"
    rows = []
    for i in idx.tolist():
        p = int(het["ppos"][i] if paternal else het["pos"][i])
        po = int(het["pos"][i] if paternal else het["ppos"][i])
        kind, m = int(het["kind"][i]), int(het["ln"][i])
        anchor = base[own[p]]
        if kind == 0:
            ref, alt = anchor, base[other[po]]
        else:
            longer = (kind == 1) == paternal      # this side holds the bases
            extra = "".join(base[c] for c in (own[p + 1: p + 1 + m]
                                              if longer else
                                              other[po + 1: po + 1 + m]))
            ref, alt = (anchor + extra, anchor) if longer else \
                (anchor, anchor + extra)
        rows.append((p, ref, alt, "0/1"))
    return rows


def _alt_kmers(seq: np.ndarray, p: int, alt: int, k: int) -> np.ndarray:
    """Codes of the 2k-1 bases around ``p`` with ``alt`` at p."""
    w = seq[p - k + 1: p + k].copy()
    w[k - 1] = alt
    return w


def _window_kmers(wins: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical k-mers [n, k] of each row of ``wins`` (int64 codes
    [n, 2k-1])."""
    fmer = torch.zeros((wins.shape[0], k), dtype=torch.int64,
                       device=wins.device)
    rmer = torch.zeros_like(fmer)
    for j in range(k):
        cj = wins[:, j: j + k]
        fmer = (fmer << 2) | cj
        rmer |= (3 - cj) << (2 * j)
    return torch.minimum(fmer, rmer)


def _table(w_err: float, shares: np.ndarray, peak: float) -> str:
    """The -prob file: rows 1 .. 5 * peak - 1, ``copy,posterior``."""
    rows = []
    for c in range(1, int(round(5 * peak))):
        post = [w_err / 3.0 if c <= 3 else 0.0]
        for j in range(1, COPIES + 1):
            lam = peak * j
            post.append(shares[j - 1] * math.exp(
                c * math.log(lam) - lam - math.lgamma(c + 1)))
        tot = sum(post)
        j = int(np.argmax(post))
        rows.append(f"{j},{float(post[j] / tot)!r}\n")
    return "".join(rows)


def build_diploid(world, spec: dict, device) -> None:
    """Make ``world`` the diploid world of the mix's ``dip_vcf``, in
    place (sequences, assembly, DBs, ``vcf``, ``table``)."""
    k, peak = world.k, world.peak
    if len(world.names) != 2 or \
            world.starts[2] - world.starts[1] != world.starts[1]:
        raise ValueError("a diploid world takes two sequences of one length")
    L = int(world.starts[1])
    rng = np.random.default_rng(world.seed + 17)
    gen = torch.Generator(device=device)
    gen.manual_seed(world.seed + 17)
    m = 3 * k

    # the genome's own k-mers, to find the error k-mers in its read DB
    g = torch.from_numpy(world.true).to(device)
    own = torch.unique(torch.cat([canonical_kmers(g[:L], k),
                                  canonical_kmers(g[L:], k)]))
    rk = torch.from_numpy(world.read_keys.view(np.int64)).to(device)
    i = torch.searchsorted(own, rk).clamp_(max=own.numel() - 1)
    is_err = own[i] != rk
    err_keys = rk[is_err]
    err_vals = torch.from_numpy(world.read_vals.view(np.int32)).to(
        device)[is_err].to(torch.int64)
    del g, own, rk, i, is_err

    mat = world.true[:L].copy()
    pat, het = _paternal(rng, mat, k)
    truths, asms, rows_of, supported = [mat, pat], [], [], []
    heavy_span = int(spec["heavy_vars"]) * int(spec["heavy_spacing"])
    het_calls, tie_sites = set(), set()
    q = str(spec["qual"])
    for h, chrom in enumerate(world.names):
        true = truths[h]
        hp = het["ppos"] if h else het["pos"]
        bad = np.sort(np.concatenate([hp, hp + INDEL_MAX]))
        subs = world.subs[(world.subs >= h * L) & (world.subs < (h + 1) * L)]
        errs = []
        for p in (subs - h * L).tolist():       # moved clear of het sites
            while not _clear(bad, p, m, m + 1):
                p += 37
            errs.append(min(p, L - m - 1))
        errs = np.asarray(errs, np.int64)
        bad = np.sort(np.concatenate([bad, errs]))
        heavy = _place(rng, int(spec["heavy"]), m, L - m, bad, m,
                       heavy_span)
        bad = np.sort(np.concatenate(
            [bad, (heavy[:, None] + np.arange(heavy_span)).reshape(-1)]))
        n_sp, n_mu = int(spec["spurious"]), int(spec["multi"])
        sp = _place(rng, n_sp + n_mu + int(spec["ties"]), m, L - m, bad, m)
        sp = sp[rng.permutation(sp.size)]
        spur, multi, ties = sp[:n_sp], sp[n_sp: n_sp + n_mu], sp[n_sp + n_mu:]
        asm = true.copy()
        fix = np.concatenate([errs, heavy])
        asm[fix] = (asm[fix] + rng.integers(1, 4, fix.size)) % 4
        asms.append(asm)
        base = "ACGT"
        rows = [(p, base[asm[p]], base[true[p]], "1/1") for p in errs.tolist()]
        idx = np.sort(rng.choice(het["pos"].size, int(spec["het_calls"]),
                                 replace=False))
        rows += _het_rows(true, truths[1 - h], het, idx, h == 1)
        het_calls |= {(chrom, r[0]) for r in rows[len(errs):]}
        for p in spur.tolist():
            alt = ALT_OF[base[asm[p]]]
            rows.append((p, base[asm[p]], alt, "0/1"))
            supported.append((_alt_kmers(asm, p, "ACGT".index(alt), k), None))
        for p in multi.tolist():
            ref = base[asm[p]]
            rows.append((p, ref, f"{ALT_OF[ref]},{ALT_OF[ALT_OF[ref]]}",
                         "1/2"))
        for p in ties.tolist():
            ref = base[asm[p]]
            a1, a2 = ALT_OF[ref], ALT_OF[ALT_OF[ref]]
            rows.append((p, ref, f"{a1},{a2}", "1/2"))
            c = int(rng.poisson(peak)) or 1
            for a in (a1, a2):
                supported.append((_alt_kmers(asm, p, base.index(a), k), c))
            tie_sites.add((chrom, p))
        for hs in heavy.tolist():
            for v in range(int(spec["heavy_vars"])):
                p = hs + v * int(spec["heavy_spacing"])
                ref = base[asm[p]]
                kind = v % 4
                if v == 0:
                    rows.append((p, ref, base[true[p]], "1/1"))
                elif kind in (0, 1):
                    rows.append((p, ref, ALT_OF[ref], "1/1"))
                elif kind == 2:
                    rows.append((p, ref, f"{ALT_OF[ref]},"
                                 f"{ALT_OF[ALT_OF[ref]]}", "1/2"))
                else:
                    rows.append((p, ref, ref + base[int(rng.integers(4))],
                                 "1/1"))
        rows.sort()
        rows_of.append("".join(f"{chrom}\t{p + 1}\t.\t{r}\t{a}\t{q}\tPASS\t."
                               f"\tGT\t{gt}\n" for p, r, a, gt in rows))

    def kmers(seqs):
        return torch.cat([canonical_kmers(torch.from_numpy(s).to(device), k)
                          for s in seqs])

    # read DB: the truths' k-mers at Poisson(peak x copies); the world's
    # error k-mers; the supported calls' ALT k-mers (counts 1-3, or a tie
    # site's one count); one sort of (mer << 1 | not_true) dedups
    t_keys, t_copies = torch.unique(kmers(truths), sorted=True,
                                    return_counts=True)
    shares = torch.bincount(t_copies.clamp(max=COPIES + 1),
                            minlength=COPIES + 2)[1: COPIES + 1].cpu().numpy()
    t_vals = torch.poisson((t_copies * peak).to(torch.float64),
                           generator=gen).clamp_(min=1).to(torch.int64)
    del t_copies
    if supported:
        wins = torch.from_numpy(np.stack([w for w, _ in supported])).to(
            device).to(torch.int64)
        s_keys = _window_kmers(wins, k).reshape(-1)
        c = torch.tensor([c or 0 for _, c in supported], device=device)
        s_vals = torch.where(
            c[:, None] > 0, c[:, None],
            torch.randint(1, 4, (len(supported), k), generator=gen,
                          device=device)).reshape(-1)   # error counts 1-3
    else:
        s_keys, s_vals = t_keys[:0], t_vals[:0]
    tagged = torch.cat([t_keys << 1, (s_keys << 1) | 1, (err_keys << 1) | 1])
    vals = torch.cat([t_vals, s_vals, err_vals])
    del t_keys, t_vals, s_keys, s_vals
    tagged, order = torch.sort(tagged, stable=True)
    vals = vals[order]
    first = torch.ones(tagged.shape[0], dtype=torch.bool, device=device)
    first[1:] = (tagged[1:] >> 1) != (tagged[:-1] >> 1)
    world.read_keys = (tagged[first] >> 1).cpu().numpy().view(np.uint64)
    world.read_vals = vals[first].to(torch.int32).cpu().numpy().view(
        np.uint32)
    del tagged, vals, order, first
    a_keys, a_vals = torch.unique(kmers(asms), sorted=True,
                                  return_counts=True)
    world.asm_keys = a_keys.cpu().numpy().view(np.uint64)
    world.asm_vals = a_vals.to(torch.int32).cpu().numpy().view(np.uint32)
    del a_keys, a_vals
    world.true = np.concatenate(truths)
    world.asm = np.concatenate(asms)
    world.table = _table(float(err_keys.numel()), shares, peak)
    header = ("##fileformat=VCFv4.2\n"
              + "".join(f"##contig=<ID={c}>\n" for c in world.names)
              + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
    world.vcf = dict(header=header, body="".join(rows_of),
                     het_calls=het_calls, tie_sites=tie_sites)


# ------------------------------------------------------------ the passes

class Bench:
    def __init__(self, ctx, world, config, traffic):
        from merfin_tpu_torch.io.prob import load_prob_table
        from merfin_tpu_torch.table.lookup import build_lookup

        from portbench.reference.polish import clusters_of

        spec = traffic["dip_vcf"]
        with ctx.stage("diploid_s"):
            build_diploid(world, spec, ctx.device)
        self.ctx, self.k, self.peak = ctx, world.k, world.peak
        self.comb = int(spec["comb"])
        self.threads = int(config["threads"]["polish"])
        self.fasta = os.path.join(ctx.tmp, "asm.fasta")
        self.vcf = os.path.join(ctx.tmp, "shard.vcf")
        self.table = os.path.join(ctx.tmp, "lookup_table.txt")
        self.out = os.path.join(ctx.tmp, "out")
        world.write_fasta(self.fasta)
        with open(self.vcf, "w") as f:
            f.write(world.vcf["header"] + world.vcf["body"])
        with open(self.table, "w") as f:
            f.write(world.table)
        cl = clusters_of(world.vcf["header"] + world.vcf["body"], world.k,
                         self.comb)
        self.clusters = len(cl)
        self.heavy = sum(len(c["gts"]) > 2 for c in cl)
        self.work = getattr(ctx.spans, "path_sum_work", None)
        # sequences with clusters, in the FASTA's order, as run_variants
        # meets them; each sampled cluster's index in its sequence
        chroms = {c["chrom"] for c in cl}
        seqs = [n for n in world.names if n in chroms]
        local, seen = [], {n: 0 for n in seqs}
        for c in cl:
            local.append(seen[c["chrom"]])
            seen[c["chrom"]] += 1
        self.capture = TotdkCapture(
            {(seqs.index(cl[i]["chrom"]), local[i]): i
             for i in sample(world, spec, cl)})
        with ctx.stage("load_s"):
            read_db = MemDB("read.mkdb", world.k, world.read_keys,
                            world.read_vals)
            asm_db = MemDB("asm.mkdb", world.k, world.asm_keys,
                           world.asm_vals)
            self.read_lookup = build_lookup(read_db, device=ctx.device)
            self.asm_lookup = build_lookup(asm_db, device=ctx.device)
            self.prob = load_prob_table(self.table, log=io.StringIO())
        with ctx.stage("union_build_s"):
            vals = read_db.vals
            self.scorer = make_scorer(
                self.read_lookup, self.asm_lookup, world.k, world.peak,
                self.prob, int(vals.max()) if vals.size else 1,
                log=io.StringIO())
        self.outputs: list = []

    def one_pass(self) -> int:
        from merfin_tpu_torch.io.fasta import SeqFile
        from merfin_tpu_torch.io.vcf import VcfFile
        from merfin_tpu_torch.modes.variants import run_variants

        log = io.StringIO()
        vcf = VcfFile(self.vcf, log=log)
        vcf.merge_clusters(self.k, self.comb, False, log=log)
        self.capture.start()
        run_variants("polish", SeqFile(self.fasta), vcf, self.k,
                     self.read_lookup.lookup_np, self.asm_lookup.lookup_np,
                     self.peak, self.prob, self.out, comb=self.comb, log=log,
                     threads=self.threads, scorer=self.scorer)
        self.ctx.sync()
        if self.work is not None:
            self.work.recording = False      # the warm pass recorded
        with open(f"{self.out}.polish.vcf") as f:
            self.outputs.append((f.read(), self.capture.got))
        return self.clusters

    def counters(self) -> dict:
        het = het_records(self.outputs[-1][0]) if self.outputs else 0
        return {"clusters": self.clusters, "heavy_clusters": self.heavy,
                "het_records": het,
                "scorer": type(self.scorer).__name__ if self.scorer
                else "host",
                "f64_path": bool(self.scorer and not self.scorer.int_path),
                "union_table_bytes": self.scorer.table.nbytes()
                if self.scorer is not None and self.scorer.table is not None
                else 0}

    def close(self) -> None:
        self.capture.close()
        if self.scorer is not None:
            self.scorer.close()
        self.scorer = None


def setup(ctx, world, config, traffic) -> Bench:
    return Bench(ctx, world, config, traffic)


# ------------------------------------------------------------ the check

def sample(world, spec: dict, clusters: list[dict]) -> list[int]:
    """Indices of the clusters to check, drawn from the world's seed:
    ``check.heavy`` heavy ones, and ``check.light`` light ones of which
    ``check.het_site`` are het-site calls and ``check.ties`` tie sites."""
    rng = np.random.default_rng(world.seed + 14)
    het, ties = world.vcf["het_calls"], world.vcf["tie_sites"]
    chk = spec["check"]

    def at(c):
        return {(c["chrom"], g[1]) for g in c["gts"]}

    groups = {"heavy": [], "het_site": [], "ties": [], "light": []}
    for i, c in enumerate(clusters):
        if len(c["gts"]) > 2:
            groups["heavy"].append(i)
        elif at(c) & het:
            groups["het_site"].append(i)
        elif at(c) & ties:
            groups["ties"].append(i)
        else:
            groups["light"].append(i)
    want = {"heavy": int(chk["heavy"]), "het_site": int(chk["het_site"]),
            "ties": int(chk["ties"])}
    want["light"] = int(chk["light"]) - want["het_site"] - want["ties"]
    picks = []
    for g, n in want.items():
        pool = groups[g]
        n = min(n, len(pool))
        picks += [pool[j] for j in rng.choice(len(pool), n, replace=False)]
    return sorted(picks)


class _Kept:
    """A reference scorer that keeps the totdK of the paths it scored
    last."""

    def __init__(self, scorer):
        self.scorer, self.k, self.totdk = scorer, scorer.k, []

    def score(self, paths):
        num_m, self.totdk = self.scorer.score(paths)
        return num_m, self.totdk


def _expected(world, spec, scorer, cap=None):
    """(the reference's records of each sampled cluster, its paths'
    totdK in traverse order, the clusters)."""
    from portbench.reference.polish import clusters_of, expected_records

    cl = clusters_of(world.vcf["header"] + world.vcf["body"], world.k,
                     int(spec["comb"]))
    seqs = {name: bytes(ACGT[world.sequence(i)]).decode()
            for i, name in enumerate(world.names)}
    kept = _Kept(scorer)
    records, totdk = {}, {}
    for i in sample(world, spec, cl):
        kept.totdk = []
        records[i] = expected_records(cl[i], seqs[cl[i]["chrom"]], kept,
                                      cap=cap)
        totdk[i] = np.asarray(kept.totdk, np.float64)
    return records, totdk, cl


def _prob_scorer(world, device, dtype=torch.float64):
    from portbench.reference.polish_prob import ProbScorer

    return ProbScorer.of_world(world, world.table, device, dtype)


def compare_dip(records: dict, totdk: dict, clusters: list[dict],
                output) -> dict:
    """``records_off`` of a pass's output (text, {sampled cluster: totdK
    as fetched}), and ``totdk_off``: the sampled clusters whose paths'
    totdK are not the reference's bit for bit (a cluster the program
    scored no path of counts as no paths)."""
    text, got = output
    empty = np.zeros(0, np.float64)
    off = sum(got.get(i, empty).tobytes() != want.tobytes()
              for i, want in totdk.items())
    return {**compare(records, clusters, text), "totdk_off": off}


def judge(world, outputs, traffic, device) -> list[dict]:
    """The compared numbers of each pass: its sampled clusters' records
    and totdK against the reference's."""
    exp, tot, cl = _expected(world, traffic["dip_vcf"],
                             _prob_scorer(world, device))
    return [compare_dip(exp, tot, cl, out) for out in outputs]


def control(world, traffic, device) -> dict:
    """The numbers of each control, the reference in the program's place
    one step below a stated guarantee, against the full reference over
    the same sample: ``no_prob``, the -prob table dropped (-peak alone);
    ``enumeration_cut``, each cluster's paths cut at ``control_cap``;
    ``float32``, the table's arithmetic and totdK in float32, one
    precision below the configuration's float64."""
    from portbench.reference.polish import Scorer

    spec = traffic["dip_vcf"]
    build_diploid(world, spec, device)
    full = _prob_scorer(world, device)
    exp, tot, cl = _expected(world, spec, full)
    out = {}
    for name, scorer, cap in (
            ("no_prob", Scorer(world, device), None),
            ("enumeration_cut", full, int(spec["control_cap"])),
            ("float32", _prob_scorer(world, device, torch.float32), None)):
        ctl, ctot, _ = _expected(world, spec, scorer, cap=cap)
        text = world.vcf["header"] + "".join(ctl[i] for i in sorted(ctl))
        out[name] = compare_dip(exp, tot, cl, (text, ctot))
    return out
