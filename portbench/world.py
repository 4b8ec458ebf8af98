"""The world of a run, made from its seed: an assembly, the true genome
it was assembled from, the read and assembly k-mer databases, and for
the variant mixes the VCF of a shard.

Provenance: rewritten from chip_smoke.py:full_world and variant_plan as
plain torch and numpy (no helper of the program under test), with the
sequence lengths, repeats and variant densities of a configuration file.

Everything large is made on the device in a few calls from one
``torch.Generator``; placements (substitutions, repeat copies, variant
sites) come from a numpy generator of the same seed.  Both sides of a
check get the same arrays: the program as in-memory databases and a
FASTA/VCF on disk, the reference as the arrays themselves.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

ACGT = np.frombuffer(b"ACGT", np.uint8)
LINE = 80                       # FASTA line width
ALT_OF = {"A": "C", "C": "G", "G": "T", "T": "A"}


def canonical_kmers(codes: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical k-mers (2 bits a base, A<C<G<T) of every window of a
    uint8 code tensor whose codes are all 0..3."""
    n = codes.shape[0] - k + 1
    if n <= 0:
        return torch.zeros(0, dtype=torch.int64, device=codes.device)
    c = codes.to(torch.int64)
    fmer = torch.zeros(n, dtype=torch.int64, device=codes.device)
    rmer = torch.zeros_like(fmer)
    for j in range(k):
        cj = c[j: j + n]
        fmer = (fmer << 2) | cj
        rmer |= (3 - cj) << (2 * j)
    return torch.minimum(fmer, rmer)


def canonical_of(mers: torch.Tensor, k: int) -> torch.Tensor:
    """Canonical form of k-mers given as integers."""
    rc = torch.zeros_like(mers)
    x = mers
    for _ in range(k):
        rc = (rc << 2) | (3 - (x & 3))
        x = x >> 2
    return torch.minimum(mers, rc)


def _strata(rng, lo: int, hi: int, n: int, margin: int) -> np.ndarray:
    """``n`` positions in [lo, hi), one at a random offset in each of n
    equal strata, ``margin`` from the stratum's ends."""
    if n <= 0:
        return np.zeros(0, np.int64)
    edges = np.linspace(lo, hi, n + 1).astype(np.int64)
    span = np.diff(edges) - 2 * margin
    if span.min() < 1:
        raise ValueError("strata too small for their margin")
    return edges[:-1] + margin + (rng.random(n) * span).astype(np.int64)


@dataclasses.dataclass
class World:
    k: int
    peak: float
    names: list
    starts: np.ndarray           # sequence starts in the concatenation
    asm: np.ndarray              # uint8 codes of the assembly
    true: np.ndarray             # uint8 codes of the true genome
    subs: np.ndarray             # substituted positions, sorted
    read_keys: np.ndarray        # uint64, sorted unique
    read_vals: np.ndarray        # uint32
    asm_keys: np.ndarray
    asm_vals: np.ndarray
    vcf: dict | None = None      # the variant plan (variant mixes)
    seed: int = 0

    def sequence(self, i: int) -> np.ndarray:
        return self.asm[self.starts[i]: self.starts[i + 1]]

    def write_fasta(self, path: str) -> None:
        """The assembly as FASTA, ``LINE`` bases a line."""
        with open(path, "wb") as f:
            for i, name in enumerate(self.names):
                s = ACGT[self.sequence(i)]
                pad = -s.size % LINE
                rows = np.concatenate([s, np.full(pad, 0, np.uint8)]) \
                    .reshape(-1, LINE)
                text = np.concatenate(
                    [rows, np.full((rows.shape[0], 1), ord("\n"), np.uint8)],
                    axis=1).reshape(-1)
                if pad:
                    text = np.concatenate([text[: -(pad + 1)],
                                           np.frombuffer(b"\n", np.uint8)])
                f.write(f">{name}\n".encode())
                f.write(text.tobytes())


def _repeats(rng, total: int, spec: dict):
    """Repeat copies: (unit lengths, copy (unit, dst, reverse) rows),
    non-overlapping, covering about ``share`` of ``total`` bases."""
    want = int(spec["share"] * total)
    units, copies, used = [], [], 0
    while used < want:
        L = int(np.exp(rng.uniform(np.log(spec["unit_min"]),
                                   np.log(spec["unit_max"]))))
        c = int(np.exp(rng.uniform(np.log(spec["copies_min"]),
                                   np.log(spec["copies_max"] + 1))))
        c = max(int(spec["copies_min"]), c)
        units.append(L)
        copies += [(len(units) - 1, int(rng.integers(0, total - L)),
                    bool(rng.integers(0, 2))) for _ in range(c)]
        used += L * c
    lens = np.asarray(units, np.int64)
    rows = np.asarray(copies, np.int64).reshape(-1, 3)
    rows = rows[np.argsort(rows[:, 1], kind="stable")]
    keep, end = [], -1
    for r in rows:                              # drop overlapping copies
        if r[1] >= end:
            keep.append(r)
            end = r[1] + lens[r[0]]
    return lens, np.asarray(keep, np.int64).reshape(-1, 3)


def _paste_repeats(seq: torch.Tensor, lens, rows, gen) -> None:
    """Write every copy of ``rows`` into ``seq`` (random units made on
    the device; a reverse copy is the unit's reverse complement)."""
    if rows.shape[0] == 0:
        return
    dev = seq.device
    unit_off = np.concatenate([[0], np.cumsum(lens)])
    units = torch.randint(0, 4, (int(unit_off[-1]),), generator=gen,
                          device=dev, dtype=torch.uint8)
    L = lens[rows[:, 0]]
    t = torch.from_numpy
    n = int(L.sum())
    copy_of = torch.repeat_interleave(torch.arange(rows.shape[0], device=dev),
                                      t(L).to(dev))
    first = t(np.concatenate([[0], np.cumsum(L)[:-1]])).to(dev)
    i = torch.arange(n, device=dev) - first[copy_of]
    Ld = t(L).to(dev)[copy_of]
    rev = t(rows[:, 2]).to(dev)[copy_of].bool()
    src = t(unit_off[rows[:, 0]]).to(dev)[copy_of] + torch.where(
        rev, Ld - 1 - i, i)
    base = units[src]
    seq[t(rows[:, 1]).to(dev)[copy_of] + i] = torch.where(rev, 3 - base, base)


def make_world(config: dict, traffic: dict, seed: int, device) -> World:
    """The world of ``config`` under ``traffic`` for ``seed``."""
    seed = int(seed) % (1 << 63)
    k, peak = int(config["k"]), float(config["peak"])
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    names = [s[0] for s in config["sequences"]]
    lens = np.asarray([s[1] for s in config["sequences"]], np.int64)
    starts = np.concatenate([[0], np.cumsum(lens)])
    G = int(starts[-1])

    true = torch.randint(0, 4, (G,), generator=gen, device=device,
                         dtype=torch.uint8)
    if config.get("repeats"):
        _paste_repeats(true, *_repeats(rng, G, config["repeats"]), gen)

    # assembly errors: one substitution in each of n equal strata, plus
    # those the variant plan asks for
    subs = _strata(rng, 0, G, int(config["substitutions"]), k)
    vcf = None
    if traffic.get("vcf"):
        vcf = plan_sites(rng, G, k, traffic["vcf"], subs)
        subs = np.sort(np.concatenate([subs, vcf["heavy_fix"]]))
    asm = true.clone()
    sd = torch.from_numpy(subs).to(device)
    asm[sd] = ((asm[sd].to(torch.int64)
                + torch.randint(1, 4, (subs.size,), generator=gen,
                                device=device)) % 4).to(torch.uint8)

    def kmers_of(codes):
        return torch.cat([canonical_kmers(codes[starts[i]: starts[i + 1]], k)
                          for i in range(lens.size)])

    # assembly DB: its canonical k-mers with their counts
    a_keys, a_vals = torch.unique(kmers_of(asm), sorted=True,
                                  return_counts=True)
    # read DB: the true genome's k-mers at Poisson(peak x copies), and
    # error k-mers at counts drawn from error_counts; one sort of
    # (mer << 1 | is_error) dedups both, a true k-mer first
    t_keys, t_copies = torch.unique(kmers_of(true), sorted=True,
                                    return_counts=True)
    t_vals = torch.poisson((t_copies * peak).to(torch.float64),
                           generator=gen).clamp_(min=1)
    del t_copies
    n_err = int(config["error_kmers"])
    err = canonical_of(torch.randint(0, 1 << (2 * k), (n_err,), generator=gen,
                                     device=device, dtype=torch.int64), k)
    lo, hi = config["error_counts"]
    tagged = torch.cat([t_keys << 1, (err << 1) | 1])
    vals = torch.cat([t_vals.to(torch.int64),
                      torch.randint(lo, hi + 1, (n_err,), generator=gen,
                                    device=device)])
    del err, t_keys, t_vals
    tagged, order = torch.sort(tagged, stable=True)
    vals = vals[order]
    del order
    first = torch.ones(tagged.shape[0], dtype=torch.bool, device=device)
    first[1:] = (tagged[1:] >> 1) != (tagged[:-1] >> 1)
    r_keys = (tagged[first] >> 1).cpu().numpy().view(np.uint64)
    r_vals = vals[first].to(torch.int32).cpu().numpy().view(np.uint32)
    del tagged, vals, first
    w = World(k=k, peak=peak, names=names, starts=starts,
              asm=asm.cpu().numpy(), true=true.cpu().numpy(), subs=subs,
              read_keys=r_keys, read_vals=r_vals,
              asm_keys=a_keys.cpu().numpy().view(np.uint64),
              asm_vals=a_vals.to(torch.int32).cpu().numpy().view(np.uint32),
              seed=seed)
    del asm, true, a_keys, a_vals
    if vcf is not None:
        w.vcf = write_plan(w, rng, traffic["vcf"], vcf)
    return w


# ------------------------------------------------------------- variants

def plan_sites(rng, G: int, k: int, spec: dict, subs: np.ndarray) -> dict:
    """Where the variant plan puts its sites, before the assembly is
    made: ``regions`` equal regions of the genome, each with one heavy
    cluster (whose first variant corrects an assembly error placed
    here) and its share of spurious SNPs and 1/2 sites, every site at
    least 3k from the others and from every substitution."""
    S, m = int(spec["regions"]), 3 * k
    span = int(spec["heavy_vars"]) * int(spec["heavy_spacing"])
    per = spec["per_region"]
    n_spur = int(per["snps"]) + int(per["multi"])
    bad = np.sort(subs)
    heavy, spur = [], []
    edges = np.linspace(0, G, S + 1).astype(np.int64)

    def clear(p, lo, hi):
        j = np.searchsorted(bad, p - lo)
        return j >= bad.size or bad[j] >= p + hi

    for s in range(S):
        a, b = int(edges[s]), int(edges[s + 1])
        h = int(rng.integers(a + 2 * m, b - span - 2 * m))
        while not clear(h, m, span + m):
            h += 997
        heavy.append(h)
        bad = np.sort(np.concatenate([bad, np.arange(h, h + span)]))
        # candidates: one in each of 4x as many strata, kept where clear
        cand = _strata(rng, a + m, b - m, 4 * n_spur, 0)
        cand = cand[[clear(p, m, m + 1) for p in cand]]
        cand = cand[np.concatenate([[True], np.diff(cand) > 2 * m])]
        if cand.size < n_spur:
            raise ValueError("region too small for its variant sites")
        spur.append(np.sort(rng.choice(cand, n_spur, replace=False)))
    return dict(heavy_fix=np.asarray(heavy, np.int64), spurious=spur,
                edges=edges)


def write_plan(w: World, rng, spec: dict, sites: dict) -> dict:
    """The VCF of the shard, region after region, from the world's own
    arrays; in each region:

    * fixes: each substitution of the region (REF = assembly base, ALT =
      true base) that is not a heavy cluster's;
    * spurious SNPs (GT 1/1) and 1/2 sites (two ALTs, GT 1/2);
    * one heavy cluster of ``heavy_vars`` variants ``heavy_spacing``
      apart in chip_smoke's SNP / SNP / 1/2 site / insertion cycle, the
      first a fix.

    Only one sequence is supported (a chromosome), as in a shard job."""
    if len(w.names) != 1:
        raise ValueError("variant plans take one sequence")
    chrom, base = w.names[0], "ACGT"
    q = str(spec["qual"])
    heavy = set(int(h) for h in sites["heavy_fix"])
    edges = sites["edges"]
    n_snp = int(spec["per_region"]["snps"])
    regions = []
    for s in range(len(edges) - 1):
        rows = []
        a, b = edges[s], edges[s + 1]
        for p in w.subs[(w.subs >= a) & (w.subs < b)].tolist():
            if p not in heavy:
                rows.append((p, base[w.asm[p]], base[w.true[p]], "1/1"))
        for j, p in enumerate(sites["spurious"][s].tolist()):
            ref = base[w.asm[p]]
            alt = ALT_OF[ref] if j < n_snp else \
                f"{ALT_OF[ref]},{ALT_OF[ALT_OF[ref]]}"
            rows.append((p, ref, alt, "1/1" if j < n_snp else "1/2"))
        h = int(sites["heavy_fix"][s])
        for v in range(int(spec["heavy_vars"])):
            p = h + v * int(spec["heavy_spacing"])
            ref = base[w.asm[p]]
            kind = v % 4
            if v == 0:
                rows.append((p, ref, base[w.true[p]], "1/1"))
            elif kind in (0, 1):
                rows.append((p, ref, ALT_OF[ref], "1/1"))
            elif kind == 2:
                rows.append((p, ref, f"{ALT_OF[ref]},{ALT_OF[ALT_OF[ref]]}",
                             "1/2"))
            else:
                rows.append((p, ref, ref + base[int(rng.integers(4))], "1/1"))
        rows.sort()
        regions.append("".join(f"{chrom}\t{p + 1}\t.\t{r}\t{a}\t{q}\tPASS\t.\t"
                               f"GT\t{gt}\n" for p, r, a, gt in rows))
    header = ("##fileformat=VCFv4.2\n" f"##contig=<ID={chrom}>\n"
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n")
    return dict(header=header, body="".join(regions),
                heavy=sorted(heavy), chrom=chrom)


def write_vcf(w: World, path: str) -> None:
    """The shard's VCF at ``path``."""
    with open(path, "w") as f:
        f.write(w.vcf["header"] + w.vcf["body"])
