"""The plain reference of -polish (merfin-variants.C, varMer.C) for a
sample of a VCF's clusters: the clusters merged as vcf.C:154-246 merges
them, each cluster's window (merfin-variants.C:166-176), its paths by
``refmodel.traverse_paths``, every path's missing k-mers (numM) and
k* gain (totdK, no -prob table) in plain torch on the world's DB arrays,
and the record ``refmodel.ref_best_variant`` selects.

The control evaluates at most ``cap`` paths of a cluster, in the order
traverse() makes them: the enumeration cut short, where the
configuration states that every cluster of up to -comb variants is
evaluated over all its paths.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import refmodel
from portbench.reference.values import db_values, get_k, to_device

_CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[ord(chr(_c).lower())] = _i
_U32 = 1 << 32


def parse_vcf(text: str) -> list[tuple]:
    """(chrom, pos0, qual, alleles, ref_len) of each record, alleles as
    vcf.C:23-87 takes them from the GT (REF first)."""
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        w = line.split("\t")
        ref, alts = w[3], w[4].split(",")
        alleles = [ref]
        gt = w[9].split(":")[0]
        if not (gt.startswith("./.") or gt.startswith("0/0")):
            seen = set()
            for tok in gt.replace("|", "/").split("/"):
                i = int(tok) if tok.isdigit() else 0
                if 0 < i <= len(alts) and i not in seen:
                    seen.add(i)
                    if alts[i - 1] != ref:
                        alleles.append(alts[i - 1])
        out.append((w[0], int(w[1]) - 1, float(w[5]), alleles, len(ref)))
    return out


def clusters_of(text: str, k: int, comb: int) -> list[dict]:
    """Clusters in vcf.C's order: records sorted by start, merged while
    a record starts within 2k of the cluster's end, a new cluster once
    one holds ``comb`` records (no -nosplit)."""
    by_chrom: dict[str, list] = {}
    for r in parse_vcf(text):
        by_chrom.setdefault(r[0], []).append(r)
    out = []
    for chrom, recs in by_chrom.items():
        recs = sorted(recs, key=lambda r: r[1])
        cl = []
        for r in recs:
            if cl and r[1] < cl[-1]["end"] + 2 * k \
                    and len(cl[-1]["gts"]) < comb:
                c = cl[-1]
                c["gts"].append(r)
                c["start"] = min(c["start"], r[1])
                c["end"] = max(c["end"], r[1] + r[4])
            else:
                cl.append({"chrom": chrom, "gts": [r], "start": r[1],
                           "end": r[1] + r[4]})
        out += cl
    return out


class Scorer:
    """numM and totdK of paths against the world's DBs, on ``device``."""

    def __init__(self, world, device):
        self.k, self.peak, self.device = world.k, world.peak, device
        self.rk = to_device(world.read_keys, device)
        self.rv = to_device(world.read_vals, device)
        self.ak = to_device(world.asm_keys, device)
        self.av = to_device(world.asm_vals, device)

    def score(self, paths, rows: int = 1 << 15):
        """(numM list, totdK list) of traverse_paths' paths, in blocks
        of ``rows`` paths."""
        num_m, totdk = [], []
        for lo in range(0, len(paths), rows):
            m, t = self._block(paths[lo: lo + rows])
            num_m += m
            totdk += t
        return num_m, totdk

    def _block(self, paths):
        k, dev = self.k, self.device
        lens = np.asarray([len(p[0]) for p in paths], np.int64)
        L = int(lens.max())
        codes = np.full((len(paths), L), 4, np.uint8)
        for i, p in enumerate(paths):
            codes[i, : lens[i]] = _CODE[np.frombuffer(p[0].encode(), np.uint8)]
        W = max(1, L - k + 1)
        c = torch.from_numpy(codes).to(dev)
        good = c < 4
        ci = torch.where(good, c, torch.zeros_like(c)).to(torch.int64)
        P = len(paths)
        fmer = torch.zeros((P, W), dtype=torch.int64, device=dev)
        rmer = torch.zeros_like(fmer)
        ok = torch.ones((P, W), dtype=torch.bool, device=dev)
        for j in range(k):
            cj = ci[:, j: j + W]
            fmer = (fmer << 2) | cj
            rmer |= (3 - cj) << (2 * j)
            ok &= good[:, j: j + W]
        q = torch.minimum(fmer, rmer)
        idx = torch.arange(W, device=dev)
        n_win = torch.from_numpy(lens - k + 1).to(dev)
        in_range = idx[None, :] < n_win[:, None]
        zero = torch.zeros((), dtype=torch.float64, device=dev)
        r = torch.where(ok, get_k(db_values(self.rk, self.rv, q), self.peak,
                                  torch.float64), zero)
        a = torch.where(ok, db_values(self.ak, self.av, q).to(torch.float64),
                        zero)
        num_m = ((r == 0) & in_range).sum(1)
        # asmK + 1 where the window overlaps a variant the path takes
        # (varMer.C:108, uint32 arithmetic for the window's start)
        V = len(paths[0][1])
        gp = torch.tensor([p[1] for p in paths], device=dev).reshape(P, V)
        ip = torch.tensor([p[2] for p in paths], device=dev).reshape(P, V)
        lp = torch.tensor([p[3] for p in paths], device=dev).reshape(P, V)
        lo = (ip + 1 - k) % _U32
        hi = ip + lp + k
        cover = torch.zeros((P, W), dtype=torch.bool, device=dev)
        for v in range(V):
            cover |= (gp[:, v: v + 1] > 0) & (idx[None, :] >= lo[:, v: v + 1]) \
                & (idx[None, :] < hi[:, v: v + 1])
        dk = (r - a).abs() - (r - (a + cover.to(torch.float64))).abs()
        totdk = torch.where(in_range, dk, zero).sum(1)
        return num_m.cpu().tolist(), totdk.cpu().tolist()


def window(cluster: dict, k: int, seq_len: int) -> tuple[int, int]:
    """merfin-variants.C:166-176, with its uint32 arithmetic."""
    r_start, r_end = cluster["start"], cluster["end"]
    r_start = r_start - (k - 1) if r_start > k - 1 else 0
    r_end = r_end + (k - 1) if r_end < (seq_len - (k - 1)) % _U32 else seq_len
    return r_start, r_end


def expected_records(cluster: dict, seq: str, scorer: Scorer,
                     cap: int | None = None) -> str:
    """The records -polish writes for ``cluster`` (bestVariant)."""
    k = scorer.k
    r_start, r_end = window(cluster, k, len(seq))
    if r_start >= r_end or r_end > len(seq):
        return ""
    gts = cluster["gts"]
    paths = refmodel.traverse_paths(
        seq[r_start:r_end], [(g[1] - r_start) % _U32 for g in gts],
        [g[4] for g in gts], [g[3] for g in gts])
    if cap is not None:
        paths = paths[:cap]
    if not paths:
        return ""
    num_m, totdk = scorer.score(paths)
    return refmodel.ref_best_variant(
        [p[0] for p in paths], num_m, [p[1] for p in paths],
        [[t] for t in totdk], cluster["chrom"],
        [(g[1], g[2], g[3]) for g in gts], k)


def records_by_cluster(vcf_out: str, clusters: list[dict]) -> list[str]:
    """The output records of each cluster, in file order: a record
    belongs to the cluster one of whose variants sits at its position."""
    at = {}
    for i, c in enumerate(clusters):
        for g in c["gts"]:
            at[(c["chrom"], g[1] + 1)] = i
    got = [""] * len(clusters)
    stray = 0
    for line in vcf_out.splitlines(keepends=True):
        if line.startswith("#"):
            continue
        w = line.split("\t")
        i = at.get((w[0], int(w[1])))
        if i is None:
            stray += 1
        else:
            got[i] += line
    return got, stray
