"""VCF input stack — vcfRecord / gtAllele / posGT / vcfFile semantics.

Reference: vcfRecord.H:50-100, vcf.C:23-149 (parsing, allele extraction)
and vcf.C:154-246 (cluster merging).  Deliberately preserved quirks:

  * A record needs >= 10 tab-separated columns (vcfRecord.H:53).
  * Alleles come from the FIRST sample's first ':' field (the GT);
    "./." and "0/0" prefixes yield an EMPTY allele list (vcf.C:34-39) —
    such a variant inside a cluster suppresses every enumeration path of
    that cluster (traverse() iterates zero haplotypes at its position).
  * GT tokens parse with C strtol semantics: non-numeric -> 0 -> skipped
    (vcf.C:54-59); the "invalidate" flag this sets is never read back by
    merfin, so het records (0/1) ARE evaluated.
  * ALT dedup is by ALT-column index (pointer identity in the reference,
    vcf.C:70-75) plus a string compare against the REF allele only
    (vcf.C:79-81) — two ALT columns with identical strings both survive.
  * Cluster merge window is rEnd + 2k (K_OFFSET, vcf.C:159,201); clusters
    reaching `comb` members start a new cluster unless -nosplit
    (vcf.C:213-223); only the FIRST gt of a merged-in cluster is adopted
    (vcf.C:231).
"""

from __future__ import annotations

import dataclasses
import re
import sys

from merfin_tpu_torch.utils.spans import span


def _strtol(s: str) -> int:
    """C strtol: parse optional sign + leading digits, 0 if none."""
    m = re.match(r"\s*([+-]?\d+)", s)
    return int(m.group(1)) if m else 0


@dataclasses.dataclass
class VcfRecord:
    chrom: str
    pos: int          # 1-based POS column
    id: str
    ref: str
    alts: str         # raw ALT column
    qual: float
    filter: str
    info: str
    formats: str
    samples: str      # first sample column

    alt_list: list[str] = dataclasses.field(default_factory=list)

    @classmethod
    def load(cls, line: str) -> "VcfRecord | None":
        words = line.split("\t")
        if len(words) < 10:
            return None
        try:
            pos = int(words[1])
        except ValueError:
            pos = 0xFFFFFFFF  # uint32max default (vcfRecord.H:125)
        try:
            qual = float(words[5])
        except ValueError:
            qual = 0.0
        r = cls(
            chrom=words[0], pos=pos, id=words[2], ref=words[3], alts=words[4],
            qual=qual, filter=words[6], info=words[7], formats=words[8],
            samples=words[9],
        )
        r.alt_list = words[4].split(",")
        return r

    def save(self) -> str:
        """vcfRecord::save() string form (vcfRecord.H:96): qual as %.1f."""
        return (f"{self.chrom}\t{self.pos}\t{self.id}\t{self.ref}\t{self.alts}\t"
                f"{self.qual:.1f}\t{self.filter}\t{self.info}\t{self.formats}\t"
                f"{self.samples}\n")


class GtAllele:
    """Per-record allele list (vcf.C:23-87)."""

    def __init__(self, record: VcfRecord):
        self.record = record
        self.pos = (record.pos - 1) & 0xFFFFFFFF   # uint32 _pos = POS - 1
        self.ref_len = len(record.ref)
        self.qual = record.qual
        self.alleles: list[str] = []               # [0] is REF when non-empty

        gt_field = record.samples.split(":")[0]
        if gt_field.startswith("./.") or gt_field.startswith("0/0"):
            return                                  # empty allele list

        self.alleles.append(record.ref)

        seen_alt_idx: set[int] = set()
        for tok in re.split(r"[|/]", gt_field):
            alt_idx = _strtol(tok)
            if alt_idx <= 0:
                continue
            if alt_idx - 1 >= len(record.alt_list):
                continue                            # out-of-range ALT index
            if alt_idx in seen_alt_idx:             # pointer-identity dedup
                continue
            seen_alt_idx.add(alt_idx)
            hap = record.alt_list[alt_idx - 1]
            if hap == record.ref:                   # string dedup vs REF only
                continue
            self.alleles.append(hap)


class PosGT:
    """A cluster of nearby variants (vcf.H:57-84)."""

    def __init__(self, record: VcfRecord):
        gt = GtAllele(record)
        self.chrom = record.chrom
        self.gts: list[GtAllele] = [gt]
        self.r_start = gt.pos
        self.r_end = gt.pos + gt.ref_len

    def add_gt(self, gt: GtAllele) -> None:
        self.gts.append(gt)
        self.r_start = min(self.r_start, gt.pos)
        self.r_end = max(self.r_end, gt.pos + gt.ref_len)


class VcfFile:
    """Streaming VCF loader + cluster merger (vcf.C:93-246)."""

    def __init__(self, path: str, log=sys.stderr):
        self.headers: list[str] = []
        self.records: list[VcfRecord] = []
        self.by_chrom: dict[str, list[PosGT]] = {}
        self._num_chr = 0
        self._load(path, log)

    def _load(self, path: str, log) -> None:
        with span("vcf.load") as h:
            self._read(path, log)
            h.count("records", len(self.records))

    def _read(self, path: str, log) -> None:
        from merfin_tpu_torch.io.compressed import open_read_text

        excluded = 0
        with open_read_text(path) as f:
            for raw in f:
                line = raw.rstrip("\n").rstrip("\r")
                if line.startswith("#"):
                    self.headers.append(line)
                    if line.startswith("##contig=<ID"):
                        self._num_chr += 1
                    continue
                rec = VcfRecord.load(line)
                if rec is None:
                    excluded += 1
                    continue
                self.records.append(rec)
                self.by_chrom.setdefault(rec.chrom, []).append(PosGT(rec))

        print(f"   Collected {len(self.headers)} header lines.", file=log)
        print(f"   Loaded {len(self.records)} records:", file=log)
        s = "" if len(self.by_chrom) == 1 else "s"
        print(f"      {len(self.by_chrom):<8} unique contig{s}", file=log)
        print(f"      {self._num_chr:<8} contig IDs", file=log)
        print(f"   Excluded {excluded} invalid records", file=log)
        print("", file=log)

    def merge_clusters(self, ksize: int, comb: int, nosplit: bool, log=sys.stderr) -> None:
        """mergeChrPosGT (vcf.C:154-246)."""
        with span("vcf.merge") as h:
            self._merge(ksize, comb, nosplit, log)
            h.count("clusters", sum(len(c) for c in self.by_chrom.values()))

    def _merge(self, ksize: int, comb: int, nosplit: bool, log) -> None:
        k_offset = 2 * ksize

        for chrom, inlist in self.by_chrom.items():
            # std::sort by _rStart; we use a stable sort (deterministic).
            inlist = sorted(inlist, key=lambda p: p.r_start)
            otlist: list[PosGT] = [inlist[0]]
            removed = split = merged = 0

            for cur in inlist[1:]:
                if len(cur.gts) == 0:       # unreachable by construction, kept for parity
                    removed += 1
                    continue
                overlapping = cur.r_start < otlist[-1].r_end + k_offset
                toomany = len(otlist[-1].gts) >= comb
                if not overlapping:
                    otlist.append(cur)
                elif toomany and not nosplit:
                    otlist.append(cur)
                    split += 1
                else:
                    otlist[-1].add_gt(cur.gts[0])
                    merged += 1

            print(f"{chrom} : Reduced {len(inlist)} variants down to {len(otlist)} "
                  f"combinations for evaluation:", file=log)
            if removed:
                print(f"{chrom} :   Removed {removed} empty alleles.", file=log)
            if split:
                print(f"{chrom} :   Split   {split} complicated combinations.", file=log)
            if merged:
                print(f"{chrom} :   Merged  {merged} variants into combinations.", file=log)

            self.by_chrom[chrom] = otlist
