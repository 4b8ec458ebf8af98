"""Scatter-gather variant evaluation across shards (a copy of
``scripts/scatter_polish.py`` that runs the torch port's CLI) — the
Slurm-array equivalent (scripts/parallel1/_submit_merfin.sh + merfin.sh
+ consensus.sh) as one tool, scheduler-agnostic.

Shard i takes every N-th scaffold (the reference's striping,
scripts/parallel1/merfin.sh:63-86) together with that scaffold's VCF
records, runs the requested mode, and writes `<out>.shardI.<mode>.vcf`.
`--gather` concatenates shard outputs in scaffold order (headers from
shard 0) — the bcftools-concat step.  Unlike the reference, shards
reuse one MKDB on shared storage; nothing is reloaded per node
beyond the memory-mapped arrays.

Run shards however you like (Slurm array, xargs -P, one per GPU host):

  python -m merfin_tpu_torch.tools.scatter_polish run --mode polish \
      --shards 8 --shard $I --sequence asm.fa --vcf calls.vcf \
      --readmers read.mkdb --seqmers asm.mkdb --peak 106.7 --output out
  python -m merfin_tpu_torch.tools.scatter_polish gather --mode polish \
      --shards 8 --output out

The device comes from MERFIN_PLATFORM, as for the CLI.
"""

from __future__ import annotations

import argparse
import os
import sys


def shard_inputs(seq_path: str, vcf_path: str, shards: int, shard: int, prefix: str):
    """Write the shard's FASTA + VCF subset; returns their paths."""
    from merfin_tpu_torch.io.compressed import open_read_text
    from merfin_tpu_torch.io.fasta import SeqFile

    keep: list[str] = []
    fa_out = f"{prefix}.shard{shard}.fasta"
    with open(fa_out, "w") as f:
        for i, seq in enumerate(SeqFile(seq_path)):
            if i % shards == shard:
                keep.append(seq.ident)
                f.write(f">{seq.ident}\n")
                b = seq.bases
                for j in range(0, len(b), 60):
                    f.write(b[j : j + 60].decode("ascii") + "\n")
    keep_set = set(keep)

    vcf_out = f"{prefix}.shard{shard}.vcf"
    with open_read_text(vcf_path) as fin, open(vcf_out, "w") as fout:
        for line in fin:
            if line.startswith("#") or line.split("\t", 1)[0] in keep_set:
                fout.write(line)
    return fa_out, vcf_out


def cmd_run(args) -> int:
    from merfin_tpu_torch.cli import merfin_main

    fa, vcf = shard_inputs(args.sequence, args.vcf, args.shards, args.shard,
                           args.output)
    out = f"{args.output}.shard{args.shard}"
    argv = [f"-{args.mode}", "-sequence", fa, "-vcf", vcf,
            "-readmers", args.readmers, "-output", out, "-resume"]
    if args.seqmers:
        argv += ["-seqmers", args.seqmers]
    if args.peak:
        argv += ["-peak", str(args.peak)]
    if args.prob:
        argv += ["-prob", args.prob]
    return merfin_main(argv)


def cmd_gather(args) -> int:
    suffix = "polish" if args.mode == "polish" else "filter"
    out_path = f"{args.output}.{suffix}.vcf"
    wrote_header = False
    with open(out_path, "w") as out:
        for i in range(args.shards):
            p = f"{args.output}.shard{i}.{suffix}.vcf"
            if not os.path.exists(p):
                # a shard with no sequences never opens its output
                print(f"note: no output from shard {i} ({p}); treating as empty",
                      file=sys.stderr)
                continue
            with open(p) as f:
                for line in f:
                    if line.startswith("#"):
                        if not wrote_header:
                            out.write(line)
                    else:
                        out.write(line)
            wrote_header = True
    print(f"wrote {out_path}")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m merfin_tpu_torch.tools.scatter_polish")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("run", "gather"):
        p = sub.add_parser(name)
        p.add_argument("--mode", default="polish",
                       choices=["polish", "filter", "better", "strict", "loose"])
        p.add_argument("--shards", type=int, required=True)
        p.add_argument("--output", required=True)
        if name == "run":
            p.add_argument("--shard", type=int, required=True)
            p.add_argument("--sequence", required=True)
            p.add_argument("--vcf", required=True)
            p.add_argument("--readmers", required=True)
            p.add_argument("--seqmers")
            p.add_argument("--peak", type=float)
            p.add_argument("--prob")
    args = ap.parse_args(argv)
    return cmd_run(args) if args.cmd == "run" else cmd_gather(args)


if __name__ == "__main__":
    raise SystemExit(main())
