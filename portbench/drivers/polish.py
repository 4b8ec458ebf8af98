"""-polish: each pass is one shard job's variant loop, run as the CLI
runs a variant mode (``cli.py:_run_variant_mode``): the shard's whole
VCF (``VcfFile``, its clusters merged at -comb), the assembly FASTA
parsed once, and ``modes/variants.py:run_variants`` with the fused
device scorer built once in set-up (``DeviceScorer``, union join).
Every pass runs the same VCF, so every pass makes the same join calls.

Set-up: the DB handles and ``build_lookup`` (``load_s``), the scorer with
its union table merged and uploaded (``union_build_s``); the union
route is asked for by name, as the CLI's default takes it on a card.  A
pass's work is the VCF's clusters.  A sample of them, drawn from the
seed with heavy ones in it, is checked in every pass's output against
``reference/polish.py``.
"""

from __future__ import annotations

import io
import os

import numpy as np

from portbench.memdb import MemDB

RATE = ("polish_clusters_per_s", "clusters/s")
SCORER = ("dispatch_paths", "fetch_paths")


def wrap(spans) -> None:
    """The fused scorer's entry methods; and, to name the trace's idle
    gaps, run_variants' steps: the VCF, the FASTA, each cluster's window,
    enumeration and selection."""
    from merfin_tpu_torch.io.fasta import SeqFile
    from merfin_tpu_torch.io.vcf import VcfFile
    from merfin_tpu_torch.modes import variants
    from merfin_tpu_torch.variants.device_score import DeviceScorer

    for name in SCORER:
        spans.wrap(DeviceScorer, name)
    spans.wrap(VcfFile, "_load", "vcf load")
    spans.wrap(VcfFile, "merge_clusters", "vcf merge")
    spans.wrap(SeqFile, "__iter__", "fasta parse")
    spans.wrap(variants, "prepare_cluster_args", "cluster window")
    spans.wrap(variants, "_enumerate_block_task", "enumeration")
    spans.wrap(variants, "_select_block_task", "selection")


def unwrap(spans) -> None:
    spans.unwrap()


def _db_max(vals) -> int:
    return int(np.asarray(vals).max()) if vals.size else 1


class Bench:
    def __init__(self, ctx, world, config, traffic):
        from merfin_tpu_torch.table.lookup import build_lookup
        from merfin_tpu_torch.variants.device_score import DeviceScorer

        from portbench.reference.polish import clusters_of
        from portbench.world import write_vcf

        spec = traffic["vcf"]
        self.ctx, self.k, self.peak = ctx, world.k, world.peak
        self.comb = int(spec["comb"])
        self.threads = int(config["threads"]["polish"])
        self.fasta = os.path.join(ctx.tmp, "asm.fasta")
        self.vcf = os.path.join(ctx.tmp, "shard.vcf")
        self.out = os.path.join(ctx.tmp, "out")
        world.write_fasta(self.fasta)
        write_vcf(world, self.vcf)
        cl = clusters_of(world.vcf["header"] + world.vcf["body"], world.k,
                         self.comb)
        self.clusters = len(cl)
        self.heavy = sum(len(c["gts"]) > 2 for c in cl)
        with ctx.stage("load_s"):
            read_db = MemDB("read.mkdb", world.k, world.read_keys,
                            world.read_vals)
            asm_db = MemDB("asm.mkdb", world.k, world.asm_keys,
                           world.asm_vals)
            self.read_lookup = build_lookup(read_db, device=ctx.device)
            self.asm_lookup = build_lookup(asm_db, device=ctx.device)
        with ctx.stage("union_build_s"):
            self.scorer = DeviceScorer(self.read_lookup, self.asm_lookup,
                                       world.k, world.peak, None,
                                       max_value=_db_max(read_db.vals),
                                       exact_max=True, sortjoin=True)
        self.outputs: list = []

    def one_pass(self) -> int:
        from merfin_tpu_torch.io.fasta import SeqFile
        from merfin_tpu_torch.io.vcf import VcfFile
        from merfin_tpu_torch.modes.variants import run_variants

        log = io.StringIO()
        vcf = VcfFile(self.vcf, log=log)
        vcf.merge_clusters(self.k, self.comb, False, log=log)
        run_variants("polish", SeqFile(self.fasta), vcf, self.k,
                     self.read_lookup.lookup_np, self.asm_lookup.lookup_np,
                     self.peak, None, self.out, comb=self.comb, log=log,
                     threads=self.threads, scorer=self.scorer)
        self.ctx.sync()
        with open(f"{self.out}.polish.vcf") as f:
            self.outputs.append(f.read())
        return self.clusters

    def counters(self) -> dict:
        return {"clusters": self.clusters, "heavy_clusters": self.heavy,
                "union_table_bytes": self.scorer.table.nbytes()}

    def close(self) -> None:
        self.scorer.close()
        self.scorer = None


def setup(ctx, world, config, traffic) -> Bench:
    return Bench(ctx, world, config, traffic)


def sample(world, spec: dict, clusters: list[dict]) -> list[int]:
    """Indices of the clusters to check, drawn from the world's seed:
    ``check.heavy`` of the heavy ones and ``check.light`` of the rest."""
    rng = np.random.default_rng(world.seed + 14)
    heavy = [i for i, c in enumerate(clusters) if len(c["gts"]) > 2]
    light = [i for i, c in enumerate(clusters) if len(c["gts"]) <= 2]
    picks = [heavy[j] for j in rng.permutation(len(heavy))
             [: int(spec["check"]["heavy"])]]
    n = min(len(light), int(spec["check"]["light"]))
    picks += [light[j] for j in rng.choice(len(light), n, replace=False)]
    return sorted(picks)


def _expected(world, spec, device, cap=None):
    """(the reference's records of each sampled cluster, the clusters)."""
    from portbench.reference.polish import (Scorer, clusters_of,
                                            expected_records)

    seq = bytes(np.frombuffer(b"ACGT", np.uint8)[world.sequence(0)]).decode()
    cl = clusters_of(world.vcf["header"] + world.vcf["body"], world.k,
                     int(spec["comb"]))
    scorer = Scorer(world, device)
    return {i: expected_records(cl[i], seq, scorer, cap=cap)
            for i in sample(world, spec, cl)}, cl


def compare(expected: dict, clusters: list[dict], text: str) -> dict:
    from portbench.reference.polish import records_by_cluster

    recs, stray = records_by_cluster(text, clusters)
    # sampled clusters whose records differ, and records at no variant
    return {"records_off": stray + sum(recs[i] != v
                                       for i, v in expected.items())}


def judge(world, outputs, traffic, device) -> list[dict]:
    """The compared numbers of each pass: its sampled clusters against
    the reference's records."""
    exp, cl = _expected(world, traffic["vcf"], device)
    return [compare(exp, cl, text) for text in outputs]


def control(world, traffic, device) -> dict:
    """The numbers of the control, the reference in the program's place
    with each cluster's paths cut at ``control_cap`` (the enumeration
    cut short), against the full reference, over the same sample."""
    spec = traffic["vcf"]
    exp, cl = _expected(world, spec, device)
    ctl, _ = _expected(world, spec, device, cap=int(spec["control_cap"]))
    text = world.vcf["header"] + "".join(ctl[i] for i in sorted(ctl))
    return {"enumeration_cut": compare(exp, cl, text)}
