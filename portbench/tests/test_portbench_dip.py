"""The diploid -polish mix (driver polish_dip, a -prob table) at a tiny
world on the CPU: a run is correct and reads its layers, each of its
controls comes out not correct, and so do runs with a fault planted in
the program's f64 path (the JAX package's two-level prefix sum put back
in place of the in-order sum; the in-order sum in float32; the table
dropped)."""

from __future__ import annotations

import json

import pytest
import torch

from portbench.control import control_readings
from portbench.run import run_cell
from portbench.tests.tiny import TINY_REPEATS, tiny_copy

CELL = "tiny.polish_dip"


def tiny_dip(dest):
    """A tiny copy of the benchmark with the cell ``tiny.polish_dip``."""
    base = tiny_copy(dest)
    c = json.loads((base / "configs/hg002-chr20-dip-k21.json").read_text())
    c.update(sequences=[["chr20_MATERNAL", 200000],
                        ["chr20_PATERNAL", 200000]],
             substitutions=30, error_kmers=20000, repeats=TINY_REPEATS)
    (base / "configs/tinydip.json").write_text(json.dumps(c))
    t = json.loads((base / "traffic/polish-dip.json").read_text())
    t["dip_vcf"].update(het_calls=40, spurious=20, multi=5, ties=12,
                        heavy=1, heavy_vars=7, control_cap=100,
                        check={"light": 1000, "het_site": 80, "ties": 24,
                               "heavy": 2})
    (base / "traffic/tiny_polish_dip.json").write_text(json.dumps(t))
    (base / f"workloads/{CELL}.json").write_text(json.dumps(
        {"config": "tinydip", "traffic": "tiny_polish_dip", "chips": 1}))
    return base


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny_dip(tmp_path_factory.mktemp("pbdip"))


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")


def test_run_is_correct(base):
    res = run_cell(CELL, 2**31 + 11, 0.5, False, device="cpu", base=base)
    assert res["correct"] is True, res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["compared"]["totdk_off"] == {"value": 0, "limit": 0}
    assert set(res["metrics"]) == {"polish_clusters_per_s", "setup_s"}
    c = res["info"]["counters"]
    assert c["scorer"] == "DeviceScorer" and c["f64_path"] is True
    assert c["het_records"] >= 12         # every tie site a 1/2 record
    assert res["info"]["stages"]["diploid_s"] > 0


def test_traced_run_reads_its_layers(base):
    res = run_cell(CELL, 7, 0.5, True, device="cpu", base=base)
    assert res["correct"] is True, res["compared"]
    # the device readers find nothing to read on the CPU: left out
    assert set(res["metrics"]) == {"load_s", "union_build_s",
                                   "scorer_share.polish_dip"}


def test_world_is_diploid(base):
    from portbench.drivers.polish_dip import build_diploid
    from portbench.reference.polish import clusters_of
    from portbench.run import load_json
    from portbench.world import make_world

    cfg = load_json(base, "configs", "tinydip")
    mix = load_json(base, "traffic", "tiny_polish_dip")
    w = make_world(cfg, mix, 2**31 + 5, torch.device("cpu"))
    build_diploid(w, mix["dip_vcf"], torch.device("cpu"))
    L = 200000
    mat, pat = w.true[:L], w.true[L:]
    assert w.true.size == w.asm.size == 2 * L
    assert 0.0005 < (mat != pat).mean() < 0.8   # het SNVs, indels shift
    body = w.vcf["body"]
    for gt in ("1/1", "0/1", "1/2"):
        assert f"\tGT\t{gt}\n" in body
    cl = clusters_of(w.vcf["header"] + body, w.k, 15)
    assert {c["chrom"] for c in cl} == set(w.names)
    assert len(w.vcf["het_calls"]) == 80 and len(w.vcf["tie_sites"]) == 24
    # a deletion among the het-site calls (REF longer than ALT)
    assert any(len(g[3][0]) > len(g[3][1]) for c in cl for g in c["gts"]
               if (c["chrom"], g[1]) in w.vcf["het_calls"])
    rows = [ln.split(",") for ln in w.table.splitlines()]
    assert len(rows) == 99 and [r[0] for r in rows[:3]] == ["0"] * 3
    assert rows[19][0] == "1" and rows[39][0] == "2"


def test_control_is_not_correct(base):
    """Each control, judged by the mix's limits as a run is, comes out
    not correct on every seed."""
    for seed in (1, 2, 3):
        got = control_readings(CELL, seed, torch.device("cpu"), base=base)
        assert set(got) == {"no_prob", "enumeration_cut", "float32"}
        # float32 misses the totdK's bits
        assert got["float32"]["compared"]["totdk_off"]["value"] > 0
        for name, c in got.items():
            assert c["correct"] is False, (seed, name, c)


def _two_level_sum(mp):
    from merfin_tpu_torch.ops import path_sum
    from merfin_tpu_torch.variants import device_score

    def two_level(values, b_start, b_end):
        at = device_score._prefix(values, torch.float64)
        return at(b_end) - at(b_start)
    mp.setattr(path_sum, "path_sums", two_level)


def _float32_sum(mp):
    from merfin_tpu_torch.ops import path_sum

    def in_float32(values, b_start, b_end):
        """The in-order sum, one precision below: float32."""
        v = values.float()
        lens = (b_end - b_start).clamp(min=0)
        out = torch.zeros(b_start.shape[0], dtype=torch.float32)
        for j in range(int(lens.max()) if lens.numel() else 0):
            idx = (b_start + j).clamp(max=v.numel() - 1)
            out = torch.where(lens > j, out + v[idx], out)
        return out.double()
    mp.setattr(path_sum, "path_sums", in_float32)


def _table_dropped(mp):
    from merfin_tpu_torch.variants import device_score

    fn = device_score.DeviceScorer.__init__

    def no_table(self, read_lookup, asm_lookup, k, peak, prob_table, *a,
                 **kw):
        fn(self, read_lookup, asm_lookup, k, peak, None, *a, **kw)
    mp.setattr(device_score.DeviceScorer, "__init__", no_table)


@pytest.mark.parametrize("fault", [_two_level_sum, _float32_sum,
                                   _table_dropped],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(base, monkeypatch, fault):
    fault(monkeypatch)
    res = run_cell(CELL, 2**31 + 21, 0.2, False, device="cpu", base=base)
    assert res["correct"] is False, res["compared"]
    assert res["failed"] >= 1
