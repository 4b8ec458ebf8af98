"""The light -polish mix (``polish-light``: the polish driver on a VCF
whose heavy clusters are lone fixes) at a tiny world on the CPU: every
cluster is light, a run is correct and reads its layers, and its control
(each cluster cut to ``control_cap`` paths) comes out not correct."""

from __future__ import annotations

import json

import pytest
import torch

from portbench.control import control_readings
from portbench.run import run_cell
from portbench.tests.tiny import tiny_copy

CELL = "tiny.polish-light"


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A tiny copy of the benchmark with the cell ``tiny.polish-light``:
    the mix's own parameters at the tiny polish cell's sizes."""
    base = tiny_copy(tmp_path_factory.mktemp("pblight"))
    t = json.loads((base / "traffic/polish-light.json").read_text())
    t["vcf"].update(regions=2, per_region={"snps": 10, "multi": 5},
                    check={"light": 1000, "heavy": 0})
    (base / "traffic/tiny_polish_light.json").write_text(json.dumps(t))
    (base / f"workloads/{CELL}.json").write_text(json.dumps(
        {"config": "tinyx", "traffic": "tiny_polish_light", "chips": 1}))
    return base


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")


def test_mix_is_all_light(base):
    from portbench.reference.polish import clusters_of
    from portbench.run import load_json
    from portbench.world import make_world

    mix = load_json(base, "traffic", "tiny_polish_light")
    assert mix["vcf"]["heavy_vars"] == 1 and mix["vcf"]["control_cap"] <= 2
    w = make_world(load_json(base, "configs", "tinyx"), mix, 2**31 + 5,
                   torch.device("cpu"))
    cl = clusters_of(w.vcf["header"] + w.vcf["body"], w.k, 15)
    assert len(cl) > 30 and max(len(c["gts"]) for c in cl) <= 2


def test_run_is_correct(base):
    res = run_cell(CELL, 2**31 + 11, 0.5, False, device="cpu", base=base)
    assert res["correct"] is True, res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {"polish_clusters_per_s", "setup_s"}
    assert res["info"]["counters"]["heavy_clusters"] == 0


def test_traced_run_reads_its_layers(base):
    res = run_cell(CELL, 7, 0.5, True, device="cpu", base=base)
    assert res["correct"] is True, res["compared"]
    # the device readers find nothing to read on the CPU: left out
    assert set(res["metrics"]) == {"load_s", "union_build_s",
                                   "scorer_share.polish"}


def test_control_is_not_correct(base):
    for seed in (1, 2, 3):
        got = control_readings(CELL, seed, torch.device("cpu"), base=base)
        assert set(got) == {"enumeration_cut"}
        assert got["enumeration_cut"]["correct"] is False, (seed, got)
