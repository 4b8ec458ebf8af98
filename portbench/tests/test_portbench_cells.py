"""Each mix of the benchmark at a tiny world on the CPU, with the
kernels' plain versions: a run is correct, reports its metrics, and the
control of its check fails."""

from __future__ import annotations

import pytest
import torch

from portbench.control import control_readings
from portbench.run import run_cell
from portbench.tests.tiny import tiny_copy

CELLS = {"tiny.completeness": "completeness_kmers_per_s",
         "tiny.polish": "polish_clusters_per_s"}


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("pb"))


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_run_is_correct(base, cell):
    res = run_cell(cell, 2**31 + 11, 0.5, False, device="cpu", base=base)
    assert res["correct"] is True, res["compared"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) == {CELLS[cell], "setup_s"}
    assert res["metrics"][CELLS[cell]]["value"] > 0
    assert list(res)[-1] == "compared"
    for c in res["compared"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell,layer", [
    ("tiny.completeness", {"load_s", "asm_table_s"}),
    ("tiny.polish", {"load_s", "union_build_s", "scorer_share.polish"})])
def test_traced_run_reads_its_layers(base, cell, layer):
    res = run_cell(cell, 7, 0.5, True, device="cpu", base=base)
    assert res["correct"] is True, res["compared"]
    # the device readers find nothing to read on the CPU: left out
    assert set(res["metrics"]) == layer
    assert CELLS[cell] not in res["metrics"]
    assert "breakdown" in res and res["device"]["busy_s"] == 0.0


def test_same_seed_same_world(base):
    from portbench.run import load_json
    from portbench.world import make_world

    cfg = load_json(base, "configs", "tiny")
    dev = torch.device("cpu")
    a, b = (make_world(cfg, {}, 2**31 + 3, dev) for _ in range(2))
    c = make_world(cfg, {}, 5, dev)
    assert (a.asm == b.asm).all() and (a.read_vals == b.read_vals).all()
    assert (a.read_keys == b.read_keys).all()
    assert not (a.asm == c.asm).all()
    assert a.asm.size == c.asm.size == 98000


@pytest.mark.parametrize("cell,control", [
    ("tiny.completeness", "fingerprint"),
    ("tiny.polish", "enumeration_cut")])
def test_control_is_not_correct(base, cell, control):
    """Each control, judged by its mix's limits as a run is, comes out
    not correct on every seed."""
    for seed in (1, 2, 3):
        got = control_readings(cell, seed, torch.device("cpu"), base=base)
        assert set(got) == {control}
        assert got[control]["correct"] is False, (seed, got)
        assert any(c["value"] > c["limit"]
                   for c in got[control]["compared"].values())
