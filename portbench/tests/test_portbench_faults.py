"""Runs with the timed path broken underneath come out not correct:
the chip's look is skipped and the rest of a run is driven on the CPU at
a tiny world, once for each fault a cell can have (one card, so no
exchange between chips): a step that returns its state unchanged, half
of the work left out, and an answer altered where it is produced."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.run import run_cell
from portbench.tests.tiny import tiny_copy


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("pb"))


@pytest.fixture(autouse=True)
def cpu(monkeypatch):
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")


def _completeness_state_unchanged(mp):
    from merfin_tpu_torch.modes import completeness

    fn = completeness.block_stats

    def zero(*a):
        t, u = fn(*a)
        return torch.zeros_like(t), torch.zeros_like(u)
    mp.setattr(completeness, "block_stats", zero)


def _completeness_half(mp):
    from merfin_tpu_torch.modes import completeness

    fn = completeness.block_stats

    def half(table, bounds_b, q_keys, q_readk):
        n = q_keys.shape[0] // 2
        return fn(table, bounds_b, q_keys[:n], q_readk[:n])
    mp.setattr(completeness, "block_stats", half)


def _sorted_altered(mp):
    from merfin_tpu_torch.ops import sorted_join

    fn = sorted_join.SortedJoinTable.lookup_sorted

    def altered(self, q):
        v = fn(self, q).clone()
        v[: 1000] = 0
        return v
    mp.setattr(sorted_join.SortedJoinTable, "lookup_sorted", altered)


def _scorer_state_unchanged(mp):
    from merfin_tpu_torch.variants import device_score

    fn = device_score.DeviceScorer.fetch_paths

    def zero(self, token):
        nm, td = fn(self, token)
        return np.zeros_like(nm), np.zeros_like(td)
    mp.setattr(device_score.DeviceScorer, "fetch_paths", zero)


def _scorer_half(mp):
    from merfin_tpu_torch.variants import device_score

    fn = device_score.DeviceScorer.fetch_paths

    def half(self, token):
        nm, td = fn(self, token)
        nm = nm.copy()
        nm[nm.shape[0] // 2:] = nm[: nm.shape[0] - nm.shape[0] // 2]
        return nm, td
    mp.setattr(device_score.DeviceScorer, "fetch_paths", half)


def _scorer_altered(mp):
    from merfin_tpu_torch.variants import device_score

    fn = device_score.DeviceScorer.fetch_paths

    def altered(self, token):
        nm, td = fn(self, token)
        nm = nm.copy()
        nm[nm == nm.min()] += 1000
        return nm, td
    mp.setattr(device_score.DeviceScorer, "fetch_paths", altered)


FAULTS = {
    "tiny.completeness": [_completeness_state_unchanged, _completeness_half,
                          _sorted_altered],
    "tiny.polish": [_scorer_state_unchanged, _scorer_half, _scorer_altered],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_not_correct(base, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run_cell(cell, 2**31 + 21, 0.2, False, device="cpu", base=base)
    assert res["correct"] is False, res["compared"]
    assert res["failed"] >= 1
