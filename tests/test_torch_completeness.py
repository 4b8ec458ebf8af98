"""-completeness: the merfin_tpu_torch CLI on the CPU vs the JAX CLI
(bin/merfin-tpu) on the CPU, byte for byte on stderr, and the port's
run_completeness vs the JAX package's and tests/refmodel.py.

Worlds: the verify recipe's, a k=21 chip_parity-style world with a -prob
table, and a k=20 one.  The integer branch (readK < 2^32) is exact; the
f64 branch (peak 0, or a peak so small that readK reaches 2^32) prints
the same lines, and its returned floats agree to a relative 1e-12 (their
sums may be taken in another order)."""

import io
import math
import re
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as cs
from merfin_tpu.io.mkdb import KmerDB
from merfin_tpu.modes.completeness import run_completeness as jax_run
from merfin_tpu_torch.modes.completeness import (build_asm_table,
                                                 gather_readk,
                                                 run_completeness)
from merfin_tpu_torch.score.value_map import ValueMap
from tests import refmodel
from tests.test_torch_hist import WORLDS, _env
from tests.util import db_from_dict


def _completeness_argv(world, tmp_path):
    return cs.mode_argv(cs.materialize(world, str(tmp_path)), "completeness")


@pytest.mark.parametrize("name", WORLDS)
def test_completeness_port_matches_jax_cli(name, tmp_path):
    world = WORLDS[name]()
    argv = _completeness_argv(world, tmp_path)
    procs = {}
    for tag, pkg in (("port", "merfin_tpu_torch"), ("jax", "merfin_tpu")):
        procs[tag] = subprocess.Popen(
            cs.counted_cli(pkg) + argv, cwd=tmp_path, env=_env(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    err = {}
    for tag, p in procs.items():
        _, err[tag] = p.communicate(timeout=600)
        assert p.returncode == 0, (tag, err[tag][-3000:])
    assert err["port"] == err["jax"]
    lines = cs.completeness_lines(err["port"])
    assert len(lines) == 67
    assert lines[-3:] == cs.oracle_completeness(world)
    if name == "recipe":
        assert lines[-2:] == ["TOTAL undrcpy:           45.00000",
                              "COMPLETENESS:             0.97734"]


def _pack(s: str) -> int:
    return int(s.translate(str.maketrans("ACGT", "0123")), 4)


def test_asm_only_skip_hand_computed(tmp_path):
    """tests/test_adversarial.py's hand-computed case on the port: the
    asm-only k-mer adds nothing; per-slice lines land at key >> (2k-6)."""
    k = 5
    canon = {s: min(s, refmodel.revcomp(s))
             for s in ("ACGTA", "GGATC", "TTACG", "CATAG", "GCGCA")}
    both1, both2, ronly, low, aonly = canon.values()
    read_db = db_from_dict({both1: 5, both2: 3, ronly: 7, low: 1}, k,
                           str(tmp_path / "r"))
    asm_db = db_from_dict({both1: 1, both2: 4, low: 2, aonly: 9}, k,
                          str(tmp_path / "a"))
    log = io.StringIO()
    res = run_completeness(read_db, asm_db, peak=2.0, log=log, device="cpu")
    assert res["total"] == 10.0 and res["undrc"] == 6.0
    assert res["completeness"] == pytest.approx(1.0 - 6.0 / 10.0)

    shift = 2 * k - 6
    per_slice = {}
    for km, t, u in ((both1, 3, 2), (both2, 2, 0), (ronly, 4, 4), (low, 1, 0)):
        a, b = per_slice.get(_pack(km) >> shift, (0, 0))
        per_slice[_pack(km) >> shift] = (a + t, b + u)
    lines = {int(m.group(1)): (float(m.group(2)), float(m.group(3)))
             for m in re.finditer(
                 r"thread\s+(\d+) total\s+([\d.]+) underc\s+([\d.]+)",
                 log.getvalue())}
    assert len(lines) == 64
    for s in range(64):
        assert lines[s] == per_slice.get(s, (0.0, 0.0)), s


@pytest.mark.parametrize("name", ["k21", "k20"])
def test_blocks_ragged_tail_and_v1_table(name, tmp_path):
    """A block far smaller than the read DB (many blocks, a ragged tail,
    not a multiple of the 512-wide rows) and a v1 (window-join) table
    give the default run's lines, which equal the JAX package's and
    refmodel's totals."""
    world = WORLDS[name]()
    argv = cs.materialize(world, str(tmp_path))
    read_db, asm_db = KmerDB(argv[4]), KmerDB(argv[6])
    assert read_db.distinct % 3001 and read_db.distinct > 10 * 3001
    prob = None
    if world["prob"]:
        from merfin_tpu.io.prob import load_prob_table

        prob = load_prob_table(argv[argv.index("-prob") + 1],
                               log=io.StringIO())

    def lines(fn, **kw):
        log = io.StringIO()
        fn(read_db, asm_db, world["peak"], prob_table=prob, log=log, **kw)
        return cs.completeness_lines(log.getvalue())

    want = lines(jax_run)
    assert lines(run_completeness, device="cpu") == want
    assert lines(run_completeness, device="cpu", block=3001) == want
    v1 = cs.v1_table(asm_db, "cpu")
    assert lines(run_completeness, asm_table=v1, block=3001) == want
    v4 = build_asm_table(asm_db, world["k"], 1 << 22, "cpu")
    assert lines(run_completeness, asm_table=v4) == want
    assert want[-3:] == cs.oracle_completeness(world)


@pytest.mark.parametrize("peak", [
    0.1,     # integer branch, readK past u8 (the JAX u16 wire plane)
    0.0,     # f64 branch, readK inf: total not finite, completeness nan
    1e-6,    # f64 branch, readK past 2^32 in the map: finite sums
])
def test_wide_readk_and_f64_branch_match_jax(peak, tmp_path):
    k = 5
    canon = [min(s, refmodel.revcomp(s))
             for s in ("ACGTA", "GGATC", "TTACG", "CATAG")]
    rdb = db_from_dict(dict(zip(canon, [50, 100, 7, 3000])), k,
                       str(tmp_path / "r"))
    adb = db_from_dict(dict(zip(canon[:3], [1, 1, 1])), k,
                       str(tmp_path / "a"))
    logs = (io.StringIO(), io.StringIO())
    got = run_completeness(rdb, adb, peak, log=logs[0], device="cpu")
    want = jax_run(rdb, adb, peak, log=logs[1])
    assert logs[0].getvalue() == logs[1].getvalue()
    for key in ("total", "undrc", "completeness"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    if peak == 0.1:
        assert got["total"] == 500 + 1000 + 70 + 30000
        assert got["undrc"] == 499 + 999 + 69 + 30000
    elif peak == 0.0:   # inf prefix differences may give nan, as in JAX
        assert not math.isfinite(got["total"])
        assert math.isnan(got["completeness"])
    else:
        assert math.isfinite(got["total"]) and got["total"] > 3e9


# the value map's cap once the largest count passes 2^21; each count
# below is a DB row of the edge-count world (count 0 included)
_CAP = 1 << 22
EDGE_COUNTS = {"0": 0, "1": 1, "cap-1": _CAP - 1, "cap": _CAP,
               "cap+1": _CAP + 1, "2^31": 1 << 31, "2^32-1": (1 << 32) - 1}


@pytest.mark.parametrize("peak", [20.0, 0.0], ids=["int64_map", "f64_map"])
@pytest.mark.parametrize("count", list(EDGE_COUNTS.values()),
                         ids=list(EDGE_COUNTS))
def test_device_readk_gather_matches_host_gather(count, peak):
    """The device gather from raw counts carried as int32 bits reads the
    exact map where the host's ``rk_map[np.minimum(rv, cap)]`` does,
    in the map's dtype: int64, or f64 (inf past 0) at peak 0."""
    vmap = ValueMap(peak, None, max(EDGE_COUNTS.values()), exact_max=True)
    assert vmap.vcap == _CAP
    rk_map = vmap.read_k_host.astype(np.int64) if peak else vmap.read_k_host
    rv = np.array([count, 1, count, 0], np.uint32)
    want = rk_map[np.minimum(rv, np.uint32(_CAP))]
    got = gather_readk(torch.from_numpy(rk_map),
                       torch.from_numpy(rv.view(np.int32)), _CAP)
    assert got.dtype == torch.from_numpy(want).dtype
    np.testing.assert_array_equal(got.numpy(), want)


def _edge_dbs(tmp_path):
    """A k=5 read DB holding every EDGE_COUNTS count, on keys spread over
    several slices, and an asm DB sharing some of its k-mers (one asm
    count above its read count, one asm-only k-mer)."""
    k = 5
    canon = []
    for s in ("AAAAC", "ACGTA", "CATAG", "CCGTT", "GATCC", "GCGCA", "TTACG",
              "AGGAC"):
        c = min(s, refmodel.revcomp(s))
        if c not in canon:
            canon.append(c)
    reads = dict(zip(canon, EDGE_COUNTS.values()))
    asm = {canon[1]: 3, canon[2]: 1 << 22, canon[4]: 7, canon[6]: 2,
           canon[-1]: 9}
    assert len(reads) == len(EDGE_COUNTS) and canon[-1] not in reads
    return (db_from_dict(reads, k, str(tmp_path / "r")),
            db_from_dict(asm, k, str(tmp_path / "a")))


@pytest.mark.parametrize("peak", [
    20.0,    # int64 map
    1e-6,    # f64 map: readK past 2^32 in the map
    0.0,     # f64 map: inf readK (the CLI takes no -peak 0)
])
def test_edge_counts_ragged_blocks_match_jax_cli(peak, tmp_path):
    """The edge counts through run_completeness in blocks of 3 (a ragged
    last block of 1) and in one block: per-slice lines and totals equal
    the JAX package's, and, where the CLI takes the peak, the JAX CLI's
    and the port CLI's stderr byte for byte."""
    rdb, adb = _edge_dbs(tmp_path)
    assert rdb.distinct % 3 == 1

    def port_log(**kw):
        log = io.StringIO()
        got = run_completeness(rdb, adb, peak, log=log, device="cpu", **kw)
        return log.getvalue(), got

    log3, got3 = port_log(block=3)
    log1, got1 = port_log()
    jlog = io.StringIO()
    want = jax_run(rdb, adb, peak, log=jlog)
    assert log3 == log1 == jlog.getvalue()
    for got in (got3, got1):
        for key in ("total", "undrc", "completeness"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    if peak == 20.0:   # the integer branch sums exactly
        assert got3 == want
    if peak == 0.0:
        return
    argv = ["-completeness", "-readmers", rdb.path, "-seqmers", adb.path,
            "-peak", repr(peak)]
    err = {}
    for tag, pkg in (("port", "merfin_tpu_torch"), ("jax", "merfin_tpu")):
        p = subprocess.run(cs.counted_cli(pkg) + argv, cwd=tmp_path,
                           env=_env(tmp_path), capture_output=True,
                           text=True, timeout=600)
        assert p.returncode == 0, (tag, p.stderr[-3000:])
        err[tag] = p.stderr
    assert err["port"] == err["jax"]
    assert cs.completeness_lines(err["jax"]) == \
        cs.completeness_lines(log3)
