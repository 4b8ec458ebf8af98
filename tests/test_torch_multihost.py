"""Two-process launches of the port's CLI over torch.distributed (gloo,
on the CPU): every shape the JAX package's tests/test_multihost.py runs,
each byte-identical to one process.

  * striped: one device per process; sequences, DB slices and input
    blocks stripe over the ranks, accumulators merge, rank 0 writes;
  * spans: ``-mesh 2x4`` and ``-mesh 1x8`` over two processes of 4
    logical devices (``MERFIN_CPU_DEVICES=4``), and ``-mesh 2x3`` over
    three of 2, the probe sums of a row adding over the processes that
    hold its entries.

Every subprocess has a timeout, and the collectives one of their own
(``MERFIN_DIST_TIMEOUT``), so a rank that misses a collective fails the
test instead of hanging it.
"""

import gzip
import os
import random
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from merfin_tpu_torch.io.mkdb import KmerDB
from tests import refmodel
from tests.util import db_from_dict, random_dna

K = 11
ALT_OF = {"A": "C", "C": "G", "G": "T", "T": "A"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """tests/test_multihost.py's world: 3 scaffolds of 500 bp (so both
    ranks get stripes), one error each, the reads at 20x, a VCF of the
    three corrections."""
    tmp = tmp_path_factory.mktemp("tmh")
    rng = random.Random(31)
    scaffolds = []
    for i in range(3):
        g = random_dna(rng, 500)
        asm = list(g)
        p = 100 + 60 * i
        asm[p] = ALT_OF[asm[p]]
        scaffolds.append(("".join(asm), g, p))
    db_from_dict(refmodel.count_canonical([g for _, g, _ in scaffolds] * 20,
                                          K), K, str(tmp / "read.mkdb"))
    db_from_dict(refmodel.count_canonical([a for a, _, _ in scaffolds], K),
                 K, str(tmp / "asm.mkdb"))
    (tmp / "asm.fasta").write_text(
        "".join(f">s{i}\n{a}\n" for i, (a, _, _) in enumerate(scaffolds)))
    (tmp / "calls.vcf").write_text(
        "##fileformat=VCFv4.2\n"
        + "".join(f"##contig=<ID=s{i}>\n" for i in range(3))
        + "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tS\n"
        + "".join(f"s{i}\t{p + 1}\t.\t{a[p]}\t{g[p]}\t30\tPASS\t.\tGT\t1/1\n"
                  for i, (a, g, p) in enumerate(scaffolds)))
    rng = random.Random(3)
    with open(tmp / "reads.fq", "w") as f:
        for i in range(400):
            r = "".join(rng.choice("ACGT")
                        for _ in range(rng.randint(30, 120)))
            f.write(f"@q{i}\n{r}\n+\n{'I' * len(r)}\n")
    return tmp


MODES_SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
from merfin_tpu_torch.cli import main

tmp, tag, mesh = sys.argv[1], sys.argv[2], sys.argv[3:]
base = ["-sequence", f"{{tmp}}/asm.fasta", "-readmers", f"{{tmp}}/read.mkdb",
        "-seqmers", f"{{tmp}}/asm.mkdb", "-peak", "20"] + mesh
assert main(["-hist"] + base + ["-output", f"{{tmp}}/{{tag}}.hist"]) == 0
assert main(["-completeness", "-readmers", f"{{tmp}}/read.mkdb",
             "-seqmers", f"{{tmp}}/asm.mkdb", "-peak", "20"] + mesh) == 0
assert main(["-dump"] + base + ["-output", f"{{tmp}}/{{tag}}.dump"]) == 0
assert main(["-polish"] + base + ["-vcf", f"{{tmp}}/calls.vcf",
             "-threads", "1", "-output", f"{{tmp}}/{{tag}}.pol"]) == 0
print("ALLDONE")
"""

RESUME_SCRIPT = """
import os, sys
sys.path.insert(0, {repo!r})

# a simulated crash: exit hard after N checkpoint saves (0: run to end)
die_after = int(os.environ.get("MERFIN_TEST_DIE_AFTER_SAVES", "0"))
if die_after:
    from merfin_tpu_torch.utils import checkpoint as _C
    _n = [0]
    _orig = _C.Checkpoint.save
    def _save(self, *a, **kw):
        _orig(self, *a, **kw)
        if self.enabled and self.writer:
            _n[0] += 1
            if _n[0] >= die_after:
                os._exit(7)
    _C.Checkpoint.save = _save

from merfin_tpu_torch.cli import main

tmp, tag, mode = sys.argv[1], sys.argv[2], sys.argv[3]
args = ["-resume", "-sequence", f"{{tmp}}/asm.fasta",
        "-readmers", f"{{tmp}}/read.mkdb", "-seqmers", f"{{tmp}}/asm.mkdb",
        "-peak", "20"]
if mode == "-polish":
    args = ["-polish"] + args + ["-vcf", f"{{tmp}}/calls.vcf", "-threads",
                                 "1", "-output", f"{{tmp}}/{{tag}}.pol"]
elif mode == "-dump-mesh":
    args = ["-dump", "-mesh", "2x4"] + args + ["-output", f"{{tmp}}/{{tag}}.dump"]
else:
    args = [mode] + args + ["-output", f"{{tmp}}/{{tag}}.dump"]
assert main(args) == 0
print("ALLDONE")
"""

DEBUG_SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
from merfin_tpu_torch.cli import main

tmp, tag = sys.argv[1], sys.argv[2]
assert main(["-polish", "-debug", "-threads", "1",
             "-sequence", f"{{tmp}}/asm.fasta",
             "-readmers", f"{{tmp}}/read.mkdb",
             "-seqmers", f"{{tmp}}/asm.mkdb", "-peak", "20",
             "-vcf", f"{{tmp}}/calls.vcf", "-output", f"{{tmp}}/{{tag}}.pol"]) == 0
print("ALLDONE")
"""

COUNT_SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
from merfin_tpu_torch.cli import main

tmp, tag = sys.argv[1], sys.argv[2]
assert main(["count", "k=11", f"{{tmp}}/reads.fq",
             f"output={{tmp}}/{{tag}}.mkdb"]) == 0
print("ALLDONE")
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(tmp, src, args, n=1, devices=1, extra_env=None):
    """Start ``n`` processes of one job -> their Popen handles.  Their
    output goes to files: a rank blocked on a full pipe that nobody reads
    would stall its peer at the next collective."""
    port = _free_port()
    procs = []
    for i in range(n):
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX", "XLA", "MERFIN"))}
        # one intra-op thread a rank: the test workers share the cores
        env.update(MERFIN_PLATFORM="cpu", MERFIN_CPU_DEVICES=str(devices),
                   MERFIN_DIST_TIMEOUT="120", OMP_NUM_THREADS="1",
                   **(extra_env or {}))
        if n > 1:
            env.update(MERFIN_NUM_PROCESSES=str(n), MERFIN_PROCESS_ID=str(i),
                       MERFIN_COORDINATOR=f"127.0.0.1:{port}")
        out, err = tempfile.TemporaryFile(), tempfile.TemporaryFile()
        p = subprocess.Popen(
            [sys.executable, "-c", src.format(repo=REPO), str(tmp)] + args,
            env=env, stdout=out, stderr=err)
        p.logs = (out, err)
        procs.append(p)
    return procs


def _wait(procs, ok=True):
    """-> [(rc, stdout, stderr)]; with ``ok`` every process must pass."""
    try:
        for p in procs:
            p.wait(timeout=TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    res = []
    for p in procs:
        for f in p.logs:
            f.seek(0)
        res.append((p.returncode, *(f.read().decode() for f in p.logs)))
        for f in p.logs:
            f.close()
    if ok:
        for rc, out, err in res:
            assert rc == 0 and "ALLDONE" in out, err[-3000:]
    return res


def _run(tmp, src, args, **kw):
    return _wait(_launch(tmp, src, args, **kw))


@pytest.fixture(scope="module")
def single(world):
    """The one-process outputs (tag "one") and stderr."""
    return _run(world, MODES_SCRIPT, ["one"])[0][2]


def _no_leftovers(tmp):
    assert not list(tmp.glob("*.part*"))
    assert not list(tmp.glob("*.ckpt.json*"))
    assert not list(tmp.glob("*.spill*"))


@pytest.mark.parametrize("shape", ["striped", "spans_2x4", "spans_1x8"])
def test_two_process_matches_single(shape, world, single):
    """-hist, -completeness, -dump and -polish in a two-process job:
    outputs byte-identical to one process, rank 0 alone reports."""
    mesh, devices = {"striped": ([], 1), "spans_2x4": (["-mesh", "2x4"], 4),
                     "spans_1x8": (["-mesh", "1x8"], 4)}[shape]
    res = _run(world, MODES_SCRIPT, [shape] + mesh, n=2, devices=devices)
    for suffix in ("hist", "dump", "pol.polish.vcf"):
        assert (world / f"one.{suffix}").read_bytes() == \
            (world / f"{shape}.{suffix}").read_bytes(), suffix
    _no_leftovers(world)
    err0, err1 = res[0][2], res[1][2]
    want = next(ln for ln in single.splitlines() if "COMPLETENESS" in ln)
    assert want in err0.splitlines() and "COMPLETENESS" not in err1
    assert "process 0 of 2" in err0 and "process 1 of 2" in err1
    # the per-sequence -dump lines add over the ranks, none counted twice
    # (a 1x8 mesh holds every row's t-shards on both processes)
    dump0 = [ln for ln in err0.split("-- Dump per-base")[1].splitlines()
             if ln.startswith("s") and ln.count("\t") == 3]
    if shape != "striped":
        assert len(dump0) == 3
        assert int(dump0[-1].split("\t")[3]) == 3 * (500 - K + 1)
    recs = [ln for ln in (world / f"{shape}.pol.polish.vcf").read_text()
            .splitlines() if not ln.startswith("#")]
    assert [r.split("\t")[0] for r in recs] == ["s0", "s1", "s2"]


def test_three_process_mesh_rows_held_by_subgroups(world, single):
    """-mesh 2x3 over three processes of 2 devices: row 0 is held by
    processes 0 and 1, row 1 by processes 1 and 2, so each row's probe
    sums run over a subgroup; process 1 computes both rows and process 2
    owns none.  The outputs are one process's, and rank 0 alone
    reports."""
    res = _run(world, MODES_SCRIPT, ["three", "-mesh", "2x3"], n=3,
               devices=2)
    for suffix in ("hist", "dump", "pol.polish.vcf"):
        assert (world / f"one.{suffix}").read_bytes() == \
            (world / f"three.{suffix}").read_bytes(), suffix
    _no_leftovers(world)
    want = next(ln for ln in single.splitlines() if "COMPLETENESS" in ln)
    assert want in res[0][2].splitlines()
    assert all("COMPLETENESS" not in err for _, _, err in res[1:])
    assert all(f"process {i} of 3" in err for i, (_, _, err) in enumerate(res))


def _kill_and_restart(tmp, tag, mode, devices=1):
    """Kill a two-process run of ``mode`` after the first checkpoint
    save, restart it with -resume -> the restart's stderr texts."""
    res = _wait(_launch(tmp, RESUME_SCRIPT, [tag, mode], n=2,
                        devices=devices,
                        extra_env={"MERFIN_TEST_DIE_AFTER_SAVES": "1"}),
                ok=False)
    rcs = [r[0] for r in res]
    # the rank that saves first exits 7; its peer fails at its next
    # collective (or finishes its stripe and fails at the barrier)
    assert 7 in rcs and 0 not in rcs, (rcs, res[0][2][-1000:])
    return [r[2] for r in _run(tmp, RESUME_SCRIPT, [tag, mode], n=2,
                               devices=devices)]


@pytest.mark.parametrize("mode", ["-polish", "-dump"])
def test_striped_kill_and_restart(mode, world, single):
    errs = _kill_and_restart(world, "rs" + mode[1:], mode)
    assert any("Resuming after" in e for e in errs)
    suffix = "pol.polish.vcf" if mode == "-polish" else "dump"
    assert (world / f"one.{suffix}").read_bytes() == \
        (world / f"rs{mode[1:]}.{suffix}").read_bytes()
    _no_leftovers(world)


def test_spans_dump_kill_and_restart(world, single):
    """A host-spanning -dump resumes in lockstep (or, with skewed
    checkpoints, restarts fresh): the same bytes either way."""
    errs = _kill_and_restart(world, "sp", "-dump-mesh", devices=4)
    assert any("Resuming after" in e or "restarting -dump fresh" in e
               for e in errs)
    assert (world / "one.dump").read_bytes() == (world / "sp.dump").read_bytes()
    _no_leftovers(world)


def _debug_rows(path):
    """Debug gz rows without the writer-local varMerId column."""
    with gzip.open(path, "rt") as f:
        return sorted(ln.split("\t", 1)[1] for ln in f if ln.strip())


def test_striped_debug_writes_per_rank_gz(world):
    """-debug in a striped job writes one gz per rank (the reference's
    per-thread split, merfin-variants.C:146-151); their rows together are
    the one-process debug log's."""
    _run(world, DEBUG_SCRIPT, ["dbg1"])
    one = _debug_rows(world / "dbg1.pol.00.debug.gz")
    assert one
    _run(world, DEBUG_SCRIPT, ["dbg2"], n=2)
    rows = sorted(_debug_rows(world / "dbg2.pol.00.debug.gz")
                  + _debug_rows(world / "dbg2.pol.01.debug.gz"))
    assert rows == one
    assert (world / "dbg1.pol.polish.vcf").read_bytes() == \
        (world / "dbg2.pol.polish.vcf").read_bytes()


def test_two_process_count_matches_single(world):
    """`count` in a two-process job (block stripes, per-rank spills,
    rank 0's gather and merge) writes the one-process DB file for file."""
    _run(world, COUNT_SCRIPT, ["c1"])
    _run(world, COUNT_SCRIPT, ["c2"], n=2)
    a, b = KmerDB(str(world / "c1.mkdb")), KmerDB(str(world / "c2.mkdb"))
    assert a.total == b.total and a.distinct == b.distinct > 0
    np.testing.assert_array_equal(np.asarray(a.keys), np.asarray(b.keys))
    np.testing.assert_array_equal(np.asarray(a.vals), np.asarray(b.vals))
    for name in ("keys.npy", "vals.npy", "mkdb.json"):
        assert (world / "c1.mkdb" / name).read_bytes() == \
            (world / "c2.mkdb" / name).read_bytes()
    _no_leftovers(world)
