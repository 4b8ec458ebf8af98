"""The program's span recorder (merfin_tpu_torch/utils/spans.py) and the
-trace option: off it records nothing; on, a tiny -completeness and a
tiny -polish on the CPU record each span on the thread that does the
work, with its parent and counts, and change no output byte; -trace
FILE writes Chrome trace-event JSON."""

import io
import json
import math
import sys
import threading

import pytest

import chip_smoke as cs
from merfin_tpu_torch.utils import spans
from tests.test_torch_variants import heavy_world

COMPLETENESS_MAIN = ("completeness.run", "completeness.value_map",
                     "completeness.block_wait",
                     "completeness.block_upload",
                     "completeness.readk_gather",
                     "completeness.block_program", "completeness.fetch")
COMPLETENESS_PREFETCH = ("completeness.block_copy",)
POLISH_MAIN = ("variants.run", "vcf.load", "vcf.merge", "fasta.parse",
               "variants.prepare", "variants.block_wait", "scorer.dispatch",
               "scorer.fetch", "variants.select", "variants.write")


@pytest.fixture
def recorder():
    """The recorder on and empty; off and empty afterwards."""
    spans.clear()
    spans.enable()
    yield spans
    spans.disable()
    spans.clear()


def _recipe_dbs(tmp_path):
    from merfin_tpu_torch.io.mkdb import KmerDB

    argv = cs.materialize(cs.recipe_world(), str(tmp_path))
    return (KmerDB(argv[argv.index("-readmers") + 1]),
            KmerDB(argv[argv.index("-seqmers") + 1]))


def _completeness(tmp_path, block=256):
    from merfin_tpu_torch.modes.completeness import run_completeness

    read_db, asm_db = _recipe_dbs(tmp_path)
    log = io.StringIO()
    run_completeness(read_db, asm_db, 20.0, log=log, block=block,
                     device="cpu")
    return read_db, log.getvalue()


def _by_name(recs):
    out: dict = {}
    for s in recs:
        out.setdefault(s.name, []).append(s)
    return out


def test_off_records_nothing(tmp_path):
    spans.clear()
    assert not spans.enabled()
    assert spans.span("a") is spans.span("b")
    with spans.span("a") as h:
        h.count("bytes", 3)
    _completeness(tmp_path)
    assert spans.records() == [] and spans.totals() == {}
    assert spans.dropped() == 0


@pytest.mark.parametrize("block", [256, 1 << 22])
def test_completeness_spans(tmp_path, recorder, block):
    read_db, _ = _completeness(tmp_path, block)
    main = threading.get_ident()
    by = _by_name(recorder.records())
    assert set(COMPLETENESS_MAIN + COMPLETENESS_PREFETCH) <= set(by)
    (run,) = by["completeness.run"]
    assert run.counts == {"keys": read_db.distinct}
    for name in COMPLETENESS_MAIN:
        assert all(s.tid == main for s in by[name]), name
    n_blocks = math.ceil(read_db.distinct / block)
    for name in COMPLETENESS_PREFETCH:
        assert len(by[name]) == n_blocks, name
        for s in by[name]:
            assert s.tid != main and s.parent == run.id, name
            assert run.start <= s.start <= s.end <= run.end
    copies = by["completeness.block_copy"]
    assert sum(s.counts["keys"] for s in copies) == read_db.distinct
    # CPU tensors: nothing is handed to a CUDA copy, no block goes
    # through the pinned ring, and so no slot is waited for
    assert all(s.counts == {"bytes": 0, "pinned": 0}
               for s in by["completeness.block_upload"])
    assert "completeness.slot_wait" not in by
    # one wait per block and one for the end of the stream
    assert len(by["completeness.block_wait"]) == n_blocks + 1
    for name in ("completeness.block_upload", "completeness.readk_gather",
                 "completeness.block_program"):
        assert len(by[name]) == n_blocks, name
    tot = recorder.totals()
    assert tot["completeness.block_copy"]["calls"] == n_blocks
    assert tot["completeness.block_copy"]["counts"] == {
        "keys": read_db.distinct}


def test_carry_and_cap(recorder, monkeypatch):
    """Work handed to another thread takes the handing span as parent;
    past CAP only the totals grow."""
    out = []
    with spans.span("outer") as outer:
        t = threading.Thread(target=spans.carry(
            lambda: out.append(spans.span("inner").__enter__())))
        t.start()
        t.join()
    inner = out[0]
    assert inner.parent == outer.id and inner.tid != outer.tid
    assert spans.carry(len) is not len
    spans.disable()
    assert spans.carry(len) is len
    spans.enable()
    spans.clear()
    monkeypatch.setattr(spans, "CAP", 3)
    for _ in range(5):
        with spans.span("x") as h:
            h.count("n", 2)
    assert len(spans.records()) == 3 and spans.dropped() == 2
    assert spans.totals()["x"]["calls"] == 5
    assert spans.totals()["x"]["counts"] == {"n": 10}


def test_threads_lose_no_span(recorder):
    """More threads than cores closing spans at once: every span and
    count is kept, and each thread's spans nest under its own."""
    n_threads, n_spans = 32, 300
    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        with spans.span("outer"):
            for _ in range(n_spans):
                with spans.span("inner") as h:
                    h.count("n", 1)

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    recs = spans.records()
    assert len(recs) == n_threads * (n_spans + 1)
    tot = spans.totals()
    assert tot["inner"]["calls"] == n_threads * n_spans
    assert tot["inner"]["counts"] == {"n": n_threads * n_spans}
    outer = {s.id: s.tid for s in recs if s.name == "outer"}
    assert all(outer[s.parent] == s.tid for s in recs if s.name == "inner")


def _polish_world(tmp_path):
    world = heavy_world()
    argv = cs.materialize(world, str(tmp_path / "world"))
    return world, cs.vcf_argv(argv, "polish") + ["-threads", "1"]


def _run_cli(argv, tmp_path, tag, monkeypatch):
    from merfin_tpu_torch import cli

    d = tmp_path / tag
    d.mkdir()
    err = io.StringIO()
    with monkeypatch.context() as m:
        m.setenv("MERFIN_PLATFORM", "cpu")
        m.chdir(d)
        m.setattr(sys, "stderr", err)
        assert cli.main(argv + ["-output", "out"]) == 0
    files = {p.name: p.read_bytes() for p in d.iterdir()}
    return err.getvalue(), files


def _scalar_paths(world, argv) -> int:
    """The clusters' candidate paths by the scalar enumeration."""
    from merfin_tpu_torch.io.fasta import SeqFile
    from merfin_tpu_torch.io.vcf import VcfFile
    from merfin_tpu_torch.modes import variants

    vcf = VcfFile(argv[argv.index("-vcf") + 1], log=io.StringIO())
    vcf.merge_clusters(world["k"], 15, False, log=io.StringIO())
    n = 0
    for seq in SeqFile(argv[argv.index("-sequence") + 1]):
        for pos_gt in vcf.by_chrom.get(seq.ident, []):
            r = variants.prepare_cluster(seq, pos_gt, world["k"], 15)
            n += len(r[2])
    return n


def test_polish_spans_and_bytes_unchanged(tmp_path, monkeypatch):
    world, argv = _polish_world(tmp_path)
    off = _run_cli(argv, tmp_path, "off", monkeypatch)
    spans.clear()
    spans.enable()
    try:
        on = _run_cli(argv, tmp_path, "on", monkeypatch)
    finally:
        spans.disable()
    recs = spans.records()
    spans.clear()
    assert on == off
    assert "-- Using fused device scoring (-devscore)." in on[0]
    assert off[1]["out.polish.vcf"].count(b"\n") > 0

    main = threading.get_ident()
    by = _by_name(recs)
    assert set(POLISH_MAIN) <= set(by)
    assert "variants.pool_spawn" not in by      # no pool at -threads 1
    for name in POLISH_MAIN:
        assert all(s.tid == main for s in by[name]), name
    (run,) = by["variants.run"]
    n_clusters = len(world["vcf"]) // 8
    assert run.counts == {"clusters": n_clusters}
    parse = by["fasta.parse"]
    assert sum(s.counts.get("bytes", 0) for s in parse) == \
        sum(len(s) for _, s in world["scaffolds"])
    assert sum(s.counts.get("python", 0) for s in parse) >= 1
    assert not any("native" in s.counts for s in parse)
    enum = by["variants.enumerate"]
    assert len(enum) == n_clusters
    assert all(s.tid != main and s.parent == run.id for s in enum)
    assert sum(s.counts["paths"] for s in enum) == \
        _scalar_paths(world, argv) == n_clusters * 576
    dispatched = sum(s.counts.get("windows", 0)
                     for s in by["scorer.dispatch"])
    assert dispatched > 0
    assert all(s.counts.get("bytes", 0) == 0 for s in by["scorer.dispatch"])
    assert sum(s.counts["clusters"] for s in by["variants.select"]) == \
        n_clusters
    assert sum(s.counts["bytes"] for s in by["variants.write"]) + \
        len(b"".join(h.encode() + b"\n" for h in _vcf_headers(argv))) == \
        len(off[1]["out.polish.vcf"])


def _vcf_headers(argv):
    with open(argv[argv.index("-vcf") + 1]) as f:
        return [ln.rstrip("\n") for ln in f if ln.startswith("#")]


@pytest.mark.parametrize("mode", ["completeness", "polish"])
def test_trace_file(tmp_path, monkeypatch, mode):
    if mode == "completeness":
        argv = cs.mode_argv(cs.materialize(cs.recipe_world(),
                                           str(tmp_path / "world")),
                            "completeness")
        want = COMPLETENESS_MAIN + COMPLETENESS_PREFETCH
    else:
        argv = _polish_world(tmp_path)[1]
        want = POLISH_MAIN + ("variants.enumerate",)
    trace = tmp_path / "run.trace.json"
    plain = _run_cli(argv, tmp_path, "plain", monkeypatch)
    traced = _run_cli(argv + ["-trace", str(trace)], tmp_path, "traced",
                      monkeypatch)
    assert traced == plain
    assert not spans.enabled()
    doc = json.loads(trace.read_text())
    ev = doc["traceEvents"]
    xs = [e for e in ev if e["ph"] == "X"]
    assert set(want) <= {e["name"] for e in xs}
    assert all(e["dur"] >= 0 and "id" in e["args"] for e in xs)
    counters = {e["name"]: e["args"] for e in ev if e["ph"] == "C"}
    assert "kernel launches" in counters
    assert counters[f"{want[0]} totals"]["calls"] == 1
    assert doc["otherData"]["dropped_spans"] == 0
