"""The port's database tools and its sequence-DB build against the JAX
CLI's, on the verify recipe's world.

* Each database tool (count, with and without a spilling ``memory=``;
  import, with and without; print, export, statistics, histogram,
  intersect, union-sum, subtract, divide-round; an unknown tool) through
  ``db_tool_main`` of both packages: stdout, the return code and the
  output files byte for byte.
* -hist (with -sortjoin), -dump, -completeness and -polish without
  -seqmers, and -hist -nosortjoin, through both CLIs in subprocesses
  with the same flags: output and stderr byte for byte, and the two
  built ``asm.fasta.meryl`` equal.
"""

import functools
import gzip
import io
import os
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
import merfin_tpu.cli as j_cli
import merfin_tpu.count.counter as j_counter
import merfin_tpu_torch.cli as p_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The recipe world's files, a FASTQ.gz of its reads and a meryl-style
    text dump (canonical lines, then reverse-complement spellings)."""
    d = tmp_path_factory.mktemp("dbtools")
    w = cs.recipe_world()
    argv = cs.materialize(w, str(d))
    with open(d / "reads.fasta", "w") as f:
        f.writelines(f">r{i}\n{s}\n" for i, s in enumerate(w["reads"]))
    rng = np.random.default_rng(9)
    with gzip.open(d / "reads.fq.gz", "wt") as f:
        for i in range(200):
            r = "".join(rng.choice(list("ACGTN"), int(rng.integers(10, 90)),
                                   p=[0.24, 0.24, 0.24, 0.24, 0.04]))
            f.write(f"@q{i}\n{r}\n+\n{'I' * len(r)}\n")
    from merfin_tpu_torch.io import meryl_text
    from merfin_tpu_torch.io.mkdb import KmerDB

    db = KmerDB(argv[4])
    meryl_text.export_text(db, str(d / "dump.txt"))
    comp = str.maketrans("ACGT", "TGCA")
    with open(d / "dump.txt", "a") as f:
        for key, v in zip(np.asarray(db.keys)[::7], np.asarray(db.vals)[::7]):
            mer = meryl_text.decode_kmer(int(key), db.k)
            f.write(f"{mer[::-1].translate(comp)}\t{int(v)}\n")
    return dict(d=d, argv=argv, fasta=argv[2], read=argv[4], asm=argv[6])


TOOLS = {
    "count": ["count", "k=15", "{d}/reads.fasta", "output", "out.mkdb"],
    "count_memory": ["count", "k=15", "memory=0.00001", "{d}/reads.fq.gz",
                     "{d}/asm.fasta", "output=out.mkdb"],
    "import": ["import", "{d}/dump.txt", "output=out.mkdb"],
    "import_memory": ["import", "memory=0.00001", "{d}/dump.txt",
                      "output=out.mkdb"],
    "print": ["print", "{d}/asm.mkdb"],
    "print_output": ["print", "{d}/read.mkdb", "output=out.txt"],
    "export": ["export", "{d}/asm.mkdb", "output", "out.txt"],
    "statistics": ["statistics", "{d}/read.mkdb"],
    "histogram": ["histogram", "{d}/read.mkdb"],
    "intersect": ["intersect", "{d}/read.mkdb", "{d}/asm.mkdb",
                  "output=out.mkdb"],
    "union-sum": ["union-sum", "{d}/read.mkdb", "{d}/asm.mkdb",
                  "output=out.mkdb"],
    "subtract": ["subtract", "{d}/read.mkdb", "{d}/asm.mkdb",
                 "output=out.mkdb"],
    "divide-round": ["divide-round", "3", "{d}/read.mkdb", "output=out.mkdb"],
    "unknown": ["merge", "{d}/read.mkdb", "output=out.mkdb"],
}


def _outputs(cwd) -> dict:
    """Every file a tool wrote under ``cwd`` -> its bytes."""
    out = {}
    for root, _, files in os.walk(cwd):
        for name in files:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, cwd)] = f.read()
    return out


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_db_tool_matches_jax(tool, world, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")
    monkeypatch.setattr(j_cli, "setup_runtime", lambda: None)
    # the JAX count_files' log default is the stderr of its import time
    monkeypatch.setattr(j_counter, "count_files", functools.partial(
        j_counter.count_files, log=io.StringIO()))
    argv = [a.format(d=world["d"]) for a in TOOLS[tool]]
    got = {}
    for tag, mod in (("jax", j_cli), ("port", p_cli)):
        cwd = tmp_path / tag
        cwd.mkdir()
        monkeypatch.chdir(cwd)
        rc = mod.db_tool_main(argv)
        cap = capsys.readouterr()
        got[tag] = (rc, cap.out, _outputs(cwd))
        if tool == "unknown":
            assert cap.err == "unknown db tool 'merge'\n"
    assert got["port"] == got["jax"]
    if tool == "count_memory":        # the port's run spilled
        assert "count: merging" in cap.err
    rc, out, files = got["port"]
    assert rc == (1 if tool == "unknown" else 0)
    if tool in ("print", "statistics", "histogram"):
        assert out.endswith("\n")
    elif tool != "unknown":
        assert files and all(files.values())
    if tool.endswith("_memory"):      # the budget spilled: same DB as in RAM
        mem = [a for a in argv if not a.startswith("memory=")]
        monkeypatch.chdir(tmp_path)
        assert p_cli.db_tool_main(mem[:-1] + ["output=mem.mkdb"]) == 0
        for name in cs.MKDB_FILES:
            assert (tmp_path / "mem.mkdb" / name).read_bytes() == \
                files[os.path.join("out.mkdb", name)]


def test_count_multi_host_not_ported(monkeypatch, capsys):
    """`count` under MERFIN_NUM_PROCESSES=2, once refused, joins the
    torch.distributed job with the JAX package's environment contract
    (the two-process count itself: tests/test_torch_multihost.py)."""
    from merfin_tpu_torch.parallel import multihost as mh

    joined = []

    def fake_init(coordinator, num_processes, process_id):
        joined.append((coordinator, num_processes, process_id))
        raise KeyboardInterrupt

    monkeypatch.setenv("MERFIN_NUM_PROCESSES", "2")
    monkeypatch.setenv("MERFIN_PROCESS_ID", "1")
    monkeypatch.delenv("MERFIN_COORDINATOR", raising=False)
    monkeypatch.setattr(mh, "init", fake_init)
    with pytest.raises(KeyboardInterrupt):
        p_cli.main(["count", "k=21", "x.fa", "output=db"])
    assert joined == [("127.0.0.1:9876", 2, 1)]
    assert "not yet ported" not in capsys.readouterr().err


def _cli(pkg: str, argv, cwd, env):
    return subprocess.Popen([sys.executable, "-m", pkg] + argv, cwd=cwd,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _no_seqmers(argv):
    at = argv.index("-seqmers")
    return argv[:at] + argv[at + 2:]


# report type -> (both CLIs' argv from materialize()'s -hist argv,
# output file)
MODES = {
    "hist": (lambda a: _no_seqmers(a) + ["-sortjoin", "-output", "out.hist"],
             "out.hist"),
    "dump": (lambda a: _no_seqmers(cs.mode_argv(a, "dump"))
             + ["-output", "out.dump"], "out.dump"),
    "completeness": (lambda a: ["-completeness", "-sequence", a[2]]
                     + _no_seqmers(cs.mode_argv(a, "completeness")[1:]),
                     None),
    "polish": (lambda a: _no_seqmers(cs.vcf_argv(a, "polish"))
               + ["-threads", "1", "-output", "out"], "out.polish.vcf"),
    "hist_nosortjoin": (lambda a: a + ["-nosortjoin", "-output", "out.hist"],
                        "out.hist"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_mode_without_seqmers_matches_jax(mode, world, tmp_path):
    make, out = MODES[mode]
    argv = make(world["argv"])
    env = dict(os.environ, JAX_PLATFORMS="cpu", MERFIN_PLATFORM="cpu",
               MERFIN_TPU_CACHE=str(tmp_path / "jax_cache"),
               TF_CPP_MIN_LOG_LEVEL="3",   # as tests/test_torch_hist.py:_env
               PYTHONPATH=REPO)
    procs = {}
    for tag, pkg in (("port", "merfin_tpu_torch"), ("jax", "merfin_tpu")):
        (tmp_path / tag).mkdir()
        procs[tag] = _cli(pkg, argv, tmp_path / tag, env)
    got = {}
    for tag, p in procs.items():
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, (tag, err[-3000:])
        got[tag] = (err, (tmp_path / tag / out).read_bytes() if out else b"")
    assert got["port"] == got["jax"]
    err, data = got["port"]
    built = "-seqmers" not in argv
    assert ("-- No -seqmer given. Build sequence db as 'asm.fasta.meryl'."
            in err.splitlines()) == built
    if built:
        for name in cs.MKDB_FILES:
            a = tmp_path / "port" / "asm.fasta.meryl" / name
            assert a.read_bytes() == \
                (tmp_path / "jax" / "asm.fasta.meryl" / name).read_bytes()
            # the counted DB is the recipe's asm.mkdb
            assert a.read_bytes() == \
                (world["d"] / "asm.mkdb" / name).read_bytes()
    if mode.startswith("hist"):
        assert "chr1\t45\t45\t1986\t28.16" in err
        assert err.count("-- Using sorted-join lookup kernel") == \
            (mode == "hist")
    elif mode == "completeness":
        assert "COMPLETENESS:             0.97734" in err
    elif mode == "dump":
        assert data.count(b"\n") == 1986
    else:
        assert cs.vcf_records(data) == 3
