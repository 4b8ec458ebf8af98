"""The torch port never imports JAX nor the JAX package: a fresh process
imports every module of merfin_tpu_torch (and chip_smoke), runs a CPU
-hist, -completeness, -dump, -polish (fused scorer and host scorer) and
-filter through the CLI, the same on a 1x2 mesh (``parallel/``), a part
file merge (``utils/partmerge.py``), then `count`, `statistics`, a
-hist without -seqmers (which counts its sequence DB), -hist with
-sortjoin and with -nosortjoin, and ``tools/scatter_polish.py`` (run on
two stripes, then gather), and finds neither 'jax' nor 'merfin_tpu' in
sys.modules."""

import os
import pathlib
import re
import subprocess
import sys

import chip_smoke as cs

REPO = pathlib.Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import merfin_tpu_torch, chip_smoke
for m in pkgutil.walk_packages(merfin_tpu_torch.__path__, "merfin_tpu_torch."):
    importlib.import_module(m.name)
from merfin_tpu_torch.cli import main
argv = sys.argv[2:]
vcf = ["-vcf", sys.argv[1], "-threads", "1"]
for mode, out in (("-hist", "out.hist"), ("-completeness", "unused"),
                  ("-dump", "out.dump"), ("-polish", "fused"),
                  ("-polish", "host"), ("-filter", "out")):
    extra = vcf + (["-nodevscore"] if out == "host" else []) \
        if mode in ("-polish", "-filter") else []
    rc = main([mode] + argv + extra + ["-output", out])
    assert rc == 0, (mode, rc)
    rc = main([mode] + argv + extra + ["-mesh", "1x2", "-output", "m" + out])
    assert rc == 0, (mode, "-mesh", rc)
from merfin_tpu_torch.utils.partmerge import PartWriter, merge_parts
for pid, rows in enumerate((b"b\\n", b"a\\n")):
    part = PartWriter("parts.txt", pid)
    part.write_seq(2 - pid, rows)
    part.close()
merge_parts("parts.txt", 2, header=b"#\\n")
assert open("parts.txt", "rb").read() == b"#\\na\\nb\\n"
# the database tools and a -hist that counts its sequence DB
assert main(["count", "k=15", argv[1], "output=asm_count.mkdb"]) == 0
assert main(["statistics", "asm_count.mkdb"]) == 0
at = argv.index("-seqmers")
assert main(["-hist"] + argv[:at] + argv[at + 2:] + ["-output", "noseq.hist"]) == 0
# -hist on each route, and the scatter-gather tool over 2 stripes
for flag in ("-sortjoin", "-nosortjoin"):
    assert main(["-hist"] + argv + [flag, "-output", flag[1:] + ".hist"]) == 0
from merfin_tpu_torch.tools import scatter_polish as sp
sg = ["--shards", "2", "--output", "sg"]
for shard in ("0", "1"):
    assert sp.main(["run", "--shard", shard, "--sequence", argv[1],
                    "--vcf", sys.argv[1], "--readmers", argv[3],
                    "--seqmers", argv[5], "--peak", argv[7]] + sg) == 0
assert sp.main(["gather"] + sg) == 0
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")))
assert not bad, bad
pkg = sorted(m for m in sys.modules
             if m == "merfin_tpu" or m.startswith("merfin_tpu."))
assert not pkg, pkg
print("NOJAX-OK")
"""


def test_port_runs_without_jax(tmp_path):
    argv = cs.materialize(cs.recipe_world(), str(tmp_path))[1:]
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    env["MERFIN_PLATFORM"] = "cpu"
    env["MERFIN_CPU_DEVICES"] = "2"
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=str(REPO)),
         str(tmp_path / "calls.vcf")] + argv,
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("NOJAX-OK")
    assert "chr1\t45\t45\t1986\t28.16" in proc.stderr
    assert "COMPLETENESS:             0.97734" in proc.stderr
    assert "chr1\t45\t45\t1986" in proc.stderr.splitlines()
    assert (tmp_path / "out.dump").read_bytes().count(b"\n") == 1986
    assert "-- Using fused device scoring (-devscore)." in proc.stderr
    pol = [(tmp_path / f"{o}.polish.vcf").read_bytes() for o in ("fused", "host")]
    assert pol[0] == pol[1] and cs.vcf_records(pol[0]) == 3
    assert cs.vcf_records((tmp_path / "out.filter.vcf").read_bytes()) == 3
    assert "    distinct         1986\n" in proc.stdout
    for name in ("keys.npy", "vals.npy", "mkdb.json"):
        want = (tmp_path / "asm.mkdb" / name).read_bytes()
        assert (tmp_path / "asm_count.mkdb" / name).read_bytes() == want
        assert (tmp_path / "asm.fasta.meryl" / name).read_bytes() == want
    for name in ("noseq.hist", "sortjoin.hist", "nosortjoin.hist"):
        assert (tmp_path / name).read_bytes() == \
            (tmp_path / "out.hist").read_bytes()
    assert (tmp_path / "sg.polish.vcf").read_bytes() == pol[0]
    for a, b in (("out.hist", "mout.hist"), ("out.dump", "mout.dump"),
                 ("fused.polish.vcf", "mfused.polish.vcf"),
                 ("host.polish.vcf", "mhost.polish.vcf"),
                 ("out.filter.vcf", "mout.filter.vcf")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes()
    assert proc.stderr.count("-- Sharding tables over a 1x2 device mesh.") == 6


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    pkg = re.compile(r"^\s*(from|import) merfin_tpu(\.|\s|$)", re.M)
    files = list((REPO / "merfin_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "bin" / "merfin-tpu-torch",
              REPO / "tests" / "test_torch_gpu.py",
              REPO / "scripts" / "count_phase.py"]
    assert len(files) > 10
    for f in files:
        assert not pat.search(f.read_text()), f
        assert not pkg.search(f.read_text()), f


def test_variant_worker_module_imports_no_torch():
    """The spawned enumeration workers import merfin_tpu_torch.modes.variants
    (and the enumeration it runs) without paying for a torch import."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import merfin_tpu_torch.modes.variants as mv\n"
            "mv._enumerate_block_task(([(\"ACGTACGTAC\", [3], [1], [[\"T\", \"G\"]])], 5))\n"
            "mv._enumerate_task((\"ACGTACGTAC\", [3], [1], [[\"T\", \"G\"]]))\n"
            "bad = sorted(m for m in sys.modules if m == 'torch' or "
            "m.startswith(('torch.', 'jax', 'merfin_tpu.')))\n"
            "assert not bad, bad\n"
            "print('NOTORCH-OK')\n" % str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "NOTORCH-OK"
