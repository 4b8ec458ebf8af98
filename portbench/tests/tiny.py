"""A copy of the benchmark's folder with tiny configurations and cells,
for the CPU tests: the same drivers, references and readers, found by
name as a run on the card finds them."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
TINY_REPEATS = {"share": 0.1, "unit_min": 200, "unit_max": 1000,
                "copies_min": 2, "copies_max": 20}


def _dump(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def tiny_copy(dest: Path) -> Path:
    """Copy the benchmark's folder to ``dest``/portbench and add the
    cells tiny.completeness and tiny.polish."""
    base = dest / "portbench"
    shutil.copytree(PB, base, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    a = json.loads((base / "configs/athal-col0-k21.json").read_text())
    a.update(sequences=[["Chr1", 60000], ["Chr2", 30000], ["ChrC", 5000],
                        ["ChrM", 3000]],
             substitutions=20, error_kmers=20000, repeats=TINY_REPEATS)
    _dump(base / "configs/tiny.json", a)
    x = json.loads((base / "configs/chm13-chrX-k21.json").read_text())
    x.update(sequences=[["chrX", 300000]], substitutions=40,
             error_kmers=20000, repeats=TINY_REPEATS)
    _dump(base / "configs/tinyx.json", x)
    t = json.loads((base / "traffic/polish.json").read_text())
    t["vcf"].update(regions=2, per_region={"snps": 10, "multi": 5},
                    heavy_vars=7, check={"light": 1000, "heavy": 2},
                    control_cap=100)
    _dump(base / "traffic/tiny_polish.json", t)
    for cell, cfg, mix in (("tiny.completeness", "tiny", "completeness"),
                           ("tiny.polish", "tinyx", "tiny_polish")):
        _dump(base / f"workloads/{cell}.json",
              {"config": cfg, "traffic": mix, "chips": 1})
    return base
