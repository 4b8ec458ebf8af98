"""The benchmark is driven by data: a configuration, a mix, a cell, a
per-layer metric and a kernel pattern are each a file of their own,
found by name; and nothing it runs loads JAX or the JAX package (top-
level module names compared whole), nor does its reference load the
port."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.run import FORBIDDEN, ROOT, forbidden_modules, run_cell
from portbench.tests.tiny import PB, tiny_copy


def _imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for f in PB.rglob("*.py"):
        assert not _imports(f) & set(FORBIDDEN), f


def test_reference_imports_nothing_of_the_port():
    for f in (PB / "reference").rglob("*.py"):
        assert not _imports(f) & {"merfin_tpu_torch", *FORBIDDEN}, f


def test_guard_compares_whole_names(monkeypatch):
    for name in ("merfin_tpu_torch.fake_mod", "merfin_tpux", "jaxtyping2"):
        monkeypatch.setitem(sys.modules, name, object())
    assert forbidden_modules() == []
    for name in ("jax", "merfin_tpu.cli", "flax.core", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, object())
    assert forbidden_modules() == ["flax.core", "jax", "jaxlib",
                                   "merfin_tpu.cli"]


def test_a_run_loads_no_jax(tmp_path):
    base = tiny_copy(tmp_path)
    code = ("import sys, json; from pathlib import Path; "
            "from portbench.run import run_cell, forbidden_modules; "
            f"r = run_cell('tiny.completeness', 3, 0.2, False, 'cpu', "
            f"Path({str(base)!r})); "
            "print(json.dumps([r['correct'], forbidden_modules()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         env={"MERFIN_PLATFORM": "cpu", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert json.loads(out.stdout.splitlines()[-1]) == [True, []]


def test_no_card_no_result(tmp_path):
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "athal.completeness", "--seed", "1", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_alone_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's
    folder, a run fails and prints no result."""
    import shutil

    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "-m", "portbench", "--workload",
                          "athal.completeness", "--seed", "1", "--seconds", "1"],
                         cwd=tmp_path, capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_new_files_run_with_no_edit(tmp_path, monkeypatch):
    """A configuration, a mix, a cell, a per-layer metric and a kernel
    pattern added as files only: the harness runs them."""
    monkeypatch.setenv("MERFIN_PLATFORM", "cpu")
    base = tiny_copy(tmp_path)
    cfg = json.loads((base / "configs/tiny.json").read_text())
    cfg["sequences"] = [["contig1", 20000], ["contig2", 15000]]
    (base / "configs/frag.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic/completeness.json").read_text())
    mix["what"] = "a fragmented assembly"
    mix["block"] = 1 << 12
    (base / "traffic/frag_completeness.json").write_text(json.dumps(mix))
    (base / "workloads/frag.completeness.json").write_text(json.dumps(
        {"config": "frag", "traffic": "frag_completeness", "chips": 1}))
    (base / "metrics/passes_per_s.completeness.py").write_text(
        'UNIT = "1/s"\n\n\ndef read(r):\n'
        '    return len([s for s in r.spans.intervals if s[0] == "pass"])'
        ' / r.window_s if r.mode == "completeness" else None\n')
    (base / "kernels/sorted_join/more.txt").write_text("join_kernel_v2\n")
    res = run_cell("frag.completeness", 9, 0.3, True, device="cpu",
                   base=base)
    assert res["correct"] is True
    assert res["metrics"]["passes_per_s.completeness"]["value"] > 0
    from portbench.trace import kernel_patterns

    pats = [p.pattern for p in kernel_patterns(base, "sorted_join")]
    assert "join_kernel_v2" in pats and "join_kernel<1>" in pats


@pytest.mark.gpu
def test_traced_run_on_the_card(tmp_path):
    """On the card: a traced tiny run reads device time and the
    rooflines of its joins."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    base = tiny_copy(tmp_path)
    for cell, roof in (("tiny.polish", "union_join_roofline.polish"),
                       ("tiny.completeness",
                        "sorted_join_roofline.completeness")):
        res = run_cell(cell, 5, 1.0, True, device="cuda", base=base)
        assert res["correct"] is True
        assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
        assert 0 < res["metrics"][roof]["value"] <= 105
