"""Nothing the benchmark runs loads JAX or the JAX package, compared by the
whole top-level name (the port's name starts with the JAX package's), and
the reference loads nothing of the port."""

from __future__ import annotations

import ast
import importlib.util
import subprocess
import sys

from benchmark.harness.cell import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "clip_glass_tpu"}


def _imported(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    paths = list(BENCH.rglob("*.py"))
    assert {BENCH / "families" / "gpt2.py", BENCH / "reference" / "gpt2.py"} <= set(paths)
    for path in paths:
        assert not set(_imported(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_port():
    paths = list((BENCH / "reference").glob("*.py"))
    assert BENCH / "reference" / "gpt2.py" in paths
    for path in paths:
        names = set(_imported(path))
        assert not {n for n in names if n.startswith("clip_glass")}, path
        assert names <= {"__future__", "contextlib", "functools", "gzip", "html", "json",
                         "math", "os", "re", "typing", "unicodedata", "numpy", "torch", "PIL",
                         "benchmark"}, path


def _run_module():
    spec = importlib.util.spec_from_file_location("benchmark_run_entry", BENCH / "run.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    run = _run_module()
    monkeypatch.setattr(sys, "modules", {"clip_glass_torch": 1, "clip_glass_torch.ops": 1,
                                         "jaxtyping": 1, "benchmark": 1})
    assert run.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {"jax.numpy": 1, "clip_glass_tpu.ops": 1})
    assert run.forbidden_modules() == ["clip_glass_tpu", "jax"]


def test_a_run_leaves_no_jax_in_its_process(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from benchmark.tests.helpers import run_tiny, tiny_bench
from benchmark.tests.test_bench_imports import _run_module
root, bench = tiny_bench(Path({str(tmp_path)!r}))
assert run_tiny(root, bench, "tiny_biggan.search8").correct
print(_run_module().forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
