"""Nothing a benchmark run loads is JAX or the JAX package, and the
references import nothing of the port.  Module names are compared by their
top-level name, whole: the port's name (``repro_torch``) begins with the
JAX package's (``repro``)."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from perfbench.harness import bench

FILES = sorted(p for p in bench.PERFBENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(bench.PERFBENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & set(bench.FORBIDDEN), (path, tops)


@pytest.mark.parametrize("path", sorted((bench.PERFBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert "repro_torch" not in tops and "repro" not in tops
    assert tops <= {"__future__", "contextlib", "math", "typing", "torch", "perfbench"}, tops
    assert all(n.startswith("perfbench.reference") for n in _imports(path)
               if n.split(".")[0] == "perfbench")


def test_no_jax_after_a_run_of_each_driver():
    """A smoke run of every cell in a fresh process, then ``sys.modules``."""
    code = (
        "import json, torch\n"
        "torch.set_num_threads(2)\n"
        "from perfbench.harness import bench\n"
        "from perfbench.tests.smoke import run_smoke\n"
        "for w in bench.benchmark_spec()['workloads']:\n"
        "    run_smoke(w['name'], 12345)\n"
        "print(json.dumps(bench.forbidden_modules()))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(bench.ROOT / "src"), str(bench.ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=str(bench.ROOT), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_fake_for_test", sys)
    assert "repro_torch_fake_for_test" not in bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake_for_test", sys)
    assert "jaxlib.fake_for_test" in bench.forbidden_modules()
