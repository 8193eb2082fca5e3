"""The port stands apart from the JAX package: it imports neither JAX nor
``repro``, its runtime copies are the originals with ``repro.`` rewritten,
and its entry points refuse to run on a missing card."""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve as launch_serve  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

#: modules kept as verbatim copies of the JAX package's framework-free code
COPIES = (
    [f"backends/{m}.py" for m in
     ("__init__", "calibration", "shim", "datastore", "billing", "simcloud", "localjax")]
    + [f"core/{m}.py" for m in
       ("__init__", "naming", "jlobject", "subgraph", "placement", "prefetch",
        "costmodel", "orchestrator", "durable", "workflow")]
    + [f"configs/{m}.py" for m in
       ("shapes", "yi_9b", "gemma2_27b", "mamba2_370m", "deepseek_moe_16b", "dbrx_132b",
        "mistral_large_123b", "qwen15_110b", "recurrentgemma_9b", "phi3_vision_42b",
        "seamless_m4t_medium")]
    + [f"data/{m}.py" for m in ("__init__", "synthetic")]
)

_IMPORTS_JAX_OR_REPRO = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


@pytest.mark.parametrize("rel", COPIES)
def test_runtime_copy_is_the_original_rewritten(rel):
    original = (ROOT / "src" / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == re.sub(r"\brepro\.", "repro_torch.", original)


def test_no_jax_or_repro_import_lines():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _IMPORTS_JAX_OR_REPRO.finditer(f.read_text())]
    assert not offenders


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 30


def test_launch_serve_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", "yi-9b", "--smoke"])


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=dict(os.environ, PYTHONPATH=""),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok": true' not in r.stdout


#: the dry-run tooling and the kernels' operators
DRY_RUN = ["configs/registry.py", "kernels/library.py", "launch/hlo_analysis.py",
           "launch/op_cost.py", "launch/dryrun.py"]


@pytest.mark.parametrize("rel", DRY_RUN)
def test_dry_run_modules_stand_alone(rel):
    """No import line of JAX or ``repro``, and importing the module alone in
    a fresh process loads neither."""
    assert not _IMPORTS_JAX_OR_REPRO.search((PORT / rel).read_text())
    module = "repro_torch." + rel.removesuffix(".py").replace("/", ".")
    code = (f"import sys, {module}\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")), timeout=300)
    assert r.returncode == 0, r.stderr
