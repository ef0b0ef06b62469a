"""The PyTorch port and its chip check import no JAX, nothing of ``repro``
and nothing of the reference's ``benchmarks`` package (which imports
``repro``)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    assert len(FILES) > 20


def test_scan_covers_the_families():
    names = {str(p.relative_to(ROOT / "src" / "repro_torch")) for p in FILES[:-1]}
    assert {"models/moe.py", "models/ssm.py", "models/rglru.py", "models/transformer.py",
            "configs/yi_9b.py", "configs/mistral_nemo_12b.py", "configs/command_r_35b.py",
            "configs/mixtral_8x22b.py", "configs/llama4_scout_17b_a16e.py",
            "configs/falcon_mamba_7b.py", "configs/recurrentgemma_2b.py"} <= names


def test_every_module_imports_with_jax_and_the_reference_blocked():
    """Each module of the port, the families' included, imports in a fresh
    interpreter in which importing ``jax`` or ``repro`` fails; the seven
    configs of the families resolve through the registry."""
    import subprocess
    import sys
    mods = sorted("repro_torch." + str(p.relative_to(ROOT / "src" / "repro_torch"))
                  .removesuffix(".py").removesuffix("/__init__").replace("/", ".")
                  for p in FILES[:-1])
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "from repro_torch.models import registry as R\n"
        "for a in ('yi-9b', 'mistral-nemo-12b', 'command-r-35b', 'mixtral-8x22b',\n"
        "          'llama4-scout-17b-a16e', 'falcon-mamba-7b', 'recurrentgemma-2b'):\n"
        "    assert R.get_config(a).name == a\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
