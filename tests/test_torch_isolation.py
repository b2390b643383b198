"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX, its ``ml_dtypes`` or the JAX package
``repro``.

Checked twice: dynamically, by importing every module in a fresh
interpreter and inspecting ``sys.modules``, and statically, by scanning
every import statement of the sources.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "ml_dtypes", "repro")


def test_importing_every_module_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
        .removesuffix(".__init__") for p in PACKAGE.rglob("*.py"))
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, timeout=120)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.core.chip.interpreter" in loaded
    # the cost model: the counter, the roofline and the dry run
    assert {"repro_torch.launch.op_cost", "repro_torch.launch.roofline",
            "repro_torch.launch.dryrun"} <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


def test_no_source_imports_jax_or_repro():
    offenders = []
    for path in SOURCES:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(ROOT)}: {n}" for n in names
                          if _forbidden(n)]
    assert len(SOURCES) > 20 and offenders == []
