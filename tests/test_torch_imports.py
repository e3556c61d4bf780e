"""The PyTorch port stands alone: importing every module of
``repro_torch`` and ``chip_smoke.py`` (without running it) loads neither
JAX nor the reference package, and no source line imports them."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

SCRIPT = r"""
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "forbidden": loaded}))
"""

FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\s|\.|,|$)",
                       re.MULTILINE)


def test_importing_the_port_loads_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", SCRIPT,
                          str(ROOT / "chip_smoke.py")], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["forbidden"] == []
    for mod in ("repro_torch.kernels.ternary_matmul", "repro_torch.convert",
                "repro_torch.serve.engine", "repro_torch.launch.serve",
                "repro_torch.models.registry"):
        assert mod in report["modules"]


def test_no_source_line_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []
