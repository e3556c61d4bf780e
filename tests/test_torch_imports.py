"""The PyTorch port stands alone: importing every module of
``repro_torch`` and ``chip_smoke.py`` (without running it) loads neither
JAX nor the reference package, and no source line imports them."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

from _torch_threads import one_thread  # noqa: F401

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
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", SCRIPT,
                          str(ROOT / "chip_smoke.py")], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["forbidden"] == []
    for mod in ("repro_torch.kernels.ternary_matmul", "repro_torch.convert",
                "repro_torch.kernels.cim_mac", "repro_torch.core.cim",
                "repro_torch.core.device_models",
                "repro_torch.serve.engine", "repro_torch.launch.serve",
                "repro_torch.models.registry", "repro_torch.models.moe",
                "repro_torch.models.ssm", "repro_torch.configs.zamba2_7b",
                "repro_torch.configs.xlstm_125m",
                "repro_torch.core.prng",
                "repro_torch.kernels.threefry", "repro_torch.faults.backend",
                "repro_torch.faults.scrub", "repro_torch.core.yield_model",
                "repro_torch.frontend", "repro_torch.frontend.admission",
                "repro_torch.frontend.registry",
                "repro_torch.frontend.server",
                "repro_torch.frontend.loadgen", "repro_torch.core.mapping",
                "repro_torch.core.energy",
                "repro_torch.configs.whisper_large_v3",
                "repro_torch.configs.llama_3_2_vision_90b",
                "repro_torch.tree", "repro_torch.optim",
                "repro_torch.optim.optimizers",
                "repro_torch.optim.compression", "repro_torch.data",
                "repro_torch.data.pipeline", "repro_torch.checkpoint",
                "repro_torch.checkpoint.checkpoint", "repro_torch.train",
                "repro_torch.train.step", "repro_torch.train.runner",
                "repro_torch.launch.train", "repro_torch.kernels.autotune",
                "repro_torch.analysis", "repro_torch.analysis.__main__",
                "repro_torch.analysis.base",
                "repro_torch.analysis.capability",
                "repro_torch.analysis.blockmap",
                "repro_torch.analysis.autotune_table",
                "repro_torch.analysis.sanitizer",
                "repro_torch.analysis.frontend",
                "repro_torch.analysis.abscache",
                "repro_torch.analysis.shardspec", "repro_torch.dist",
                "repro_torch.dist.mesh", "repro_torch.dist.sharding",
                "repro_torch.dist.variants", "repro_torch.dist.runtime"):
        assert mod in report["modules"]


def test_no_source_line_imports_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if FORBIDDEN.search(f.read_text())]
    assert offenders == []
