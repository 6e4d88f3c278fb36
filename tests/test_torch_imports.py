"""The port stands alone: it imports neither JAX nor the JAX package.

Two checks: importing every module of ``repro_torch`` (and ``chip_smoke``)
in a fresh interpreter leaves no ``jax*`` or ``repro``/``repro.*`` module
in ``sys.modules``; and no import statement in their sources, including
the ones inside functions, names either.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "repro" or m.startswith("repro."))
print(len(names), ",".join(names), bad)
"""

# the modules of the training and MoE slices: each must be walked (and so imported) above
TRAIN_MODULES = {
    "repro_torch.optim.adamw", "repro_torch.train.steps", "repro_torch.train.smoke", "repro_torch.data.pipeline",
    "repro_torch.checkpoint.manager", "repro_torch.runtime.fault_tolerance", "repro_torch.launch.train",
    "repro_torch.models.moe", "repro_torch.configs.moonshot_v1_16b_a3b", "repro_torch.configs.phi35_moe_42b_a6_6b",
}
# the distributed slice's modules
DIST_MODULES = {"repro_torch.core.distributed", "repro_torch.launch.dsort"}
# the runtime and telemetry slice's modules
RUNTIME_MODULES = {"repro_torch.runtime.resilience", "repro_torch.runtime.faults", "repro_torch.telemetry.export",
                   "repro_torch.telemetry.__main__", "repro_torch.telemetry.smoke"}
# the VLM and audio slice's config modules
VLM_AUDIO_MODULES = {"repro_torch.configs.paligemma_3b", "repro_torch.configs.whisper_large_v3"}
# the parallel slice's modules
PARALLEL_MODULES = {"repro_torch.configs.nemotron_4_340b", "repro_torch.parallel", "repro_torch.parallel.sharding",
                    "repro_torch.parallel.compression", "repro_torch.serving.context_parallel",
                    "repro_torch.launch.mesh", "repro_torch.launch.specs", "repro_torch.launch.dryrun",
                    "repro_torch.launch.roofline"}
# the analysis slice's modules
ANALYSIS_MODULES = {"repro_torch.analysis", "repro_torch.analysis.__main__", "repro_torch.analysis.checker",
                    "repro_torch.analysis.lattice", "repro_torch.analysis.registry"}


def _forbidden(module: str) -> bool:
    root = module.split(".")[0]
    return root in ("jax", "jaxlib", "repro")


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, names, bad = out.stdout.strip().split(" ", 2)
    assert int(count) >= 73  # every module was walked
    assert TRAIN_MODULES <= set(names.split(","))
    assert DIST_MODULES <= set(names.split(","))
    assert RUNTIME_MODULES <= set(names.split(","))
    assert VLM_AUDIO_MODULES <= set(names.split(","))
    assert PARALLEL_MODULES <= set(names.split(","))
    assert ANALYSIS_MODULES <= set(names.split(","))
    assert bad == "[]"


def test_no_import_statement_names_jax_or_the_reference():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    offenders = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                offenders += [(path.name, a.name) for a in node.names if _forbidden(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and _forbidden(node.module or ""):
                offenders.append((path.name, node.module))
    assert offenders == []
