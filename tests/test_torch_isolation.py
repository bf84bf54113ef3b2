"""The port stands alone: every repro_torch module, every port benchmark
driver (``benchmarks/pt_*.py`` but ``pt_jax_reference.py``, which runs the
JAX package by design) and chip_smoke.py import with JAX and the JAX
package made unimportable, and chip_smoke.py refuses to report a result
without a CUDA card."""
import ast
import os
import pkgutil
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
SMOKE = os.path.join(ROOT, "chip_smoke.py")
BENCH = os.path.join(ROOT, "benchmarks")
# imports both packages: it writes the JAX rows the port is held to
REFERENCE_DRIVER = "pt_jax_reference.py"


def _driver_files():
    return sorted(os.path.join(BENCH, f) for f in os.listdir(BENCH)
                  if f.startswith("pt_") and f.endswith(".py")
                  and f != REFERENCE_DRIVER)


def _port_modules():
    import repro_torch

    return ["repro_torch"] + [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]


def test_port_imports_without_jax_or_reference():
    mods = _port_modules()
    assert "repro_torch.core.fabric.simulator" in mods
    assert "repro_torch.kernels.fabric_step" in mods
    assert "repro_torch.kernels.fused_reduce" in mods
    for m in ("repro_torch.models.transformer", "repro_torch.runtime.serve",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.ssm_scan", "repro_torch.kernels.quant",
              "repro_torch.optim.adamw", "repro_torch.optim.compression",
              "repro_torch.data.pipeline",
              "repro_torch.checkpoint.checkpoint",
              "repro_torch.runtime.fault", "repro_torch.runtime.train_loop",
              "repro_torch.launch.steps", "repro_torch.launch.train",
              "repro_torch.configs.opt_variants", "repro_torch.core.metrics",
              "repro_torch.core.prng", "repro_torch.core.workload",
              "repro_torch.core.autotune", "repro_torch.core.mitigation",
              "repro_torch.core.mitigation.search",
              "repro_torch.core.mitigation.score",
              "repro_torch.core.mitigation.agents",
              "repro_torch.runtime.whatif", "repro_torch.launch.sweep",
              "repro_torch.launch.mesh", "repro_torch.core.collectives",
              "repro_torch.models.moe", "repro_torch.models.encdec",
              "repro_torch.models.api", "repro_torch.models.layers",
              "repro_torch.launch.dryrun", "repro_torch.launch.hlo_stats",
              "repro_torch.launch.roofline"):
        assert m in mods, m
    drivers = ["benchmarks." + os.path.basename(f)[:-3]
               for f in _driver_files()]
    assert "benchmarks.pt_run" in drivers
    assert "benchmarks.pt_fig1_breakdown" in drivers
    assert "benchmarks.pt_new_scenarios" in drivers
    assert "benchmarks.pt_fault_scenarios" in drivers
    assert "benchmarks.pt_fleet_replay" in drivers
    assert "benchmarks.pt_mitigation_lab" in drivers
    assert "benchmarks.pt_whatif" in drivers
    assert "benchmarks.pt_collective_bench" in drivers
    mods = mods + drivers
    assert "benchmarks.pt_serve" in mods
    assert "benchmarks.pt_train" in mods
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.path[:0] = [{SRC!r}, {ROOT!r}]\n"
        "import importlib\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m, v in sys.modules.items() if v is not None "
        "and (m in ('jax', 'repro') or m.startswith(('jax.', 'jaxlib', "
        "'repro.'))))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module == "benchmarks":
            yield from ("benchmarks." + a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_name_neither_package():
    files = [SMOKE] + _driver_files() + [
        os.path.join(d, f)
        for d, _, fs in os.walk(os.path.join(SRC, "repro_torch"))
        for f in fs if f.endswith(".py")]
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)
            # a driver may import only the port's own drivers
            if top == "benchmarks":
                assert mod.startswith("benchmarks.pt_"), (path, mod)


def test_chip_smoke_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, SMOKE], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
