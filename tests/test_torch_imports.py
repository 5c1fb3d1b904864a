"""The port stands alone: importing every ``repro_torch`` module loads
neither ``jax`` nor the JAX package ``repro``."""
import os
import pathlib
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"


def _modules():
    mods = []
    for p in (SRC / "repro_torch").rglob("*.py"):
        parts = p.relative_to(SRC).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    return sorted(mods)


def test_module_list_covers_the_slice():
    mods = _modules()
    for m in ("repro_torch", "repro_torch.rng", "repro_torch.convert",
              "repro_torch.quickstart", "repro_torch.core.spaceify",
              "repro_torch.core.autoflsat", "repro_torch.sim.flystack",
              "repro_torch.kernels.quant_agg", "repro_torch.kernels._build",
              "repro_torch.kernels.trimmed_agg", "repro_torch.kernels.ops",
              "repro_torch.core.aggregation", "repro_torch.core.quantize",
              "repro_torch.configs", "repro_torch.configs.base",
              "repro_torch.configs.mixtral", "repro_torch.configs.mamba2_1p3b",
              "repro_torch.kernels.ssd_scan",
              "repro_torch.kernels.swa_attention",
              "repro_torch.models.layers", "repro_torch.models.ssm",
              "repro_torch.models.moe", "repro_torch.models.model",
              "repro_torch.launch.serve", "repro_torch.launch.serve_batched",
              "repro_torch.sim.faults", "repro_torch.sim.energy",
              "repro_torch.orbit.eclipse", "repro_torch.energy_aware",
              "repro_torch.constellation_train"):
        assert m in mods


def test_port_imports_neither_jax_nor_repro():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('jaxlib') or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
