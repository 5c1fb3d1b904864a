"""Nothing the benchmark runs loads JAX or the JAX package ``repro``, and
the reference loads nothing of the program. Modules are compared by their
whole top-level name (``repro_torch`` is not ``repro``)."""
import ast
import os
import subprocess
import sys

import pytest

from portbench.tests.tiny import ROOT

PB = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _modules(sub=""):
    out = []
    for p in sorted((PB / sub).rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts or "metrics" in rel.parts:
            continue
        parts = rel.parts[:-1] if rel.parts[-1] == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def _loaded_after(imports, extra=""):
    code = ("import importlib, sys\n"
            f"for m in {imports!r}:\n"
            "    importlib.import_module(m)\n"
            f"{extra}"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{ROOT / 'src'}")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_nor_repro():
    top = _loaded_after(_modules())
    assert not top & FORBIDDEN, top & FORBIDDEN
    assert "repro_torch" in top


def test_reference_loads_nothing_of_the_program():
    top = _loaded_after(_modules("reference"))
    assert not top & (FORBIDDEN | {"repro_torch"})


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_source_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert not names & FORBIDDEN
    if "reference" in path.parts:
        assert "repro_torch" not in names


def test_run_refuses_without_the_program(tmp_path):
    # a directory that holds only BENCHMARK.json and the benchmark's files
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mamba2-prefill-2k", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
