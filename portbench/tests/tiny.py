"""Helpers of the benchmark's tests: tiny cells on the CPU, built from the
data files beside this file and the cells of ``BENCHMARK.json``."""
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

DATA = Path(__file__).resolve().parent / "data"
# (config, traffic, a cell of BENCHMARK.json with the same kind and metrics)
TINY = {
    "train": ("mamba2-tiny", "hfl-tiny", "mamba2-hfl-train"),
    "moe_prefill": ("mixtral-tiny", "prefill-tiny", "mixtral-prefill-8k"),
    "ssm_prefill": ("mamba2-tiny", "prefill-tiny", "mamba2-prefill-2k"),
}


def tiny_spec(which):
    from portbench import harness
    cfg, traffic, cell = TINY[which]
    if which == "train":
        # the training cell is not in BENCHMARK.json (PERF.md s7)
        spec = harness.load_json(DATA / "hfl-cell.json")
    else:
        spec = harness.cell_spec(
            harness.load_json(ROOT / "BENCHMARK.json"), cell)
    spec["config"] = harness.load_json(DATA / f"{cfg}.json")
    spec["traffic"] = harness.load_json(DATA / f"{traffic}.json")
    limits = harness.load_json(DATA / "limits-tiny.json")
    key = "hfl_train" if which == "train" else cfg
    spec["limits"] = limits[key]
    return spec


def run_tiny(which, seed=1234567890123, trace=0, seconds=0.5, **traffic):
    """One run of a tiny cell; ``traffic`` overrides keys of its mix."""
    from portbench import harness
    spec = tiny_spec(which)
    spec["traffic"].update(traffic)
    return harness.run_cell(spec, seed, seconds, trace, "cpu",
                            time.perf_counter())


def need_cuda():
    """Skips the calling test where there is no CUDA device (decided when
    the test runs, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
