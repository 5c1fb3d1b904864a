"""``BENCHMARK.json`` against the benchmark's contract: legal names and
units, every file it names present, every per-layer metric with a reader
and an end-to-end metric it moves that each of its cells reports, and the
run's length inside the check's time."""
import json
import re

import pytest

from portbench.tests.tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_names_and_units(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        allowed.add("bound")
    else:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        allowed |= {"layer", "moves"}
    assert set(m) <= allowed


def test_names_unique_and_setup_s_present():
    for group in ("configs", "workloads"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    assert "setup_s" in names


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_and_metrics(cell):
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] in (1, 4) and 1 <= len(cell["why"]) <= 200
    cfg = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert (ROOT / cfg["file"]).exists()
    assert (ROOT / "portbench" / "traffic" / f"{cell['traffic']}.json"
            ).exists()
    limits = json.loads((ROOT / "portbench" / "limits"
                         / f"{cell['name']}.json").read_text())
    assert limits["numbers"]
    reports = {m["name"] for m in BENCH["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])}
    assert "setup_s" in reports and len(reports) >= 2
    layer = [m for m in BENCH["per_layer"]
             if cell["name"] in m.get("workloads", [cell["name"]])]
    assert layer
    for m in layer:
        assert m["moves"] in reports


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(cfg):
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
    widths = re.compile(r"(_dim|_rank)$|^(d_|hidden|intermediate|expand"
                        r"|top_k|head)")
    assert not any(widths.search(k) for k in cfg["reduced"])
    assert all(k in data for k in cfg["reduced"])
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


def test_layer_names_agree():
    by_layer = {}
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        by_layer.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert by_layer["idle_share"] == {"device"}


def test_run_length_fits_the_check():
    # a full check of 24 cells: 2 + 14 runs a cell of run_seconds + 60 s,
    # 2 x 90 s of compiling a cell, 1200 s spare
    s = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
