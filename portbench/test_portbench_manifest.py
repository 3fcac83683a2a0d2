"""BENCHMARK.json holds to the benchmark's contract: its keys, names and
units, the cells' configurations and traffic files, the bounds, and the
per-layer metrics' cells, which report the end-to-end metric each moves."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text(encoding="utf-8"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= MANIFEST["run_seconds"] <= 51
    assert isinstance(MANIFEST["run_seconds"], int)
    assert MANIFEST["command"][1].startswith(MANIFEST["paths"][0] + "/")


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_names_units_sources(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    allowed = ({"name", "unit", "better", "bound", "source", "workloads"}
               if m in MANIFEST["end_to_end"] else
               {"name", "unit", "better", "source", "layer", "moves", "workloads"})
    assert set(m) <= allowed


@pytest.mark.parametrize("m", MANIFEST["end_to_end"], ids=lambda m: m["name"])
def test_bounds(m):
    assert 0.01 <= m["bound"] <= 0.25
    assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("m", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_per_layer_cells_report_what_it_moves(m):
    moved = {e["name"]: e for e in MANIFEST["end_to_end"]}[m["moves"]]
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for cell in m.get("workloads", cells):
        assert cell in cells and cell in moved.get("workloads", cells)
    assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").is_file()
    if m["unit"] == "%" and "roofline" in m["name"]:
        assert m["name"].endswith("_roofline_pct")


@pytest.mark.parametrize("w", MANIFEST["workloads"], ids=lambda w: w["name"])
def test_cells(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"])
    assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    assert w["config"] in {c["name"] for c in MANIFEST["configs"]}
    assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").is_file()
    assert "limits" in json.loads(
        (ROOT / "portbench" / "workloads" / f"{w['name']}.json").read_text())
    reported = {m["name"] for m in MANIFEST["end_to_end"]
                if w["name"] in m.get("workloads", [w["name"]])}
    assert "setup_s" in reported and len(reported) >= 2
    assert any(w["name"] in m.get("workloads", [w["name"]])
               for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("c", MANIFEST["configs"], ids=lambda c: c["name"])
def test_configs(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    assert c["file"].startswith(MANIFEST["paths"][0] + "/")
    assert (ROOT / c["file"]).is_file() and len(c["reduced"]) <= 16
    assert any(w["config"] == c["name"] for w in MANIFEST["workloads"])


def test_names_unique_and_small():
    for group in (METRICS, MANIFEST["workloads"], MANIFEST["configs"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(
        1, len(MANIFEST["workloads"]) // 4)
