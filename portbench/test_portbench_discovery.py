"""A configuration, a traffic mix, a cell and a per-layer metric added as
new files (and entries in BENCHMARK.json) are found by name, without an
edit to any file that is there."""
import json
import shutil
import time

from portbench import harness
from portbench.conftest import TINY, tiny_call

NEW_METRIC = '''"""Counts the traced window's device events (a test's metric)."""


def read(ctx):
    return float(len(ctx["window"].device)) if ctx["window"].device else None
'''


def test_new_files_are_found(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    pb = tmp_path / "portbench"
    (pb / "configs" / "tiny-lm.json").write_text(json.dumps(TINY))
    traffic = json.loads((pb / "traffic" / "aau_n256_paper_default.json").read_text())
    traffic.update(workers=8, call=tiny_call(traffic["call"]))
    traffic["data"].update(pool=2, batch=2, seq_len=16, eval_batch=4)
    (pb / "traffic" / "aau_tiny.json").write_text(json.dumps(traffic))
    (pb / "workloads" / "tiny_aau.json").write_text(json.dumps(
        json.loads((pb / "workloads" / "charlm_aau_n256.json").read_text())))
    (pb / "metrics" / "tiny_device_events.py").write_text(NEW_METRIC)
    manifest["configs"].append({"name": "tiny-lm", "source": "tests",
                                "file": "portbench/configs/tiny-lm.json",
                                "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "tiny_aau", "config": "tiny-lm",
                                  "traffic": "aau_tiny", "chips": 1,
                                  "why": "a test"})
    for m in manifest["end_to_end"]:
        if m["name"] == "sim_worker_steps_per_s":
            m["workloads"].append("tiny_aau")
    manifest["per_layer"].append({
        "name": "tiny_device_events", "unit": "events", "better": "lower",
        "source": "device_trace", "layer": "device",
        "moves": "sim_worker_steps_per_s", "workloads": ["tiny_aau"]})
    cell = harness.Cell(manifest, "tiny_aau", root=tmp_path)
    assert cell.config["hidden_size"] == 32 and cell.traffic["workers"] == 8
    assert {m["name"] for m in cell.per_layer} == {"tiny_device_events"}
    assert {m["name"] for m in cell.end_to_end} == {"sim_worker_steps_per_s",
                                                    "setup_s"}
    result = harness.execute(cell, 2**31 + 11, 0.05, False, "cpu",
                             time.perf_counter())
    assert result["correct"] and set(result["metrics"]) == {
        "sim_worker_steps_per_s", "setup_s"}
    win = type("W", (), {"device": [("k", 0.0, 1.0)] * 3})()
    assert harness.read_metric("tiny_device_events", {"window": win},
                               base=pb) == 3.0
