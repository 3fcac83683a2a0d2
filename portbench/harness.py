"""The benchmark of the PyTorch/CUDA port ``repro_torch``: one run of one
cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
names a configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``, which names its driver in ``drivers/``); the
cell's own limits are in ``workloads/<workload>.json``; each per-layer
metric is read by ``metrics/<metric>.py``.  A run prints the contract's
JSON object as the last line of its standard output, and the compared
numbers, each beside its limit, as the last lines of its standard error.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Cell:
    """One entry of ``workloads`` with its configuration, traffic and
    limits, and the manifest's metrics that it reports."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT):
        entries = {w["name"]: w for w in manifest["workloads"]}
        if name not in entries:
            raise SystemExit(f"unknown workload {name!r}; the benchmark has "
                             f"{sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        configs = {c["name"]: c for c in manifest["configs"]}
        base = root / "portbench"
        self.config = dict(_load(root / configs[self.entry["config"]]["file"]),
                           name=self.entry["config"])
        self.traffic = _load(base / "traffic" / f"{self.entry['traffic']}.json")
        own = _load(base / "workloads" / f"{name}.json")
        self.limits, self.leaf_gap = own["limits"], own.get("leaf_gap", "worst")
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]


def _load(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def read_metric(name: str, context: dict, base: Path = HERE) -> Optional[float]:
    """``metrics/<name>.py``'s reading of a traced run, or None where its
    reader finds nothing to read."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{len(sys.modules)}", base / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(context)


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole: ``repro_torch`` is
    not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def caches() -> None:
    """Every build or kernel cache at a fixed directory inside the
    checkout (the port builds its kernels into ``build/repro_torch/``)."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, count: int = 1) -> dict:
    """Run the cell on ``device`` and return the result object."""
    import torch
    from portbench import check

    spec = importlib.util.spec_from_file_location(
        f"portbench.drivers.{cell.traffic['driver']}",
        HERE / "drivers" / f"{cell.traffic['driver']}.py")
    driver = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(driver)
    out = driver.run(cell, seed, seconds, trace, device, t_start)
    metrics: Dict[str, dict] = {}
    if trace:
        ctx = dict(out.context, cell=cell.name, config=cell.config,
                   traffic=cell.traffic, peak_bytes=out.peak_bytes)
        for m in cell.per_layer:
            v = read_metric(m["name"], ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    nums = check.numbers(out.program, out.reference, cell.leaf_gap)
    cuda = torch.device(device).type == "cuda"
    result = {
        "correct": check.judge(nums, cell.limits),
        "attempted": out.attempted, "failed": 0, "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if cuda
                            else "cpu"),
                   "count": count, "memory_peak_bytes": out.peak_bytes}}
    if trace:
        win = out.context["window"]
        result["device"].update(busy_s=win.busy_s, window_s=win.window_s)
        result["breakdown"] = win.breakdown()
    result["power_limit"] = power_limit() if cuda else ""
    result["checks"] = check.report(nums, cell.limits)
    return result


def main(argv=None, t_start: Optional[float] = None) -> int:
    import time
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    caches()
    cell = Cell(_load(ROOT / "BENCHMARK.json"), args.workload)
    import torch
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda", t_start, count=chips)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
