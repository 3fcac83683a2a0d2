"""Artifact writers: BENCH_paper_figures.json + benchmark CSV rows.

The port's copy of the reference's ``repro/xp/artifacts.py``.  The schema
is the reference's key for key, except the meta: in place of the JAX
version it names the torch version, the device the sweep ran on and, for
a card, its power limit as ``nvidia-smi`` reports it (``"cpu"`` for a CPU
run), since every rate in the artifact belongs to that device.

The JSON artifact schema (consumed by experiments/render_tables.py):

```
{
  "meta":        {spec: {...}, torch: "...", device: "...",
                  power_limit: "...", generated_unix: float},
  "scenarios":   {name: Scenario.describe() at the largest scale},
  "speedup_vs_n":  [ {scenario, n, algorithm, speedup_mean, speedup_std,
                      t_target_mean, t_sync_mean, n_seeds, unreached} ],
  "convergence":   [ {scenario, n, algorithm, n_seeds,
                      points: [{k, time_mean, loss_mean, loss_std,
                                metric_mean}]} ],
  "dtype_policy":  [ {dtype, scenario, algorithm, n, events, final_loss,
                      final_metric, wall_s, events_per_s} ],
  "telemetry":     [ {scenario, n, algorithm, n_seeds, utilization_mean,
                      utilization_min, stale_mean, stale_max,
                      stale_hist: [16 log2-binned counts], comm_copies,
                      grad_steps_total,
                      staleness_bound?: {bound, observed_max, ok},
                      bucket_occupancy?: [{A, events, lane_fill}]} ],
  "trace":         [ {scenario, n, algorithm, n_seeds, events,
                      straggler_tax_mean, busy_t_mean, wait_t_mean,
                      blame_total_mean, residual_wait_mean,
                      blame_concentration, blame_top: [{worker, blame_t,
                      share}], cp_wait_frac_mean} ],
}
```

The ``telemetry`` section is present only when the spec ran with
``telemetry=True`` (device-resident counters drained once per run — see
repro_torch/obs); ``staleness_bound`` appears for DSGD-AAU rows (the 2N−4
event-staleness monitor induced by the B ≤ N−1 per-epoch commit bound)
and ``bucket_occupancy`` for bucketed sparse streams.  The ``trace``
section likewise appears only for ``trace=True`` runs — the wait-blame /
straggler-tax decomposition of repro_torch/obs/critical_path (the numbers
behind ``render_tables.straggler_tax_table``).

``speedup_mean`` is NaN (serialized as the JSON string "nan") whenever a
run never reached the target loss inside its budget — the ``unreached``
count says how many seeds that was — so an artifact can never be misread as
"no speedup" when the truth is "budget too small".
"""
from __future__ import annotations

import json
import math
import subprocess
import time
from typing import Dict, List, Tuple

import torch

from repro_torch.xp.sweep import (SweepResult, convergence_rows,
                                  speedup_rows, telemetry_rows, trace_rows)


def _json_safe(obj):
    """NaN/Inf → strings, tuples → lists (json.dump with allow_nan=False)."""
    if isinstance(obj, float):
        if math.isnan(obj):
            return "nan"
        if math.isinf(obj):
            return "inf" if obj > 0 else "-inf"
        return obj
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def parse_float(v) -> float:
    """Inverse of the NaN/Inf serialization above (for artifact readers);
    ``float()`` parses plain numbers and the "nan"/"inf" strings alike."""
    return float(v)


def device_meta(device: str) -> Tuple[str, str]:
    """(device name, power limit) of the device a sweep ran on: for a card,
    ``torch.cuda.get_device_name`` and ``nvidia-smi``'s ``power.limit``;
    ``("cpu", "cpu")`` for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu", "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return torch.cuda.get_device_name(index), out.stdout.strip()


def artifact_payload(sweep: SweepResult) -> Dict[str, object]:
    name, power = device_meta(sweep.device)
    payload = {
        "meta": {
            "spec": sweep.spec.to_dict(),
            "torch": torch.__version__,
            "device": name,
            "power_limit": power,
            "generated_unix": round(time.time(), 1),
        },
        "scenarios": sweep.scenario_meta,
        "speedup_vs_n": speedup_rows(sweep),
        "convergence": convergence_rows(sweep),
        "dtype_policy": sweep.dtype_rows,
    }
    rows = telemetry_rows(sweep)
    if rows:  # present only for telemetry=True runs (see module docstring)
        payload["telemetry"] = rows
    t_rows = trace_rows(sweep)
    if t_rows:  # present only for trace=True runs
        payload["trace"] = t_rows
    return payload


def write_artifact(path: str, payload: Dict[str, object]) -> None:
    with open(path, "w") as f:
        json.dump(_json_safe(payload), f, indent=1, allow_nan=False)
        f.write("\n")


def load_artifact(path: str) -> Dict[str, object]:
    with open(path) as f:
        return json.load(f)


def csv_rows(payload: Dict[str, object]) -> List[str]:
    """The benchmark-harness CSV contract: ``name,us_per_call,derived``."""
    out = []
    for r in payload["speedup_vs_n"]:
        mean = parse_float(r["speedup_mean"])
        std = parse_float(r["speedup_std"])
        t_t = parse_float(r["t_target_mean"])
        t_s = parse_float(r["t_sync_mean"])
        fmt = lambda v: "unreached" if math.isnan(v) else f"{v:.1f}"
        if math.isnan(mean):
            # distinguish "the algorithm never got there" from "the sync
            # reference's budget fell short" — keep whichever time exists
            derived = (f"speedup_vs_sync=nan;t_target={fmt(t_t)};"
                       f"t_sync={fmt(t_s)};"
                       f"unreached={r['unreached']}/{r['n_seeds']};"
                       f"unreached_ref={r.get('unreached_ref', 0)}"
                       f"/{r['n_seeds']}")
        else:
            derived = (f"speedup_vs_sync={mean:.2f};std={std:.2f};"
                       f"t_target={fmt(t_t)};t_sync={fmt(t_s)};"
                       f"unreached={r['unreached']}/{r['n_seeds']}")
        out.append(f"paper_figures/speedup/{r['scenario']}/N{r['n']}/"
                   f"{r['algorithm']},0.0,{derived}")
    for r in payload.get("dtype_policy", []):
        out.append(
            f"paper_figures/dtype/{r['dtype']}/{r['algorithm']}/N{r['n']},"
            f"0.0,final_loss={parse_float(r['final_loss']):.4f};"
            f"events_per_s={parse_float(r['events_per_s']):.1f}")
    for r in payload.get("telemetry", []):
        derived = (f"util={parse_float(r['utilization_mean']):.3f};"
                   f"stale_mean={parse_float(r['stale_mean']):.2f};"
                   f"stale_max={r['stale_max']}")
        b = r.get("staleness_bound")
        if b is not None:
            derived += (f";bound={b['bound']};"
                        f"bound_ok={'yes' if b['ok'] else 'VIOLATED'}")
        out.append(f"paper_figures/telemetry/{r['scenario']}/N{r['n']}/"
                   f"{r['algorithm']},0.0,{derived}")
    for r in payload.get("trace", []):
        derived = (f"tax={parse_float(r['straggler_tax_mean']):.3f};"
                   f"blame_conc={parse_float(r['blame_concentration']):.3f};"
                   f"cp_wait={parse_float(r['cp_wait_frac_mean']):.3f}")
        out.append(f"paper_figures/trace/{r['scenario']}/N{r['n']}/"
                   f"{r['algorithm']},0.0,{derived}")
    return out
