"""CLI for the experiment harness, on the card.

  python -m repro_torch.xp [--preset paper_figures] [--out FILE.json]
  python -m repro_torch.xp --smoke --device cpu   # dry-run tier on the CPU

Prints ``name,us_per_call,derived`` CSV rows (the benchmark-harness
contract) and writes the JSON artifact only when ``--out`` is given, so a
smoke run can never clobber recorded results.  The arguments are the
reference's (``python -m repro.xp``) plus ``--device``: ``cuda`` unless
``--device cpu`` is given; without a card the CLI raises before it runs
anything.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.device import resolve_device
from repro_torch.xp.artifacts import (artifact_payload, csv_rows,
                                      write_artifact)
from repro_torch.xp.presets import PRESETS, get_preset
from repro_torch.xp.sweep import run_spec


def _csv_tuple(s, conv=str):
    return tuple(conv(x) for x in s.split(",") if x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.xp")
    ap.add_argument("--preset", default="paper_figures",
                    choices=sorted(PRESETS))
    ap.add_argument("--smoke", action="store_true",
                    help="shortcut for --preset smoke (CI dry-run tier)")
    ap.add_argument("--out", default=None,
                    help="write the JSON artifact here (omit: print only)")
    ap.add_argument("--scales", default=None,
                    help="override worker counts, e.g. 32,64")
    ap.add_argument("--seeds", default=None, help="override seeds, e.g. 0,1")
    ap.add_argument("--scenarios", default=None,
                    help="override scenario names, e.g. paper_default,churn")
    ap.add_argument("--dtype", default=None,
                    help="worker-state dtype policy: float32 | bfloat16")
    ap.add_argument("--max-time", type=float, default=None,
                    help="override the async virtual-time budget")
    ap.add_argument("--telemetry", action="store_true",
                    help="record device-resident per-worker telemetry "
                         "(repro_torch.obs) into the artifact's telemetry "
                         "section")
    ap.add_argument("--trace", action="store_true",
                    help="record event-identity traces and the wait-blame / "
                         "straggler-tax summary (repro_torch.obs.trace) into "
                         "the artifact's trace section")
    ap.add_argument("--run-log", default=None,
                    help="append structured JSONL run events here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    spec = get_preset("smoke" if args.smoke else args.preset)
    over = {}
    if args.scales:
        over["scales"] = _csv_tuple(args.scales, int)
    if args.seeds:
        over["seeds"] = _csv_tuple(args.seeds, int)
    if args.scenarios:
        over["scenarios"] = _csv_tuple(args.scenarios)
    if args.dtype:
        over["dtype"] = args.dtype
    if args.max_time is not None:
        # an explicit time budget must actually bind: drop any event bound
        # the preset carries (event bounds take precedence in the sweep)
        over["max_time"] = args.max_time
        over["max_events"] = None
    if args.telemetry:
        over["telemetry"] = True
    if args.trace:
        over["trace"] = True
    if args.run_log:
        over["run_log"] = args.run_log
    if over:
        spec = spec.replace(**over)

    sweep = run_spec(spec, log=lambda s: print(s, file=sys.stderr),
                     device=device)
    payload = artifact_payload(sweep)
    print("name,us_per_call,derived")
    for row in csv_rows(payload):
        print(row)
    if args.out:
        write_artifact(args.out, payload)
        print(f"# wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
