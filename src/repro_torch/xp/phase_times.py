"""Wall times of ``chip_smoke.py``'s phases 2-4 and 6 (or 17 and 26) on
one source tree, for an A/B of two.

    python src/repro_torch/xp/phase_times.py --tree DIR [--phases P,...]
        [--out FILE]

Loads ``DIR/chip_smoke.py`` as a module, puts ``DIR/src`` first on the
path (so its functions import that tree's ``repro_torch``), builds that
tree's kernels, and runs under the host clock, as ``chip_smoke.main``
drives them: phase 2's kernel comparisons one function at a time (each
``check_*`` of phase 2 the tree's script has, and ``train_mix_row`` where
it has it); phase 3 (DSGD-AAU at N = 256, ``sparse_scan``, 1024 events);
phase 4 (sync DSGD at N = 256, ``scan``, the preset's 160 events); and
phase 6 (recurrentgemma-2b served, two waves).  ``--phases`` picks among
those (default ``2,3,4,6``) and two more: phase 17 (the LM example's 100m
preset at N = 8, dense ``scan`` and ``sparse_scan``, then the char-LM at
N = 256: events/s, device idle share and launches of each run) and phase
26 (recurrentgemma-2b trained at full width through ``launch/train.py``:
seconds per step, steady s/step, tokens/s, launches).  Prints the card's
name and power limit, then one JSON object: seconds per function and
phase, events/s of phases 3 and 4, phase 6's times to first token and
decode rate, and the rates of 17 and 26.
Two trees are compared by running this on each in turn in one call on one
card (each run its own process).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

PHASE2 = ("check_kernels", "check_mix_kernels", "check_dense_bodies",
          "check_sequence_kernels", "check_lm_kernels",
          "check_prefill_kernels", "train_mix_row")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, required=True,
                    help="root of a checkout (holds chip_smoke.py and src/)")
    ap.add_argument("--phases", default="2,3,4,6",
                    help="comma-separated phases among 2, 3, 4, 6, 17, 26")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    unknown = phases - {"2", "3", "4", "6", "17", "26"}
    if unknown:
        raise SystemExit(f"phase_times: no phase {sorted(unknown)}")
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("tree_smoke",
                                                  tree / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("phase_times needs a CUDA device")
    import repro_torch
    if not Path(repro_torch.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {repro_torch.__file__}, not {tree}'s")
    from repro_torch.kernels import build
    from repro_torch.xp import build_trainer
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    seconds = {}
    t0 = time.perf_counter()
    build.build()
    seconds["build"] = build_s = time.perf_counter() - t0
    for name in PHASE2 if "2" in phases else ():
        fn = getattr(smoke, name, None)
        if fn is not None:
            t0 = time.perf_counter()
            fn(device)
            seconds[name] = time.perf_counter() - t0
    smoke._FLUSH.clear()
    seconds["phase2"] = sum(seconds[k] for k in PHASE2 if k in seconds)

    rates = {}
    spec3 = smoke.paper_spec()
    for phase, alg, kw, events, every in (
            ("phase3", "dsgd_aau", dict(batch_pool=64), 1024, 256),
            ("phase4", "dsgd_sync", {}, spec3.ref_max_events,
             spec3.ref_eval_every)):
        if phase.removeprefix("phase") not in phases:
            continue
        t0 = time.perf_counter()
        tr = build_trainer(spec3, alg, smoke.N_MAIN, 0, device=device, **kw)
        res, setup, wall, _ = smoke.drive(tr, events, every)
        seconds[phase] = time.perf_counter() - t0
        rates[phase] = dict(events=res.total_events, wall_s=wall,
                            setup_s=setup, eps=res.total_events / wall)
        del tr

    if "6" in phases:
        t0 = time.perf_counter()
        served = smoke.serve_full_width(device, build_s)
        seconds["phase6"] = time.perf_counter() - t0
        rates["phase6"] = {k: served[k] for k in ("ttft", "prefill_tok_s",
                                                  "decode_tok_s", "peak_bytes")}
    if "17" in phases:
        t0 = time.perf_counter()
        trained = smoke.lm_training(device)
        seconds["phase17"] = time.perf_counter() - t0
        rates["phase17"] = {k: {f: v.get(f) for f in ("eps", "idle", "busy_ms",
                                                     "wall_ms", "launches",
                                                     "top")}
                            for k, v in trained.items()}
    if "26" in phases:
        t0 = time.perf_counter()
        full = smoke.train_full_width(device)
        seconds["phase26"] = time.perf_counter() - t0
        rates["phase26"] = {k: full[k] for k in ("seconds", "steady_s",
                                                 "tokens_per_s", "launches")}
    out = {"tree": str(tree), "seconds": seconds, "rates": rates}
    print(smoke.card_line())
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
