"""Where the time of one trainer path goes, on the card.

    python -m repro_torch.xp.profile_path [--alg dsgd_aau] [--n 256]
        [--events 256] [--warm 64] [--out FILE]

Builds one cell with the ``paper_figures`` settings (as ``chip_smoke.py``
does), runs ``--warm`` events to pay one-time costs, then times ``--events``
more three ways: the host clock around the run (events/s), a
``torch.profiler`` window over the same run (device time per kernel, the
device's busy and idle share of the window, host time per operator) and a
``cProfile`` pass (host time per Python function).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import time


def _spec(n: int):
    from repro_torch.xp import ExperimentSpec
    return ExperimentSpec(name="paper_figures", scales=(n,), seeds=(0,),
                          mode="sparse_scan", max_time=30.0,
                          ref_max_events=160, eval_every=10, ref_eval_every=2)


def _busy_ms(prof) -> float:
    """Device time covered by at least one kernel or copy (union of spans)."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type.name == "CUDA" and e.time_range.end > 0)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alg", default="dsgd_aau")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--events", type=int, default=256)
    ap.add_argument("--warm", type=int, default=64)
    ap.add_argument("--eval-every", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="also write the summary JSON here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.xp import build_trainer
    if not torch.cuda.is_available():
        raise SystemExit("profile_path needs a CUDA device")
    spec = _spec(args.n)
    eval_every = args.eval_every or args.events
    tr = build_trainer(spec, args.alg, args.n, 0, batch_pool=64)
    tr.warmup(max_events=args.warm + 3 * args.events)
    tr.run(max_events=args.warm, eval_every=args.warm)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    tr.run(max_events=args.events, eval_every=eval_every)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        tr.run(max_events=args.events, eval_every=eval_every)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t1
    busy = _busy_ms(prof)

    pr = cProfile.Profile()
    pr.enable()
    tr.run(max_events=args.events, eval_every=eval_every)
    torch.cuda.synchronize()
    pr.disable()

    ka = prof.key_averages()
    dev_rows = sorted(ka, key=lambda e: -e.self_device_time_total)[:15]
    host_rows = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:15]
    summary = {
        "device": torch.cuda.get_device_name(0),
        "alg": args.alg, "n": args.n, "mode": tr.mode, "events": args.events,
        "events_per_s": args.events / wall,
        "profiled_wall_ms": wall_prof * 1e3, "device_busy_ms": busy,
        "device_idle_share": 1.0 - busy / (wall_prof * 1e3),
        "top_device_ms": [(e.key, e.count, e.self_device_time_total / 1e3)
                          for e in dev_rows],
        "top_host_ms": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                        for e in host_rows],
    }
    print(json.dumps(summary, indent=1))
    s = io.StringIO()
    pstats.Stats(pr, stream=s).sort_stats("tottime").print_stats(25)
    print(s.getvalue())
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
