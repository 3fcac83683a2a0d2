"""Where the time of one trainer path goes, on the card.

    python -m repro_torch.xp.profile_path [--alg dsgd_aau] [--n 256]
        [--mode sparse_scan] [--events 256] [--warm 64] [--out FILE]

Builds one cell with the ``paper_figures`` settings (as ``chip_smoke.py``
does) in the trainer mode ``--mode`` (``scan``, ``sparse_scan``,
``per_event`` or ``fused``; ``fused`` takes ``ad_psgd`` or ``agp``), runs ``--warm`` events to pay one-time costs, then times ``--events``
more three ways: the host clock around the run (events/s), a
``torch.profiler`` window over the same run (device time per kernel, the
device's busy and idle share of the window, host time per operator, the
launches: device kernels and copies in the window, per event and, for
the active-set modes, per row -- a row launches ``sparse_gossip`` once per
leaf -- and the trainer's host spans, ``spans``: each span name's count,
total and self host seconds and counts per event,
``repro_torch.obs.spans``) and a ``cProfile`` pass (host time per Python
function).  Needs a CUDA device.

To count another tree's launches with this script, run it as a file with
that tree's ``src`` first on the path:
``PYTHONPATH=DIR/src python src/repro_torch/xp/profile_path.py``.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import time


def _spec(n: int, mode: str, events: int):
    from repro_torch.xp import ExperimentSpec
    # fused runs keep the virtual clock on the device: bounded by events
    bound = (dict(max_time=None, max_events=events) if mode == "fused"
             else dict(max_time=30.0))
    return ExperimentSpec(name="paper_figures", scales=(n,), seeds=(0,),
                          mode=mode, ref_max_events=160, eval_every=10,
                          ref_eval_every=2, **bound)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--alg", default="dsgd_aau")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--mode", default="sparse_scan",
                    choices=("scan", "sparse_scan", "per_event", "fused"))
    ap.add_argument("--events", type=int, default=256)
    ap.add_argument("--warm", type=int, default=64)
    ap.add_argument("--eval-every", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="also write the summary JSON here")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.sparse_gossip import ops as sparse_ops
    from repro_torch.obs import spans
    from repro_torch.profiling import device_events, window_summary
    from repro_torch.xp import build_trainer
    if not torch.cuda.is_available():
        raise SystemExit("profile_path needs a CUDA device")
    spec = _spec(args.n, args.mode, args.events)
    eval_every = args.eval_every or args.events
    tr = build_trainer(spec, args.alg, args.n, 0, batch_pool=64)
    tr.warmup(max_events=args.warm + 3 * args.events)
    tr.run(max_events=args.warm, eval_every=args.warm)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    tr.run(max_events=args.events, eval_every=eval_every)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    rows0 = sparse_ops.sparse_gossip_cuda.launches
    spans.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        tr.run(max_events=args.events, eval_every=eval_every)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t1
    rows = (sparse_ops.sparse_gossip_cuda.launches - rows0) // len(tr.W)
    n_dev = len(device_events(prof))

    pr = cProfile.Profile()
    pr.enable()
    tr.run(max_events=args.events, eval_every=eval_every)
    torch.cuda.synchronize()
    pr.disable()

    summary = {
        "device": torch.cuda.get_device_name(0),
        "alg": args.alg, "n": args.n, "mode": tr.mode, "events": args.events,
        "events_per_s": args.events / wall,
        "profiled": window_summary(prof, wall_prof, 15),
        "launches": {"device_events": n_dev, "rows": rows,
                     "per_event": n_dev / args.events,
                     "per_row": n_dev / rows if rows else None},
        "spans": spans.summary(spans.records(), per=args.events),
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
