"""Where the time of one training step goes, on the card.

    python -m repro_torch.launch.profile_train [--steps K] [--out FILE]
        [any flag of python -m repro_torch.launch.train]

Runs ``python -m repro_torch.launch.train`` itself (``train.main``) with
this script's defaults before the given flags: recurrentgemma-2b at full
width and depth, ``--workers 4 --seq 4096 --global-batch 8 --steps 3
--straggler-prob 0`` (every step gossips on the ring).  The last of the
``--steps`` steps runs under ``torch.profiler`` (device activity only: a
step issues ~10^6 operators, and recording them on the host too makes the
window take minutes); the earlier ones pay the one-time costs.  Reports
the steps' host-clock seconds, the profiled step's device busy and idle
share, device time of the 15 kernels that take most and, by name, of the
port's own kernels (the ``repro`` namespace of ``csrc/``), the number of
device kernels launched, the step's peak device memory, and the step's
host spans (``spans``: each span name's count, total and self host
seconds and counts in the profiled step, ``repro_torch.obs.spans``).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json

DEFAULTS = ("--arch", "recurrentgemma-2b", "--workers", "4", "--seq", "4096",
            "--global-batch", "8", "--straggler-prob", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3,
                    help="steps to run; the last one is profiled")
    ap.add_argument("--out", default=None, help="also write the summary JSON here")
    args, rest = ap.parse_known_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch.launch import train
    from repro_torch.obs import spans
    from repro_torch.profiling import device_events, window_summary
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    last = args.steps - 1
    seconds, summary = [], {}

    def on_step(k, loss, s, W):
        seconds.append(s)
        if k == last - 1:
            torch.cuda.reset_peak_memory_stats()
        prof.step()

    def on_trace_ready(p):
        summary.update(window_summary(p, seconds[-1], 15),
                       port_device_ms=[
                           (e.key, e.count, e.self_device_time_total / 1e3)
                           for e in p.key_averages() if "repro::" in e.key],
                       device_kernels=len(device_events(p)),
                       peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del summary["top_host_ms"]      # no host activity recorded

    spans.clear()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=last, warmup=0, active=1, repeat=1),
                 on_trace_ready=on_trace_ready) as prof:
        rc = train.main([*DEFAULTS, *rest, "--steps", str(args.steps)],
                        on_step=on_step)
    out = {"device": torch.cuda.get_device_name(0),
           "argv": [*DEFAULTS, *rest, "--steps", str(args.steps)],
           "step_s": seconds, "profiled": summary,
           "spans": spans.summary(spans.records())}
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
