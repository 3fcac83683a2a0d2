"""Readings of the control and of the planted faults at a cell's own size,
for setting the cell's limits (``workloads/<workload>.json``).

    python3 portbench/control.py --workload NAME --seeds S [S ...] \\
        [--kinds control half_batch no_exchange]

For each seed the sound reference's readings of the first steps are
compared (``check.numbers``) with those of the same reference put in the
program's place and

- ``control``: computed in the precision below the configuration's
  (float32 configurations in TF32, bfloat16 ones in scaled fp8);
- ``half_batch``: each gradient taken on the first half of its batch;
- ``no_exchange``: the gossip left out.

A state left unchanged reads 1 on the gradient's and the change's gaps by
construction and needs no run.  Prints one JSON line a reading.  The
benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def readings(cell, seed: int, device, mm, fault=None) -> dict:
    """The reference's readings of the cell's first steps."""
    from portbench.drivers import sim, train
    if cell.traffic["driver"] == "sim":
        data = sim.make_inputs(cell, seed, device)
        return sim.reference(cell, seed, data, device, mm, fault)
    return train.reference(cell, seed, device, mm, fault)


def control_readings(cell, seed: int, kinds, device="cuda"):
    """[(kind, numbers)] of one seed."""
    import torch
    from portbench import check
    from portbench.drivers import free, sim, train
    from portbench.reference.model import Matmul

    sound = (sim if cell.traffic["driver"] == "sim" else train).REFERENCE
    ref = readings(cell, seed, device, Matmul(sound))
    free(device)
    out = []
    for kind in kinds:
        if kind == "control":
            mm = Matmul(torch.float32, CONTROL[cell.config["torch_dtype"]])
            alt = readings(cell, seed, device, mm)
        else:
            alt = readings(cell, seed, device, Matmul(sound), fault=kind)
        free(device)
        out.append((kind, check.numbers(alt, ref, cell.leaf_gap)))
    return out


def main(argv=None) -> int:
    from portbench.harness import ROOT, Cell, _load, caches
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--kinds", nargs="+",
                    default=["control", "half_batch", "no_exchange"])
    args = ap.parse_args(argv)
    caches()
    cell = Cell(_load(ROOT / "BENCHMARK.json"), args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for kind, nums in control_readings(cell, seed, args.kinds):
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "kind": kind, "numbers": nums,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
