"""Figure 9/10 ablation: how straggler probability & slow-down affect each
algorithm's accuracy at a fixed virtual-time budget.

The port of the reference's ``examples/straggler_ablation.py``.  The
reference builds its cells with ``benchmarks/common.py``, which imports
JAX, so this module carries its own :func:`make_classification_trainer`
with the same defaults: the paper's 2-NN (``repro_torch.xp.builders``),
64 features, 256 samples a worker, an Erdős–Rényi graph, η₀ = 0.2
decaying 0.999 per event.  Runs on the card unless ``--device cpu`` is
given.

  python -m repro_torch.examples.straggler_ablation
  python -m repro_torch.examples.straggler_ablation --device cpu
"""
from __future__ import annotations

import argparse
from typing import Mapping, Optional

import torch

from repro_torch.core.baselines import make_scheduler
from repro_torch.core.runner import DecentralizedTrainer
from repro_torch.core.straggler import StragglerModel
from repro_torch.data import ClassificationData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.xp.builders import (build_graph, mlp2nn_eval, mlp2nn_init,
                                     mlp2nn_loss)

BUDGET = 50.0
N_WORKERS = 16
ALGORITHMS = ("dsgd_aau", "ad_psgd", "prague")
PROBS = (0.05, 0.1, 0.2, 0.4)
SLOWDOWNS = (5.0, 10.0, 20.0, 40.0)


def make_classification_trainer(
        alg: str, n: int, *, straggler_prob: float = 0.1,
        slowdown: float = 10.0, device: DeviceLike = "cuda",
        init_params: Optional[Mapping[str, torch.Tensor]] = None
        ) -> DecentralizedTrainer:
    """One ablation cell (``benchmarks/common.py``'s trainer at seed 0 on
    label-sharded data).  ``init_params`` (one worker's parameters)
    replaces the 2-NN's init."""
    data = ClassificationData(n_workers=n, d=64, partition="label_shard",
                              samples_per_worker=256, seed=0)
    g = build_graph("erdos_renyi", n)
    sm = StragglerModel(n=n, straggler_prob=straggler_prob,
                        slowdown=slowdown, seed=0)
    init = mlp2nn_init()
    if init_params is not None:
        fixed = dict(init_params)
        init = lambda gen: fixed  # noqa: E731
    return DecentralizedTrainer(
        make_scheduler(alg, g, sm), mlp2nn_loss, init,
        lambda w, s: data.batch(w, s, batch_size=32),
        data.eval_batch(1024), eval_fn=mlp2nn_eval,
        eta0=0.2, eta_decay=0.999, seed=0, device=device)


def _accuracies(device: DeviceLike, **cell) -> str:
    accs = [make_classification_trainer(alg, N_WORKERS, device=device, **cell)
            .run(max_time=BUDGET, eval_every=10**6).final_metric
            for alg in ALGORITHMS]
    return "  ".join(f"{a:10.4f}" for a in accs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("== straggler probability sweep (slowdown 10x) ==")
    print(f"{'prob':>6s}  " + "  ".join(f"{a:>10s}" for a in ALGORITHMS))
    for prob in PROBS:
        print(f"{prob:6.2f}  " + _accuracies(device, straggler_prob=prob))

    print("== slow-down sweep (prob 10%) ==")
    for slow in SLOWDOWNS:
        print(f"{slow:5.0f}x  " + _accuracies(device, slowdown=slow))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
