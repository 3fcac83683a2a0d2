"""Quickstart: straggler-resilient decentralized training in ~30 lines.

The port of the reference's ``examples/quickstart.py``: trains the
quickstart's 2-layer net (64 → 256 → 10, no biases) on synthetic non-iid
data with all five algorithms under a 10×-slowdown straggler model and
prints the Table-2-style comparison.  At N = 16 ``mode="auto"`` takes the
dense scan (``masked_gossip``) for every algorithm.  Runs on the card
unless ``--device cpu`` is given.

  python -m repro_torch.examples.quickstart
  python -m repro_torch.examples.quickstart --device cpu
"""
from __future__ import annotations

import argparse
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core import topology
from repro_torch.core.baselines import make_scheduler
from repro_torch.core.runner import DecentralizedTrainer
from repro_torch.core.straggler import StragglerModel
from repro_torch.data import ClassificationData
from repro_torch.device import DeviceLike, resolve_device

N_WORKERS = 16
ALGORITHMS = ("dsgd_aau", "dsgd_sync", "ad_psgd", "prague", "agp")
BUDGET = 50.0            # virtual seconds of training per algorithm

Params = Dict[str, torch.Tensor]


def loss_fn(params: Mapping[str, torch.Tensor], batch) -> torch.Tensor:
    h = torch.relu(batch["x"] @ params["w1"])
    logp = torch.log_softmax(h @ params["w2"], dim=-1)
    return -logp.gather(1, batch["y"].long()[:, None]).mean()


def eval_fn(params: Mapping[str, torch.Tensor], batch
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = torch.relu(batch["x"] @ params["w1"])
    acc = ((h @ params["w2"]).argmax(-1) == batch["y"].long()).to(torch.float32).mean()
    return loss_fn(params, batch), acc


def init_fn(gen: torch.Generator) -> Params:
    return {"w1": torch.randn((64, 256), generator=gen) * 0.1,
            "w2": torch.randn((256, 10), generator=gen) * 0.1}


def build_trainer(alg: str, device: DeviceLike = "cuda",
                  init_params: Optional[Mapping[str, torch.Tensor]] = None
                  ) -> DecentralizedTrainer:
    """One algorithm's trainer at the quickstart's protocol: 16 workers on
    label-sharded data (5 classes each), an Erdős–Rényi graph (p = 0.3),
    10 % stragglers slowed 10×, η₀ = 0.2.  ``init_params`` (one worker's
    parameters, e.g. carried from NumPy) replaces ``init_fn``."""
    dev = resolve_device(device)
    data = ClassificationData(n_workers=N_WORKERS, d=64, partition="label_shard",
                              classes_per_worker=5, samples_per_worker=256)
    graph = topology.erdos_renyi(N_WORKERS, 0.3, seed=1)     # the paper's
    stragglers = StragglerModel(n=N_WORKERS, straggler_prob=0.1,  # protocol
                                slowdown=10.0)
    init = init_fn
    if init_params is not None:
        fixed = dict(init_params)
        init = lambda gen: fixed  # noqa: E731
    return DecentralizedTrainer(
        make_scheduler(alg, graph, stragglers), loss_fn, init,
        lambda w, s: data.batch(w, s, 32), data.eval_batch(1024),
        eval_fn=eval_fn, eta0=0.2, device=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(f"{'algorithm':12s} {'acc@t=50':>9s} {'loss':>8s} {'iters':>6s} {'comm-GiB':>9s}")
    for alg in ALGORITHMS:
        res = build_trainer(alg, device).run(max_time=BUDGET, eval_every=10**6)
        print(f"{res.algorithm:12s} {res.final_metric:9.4f} {res.final_loss:8.4f} "
              f"{res.total_events:6d} {res.comm_bytes()/2**30:9.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
