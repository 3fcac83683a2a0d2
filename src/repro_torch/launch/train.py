"""Production training launcher: decentralized DSGD-AAU on one card.

The port of ``repro/launch/train.py``.  Runs ``launch/steps.py``'s
train_step in a loop with the host's straggler draw setting each step's
gossip weights, the token data pipeline, and periodic checkpointing.
``--demo`` runs the reduced config at a short sequence; without it the
arch trains at its published widths and depth, seq 4096.

On one card the workers are a stacked leading axis of every parameter
(``--workers``, default 2), gossiping on a ring through the ``gossip_mix``
kernel.  The reference takes its worker count from the production mesh
(``train_view``) without ``--demo``; that mesh, and ``--multipod``'s
inter-pod edge, belong to the sharded launch stack (ROADMAP A5), so
``--workers`` stands in for them here.

  python -m repro_torch.launch.train --arch qwen3-8b --demo --steps 20 --device cpu
  python -m repro_torch.launch.train --arch recurrentgemma-2b --workers 4 \\
      --seq 4096 --global-batch 8 --steps 3                      # on the card
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Optional

import numpy as np
import torch


def main(argv=None, *, on_mix: Optional[Callable] = None,
         on_step: Optional[Callable] = None) -> int:
    """The CLI.  Instrumentation hooks for callers that drive it in process
    (``chip_smoke.py``): ``on_mix(k, key, before, after)`` sees each
    leaf's pre- and post-gossip tensors of step k, ``on_step(k, loss,
    seconds, W)`` each step's mean loss, host time and parameters."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--workers", type=int, default=2,
                    help="decentralized workers, a stacked leading axis of "
                         "the parameters on one card (the reference's "
                         "production mesh sets them: ROADMAP A5)")
    ap.add_argument("--demo", action="store_true",
                    help="reduced config at a short sequence")
    ap.add_argument("--multipod", action="store_true",
                    help="the inter-pod gossip edge (not ported: ROADMAP A5)")
    ap.add_argument("--straggler-prob", type=float, default=0.1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)
    if args.multipod:
        raise NotImplementedError(
            "--multipod needs the sharded launch stack on torch.distributed "
            "(ROADMAP A5)")

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
    from repro_torch.device import resolve_device
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import MICROBATCH

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    n_workers = args.workers
    if args.demo:
        cfg = cfg.reduced()
        seq = args.seq or 64
        gb = args.global_batch or max(n_workers * 2, 4)
        microbatch = 1
    else:
        seq = args.seq or 4096
        gb = args.global_batch or 256
        microbatch = MICROBATCH.get(args.arch, 1)

    step = ST.build_train_step(cfg, n_workers, microbatch=microbatch,
                               logit_chunk=min(512, max(seq // 4, 16)),
                               device=dev)
    gw0 = ST.default_gossip_weights(n_workers, False)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=gb,
        n_workers=n_workers))
    rng = np.random.default_rng(0)
    W = ST.stacked_init(cfg, n_workers,
                        torch.Generator(device=dev).manual_seed(0), dev)
    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    for k in range(args.steps):
        # AAU adaptivity: edges whose endpoint straggles this round carry
        # zero weight (the worker keeps computing; its mass stays put).
        gw = dict(gw0)
        if rng.random() < args.straggler_prob:
            gw.update({"left": torch.tensor(0.0), "right": torch.tensor(0.0),
                       "self": torch.tensor(1.0)})
        toks = np.stack([stream.worker_batch(w)["tokens"]
                         for w in range(n_workers)])
        batch = {"tokens": torch.as_tensor(toks).to(dev)}
        if cfg.frontend:
            batch["prefix"] = torch.zeros(
                (n_workers, gb // n_workers, cfg.n_prefix_tokens, cfg.d_model),
                dtype=cfg.cdtype, device=dev)
        mix = (None if on_mix is None else
               lambda key, before, after, k=k: on_mix(k, key, before, after))
        t0 = time.time()
        W, loss = step(W, batch, args.eta, gw, mix)
        loss = float(loss)
        seconds = time.time() - t0
        print(f"step {k:4d} loss {loss:.4f}  ({seconds:.2f}s)")
        if on_step is not None:
            on_step(k, loss, seconds, W)
        if ckpt and args.ckpt_every and (k + 1) % args.ckpt_every == 0:
            ckpt.save(k + 1, W, extra={"stream": {
                "cursor": stream.state_dict()["cursor"].tolist()}})
    print("done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
