"""End-to-end serving driver: batched requests against an assigned arch.

The port of the reference's ``examples/serve_batched.py``: spins up the
``BatchedServer`` with a reduced rwkv6 (O(1) decode state — the
long-context family), submits a wave of mixed-length prompts, decodes
greedily, and reports per-request outputs + throughput.  Runs on the card
unless ``--device cpu`` is given.

  python -m repro_torch.examples.serve_batched [--arch recurrentgemma-2b]
  python -m repro_torch.examples.serve_batched --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.serve import BatchedServer, Request
from repro_torch.models import init_model

CACHE_LEN = 256


def make_requests(vocab_size: int, n: int, max_new: int) -> List[Request]:
    """``n`` requests of 4-23 prompt tokens drawn by ``default_rng(0)``
    (the reference's draws)."""
    rng = np.random.default_rng(0)
    return [Request(rid=i,
                    prompt=rng.integers(0, vocab_size,
                                        size=int(rng.integers(4, 24))).astype(np.int32),
                    max_new=max_new)
            for i in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = init_model(cfg, torch.Generator(device=device).manual_seed(0), device)
    server = BatchedServer(cfg, model, batch_slots=args.slots, cache_len=CACHE_LEN)

    reqs = make_requests(cfg.vocab_size, args.requests, args.max_new)
    t0 = time.time()
    server.run(reqs)
    dt = time.time() - t0
    for r in reqs:
        print(f"req {r.rid}: prompt_len={len(r.prompt):2d} -> "
              f"{' '.join(map(str, r.out[:10]))} ...")
    tok = sum(len(r.out) for r in reqs)
    print(f"\n{args.arch} ({cfg.name}): {len(reqs)} requests, {tok} tokens, "
          f"{dt:.2f}s ({tok/dt:.1f} tok/s greedy, slots={args.slots})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
