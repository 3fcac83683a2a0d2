"""Production training launcher: decentralized DSGD-AAU, on one card or
sharded over ranks.

The port of ``repro/launch/train.py``.  Runs a ``launch/steps.py`` train
step in a loop with the host's straggler draw setting each step's gossip
weights, the token data pipeline, and periodic checkpointing.  ``--demo``
runs the reduced config at a short sequence; without it the arch trains at
its published widths and depth, seq 4096.

Under ``torchrun`` (``WORLD_SIZE`` set) it takes the reference's mesh
path: a ``DeviceMesh`` over the ranks (NCCL on ``cuda``, gloo on ``cpu``),
the worker-sharded replicas of ``build_sharded_train_step`` and the
send/recv ring.  With ``--demo`` the mesh is (data, model) with model 2
when the world size is even and above 1, and ``--workers`` (default: the
data axis) splits data into (worker, fsdp); as in the reference, ``--demo``
ignores ``--multipod``.  Without ``--demo`` the mesh is the production
``train_view`` of the arch: 256 ranks, 512 with ``--multipod``.

Without a process group the workers are a stacked leading axis of every
parameter on one device (``--workers``, default 2), gossiping through the
``gossip_mix`` kernel; ``--multipod`` splits them into two pods joined by
the inter-pod edge.

  python -m repro_torch.launch.train --arch qwen3-8b --demo --steps 20 --device cpu
  python -m repro_torch.launch.train --arch recurrentgemma-2b --workers 4 \\
      --seq 4096 --global-batch 8 --steps 3                      # on the card
  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch qwen3-8b --demo --steps 3 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(device: torch.device) -> bool:
    """The default process group of a ``torchrun`` launch (its env://
    rendezvous), on the backend of ``device``'s type: NCCL for ``cuda``,
    gloo for ``cpu``, never another.  Returns whether it was created here
    (False: the caller's group is used as it is)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(BACKENDS[device.type],
                            timeout=datetime.timedelta(seconds=600))
    return True


@dataclasses.dataclass
class Setup:
    """What the step loop needs of a set-up: the workers and the batch, the
    parameters, ``step(W, toks, eta, gossip_w, k) -> (W, loss)`` on the
    host's (N, b, T) draw of every worker's tokens, ``whole(W)`` (every
    worker's replica, stacked, for a checkpoint) and this rank."""
    n_workers: int
    pods: int
    seq: int
    global_batch: int
    W: dict
    step: Callable
    whole: Callable
    rank: int = 0


def _batch(cfg, toks: np.ndarray, dev) -> dict:
    """{"tokens", ["prefix"]} on ``dev``: the stub frontend's prefix is
    zeros of the tokens' leading dims."""
    batch = {"tokens": torch.as_tensor(toks).to(dev)}
    if cfg.frontend:
        batch["prefix"] = torch.zeros(
            toks.shape[:-1] + (cfg.n_prefix_tokens, cfg.d_model),
            dtype=cfg.cdtype, device=dev)
    return batch


def _stacked_setup(args, cfg, dev, on_mix: Optional[Callable]) -> Setup:
    """The workers stacked on one device's leading axis."""
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import MICROBATCH
    n_workers = args.workers or 2
    pods = 2 if args.multipod else 1
    if n_workers % pods:
        raise ValueError(f"--multipod splits --workers into two pods; "
                         f"{n_workers} is odd")
    seq = args.seq or (64 if args.demo else 4096)
    gb = args.global_batch or (max(n_workers * 2, 4) if args.demo else 256)
    microbatch = 1 if args.demo else MICROBATCH.get(args.arch, 1)
    train_step = ST.build_train_step(cfg, n_workers, microbatch=microbatch,
                                     logit_chunk=min(512, max(seq // 4, 16)),
                                     pods=pods, device=dev)
    W = ST.stacked_init(cfg, n_workers,
                        torch.Generator(device=dev).manual_seed(0), dev)

    def step(W, toks, eta, gw, k):
        mix = (None if on_mix is None else
               lambda key, before, after: on_mix(k, key, before, after))
        return train_step(W, _batch(cfg, toks, dev), eta, gw, mix)

    return Setup(n_workers, pods, seq, gb, W, step, whole=lambda W: W)


def _sharded_setup(args, cfg, dev) -> Setup:
    """The reference's mesh path: this rank's shards of its worker."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import sharding as S
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import (MICROBATCH, hierarchical_view,
                                         train_view)
    world = dist.get_world_size()
    if args.demo:
        model_par = 2 if world % 2 == 0 and world > 1 else 1
        data_par = max(1, world // model_par)
        base = init_device_mesh(dev.type, (data_par, model_par),
                                mesh_dim_names=("data", "model"))
        n_workers = args.workers or data_par
        mesh, axes = hierarchical_view(base, n_workers,
                                       max(1, data_par // n_workers))
        seq = args.seq or 64
        gb = args.global_batch or max(n_workers * 2, 4)
        microbatch = 1
    else:
        need = 512 if args.multipod else 256
        if world != need:
            raise ValueError(f"the production mesh of {args.arch} needs "
                             f"{need} ranks, got {world} (use --demo for a "
                             f"small mesh)")
        mesh, axes, n_workers = train_view(args.arch, multi_pod=args.multipod,
                                           device_type=dev.type)
        seq, gb = args.seq or 4096, args.global_batch or 256
        microbatch = MICROBATCH.get(args.arch, 1)
    specs = S.param_pspecs(ST.stacked_init(cfg, n_workers, None, "meta"),
                           mesh, fsdp=axes.fsdp, model=axes.model,
                           worker_axes=axes.worker_axes)
    train_step = ST.build_sharded_train_step(
        cfg, n_workers, axes, mesh, specs, microbatch=microbatch,
        logit_chunk=min(512, max(seq // 4, 16)))
    # every rank draws the same replica and keeps its shard
    rep = {k: v[0] for k, v in ST.stacked_init(
        cfg, 1, torch.Generator(device=dev).manual_seed(0), dev).items()}
    W = ST.shard_replica(rep, mesh, axes, specs)
    del rep
    me = ST.worker_index(mesh, axes)

    def step(W, toks, eta, gw, k):
        return train_step(W, _batch(cfg, toks[me], dev), eta, gw)

    return Setup(n_workers, 2 if axes.pod else 1, seq, gb, W, step,
                 whole=lambda W: ST.gather_workers(W, mesh, axes),
                 rank=dist.get_rank())


def main(argv=None, *, on_mix: Optional[Callable] = None,
         on_step: Optional[Callable] = None) -> int:
    """The CLI.  Instrumentation hooks for callers that drive it in process
    (``chip_smoke.py``): ``on_mix(k, key, before, after)`` sees each
    leaf's pre- and post-gossip tensors of step k (the stacked path),
    ``on_step(k, loss, seconds, W)`` each step's mean loss, host time and
    parameters."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--eta", type=float, default=0.05)
    ap.add_argument("--workers", type=int, default=None,
                    help="decentralized workers: stacked on one device "
                         "without a process group (default 2); under "
                         "torchrun with --demo, the worker split of the data "
                         "axis (default: all of it)")
    ap.add_argument("--demo", action="store_true",
                    help="reduced config at a short sequence (a small mesh "
                         "under torchrun)")
    ap.add_argument("--multipod", action="store_true",
                    help="two pods joined by the inter-pod gossip edge")
    ap.add_argument("--straggler-prob", type=float, default=0.1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenStream, TokenStreamConfig
    from repro_torch.device import resolve_device
    from repro_torch.launch import steps as ST

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.demo:
        cfg = cfg.reduced()
    created = False
    if "WORLD_SIZE" in os.environ:
        created = init_distributed(dev)
        run = _sharded_setup(args, cfg, dev)
    else:
        run = _stacked_setup(args, cfg, dev, on_mix)

    n_workers, W = run.n_workers, run.W
    gw0 = ST.default_gossip_weights(n_workers // run.pods, run.pods == 2)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=run.seq,
        global_batch=run.global_batch, n_workers=n_workers))
    rng = np.random.default_rng(0)
    ckpt = (Checkpointer(args.ckpt_dir) if args.ckpt_dir and run.rank == 0
            else None)
    for k in range(args.steps):
        # AAU adaptivity: edges whose endpoint straggles this round carry
        # zero weight (the worker keeps computing; its mass stays put).
        gw = dict(gw0)
        if rng.random() < args.straggler_prob:
            gw.update({"left": torch.tensor(0.0), "right": torch.tensor(0.0),
                       "self": torch.tensor(1.0)})
        # every rank draws every worker's batch, so the streams' cursors
        # (the checkpoint's) agree with the stacked path's
        toks = np.stack([stream.worker_batch(w)["tokens"]
                         for w in range(n_workers)])
        t0 = time.time()
        W, loss = run.step(W, toks, args.eta, gw, k)
        loss = float(loss)
        seconds = time.time() - t0
        if run.rank == 0:
            print(f"step {k:4d} loss {loss:.4f}  ({seconds:.2f}s)")
        if on_step is not None:
            on_step(k, loss, seconds, W)
        if args.ckpt_dir and args.ckpt_every and (k + 1) % args.ckpt_every == 0:
            # rank 0 writes every worker's replica, gathered whole
            whole = run.whole(W)
            if ckpt is not None:
                ckpt.save(k + 1, whole, extra={"stream": {
                    "cursor": stream.state_dict()["cursor"].tolist()}})
            del whole
    if run.rank == 0:
        print("done")
    if created:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
