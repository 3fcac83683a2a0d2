"""End-to-end example: decentralized training of an assigned-architecture LM.

The port of the reference's ``examples/decentralized_lm.py``: trains a
qwen3-family decoder (qk-norm, GQA, float32) with DSGD-AAU over N workers
on non-iid synthetic token streams.  ``--preset 100m`` builds a
126.6M-parameter model (12 layers, d_model 768); the default preset is
laptop-sized.  Runs on the card unless ``--device cpu`` is given.

  python -m repro_torch.examples.decentralized_lm --device cpu          # tiny
  python -m repro_torch.examples.decentralized_lm --preset 100m --events 300
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from repro_torch.configs import ModelConfig, get_config
from repro_torch.core import topology
from repro_torch.core.baselines import make_scheduler
from repro_torch.core.runner import DecentralizedTrainer
from repro_torch.core.straggler import StragglerModel
from repro_torch.data import TokenStream, TokenStreamConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import flat_params, init_model, lm_loss, param_count

PRESETS = {
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                 d_ff=256, vocab_size=512),
    "20m": dict(n_layers=6, d_model=384, n_heads=6, n_kv_heads=2,
                d_ff=1152, vocab_size=8192),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=2304, vocab_size=16384),
}


def preset_config(preset: str) -> ModelConfig:
    """qwen3-8b's family and options at the preset's widths, in float32."""
    return dataclasses.replace(
        get_config("qwen3-8b"), name=f"qwen3-{preset}",
        param_dtype="float32", compute_dtype="float32", **PRESETS[preset])


def build_trainer(cfg: ModelConfig, workers: int, seq: int, batch: int,
                  algorithm: str = "dsgd_aau", device: DeviceLike = "cuda",
                  eta0: float = 0.3, **trainer_kw) -> DecentralizedTrainer:
    """The example's trainer: ``TokenStream`` batches (``batch`` sequences of
    ``seq`` tokens per worker), an Erdős–Rényi graph (p = 0.4), 10 %
    stragglers slowed 10×, η₀ (0.3 as the reference's example) decaying
    0.999 per event; further keywords (``mode``, ``events_per_step``, ...)
    go to the trainer."""
    dev = resolve_device(device)
    stream = TokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=seq,
        global_batch=batch * workers, n_workers=workers))
    g = topology.erdos_renyi(workers, 0.4, seed=1)
    sm = StragglerModel(n=workers, straggler_prob=0.1, slowdown=10.0)
    return DecentralizedTrainer(
        make_scheduler(algorithm, g, sm),
        lambda p, b: lm_loss(p, cfg, b),
        lambda gen: flat_params(init_model(cfg, gen, dev)),
        lambda w, s: stream.worker_batch(w, s),
        stream.worker_batch(0, 10**9),
        eta0=eta0, eta_decay=0.999, device=dev, **trainer_kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=sorted(PRESETS))
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--events", type=int, default=60)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--algorithm", default="dsgd_aau")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = preset_config(args.preset)
    print(f"model: {cfg.name}  params={param_count(cfg)/1e6:.1f}M  "
          f"workers={args.workers}  alg={args.algorithm}")
    trainer = build_trainer(cfg, args.workers, args.seq, args.batch,
                            args.algorithm, args.device)

    t0 = time.time()
    res = trainer.run(max_events=args.events, eval_every=max(args.events // 6, 1))
    for h in res.history:
        print(f"  iter {h.k:5d}  vclock {h.time:8.1f}  loss {h.loss:.4f}  "
              f"active {h.n_active_mean:.1f}")
    print(f"done: {res.total_events} events in {time.time()-t0:.1f}s wall, "
          f"final loss {res.final_loss:.4f}, comm {res.comm_bytes()/2**20:.1f} MiB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
