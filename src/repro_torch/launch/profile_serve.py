"""Where the time of one serving wave goes, on the card.

    python -m repro_torch.launch.profile_serve [--arch A] [--layers L] [--prefix] [--out FILE]

Initialises ``--arch`` (recurrentgemma-2b by default; any registered arch)
at full width from a seeded generator, its depth cut to ``--layers`` where
given (grok-1-314b at 4, arctic-480b at 2, as ``chip_smoke.py`` serves
them), and serves ``chip_smoke.py``'s first wave (4 prompts of 3561, 2344,
1479 and 658 tokens, left-padded to 3561; 32 greedy tokens each; a cache
of 3593) through ``BatchedServer``; with ``--prefix`` (audio and vlm
archs) the wave is prefilled after the config's stub-frontend prefix
(``make_stub_prefix``: musicgen-large's 256 frames, llava-next's 2880
patches), the cache P positions longer.  A short warm-up wave pays
one-time costs, then the wave runs once under the host clock and once
under ``torch.profiler``, the server's prefill and its decode steps as two
windows.  For each window it reports the host-clock time, the device's
busy and idle share, the device time per kernel and the host time per
operator.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

PROMPTS = (3561, 2344, 1479, 658)   # chip_smoke.py's wave 0
NEW = 32
CACHE_LEN = 3561 + NEW


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers, widths kept")
    ap.add_argument("--prefix", action="store_true",
                    help="prefill after the config's stub-frontend prefix")
    ap.add_argument("--out", default=None, help="also write the summary JSON here")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.multimodal import make_stub_prefix
    from repro_torch.models.transformer import init_model
    from repro_torch.profiling import window_summary
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPTS]

    def wave():
        return [Request(rid=i, prompt=p, max_new=NEW) for i, p in enumerate(prompts)]

    prefix = None
    if args.prefix:
        prefix = make_stub_prefix(torch.Generator(device=dev).manual_seed(1),
                                  cfg, len(PROMPTS), dev)
    n_prefix = 0 if prefix is None else prefix.shape[1]
    server = BatchedServer(cfg, model, len(PROMPTS), CACHE_LEN + n_prefix)
    server.run([Request(rid=-1, prompt=prompts[0][:256], max_new=2)])   # warm-up
    reqs = wave()
    t0 = time.perf_counter()
    carry = server.prefill_wave(reqs, prefix)
    first_token_s = time.perf_counter() - t0
    server.decode_wave(reqs, *carry)
    decode_s = time.perf_counter() - t0 - first_token_s

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    reqs = wave()
    with profile(activities=acts) as p_pre:
        t0 = time.perf_counter()
        carry = server.prefill_wave(reqs, prefix)
        t_pre = time.perf_counter() - t0
    with profile(activities=acts) as p_dec:
        t0 = time.perf_counter()
        steps = server.decode_wave(reqs, *carry)
        t_dec = time.perf_counter() - t0
    summary = {
        "device": torch.cuda.get_device_name(0), "arch": cfg.name,
        "n_layers": cfg.n_layers, "prefix_tokens": n_prefix,
        "prompts": list(PROMPTS), "new": NEW,
        "first_token_s": first_token_s, "decode_s": decode_s,
        "prefill": window_summary(p_pre, t_pre, 12),
        "decode": dict(window_summary(p_dec, t_dec, 12), steps=steps,
                       ms_per_step=t_dec * 1e3 / steps),
    }
    print(json.dumps(summary, indent=1))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(summary, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
