"""Serving launcher of the port: batched prefill + greedy decode.

The port of ``repro/launch/serve.py``.  Requests (token prompts) are
admitted in slot-sized waves (static batching): each wave is left-padded
with token 0 to its longest prompt, prefilled once, then decoded step by
step; every request of a wave gets its own number of new tokens.  Each
step fetches the wave's tokens to the host once.  ``--demo`` runs the
reduced config; ``--layers`` keeps the published widths and cuts the
depth (a model whose weights exceed the card).  Every arch of the
registry serves: hybrid (``recurrentgemma-2b``), dense (``qwen3-8b``,
``minicpm-2b``, ``mistral-nemo-12b``, ``deepseek-67b``,
``paper-char-lm``), moe (``grok-1-314b``, ``arctic-480b``:
capacity-routed experts, arctic's dense residual), ssm (``rwkv6-1.6b``:
the chunked WKV recurrence in PyTorch, an O(1) decode state), audio
(``musicgen-large``) and vlm (``llava-next-mistral-7b``); prefill
attention runs the ``swa_attention`` kernel (no window for the dense, moe,
audio and vlm archs), decode reads the KV cache in plain PyTorch.

The server serves token prompts, as the reference's does: the audio and
vlm archs' stub-frontend prefix goes through ``prefill(...,
prefix_embeds=)`` (``models.multimodal.make_stub_prefix``), which
``prefill_wave`` takes on request for a wave that is then decoded with
``decode_wave`` (``launch/profile_serve.py --prefix``).

  python -m repro_torch.launch.serve --arch recurrentgemma-2b --demo --device cpu
  python -m repro_torch.launch.serve --arch rwkv6-1.6b --demo --device cpu
  python -m repro_torch.launch.serve --arch llava-next-mistral-7b --demo --device cpu
  python -m repro_torch.launch.serve --arch qwen3-8b                 # on the card
  python -m repro_torch.launch.serve --arch grok-1-314b --layers 4   # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import decode_step, init_model, prefill


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class WaveStats:
    """Host-clock times of one wave; each ends at a fetch of tokens to the
    host, which waits for the device."""
    batch: int
    padded_len: int
    prompt_tokens: int       # real prompt tokens (padding excluded)
    first_token_s: float     # wave start → first tokens on the host
    decode_s: float          # first tokens → last tokens on the host
    decode_steps: int


class BatchedServer:
    """Fixed-slot batched greedy decoder around prefill/decode_step."""

    def __init__(self, cfg, model, batch_slots: int, cache_len: int):
        self.cfg = cfg
        self.model = model
        self.slots = batch_slots
        self.cache_len = cache_len
        self.device = model.final_norm.scale.device
        self.stats: List[WaveStats] = []

    def run(self, requests: List[Request]) -> List[Request]:
        """Admit requests in slot-sized waves, in order."""
        for i in range(0, len(requests), self.slots):
            self._run_wave(requests[i:i + self.slots])
        return requests

    def _run_wave(self, wave: List[Request]) -> None:
        t0 = time.perf_counter()
        cur, host, state, padded_len = self.prefill_wave(wave)
        t1 = time.perf_counter()
        steps = self.decode_wave(wave, cur, host, state, padded_len)
        self.stats.append(WaveStats(
            batch=len(wave), padded_len=padded_len,
            prompt_tokens=sum(len(r.prompt) for r in wave),
            first_token_s=t1 - t0, decode_s=time.perf_counter() - t1,
            decode_steps=steps))

    def prefill_wave(self, wave: List[Request],
                     prefix_embeds: Optional[torch.Tensor] = None):
        """Left-pad the wave's prompts with 0 and prefill them, after
        ``prefix_embeds`` (B, P, D) where given (``cache_len`` must then
        hold P more positions); returns the first greedy tokens (on the
        card and on the host), the decode state and the next token's
        position (P + the padded length)."""
        max_len = max(len(r.prompt) for r in wave)
        toks = np.zeros((len(wave), max_len), np.int64)
        for j, r in enumerate(wave):
            toks[j, max_len - len(r.prompt):] = r.prompt   # left-pad with 0
        logits, state = prefill(self.model, self.cfg,
                                torch.from_numpy(toks).to(self.device),
                                self.cache_len, prefix_embeds=prefix_embeds)
        cur = torch.argmax(logits, -1)
        pos = max_len + (0 if prefix_embeds is None else prefix_embeds.shape[1])
        return cur, cur.tolist(), state, pos

    def decode_wave(self, wave: List[Request], cur, host, state, pos: int) -> int:
        """Greedy decode from ``prefill_wave``'s result until every request
        has its tokens; returns the number of decode steps."""
        max_new = max(r.max_new for r in wave)
        for step in range(max_new):
            for j, r in enumerate(wave):
                if step < r.max_new:
                    r.out.append(host[j])
            if step + 1 == max_new:
                break
            logits, state = decode_step(self.model, self.cfg, cur, state, pos)
            cur = torch.argmax(logits, -1)
            host = cur.tolist()
            pos += 1
        for r in wave:
            r.done = True
        return max_new - 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers, widths kept")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.demo:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    model = init_model(cfg, gen, device)
    cache_len = args.cache_len or 256
    server = BatchedServer(cfg, model, args.slots, cache_len)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(rid=i,
                    prompt=rng.integers(0, cfg.vocab_size,
                                        size=rng.integers(4, 17)).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.requests)]
    t0 = time.time()
    server.run(reqs)
    dt = time.time() - t0
    n_tok = sum(len(r.out) for r in reqs)
    for r in reqs[:3]:
        print(f"req {r.rid}: prompt[{len(r.prompt)}] -> {r.out[:8]}...")
    print(f"served {len(reqs)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s) on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
