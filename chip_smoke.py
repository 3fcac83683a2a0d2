"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root of a checkout (it imports ``src/repro_torch``
beside this file and builds the CUDA kernels from ``src/repro_torch/csrc``
with nvcc into ``build/repro_torch``).  It needs one CUDA device and exits
non-zero, printing no result, when there is none or when any phase fails:

1. build every kernel (one nvcc per source, in parallel) and name the card;
2. hold each kernel against its plain PyTorch version on the card, at the
   main paths' shapes plus ragged and edge cases, in float32 and bfloat16,
   and time the kernel, the plain version and one PyTorch library call of
   the same function where one exists -- per call (CUDA events) and, for
   the kernel and the library call, as device time alone (a profiled run,
   L2 emptied before each call, each call's device events counted) and
   the kernel's host issue time; ``masked_gossip``, ``gossip_mix`` and
   ``sparse_gossip`` (A=256 gathered from N=512) also against the float64
   product where outputs are of order 10, and ``masked_gossip`` summed
   over the 2-NN's six leaves (``sparse_gossip`` and ``scatter_rows`` at
   A = 2, 16, 64, 256 with all, some and no lanes valid, and the main
   path's merged rows at A = 64; ``gossip_mix`` and
   ``gossip_mix_batched`` over N 1-256, D 1-65536, E 1-32, ``gossip_mix``
   timed at every leaf width of the 2-NN; ``swa_attention`` over T 1-4096
   with the serve waves' padded lengths, windows 1 to past T, dh 64-256);
3. the main path: DSGD-AAU at N=256 with the full 2-NN through the bucketed
   active-set path (``sparse_scan``, rungs 16/64/256), 1024 events, with the
   kernels' launch counters set to 0 just before and read just after, and
   the (A, valid lanes) of every ``sparse_gossip`` launch and the cliques'
   sizes recorded;
4. the dense path: synchronous DSGD at N=256 through the dense scan, 160
   events, counters likewise;
5. card vs CPU: DSGD-AAU at N=64 on both from the same W0;
6. the serve path: RecurrentGemma-2B at full width in bfloat16 (random
   weights from a seeded generator) behind ``BatchedServer``, 4 slots, 8
   requests of 512-4096 prompt tokens in 2 waves, 32 new tokens each, with
   the counters set to 0 before each wave and read after it;
7. card vs CPU: the reduced RecurrentGemma on both from the same weights;
9. the per-event path: DSGD-AAU at N=256 with the full 2-NN in
   ``mode="per_event"`` (``gossip_mix`` per leaf per event), 256 events,
   counters zeroed just before and read just after;
10. two routes to eq. (5): DSGD-AAU at N=64 from one W0 in ``per_event``
    (``gossip_mix``) and ``scan`` (``masked_gossip``) on the card, and
    ``per_event`` on the CPU;
11. the fused path: AD-PSGD and AGP at N=256 in ``mode="fused"``, 1024
    events in blocks of 32, counters likewise; then fused on the card
    against fused on the CPU at N=16;
12. ``gossip_mix_batched`` on the system's own data: the (32, 64, 64)
    consensus matrices of a DSGD-AAU ``EventBatch`` applied to 32 copies of
    each trainer leaf, counters likewise, against ``gossip_mix_dense``;
13. the experiment CLI as its users enter it: ``repro_torch.xp.__main__
    .main`` on one ``paper_figures`` cell (N=256, full 2-NN, seed 0,
    ``paper_default``) with ``--telemetry --trace --run-log --out``:
    sync DSGD in ``scan``, DSGD-AAU, AD-PSGD, Prague and AGP in
    ``sparse_scan``, and the dtype probe (fp32 and bf16); counters zeroed
    just before the call and read just after; the artifact's sections,
    staleness bound, copy accounting and meta, and the run log, checked;
14. card vs CPU with telemetry and trace, from one W0 carried with
    ``params_from_numpy``: DSGD-AAU at N=64 in ``sparse_scan`` (merged
    rows) and ``per_event``, sync DSGD at N=64 in ``scan``, AD-PSGD at
    N=16 in ``fused``; integer counters and trace arrays exactly, float
    counters within 1e-4, the wait-blame summary within 1e-6;
15. the cost of observing: events/s with and without telemetry, runs in
    turns (off, on, on, off) of one trainer each, in every mode at N=256
    (fused AD-PSGD 1024 events, the reference's contract being under 10 %);
    then one sanitized ``sparse_scan`` run at N=256, its explicit fetches
    counted;
16. the dense serve path: qwen3-8b at full width in bfloat16 (random
    weights from a seeded generator) behind ``BatchedServer``, phase 6's
    traffic, counters zeroed before each wave and read after it
    (``swa_attention`` once per layer per prefill, no window);
17. decentralized LM training through the LM example's trainer
    (``repro_torch.examples.decentralized_lm.build_trainer``): the 100m
    preset (126.6 M parameters, float32) at N=8, seq 64, batch 8,
    DSGD-AAU, 60 events under ``mode="auto"`` (the dense scan,
    ``masked_gossip``) and under ``mode="sparse_scan"`` one event a row
    (``sparse_gossip`` at A = 8, ``scatter_rows``); then the paper's
    char-LM at full width on ``CharLMData`` at N=256, DSGD-AAU
    ``sparse_scan`` on the main path's stream, 512 events; counters zeroed
    just before each run and read just after; events/s after set-up, the
    device's busy share of a profiled steady window, the loss falling and
    DSGD-AAU's staleness bound 2N−4 held;
18. card vs CPU: the LM example's tiny preset at N=8, 16 events, in ``scan``
    and ``sparse_scan``: worker state within 1e-4, counters exactly;
19. the MoE serve path: grok-1-314b at its published widths in bfloat16
    (d 6144, 48 heads / 8 KV, d_ff 32768, 8 experts top-2, vocab 131,072),
    its depth cut from 64 to 4 layers so that one card holds it, random
    weights from a seeded generator, behind ``BatchedServer`` with phase
    6's traffic; counters zeroed before each wave and read after it
    (``swa_attention`` once per layer per prefill, no other kernel);
20. the same for arctic-480b (d 7168, 56 heads / 8 KV, 128 experts of
    d_ff 4864 top-2, a dense residual MLP of 4864, vocab 32,000), its
    depth cut from 35 to 2 layers;
21. card vs CPU: reduced grok-1 and arctic (float32) from the same weights,
    through ``BatchedServer`` and ``lm_loss`` (its router gradient too),
    also with two dispatch groups and with a capacity factor that drops
    tokens: logits within 1e-4, the same greedy tokens;
22. the ssm serve path: rwkv6-1.6b at full width and depth in bfloat16
    (24 layers, d 2048, 32 heads of 64, d_ff 7168, vocab 65,536; random
    weights from a seeded generator) behind ``BatchedServer`` with phase
    6's traffic; counters zeroed before each wave and read after it (no
    kernel: the chunked WKV recurrence is PyTorch ops, as the reference's
    is a ``jax.lax.scan``); the decode state no larger than the empty one;
23. the audio serve path: musicgen-large at full width and depth (48
    layers, d 2048, MHA 32/32 at dh 64, d_ff 8192, vocab 2048), phase 6's
    traffic (``swa_attention`` once per layer per prefill), then wave 0's
    prompts behind the 256-frame stub prefix through ``prefill(...,
    prefix_embeds=)`` and 31 decode steps;
24. the same for llava-next-mistral-7b (32 layers, d 4096, GQA 32/8 at dh
    128, d_ff 14336, vocab 32,000), its prefix the anyres worst case of
    2880 patch embeddings (prefill length 6441);
25. card vs CPU: reduced rwkv6, musicgen and llava (float32) from the same
    weights, through ``BatchedServer``, a prefill (behind a prefix for
    musicgen and llava) with 15 decode steps, ``lm_loss`` and, for rwkv6,
    its gradient at a ragged T = 100: logits within 1e-4, tokens identical;
26. training through the production launcher: recurrentgemma-2b at full
    width and depth (26 layers, d 2560, vocab 256,000; 3,549,934,080
    parameters a worker, bf16) through ``launch/train.py:main`` with
    ``--workers 4 --seq 4096 --global-batch 8 --steps 3`` (each layer and
    CE chunk rematerialised; the default straggler probability makes step
    2 a straggler round); counters zeroed just before the steps and read
    just after (``gossip_mix`` once per leaf per step, no other kernel);
    every loss and leaf finite, the workers' mean of three leaves kept by
    step 0's ring within the bf16 bound, step 2's gossip (P = I) leaving
    every leaf bit-equal; seconds per step after step 0, tokens/s, peak
    device memory;
27. card vs CPU: one ``build_train_step`` step at N = 2 from one float32
    W0 for each of the ten assigned archs reduced (T = 64), and reduced
    recurrentgemma-2b and minicpm-2b at T = 1280 (blockwise attention, the
    chunked RG-LRU scan): W within 1e-4, the loss within 1e-5;
28. the stacked multi-pod step: one step of ``launch/train.py:main`` for
    recurrentgemma-2b at full width and depth with ``--workers 4
    --multipod`` (2 pods × 2 workers, seq 1024, global batch 4), counters
    zeroed just before and read just after (``gossip_mix`` once per leaf,
    no other kernel); every leaf the two-pod matrix's mix of its workers
    (``ring_err`` ≤ 1) and the workers' mean kept within the bf16 bound;
29. the sharded step on NCCL at world size 1 (a ``FileStore``, ``cuda``):
    recurrentgemma-2b at full width, 1 worker, seq 4096, batch 2, one step
    of ``build_sharded_train_step`` (no kernel launched) against one step of
    the stacked ``build_train_step`` at ``--workers 1``: W within the bf16
    bound, the loss within 1e-5 relative, bit-equality reported; then, in
    a subprocess, the dry run of qwen3-8b × train_4k on the 16×16 mesh of
    a fake 256-rank group, its record printed;
30. the example drivers as their users run them
    (``repro_torch.examples``): ``quickstart.main`` whole (five
    algorithms at N = 16, 50 virtual seconds each, the dense scan's
    ``masked_gossip``), one ``straggler_ablation`` cell, and
    ``serve_batched.main`` at its default (reduced rwkv6) and with
    ``--arch recurrentgemma-2b`` (``linear_scan``, ``swa_attention``);
    counters zeroed just before each and read just after, every printed
    number finite and non-zero;
8. (printed last) a ``{"kernels": [...]}`` line, the card's name and power
   limit, and the final ``{"ok": true, "device": ...}`` line.

Phase 2 also holds ``gossip_mix`` at phase 26's training shape (N = 4
workers of the embed leaf, D = 655,360,000, bf16; timed against cuBLAS's
bf16 ``torch.matmul(P.T, W)``), and the dense LM paths' shapes:
``masked_gossip`` at N=8, ``sparse_gossip`` and ``scatter_rows`` at A=8 of N=8, each at the 100m
preset's widest leaf (D = 21,233,664), and ``swa_attention`` at qwen3-8b's
prefill (B=4, T=4096, H=32, KV=8, dh=128, no window), the MoE serve
waves' (B=4, T 2795 and 3561, GQA 48/8 and 56/8, dh=128, no window), and
the audio and vlm prefills' (B=4, no window, bf16, each timed against
SDPA's causal mask: musicgen MHA 32/32 at dh 64, T 3561 and 3817 with its
prefix; llava GQA 32/8 at dh 128, T 3561 and 6441 with its prefix).
Each full-width model is freed before the next phase.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (dense, no sparsity; NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12,     # CUDA cores (TF32 is off for parity)
              "bfloat16": 989e12}   # tensor cores
# The least time for a float32-accurate matrix product: three TF32 tensor-
# core products per multiply-add (hi·hi + hi·lo + lo·hi, the 3xTF32 split
# the gossip kernels can use) at 495 TFLOP/s, 165 TFLOP/s effective, which
# beats the CUDA cores' 67.  The product rows (masked_gossip, gossip_mix,
# gossip_mix_batched, sparse_gossip) are bounded by it in float32.
PRODUCT_FLOPS = dict(PEAK_FLOPS, float32=495e12 / 3)
TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
# swa_attention's outputs are small (about sqrt(e / window) for unit q, k,
# v: 0.03 at the main window), so its bfloat16 cases are held to a bound
# set from that scale; one bf16 rounding apart stays within it
SWA_TOL = dict(TOL, bfloat16=dict(atol=5e-3, rtol=1e-2))
NN_LEAVES = (16384, 256, 65536, 256, 2560, 10)   # the 2-NN's leaf widths
D_LEAVES = (16384, 65536, 256, 2560, 10)   # each width once
REPS = 200                                 # calls per timing of a small kernel
N_MAIN = 256
A_RUNGS = (2, 16, 64, 256)                # the fused path's width, the ladder
MERGED_A = 64                              # merged rows' width on the main path
ARCH = "recurrentgemma-2b"
SERVE_SLOTS, SERVE_REQUESTS, SERVE_NEW = 4, 8, 32
SCAN_MAIN = (4, 4096, 2560)                # B, T, rnn width
SWA_MAIN = (4, 4096, 10, 1, 256, 2048)     # B, T, H, KV, dh, window
SERVE_PADDED = (2795, 3561)                # phase 6's padded prompt lengths
DENSE_ARCH = "qwen3-8b"                    # phase 16's model
SWA_DENSE = (4, 4096, 32, 8, 128, 4096)   # its prefill: window = T (none)
LM_N, LM_LEAF_D = 8, 12 * 768 * 2304       # the 100m preset's widest leaf
LM_PRESET, LM_EVENTS, LM_SEQ, LM_BATCH = "100m", 60, 64, 8
# the 100m preset's step size: at the LM example's 0.3 its loss swings between
# 9.4 and 12.8 from one eval to the next and two runs whose states differ
# by 5e-6 part by O(1) within 10 events; at 0.03 it falls steadily
LM_ETA0 = 0.03
CHAR_N, CHAR_EVENTS, CHAR_POOL = 256, 512, 4   # CharLMData draws ~6 ms each
# phases 19-20: (arch, layers kept of the published depth, phase)
MOE_SERVE = (("grok-1-314b", 4, "19"), ("arctic-480b", 2, "20"))
# phases 22-24: the ssm, audio and vlm archs at full width and depth
MM_SERVE = (("rwkv6-1.6b", "22"), ("musicgen-large", "23"),
            ("llava-next-mistral-7b", "24"))
# phase 26: recurrentgemma-2b trained at full width and depth through the
# production launcher; step 2 is the straggler round of default_rng(0)'s
# draws 0.637, 0.270, 0.041 against the default probability 0.1
TRAIN_ARGV = ("--arch", ARCH, "--workers", "4", "--seq", "4096",
              "--global-batch", "8", "--steps", "3")
TRAIN_STRAGGLERS = (False, False, True)
TRAIN_MEAN_LEAVES = ("embed.table", "layers.0.rec.w_in", "layers.2.attn.wq")
# phase 2's gossip_mix row at the training shape: 4 workers of the embed leaf
TRAIN_MIX = (4, 256000 * 2560)
# calls per timing at that shape: cuBLAS's bf16 product there launches
# ~600 kernels a call, and its profiled device time over 20 calls took 88 s
# on the H100 (the row's phase-2 share, 98-101 s of 240, came down to it)
TRAIN_MIX_REPS = 5
# phase 27: reduced archs at the demo length, and at T = 1280 where
# attention turns blockwise (T > 1024) and the RG-LRU scan chunked
TRAIN_LONG = (("recurrentgemma-2b", 1280), ("minicpm-2b", 1280))
# phase 28: one stacked step with the inter-pod edge, 2 pods × 2 workers
# (step 0 of default_rng(0) is a ring round, draw 0.637)
POD_ARGV = ("--arch", ARCH, "--workers", "4", "--multipod", "--seq", "1024",
            "--global-batch", "4", "--steps", "1")
# phase 29: the sharded step on NCCL at world size 1 against the stacked one
SHARDED_SEQ, SHARDED_BATCH = 4096, 2
# the dry run's pair after phase 29, in a subprocess (the fake group cannot
# share a process with NCCL) and its time limit
DRYRUN_PAIR, DRYRUN_TIMEOUT = ("qwen3-8b", "train_4k"), 300
MIX_N, MIX_D = (1, 8, 63, 64, 100, 256), (1, 10, 511, 2560, 4097, 65536)
MIX_E = (1, 7, 32)
BATCHED_MAIN = (32, 64, 65536)             # E, N, D of gossip_mix_batched


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(2)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_FLUSH = []   # phase 2's L2 flush (256 MB), made once, dropped after it


def timings(fn, reps: int, plain, plain_reps: int, library=None,
            launches: int = 1) -> dict:
    """A kernel's figures per call: ``ms`` (CUDA events around back-to-back
    calls, the larger of the device time and the host's issue time),
    ``device_ms`` (the device time alone: the kernel's ``launches`` events
    in a profiled run of as many calls, each after an L2 flush, so that its
    operands come from device memory as ``bound_ms`` counts them),
    ``host_us`` (the host's issue time); the plain version's ``plain_ms``;
    and ``library_ms`` and ``library_device_ms`` (timed alike) of one
    PyTorch call of the same function, where there is one."""
    from repro_torch.profiling import device_ms, host_us, l2_flush, time_ms
    if not _FLUSH:
        _FLUSH.append(l2_flush("cuda"))
    flush = _FLUSH[0]
    parts = dict(ms=lambda: time_ms(fn, reps),
                 device_ms=lambda: device_ms(fn, reps, launches, flush),
                 host_us=lambda: host_us(fn, reps),
                 plain_ms=lambda: time_ms(plain, plain_reps))
    if library is not None:
        parts.update(library_ms=lambda: time_ms(library, reps),
                     library_device_ms=lambda: device_ms(library, reps,
                                                         flush=flush))
    row = dict(library_ms=None, library_device_ms=None, spent_s={})
    for k, part in parts.items():
        t0 = time.perf_counter()
        row[k] = part()
        row["spent_s"][k] = time.perf_counter() - t0
    return row


def bound_ms(nbytes: float, flops: float, dtype: str, peaks: dict = PEAK_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / peaks[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def close(out, ref, dtype: str, tols: dict = TOL) -> float:
    """Max |out − ref|; fails unless within the dtype's tolerance."""
    import torch
    o, r = out.to(torch.float32), ref.to(torch.float32)
    err = float((o - r).abs().max()) if o.numel() else 0.0
    tol = tols[dtype]
    if not torch.allclose(o, r, **tol):
        fail(f"kernel disagrees with its plain version: max abs err {err} "
             f"over tolerance {tol}")
    return err


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def lanes(gen, A: int, n: int, device, kind: str):
    """(A,) int32 workers and the (A, A) block mask of P_sub: distinct
    workers, worker 0 active, ~1/4 of the lanes padded with -1 at random
    positions (``pads``), none padded (``full``), all padded (``all_pad``),
    or ``merged`` as ``merge_event_groups`` packs a row of the main path:
    the valid lanes of cliques of 3-8 workers, one after another from lane
    0 while they fit, then -1 lanes, with a block-diagonal P_sub (one block
    per clique).  The mask is all ones but for ``merged``."""
    import torch
    block = torch.ones(A, A)
    if kind == "all_pad":
        return torch.full((A,), -1, dtype=torch.int32, device=device), block
    perm = torch.randperm(n - 1, generator=gen)[:A - 1] + 1
    w = torch.cat([torch.zeros(1, dtype=torch.int64), perm])
    if kind == "merged":
        clique = torch.full((A,), -1, dtype=torch.int64)
        o = c = 0
        while True:
            m = int(torch.randint(3, 9, (1,), generator=gen))
            if o + m > A:
                break
            clique[o:o + m] = c
            o, c = o + m, c + 1
        w[o:] = -1
        block = ((clique[:, None] == clique[None, :])
                 & (clique[:, None] >= 0)).float()
        return w.to(torch.int32).to(device), block
    w = w[torch.randperm(A, generator=gen)]
    if kind == "pads":
        pad = torch.randperm(A, generator=gen)[:max(1, A // 4)]
        keep0 = (w[pad] == 0)
        pad = pad[~keep0]           # worker 0 stays active
        w[pad] = -1
    return w.to(torch.int32).to(device), block


def check_kernels(device) -> dict:
    import torch
    from repro_torch.kernels.gossip_mix import ops as gossip_ops
    from repro_torch.kernels.sparse_gossip import ops as sparse_ops

    gen = torch.Generator().manual_seed(0)
    rows = []
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    def stochastic(n):
        P = torch.rand(n, n, generator=gen) + torch.eye(n)
        return (P / P.sum(1, keepdim=True)).to(device)

    for dname, dt in dts.items():
        # masked_gossip: the dense event update at N = 256
        N = N_MAIN
        P = stochastic(N)
        mask = (torch.rand(N, generator=gen) < 0.5).float().to(device) * 0.2
        for D in D_LEAVES:
            W = rnd(N, D, scale=0.1).to(dt)
            G = rnd(N, D, scale=0.5).to(dt)
            Pd = P.to(dt)
            Q = (mask.to(dt)[:, None] * Pd).contiguous()
            out = gossip_ops.masked_gossip_cuda(W, G, Pd, Q)
            ref = gossip_ops.masked_gossip_plain(W, G, Pd, Q)
            torch.cuda.synchronize()
            err = close(out, ref, dname)
            s = W.element_size()
            nbytes = 3 * N * D * s + 2 * N * N * s
            b, by = bound_ms(nbytes, 4.0 * N * N * D, dname, PRODUCT_FLOPS)
            rows.append(dict(
                kernel="masked_gossip", dtype=dname, N=N, A=None, D=D,
                max_abs_err=err, bound_ms=b, bound_by=by,
                **timings(
                    lambda: gossip_ops.masked_gossip_cuda(W, G, Pd, Q), REPS,
                    lambda: gossip_ops.masked_gossip_plain(W, G, Pd, Q), REPS,
                    lambda: Pd.T @ W - Q.T @ G, launches=2)))
        mine = {r["D"]: r for r in rows
                if r["kernel"] == "masked_gossip" and r["dtype"] == dname}
        per_event = {k: sum(mine[D][k] for D in NN_LEAVES)
                     for k in ("device_ms", "ms", "library_device_ms")}
        print(f"[2] masked_gossip {dname} per dense event (the 2-NN's six "
              f"leaves at N={N}): device {per_event['device_ms']:.4f} ms "
              f"(calls {per_event['ms']:.4f} ms); library device "
              f"{per_event['library_device_ms']:.4f} ms")
        if dname == "float32":
            # the tensor cores' float32 sums truncate: against the exact
            # product, the kernel must stay within the float32 bound where
            # an unnormalised P makes outputs of order 10
            g64 = torch.Generator().manual_seed(3)
            W, G = (torch.randn(N, 16384, generator=g64).to(device)
                    for _ in range(2))
            Pu = torch.rand(N, N, generator=g64).to(device)
            Qu = (torch.rand(N, N, generator=g64) * 0.1).to(device)
            exact = Pu.double().T @ W.double() - Qu.double().T @ G.double()
            e_k = float((gossip_ops.masked_gossip_cuda(W, G, Pu, Qu).double()
                         - exact).abs().max())
            e_p = float((gossip_ops.masked_gossip_plain(W, G, Pu, Qu).double()
                         - exact).abs().max())
            print(f"[2] masked_gossip float32 against float64, N={N}, D=16384, "
                  f"P uniform on [0, 1), Q on [0, 0.1): kernel {e_k:.3e}, "
                  f"plain (cuBLAS) {e_p:.3e}")
            require(e_k <= TOL["float32"]["atol"],
                    f"masked_gossip is {e_k} from the exact product")
            del W, G, Pu, Qu, exact
        if dname == "float32":
            # sparse_gossip at A = 256 runs masked_gossip's tensor-core sums
            # on gathered rows: the same float64 gate
            g64 = torch.Generator().manual_seed(4)
            n_carry, A, D = 2 * N, N, 16384
            W = torch.randn(n_carry, D, generator=g64).to(device)
            G = torch.randn(A, D, generator=g64).to(device)
            Pu = torch.rand(A, A, generator=g64).to(device)
            Qu = (torch.rand(A, A, generator=g64) * 0.1).to(device)
            gidx = torch.randperm(n_carry, generator=g64)[:A].to(device,
                                                               torch.int32)
            Wa = W.double().index_select(0, gidx.long())
            exact = Pu.double().T @ Wa - Qu.double().T @ G.double()
            e_k = float((sparse_ops.sparse_gossip_cuda(W, G, Pu, Qu, gidx)
                         .double() - exact).abs().max())
            e_p = float((sparse_ops.sparse_gossip_plain(W, G, Pu, Qu, gidx)
                         .double() - exact).abs().max())
            print(f"[2] sparse_gossip float32 against float64, A={A} gathered "
                  f"from N={n_carry}, D={D}, P uniform on [0, 1), Q on "
                  f"[0, 0.1): kernel {e_k:.3e}, plain (cuBLAS) {e_p:.3e}")
            require(e_k <= TOL["float32"]["atol"],
                    f"sparse_gossip is {e_k} from the exact product")
            del W, G, Pu, Qu, Wa, exact
        # sparse_gossip and scatter_rows at the bucket rungs
        for A in A_RUNGS:
            kinds = ("full", "pads", "all_pad") + (
                ("merged",) if A == MERGED_A else ())
            kernels_per_call = sparse_ops.sparse_gossip_kernels(A)
            for kind in kinds:
                w, block = lanes(gen, A, N, device, kind)
                valid = w >= 0
                vf = valid.float()
                Ps = (stochastic(A) * block.to(device) * vf[:, None]
                      * vf[None, :])
                ms_ = (torch.rand(A, generator=gen) < 0.7).float().to(device) * 0.2 * vf
                Ps_d = Ps.to(dt).contiguous()
                Qs = ((ms_ * vf).to(dt)[:, None] * Ps_d).contiguous()
                gidx = torch.where(valid, w, 0).to(torch.int32).contiguous()
                n_valid = int(valid.sum())
                pairs = int((Ps != 0).sum())     # (a, b) the data multiplies
                for D in D_LEAVES:
                    W = rnd(N, D, scale=0.1).to(dt)
                    G = rnd(A, D, scale=0.5).to(dt)
                    out = sparse_ops.sparse_gossip_cuda(W, G, Ps_d, Qs, gidx)
                    ref = sparse_ops.sparse_gossip_plain(W, G, Ps_d, Qs, gidx)
                    torch.cuda.synchronize()
                    err = close(out, ref, dname)
                    require(not out[~valid].to(torch.float32).any(),
                            "sparse_gossip: a padded lane's row is not zero")
                    Xk, Xp = W.clone(), W.clone()
                    sparse_ops.scatter_rows_cuda(Xk, out, w)
                    sparse_ops.scatter_rows_plain(Xp, out, w)
                    torch.cuda.synchronize()
                    err_s = close(Xk, Xp, dname)
                    require(bool(torch.equal(Xk, Xp)),
                            "scatter_rows: not an exact copy")
                    if kind == "all_pad":
                        require(bool(torch.equal(Xk, W)),
                                "scatter_rows: an all-pad row wrote the carry")
                    s = W.element_size()
                    b, by = bound_ms(3 * n_valid * D * s + 2 * A * A * s + 4 * A,
                                     4.0 * pairs * D, dname, PRODUCT_FLOPS)
                    wv = w[valid].long()
                    gv = out[valid]
                    row = dict(kernel="sparse_gossip", dtype=dname, N=N, A=A,
                               D=D, lanes=kind, valid=n_valid,
                               kernels=kernels_per_call, max_abs_err=err,
                               bound_ms=b, bound_by=by)
                    row_s = dict(kernel="scatter_rows", dtype=dname, N=N, A=A,
                                 D=D, lanes=kind, max_abs_err=err_s)
                    row_s["bound_ms"], row_s["bound_by"] = bound_ms(
                        2 * n_valid * D * s + 4 * A, 0.0, dname)
                    if kind == "full" or (kind in ("pads", "merged")
                                          and D == 65536):
                        row.update(timings(
                            lambda: sparse_ops.sparse_gossip_cuda(
                                W, G, Ps_d, Qs, gidx), REPS,
                            lambda: sparse_ops.sparse_gossip_plain(
                                W, G, Ps_d, Qs, gidx), REPS,
                            lambda: Ps_d.T @ W.index_select(0, gidx.long())
                            - Qs.T @ G, launches=kernels_per_call))
                        row_s.update(timings(
                            lambda: sparse_ops.scatter_rows_cuda(Xk, out, w), REPS,
                            lambda: sparse_ops.scatter_rows_plain(Xp, out, w), REPS,
                            lambda: Xp.index_copy_(0, wv, gv)))
                    rows += [row, row_s]
    return rows


def check_mix_kernels(device) -> list:
    """gossip_mix and gossip_mix_batched against their plain versions over
    ragged N, D and E, timed at the main shapes."""
    import torch
    from repro_torch.kernels.gossip_mix import ops as gossip_ops

    gen = torch.Generator().manual_seed(2)
    dgen = torch.Generator(device=device).manual_seed(2)   # W up to 2.1 GB
    rows = []
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def stochastic(*lead, n):
        P = torch.rand(*lead, n, n, generator=gen) + torch.eye(n)
        return P / P.sum(-1, keepdim=True)

    for dname, dt in dts.items():
        s = torch.empty((), dtype=dt).element_size()
        for N in MIX_N:
            P = stochastic(n=N).to(device, dt)
            # at N = 256 also the widths per_event launches, each timed
            widths = sorted(set(MIX_D) | (set(D_LEAVES) if N == N_MAIN else set()))
            for D in widths:
                W = torch.randn(N, D, generator=dgen, device=device).to(dt)
                out = gossip_ops.gossip_mix_cuda(W, P)
                ref = gossip_ops.gossip_mix_plain(W, P)
                torch.cuda.synchronize()
                row = dict(kernel="gossip_mix", dtype=dname, E=None, N=N, D=D,
                           max_abs_err=close(out, ref, dname))
                row["bound_ms"], row["bound_by"] = bound_ms(
                    (2 * N * D + N * N) * s, 2.0 * N * N * D, dname, PRODUCT_FLOPS)
                if N == N_MAIN and D in D_LEAVES:
                    row.update(timings(
                        lambda: gossip_ops.gossip_mix_cuda(W, P), REPS,
                        lambda: gossip_ops.gossip_mix_plain(W, P), 20,
                        lambda: torch.matmul(P.T, W), launches=2))
                rows.append(row)
                del W, out, ref
        if dname == "float32":
            # the tensor cores' float32 sums truncate: against the exact
            # product, the kernel must stay within the float32 bound where
            # unnormalised P makes outputs of order 10
            W = torch.randn(N_MAIN, 16384, generator=dgen, device=device)
            P = torch.rand(N_MAIN, N_MAIN, generator=gen).to(device)
            exact = P.double().T @ W.double()
            e_k = float((gossip_ops.gossip_mix_cuda(W, P).double() - exact).abs().max())
            e_p = float((gossip_ops.gossip_mix_plain(W, P).double() - exact).abs().max())
            print(f"[2] gossip_mix float32 against float64, N={N_MAIN}, D=16384, "
                  f"P uniform on [0, 1): kernel {e_k:.3e}, plain (cuBLAS) {e_p:.3e}")
            require(e_k <= TOL["float32"]["atol"],
                    f"gossip_mix is {e_k} from the exact product")
            del W, P, exact
        for E in MIX_E:
            for N in MIX_N:
                P = stochastic(E, n=N).to(device, dt)
                for D in MIX_D:
                    W = torch.randn(E, N, D, generator=dgen,
                                    device=device).to(dt)
                    out = gossip_ops.gossip_mix_batched_cuda(W, P)
                    ref = gossip_ops.gossip_mix_batched_plain(W, P)
                    torch.cuda.synchronize()
                    row = dict(kernel="gossip_mix_batched", dtype=dname, E=E,
                               N=N, D=D, max_abs_err=close(out, ref, dname))
                    row["bound_ms"], row["bound_by"] = bound_ms(
                        E * (2 * N * D + N * N) * s, 2.0 * E * N * N * D, dname,
                        PRODUCT_FLOPS)
                    if (E, N, D) == BATCHED_MAIN:
                        Pt = P.transpose(1, 2)
                        row.update(timings(
                            lambda: gossip_ops.gossip_mix_batched_cuda(W, P), REPS,
                            lambda: gossip_ops.gossip_mix_batched_plain(W, P), 20,
                            lambda: torch.bmm(Pt, W), launches=2))
                    rows.append(row)
                    del W, out, ref
    return rows


def train_mix_row(device) -> list:
    """gossip_mix at phase 26's shape: N = 4 workers of recurrentgemma-2b's
    embed leaf (D = 655,360,000), bf16, against its plain version; timed
    with cuBLAS's bf16 ``torch.matmul(P.T, W)`` beside it.  Run last in
    phase 2: its 5 GB operands and 40 ms calls stay out of the small
    kernels' profiled windows."""
    import torch
    from repro_torch.kernels.gossip_mix import ops as gossip_ops
    N, D = TRAIN_MIX
    t0 = time.perf_counter()
    W = torch.randn(N, D, generator=torch.Generator(device=device).manual_seed(26),
                    device=device, dtype=torch.bfloat16)
    P = torch.rand(N, N, generator=torch.Generator().manual_seed(26)) + torch.eye(N)
    P = (P / P.sum(-1, keepdim=True)).to(device, torch.bfloat16)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    out = gossip_ops.gossip_mix_cuda(W, P)
    ref = gossip_ops.gossip_mix_plain(W, P)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    row = dict(kernel="gossip_mix", dtype="bfloat16", E=None, N=N, D=D,
               train=True, max_abs_err=close(out, ref, "bfloat16"))
    del out, ref
    spent = dict(operands=t1 - t0, first_calls=t2 - t1,
                 compare=time.perf_counter() - t2)
    row["bound_ms"], row["bound_by"] = bound_ms(
        (2 * N * D + N * N) * 2, 2.0 * N * N * D, "bfloat16", PRODUCT_FLOPS)
    row.update(timings(lambda: gossip_ops.gossip_mix_cuda(W, P), TRAIN_MIX_REPS,
                       lambda: gossip_ops.gossip_mix_plain(W, P), 3,
                       lambda: torch.matmul(P.T, W), launches=2))
    row["spent_s"].update(spent)
    return [row]


def band_pairs(T: int, window: int) -> int:
    """Unmasked (query, key) pairs of causal attention with this window."""
    w = min(window, T)
    return w * (w + 1) // 2 + (T - w) * w


def check_sequence_kernels(device) -> list:
    """linear_scan and swa_attention against their plain versions: main
    shapes, ragged T and widths, decays 0 and 1, windows 1 to past T, MQA
    and plain heads, head widths 64 and 256."""
    import torch
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.kernels.swa_attention import ops as swa_ops

    gen = torch.Generator().manual_seed(1)
    rows = []
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    for dname, dt in dts.items():
        for B, T, W in [(1, 1, 100), (1, 1, 2560), (4, 100, 100),
                        (4, 100, 2560), (4, 4096, 100), SCAN_MAIN]:
            for kind in ("gate", "zero", "one"):
                shape = (B, T, W)
                a = {"gate": 0.36 + 0.64 * torch.rand(shape, generator=gen),
                     "zero": torch.zeros(shape),
                     "one": torch.ones(shape)}[kind].to(device, dt)
                x = torch.randn(shape, generator=gen)
                if kind == "one":
                    # a running sum: scaled to stay O(1), where the float32
                    # tolerance holds (a chunked and a sequential sum round
                    # apart by a few ulps of the partial sums)
                    x = x / math.sqrt(T)
                x = x.to(device, dt)
                out = scan_ops.linear_scan_cuda(a, x)
                ref = scan_ops.linear_scan_plain(a, x)
                torch.cuda.synchronize()
                row = dict(kernel="linear_scan", dtype=dname, B=B, T=T, W=W,
                           decay=kind, max_abs_err=close(out, ref, dname))
                n = B * T * W
                row["bound_ms"], row["bound_by"] = bound_ms(
                    3 * n * x.element_size(), 2.0 * n, dname)
                if (B, T, W) == SCAN_MAIN and kind == "gate":
                    row.update(timings(
                        lambda: scan_ops.linear_scan_cuda(a, x), REPS,
                        lambda: scan_ops.linear_scan_plain(a, x), 2))
                rows.append(row)
        for T in (1, 100, 4096):
            for window in (1, 64, 2048, T + 1):
                for groups in (1, 10):
                    for dh in (64, 128, 256):
                        rows.append(_swa_case(swa_ops, gen, device, dname, dt,
                                              1, T, groups, 1, dh, window))
        for T in SERVE_PADDED:
            for window in (1, 2048, T + 1):
                for dh in (128, 256):
                    rows.append(_swa_case(swa_ops, gen, device, dname, dt,
                                          1, T, 10, 1, dh, window))
        rows.append(_swa_case(swa_ops, gen, device, dname, dt, *SWA_MAIN,
                              timed=True))
    return rows


def _swa_case(swa_ops, gen, device, dname, dt, B, T, H, KV, dh, window,
              timed=False, per_sequence=False):
    """One swa_attention case; ``per_sequence`` runs the plain version one
    sequence of the batch at a time (its (H, T, T) float32 scores, 5.3 GB
    at llava's prefix wave, would take 21 GB for the whole batch at once,
    three times over)."""
    import torch
    import torch.nn.functional as F
    q = torch.randn(B * H, T, dh, generator=gen).to(device, dt)
    k = torch.randn(B * KV, T, dh, generator=gen).to(device, dt)
    v = torch.randn(B * KV, T, dh, generator=gen).to(device, dt)
    g = H // KV

    def plain():
        if not per_sequence:
            return swa_ops.swa_attention_plain(q, k, v, window=window, n_groups=g)
        return torch.cat([swa_ops.swa_attention_plain(
            q[b * H:(b + 1) * H], k[b * KV:(b + 1) * KV],
            v[b * KV:(b + 1) * KV], window=window, n_groups=g)
            for b in range(B)])

    out = swa_ops.swa_attention_cuda(q, k, v, window=window, n_groups=g)
    ref = plain()
    torch.cuda.synchronize()
    row = dict(kernel="swa_attention", dtype=dname, B=B, T=T, H=H, KV=KV,
               dh=dh, window=window, max_abs_err=close(out, ref, dname, SWA_TOL))
    s = q.element_size()
    row["bound_ms"], row["bound_by"] = bound_ms(
        (2 * q.numel() + 2 * k.numel()) * s,
        4.0 * B * H * band_pairs(T, window) * dh, dname)
    if timed:
        # the library call: SDPA with the band as its mask, or, with no
        # window (window >= T), SDPA's own causal mask
        pos = torch.arange(T, device=device)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        mask = dict(is_causal=True) if window >= T else dict(attn_mask=band)
        q4 = q.reshape(B, H, T, dh)
        k4 = k.reshape(B, KV, 1, T, dh).expand(B, KV, g, T, dh).reshape(B, H, T, dh)
        v4 = v.reshape(B, KV, 1, T, dh).expand(B, KV, g, T, dh).reshape(B, H, T, dh)
        row.update(timings(
            lambda: swa_ops.swa_attention_cuda(q, k, v, window=window,
                                               n_groups=g), 20,
            plain, 2,
            lambda: F.scaled_dot_product_attention(q4, k4, v4, **mask)))
    return row


def check_lm_kernels(device) -> list:
    """The dense LM paths' shapes: ``masked_gossip`` at N=8,
    ``sparse_gossip`` and ``scatter_rows`` at A=8 lanes of N=8 workers
    (all valid, and with padded lanes), each at the 100m preset's widest
    leaf in float32, timed; ``swa_attention`` at qwen3-8b's prefill, timed
    in bfloat16 against SDPA with the causal mask, held in float32 too."""
    import torch
    from repro_torch.kernels.gossip_mix import ops as gossip_ops
    from repro_torch.kernels.sparse_gossip import ops as sparse_ops
    from repro_torch.kernels.swa_attention import ops as swa_ops

    gen = torch.Generator().manual_seed(6)
    dgen = torch.Generator(device=device).manual_seed(6)
    N, D, s = LM_N, LM_LEAF_D, 4
    rows = []

    def stochastic(n):
        P = torch.rand(n, n, generator=gen) + torch.eye(n)
        return (P / P.sum(1, keepdim=True)).to(device)

    W = torch.randn(N, D, generator=dgen, device=device) * 0.1
    G = torch.randn(N, D, generator=dgen, device=device) * 0.5
    P = stochastic(N)
    mask = (torch.rand(N, generator=gen) < 0.5).float().to(device) * 0.3
    Q = (mask[:, None] * P).contiguous()
    err = close(gossip_ops.masked_gossip_cuda(W, G, P, Q),
                gossip_ops.masked_gossip_plain(W, G, P, Q), "float32")
    b, by = bound_ms(3 * N * D * s + 2 * N * N * s, 4.0 * N * N * D,
                     "float32", PRODUCT_FLOPS)
    rows.append(dict(
        kernel="masked_gossip", dtype="float32", N=N, A=None, D=D,
        max_abs_err=err, bound_ms=b, bound_by=by, lm=True,
        **timings(lambda: gossip_ops.masked_gossip_cuda(W, G, P, Q), REPS,
                  lambda: gossip_ops.masked_gossip_plain(W, G, P, Q), 20,
                  lambda: P.T @ W - Q.T @ G, launches=2)))
    del G
    for kind in ("full", "pads"):
        w = torch.randperm(N, generator=gen).to(torch.int32)
        if kind == "pads":
            w[torch.randperm(N, generator=gen)[:3]] = -1
        w = w.to(device)
        valid = w >= 0
        vf = valid.float()
        Ps = (stochastic(N) * vf[:, None] * vf[None, :]).contiguous()
        Qs = ((mask * vf)[:, None] * Ps).contiguous()
        gidx = torch.where(valid, w, 0).to(torch.int32).contiguous()
        Ga = torch.randn(N, D, generator=dgen, device=device) * 0.5
        out = sparse_ops.sparse_gossip_cuda(W, Ga, Ps, Qs, gidx)
        err = close(out, sparse_ops.sparse_gossip_plain(W, Ga, Ps, Qs, gidx),
                    "float32")
        Xk, Xp = W.clone(), W.clone()
        sparse_ops.scatter_rows_cuda(Xk, out, w)
        sparse_ops.scatter_rows_plain(Xp, out, w)
        torch.cuda.synchronize()
        require(bool(torch.equal(Xk, Xp)), "scatter_rows: not an exact copy")
        n_valid = int(valid.sum())
        pairs = int((Ps != 0).sum())
        row = dict(kernel="sparse_gossip", dtype="float32", N=N, A=N, D=D,
                   lanes=kind, valid=n_valid, max_abs_err=err, lm=True,
                   kernels=sparse_ops.sparse_gossip_kernels(N))
        row["bound_ms"], row["bound_by"] = bound_ms(
            3 * n_valid * D * s + 2 * N * N * s + 4 * N, 4.0 * pairs * D,
            "float32", PRODUCT_FLOPS)
        row_s = dict(kernel="scatter_rows", dtype="float32", N=N, A=N, D=D,
                     lanes=kind, max_abs_err=0.0, lm=True)
        row_s["bound_ms"], row_s["bound_by"] = bound_ms(
            2 * n_valid * D * s + 4 * N, 0.0, "float32")
        if kind == "full":
            wv, gv = w.long(), out
            row.update(timings(
                lambda: sparse_ops.sparse_gossip_cuda(W, Ga, Ps, Qs, gidx), REPS,
                lambda: sparse_ops.sparse_gossip_plain(W, Ga, Ps, Qs, gidx), 20,
                lambda: Ps.T @ W.index_select(0, gidx.long()) - Qs.T @ Ga,
                launches=row["kernels"]))
            row_s.update(timings(
                lambda: sparse_ops.scatter_rows_cuda(Xk, out, w), REPS,
                lambda: sparse_ops.scatter_rows_plain(Xp, out, w), 20,
                lambda: Xp.index_copy_(0, wv, gv)))
        rows += [row, row_s]
        del Ga, out, Xk, Xp
    del W
    torch.cuda.empty_cache()
    for dname, dt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        row = _swa_case(swa_ops, gen, device, dname, dt, *SWA_DENSE,
                        timed=dname == "bfloat16")
        row["lm"] = True
        rows.append(row)
        torch.cuda.empty_cache()
    for r in rows:
        print(f"[2] {r['kernel']} {r['dtype']} at the dense LM's shape "
              f"{ {k: r[k] for k in ('N', 'A', 'D', 'B', 'T', 'H', 'KV', 'dh', 'lanes') if k in r} }: "
              f"max abs err {r['max_abs_err']:.3e}" + (
                  f"; device {r['device_ms']:.4f} ms, call {r['ms']:.4f} ms, "
                  f"plain {r['plain_ms']:.4f} ms, library device "
                  f"{r['library_device_ms']:.4f} / call {r['library_ms']:.4f} "
                  f"ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                  if "ms" in r else ""))
    return rows


def check_prefill_kernels(device) -> list:
    """``swa_attention`` at the serve phases' prefill shapes, bf16, no
    window, B=4: each attention arch of phases 19-20 and 23-24 at both of
    phase 6's padded lengths, and the audio and vlm archs also behind their
    stub prefix (T = 3561 + 256 and 3561 + 2880).  The rows at T = 3561 and
    the prefixed ones are timed against SDPA with its own causal mask; the
    prefixed ones run the plain version one sequence at a time.  Each row
    carries its arch and prefix."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.swa_attention import ops as swa_ops

    gen = torch.Generator().manual_seed(19)
    T0 = max(SERVE_PADDED)
    rows = []
    for arch in [a for a, _, _ in MOE_SERVE] + [a for a, _ in MM_SERVE]:
        cfg = get_config(arch)
        if cfg.is_attention_free:
            continue
        H, KV, dh, P = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.n_prefix_tokens
        for T, prefix in [(T, 0) for T in SERVE_PADDED] + ([(T0 + P, P)] if P else []):
            row = _swa_case(swa_ops, gen, device, "bfloat16", torch.bfloat16,
                            4, T, H, KV, dh, T, timed=T >= T0,
                            per_sequence=prefix > 0)
            row.update(arch=arch, prefix=prefix)
            rows.append(row)
            torch.cuda.empty_cache()
            print(f"[2] swa_attention bfloat16 at {arch}'s prefill (B=4, T={T}"
                  f"{f' = {T0} + {prefix} prefix' if prefix else ''}, H={H}, "
                  f"KV={KV}, dh={dh}, no window): max abs err "
                  f"{row['max_abs_err']:.3e}" + (
                      f"; device {row['device_ms']:.4f} ms, call "
                      f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                      f"SDPA is_causal device {row['library_device_ms']:.4f} "
                      f"/ call {row['library_ms']:.4f} ms, bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
                      if "ms" in row else ""))
    return rows


# ---------------------------------------------------------------------------
# phases 3-5: the trainer
# ---------------------------------------------------------------------------

def paper_spec(**kw):
    """The paper_figures preset's settings for one cell (N=256)."""
    from repro_torch.xp import ExperimentSpec
    base = dict(name="paper_figures",
                algorithms=("dsgd_aau", "ad_psgd", "prague", "agp"),
                reference="dsgd_sync", scenarios=("paper_default",),
                scales=(N_MAIN,), seeds=(0,), mode="sparse_scan",
                max_time=30.0, ref_max_time=400.0, ref_max_events=160,
                eval_every=10, ref_eval_every=2, target_loss=0.9)
    base.update(kw)
    return ExperimentSpec(**base)


def _counted() -> dict:
    from repro_torch.kernels.gossip_mix import ops as gossip_ops
    from repro_torch.kernels.linear_scan import ops as scan_ops
    from repro_torch.kernels.sparse_gossip import ops as sparse_ops
    from repro_torch.kernels.swa_attention import ops as swa_ops
    return {"masked_gossip": gossip_ops.masked_gossip_cuda,
            "gossip_mix": gossip_ops.gossip_mix_cuda,
            "gossip_mix_batched": gossip_ops.gossip_mix_batched_cuda,
            "sparse_gossip": sparse_ops.sparse_gossip_cuda,
            "scatter_rows": sparse_ops.scatter_rows_cuda,
            "linear_scan": scan_ops.linear_scan_cuda,
            "swa_attention": swa_ops.swa_attention_cuda}


def reset_counts():
    for fn in _counted().values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


def drive(trainer, max_events: int, eval_every: int, active_sets=None):
    """Set up, then run once with the launch counters (and ``active_sets``,
    where given) zeroed just before; returns (result, set-up s, run wall s,
    launch counts of the run)."""
    import torch
    t0 = time.perf_counter()
    trainer.warmup(max_events=max_events)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    reset_counts()
    if active_sets is not None:
        active_sets.clear()
    t0 = time.perf_counter()
    res = trainer.run(max_events=max_events, eval_every=eval_every)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    return res, setup, wall, counts


class ActiveSets:
    """The (A, valid lanes) of every active-set row the trainer dispatches,
    and the size of every clique in them, read from the host's
    ``SparseEventBatch`` as ``_dispatch_sparse_block`` receives it (each
    row launches ``sparse_gossip`` once per leaf; a merged row's cliques
    are its lanes grouped by source event).  Installed around one run; the
    hook reads host arrays only, so it adds no device work or sync."""

    def __init__(self):
        from collections import Counter
        self.rows, self.cliques = Counter(), Counter()

    def __enter__(self):
        import numpy as np
        from repro_torch.core.runner import DecentralizedTrainer
        self._cls = DecentralizedTrainer
        self._orig = orig = DecentralizedTrainer._dispatch_sparse_block
        rows, cliques = self.rows, self.cliques

        def recorded(tr, batch, rounds, lane_off=None, lane_ts=None):
            w = np.asarray(batch.workers)
            for e in range(w.shape[0]):
                valid = w[e] >= 0
                n = int(valid.sum())
                if n == 0:
                    continue           # a no-op row: skipped, no launch
                rows[(int(w.shape[1]), n)] += 1
                if lane_off is None:
                    cliques[n] += 1
                else:
                    _, sizes = np.unique(np.asarray(lane_off)[e][valid],
                                         return_counts=True)
                    for m in sizes:
                        cliques[int(m)] += 1
            return orig(tr, batch, rounds, lane_off, lane_ts)

        DecentralizedTrainer._dispatch_sparse_block = recorded
        return self

    def __exit__(self, *exc):
        self._cls._dispatch_sparse_block = self._orig
        return False

    def clear(self):
        self.rows.clear()
        self.cliques.clear()

    def median_clique(self) -> float:
        import numpy as np
        sizes = np.repeat(list(self.cliques), list(self.cliques.values()))
        return float(np.median(sizes)) if len(sizes) else float("nan")


def check_history(res, what: str):
    import math
    for p in res.history:
        require(math.isfinite(p.loss) and math.isfinite(p.metric),
                f"{what}: non-finite eval {p}")


# ---------------------------------------------------------------------------
# phases 6-7: the serve path
# ---------------------------------------------------------------------------

def serve_requests(vocab: int):
    """8 requests, prompt lengths drawn from 512-4096 by
    ``default_rng(0)``; the longest are dealt to alternate waves, so each
    wave's padded length passes the 2048 window."""
    import numpy as np
    from repro_torch.launch.serve import Request
    rng = np.random.default_rng(0)
    lens = rng.integers(512, 4097, size=SERVE_REQUESTS)
    reqs = [Request(rid=i, prompt=rng.integers(0, vocab, size=n).astype(np.int32),
                    max_new=SERVE_NEW) for i, n in enumerate(lens)]
    order = np.argsort(-lens, kind="stable")
    n_waves = SERVE_REQUESTS // SERVE_SLOTS
    return [[reqs[i] for i in order[w::n_waves]] for w in range(n_waves)]


def serve_full_width(device, build_s: float, arch: str = ARCH,
                     tag: str = "6", layers: int = None) -> dict:
    """Phase 6 (RecurrentGemma-2B), 16 (qwen3-8b), 19 (grok-1-314b), 20
    (arctic-480b), 22 (rwkv6-1.6b), 23 (musicgen-large) or 24
    (llava-next-mistral-7b): ``arch`` at its published widths behind
    BatchedServer, its depth cut to ``layers`` where given; each prefill
    launches ``linear_scan`` once per recurrent layer, ``swa_attention``
    once per attention layer and no other kernel (rwkv6: none).  An ssm
    model's decode state must hold no more bytes than the empty one; an
    audio or vlm model then serves one wave behind its stub prefix
    (``prefix_wave``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.transformer import (block_pattern, decode_step,
                                                init_decode_state, init_model,
                                                prefill)

    cfg = get_config(arch)
    published = cfg.n_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
        print(f"[{tag}] {arch}: depth cut from {published} to {layers} layers "
              f"(published widths kept: d {cfg.d_model}, {cfg.n_heads} heads / "
              f"{cfg.n_kv_heads} KV, d_ff {cfg.d_ff}, {cfg.n_experts} experts "
              f"top-{cfg.top_k}, dense residual {cfg.dense_residual_ff}, "
              f"vocab {cfg.vocab_size})")
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device=device).manual_seed(0), device)
    n_params = sum(p.numel() for p in model.parameters())
    waves = serve_requests(cfg.vocab_size)
    cache_len = max(len(r.prompt) for w in waves for r in w) + SERVE_NEW
    server = BatchedServer(cfg, model, SERVE_SLOTS, cache_len)
    # warm-up wave (first cuBLAS and allocator use), counted as set-up
    server.run([Request(rid=-1, prompt=waves[0][0].prompt[:256], max_new=2)])
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    print(f"[{tag}] {arch}: {n_params:,} parameters in {cfg.param_dtype}; set-up "
          f"{build_s + setup:.2f} s (build {build_s:.2f}, init and warm-up "
          f"{setup:.2f}); cache_len {cache_len}")
    launches = {"linear_scan": 0, "swa_attention": 0}
    n_rec = block_pattern(cfg).count("rec")
    n_attn = block_pattern(cfg).count("attn")
    peaks = []
    for w, wave in enumerate(waves):
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        server.run(wave)
        counts = read_counts()
        peaks.append(torch.cuda.max_memory_allocated(device))
        st = server.stats[-1]
        print(f"[{tag}] wave {w}: batch {st.batch}, prompts "
              f"{[len(r.prompt) for r in wave]} padded to {st.padded_len}")
        print(f"[{tag}] wave {w}: time to first token {st.first_token_s:.4f} s")
        print(f"[{tag}] wave {w}: prefill {st.prompt_tokens / st.first_token_s:.1f} "
              f"prompt tok/s ({st.batch * st.padded_len / st.first_token_s:.1f} "
              f"with padding)")
        print(f"[{tag}] wave {w}: decode {st.batch * st.decode_steps / st.decode_s:.1f} "
              f"tok/s ({st.decode_steps} steps in {st.decode_s:.4f} s)")
        print(f"[{tag}] wave {w}: launches {counts}")
        print(f"[{tag}] wave {w}: max_memory_allocated {peaks[-1] / 2**30:.2f} GiB")
        require(cfg.attn_window is None or st.padded_len > cfg.attn_window,
                f"wave {w} is not longer than the window")
        expected = dict.fromkeys(counts, 0)
        expected.update(linear_scan=n_rec, swa_attention=n_attn)
        require(counts == expected,
                f"wave {w} launched {counts}, not {n_rec} linear_scan, "
                f"{n_attn} swa_attention and no other kernel")
        for k in launches:
            launches[k] += counts[k]
    peak = max(peaks)
    reqs = [r for w in waves for r in w]
    n_out = sum(len(r.out) for r in reqs)
    print(f"[{tag}] {n_out} tokens for {len(reqs)} requests")
    print(f"[{tag}] max_memory_allocated {peak / 2**30:.2f} GiB")
    require(n_out == SERVE_REQUESTS * SERVE_NEW and all(
        len(r.out) == SERVE_NEW and r.done for r in reqs), "tokens missing")
    # the first wave again through the model's entry points: finite logits
    # and the server's first two greedy tokens
    wave = waves[0]
    T = max(len(r.prompt) for r in wave)
    toks = torch.zeros((len(wave), T), dtype=torch.int64)
    for j, r in enumerate(wave):
        toks[j, T - len(r.prompt):] = torch.from_numpy(r.prompt)
    logits, state = prefill(model, cfg, toks.to(device), cache_len)
    cur = logits.argmax(-1)
    logits2, state = decode_step(model, cfg, cur, state, T)
    require(bool(torch.isfinite(logits).all() and torch.isfinite(logits2).all()),
            "non-finite logits")
    require(cur.tolist() == [r.out[0] for r in wave]
            and logits2.argmax(-1).tolist() == [r.out[1] for r in wave],
            "prefill/decode_step disagree with the server's tokens")
    state_bytes = None
    if cfg.family == "ssm":
        def storage_bytes(st):
            return sum(t.untyped_storage().nbytes() for s in st for t in s)
        state_bytes = storage_bytes(state)
        empty = storage_bytes(init_decode_state(cfg, len(wave), cache_len, device))
        print(f"[{tag}] decode state after a {T}-token prefill and a step: {state_bytes:,} "
              f"bytes; the empty state's: {empty:,}")
        require(state_bytes == empty,
                "the ssm decode state grows with the prompt")
    del state, logits, logits2   # before the prefix wave's peak memory
    ttft = [s.first_token_s for s in server.stats[1:]]
    prefixed = prefix_wave(device, cfg, model, waves[0], tag) if cfg.frontend else None
    return dict(launches=launches, peak_bytes=peak, ttft=ttft,
                state_bytes=state_bytes, prefixed=prefixed,
                n_params=n_params, n_layers=cfg.n_layers,
                published_layers=published, wave_peaks=peaks,
                prefill_tok_s=sum(s.prompt_tokens for s in server.stats[1:]) / sum(ttft),
                decode_tok_s=sum(s.batch * s.decode_steps for s in server.stats[1:])
                / sum(s.decode_s for s in server.stats[1:]))


def prefix_wave(device, cfg, model, first_wave, tag: str) -> dict:
    """Phases 23-24: the prompts of phase 6's first wave behind the
    config's stub-frontend prefix (``make_stub_prefix``: 256 frames for
    musicgen-large, anyres 2880 patches for llava-next), prefilled through
    ``prefill(..., prefix_embeds=)`` and decoded for SERVE_NEW tokens;
    counters zeroed before and read after (``swa_attention`` once per layer
    in the prefill, nothing in decode); finite logits one step further."""
    import torch
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.multimodal import anyres_tile_count, make_stub_prefix
    from repro_torch.models.transformer import decode_step

    P = cfg.n_prefix_tokens
    if cfg.frontend == "vision":
        require(anyres_tile_count((672, 672)) == P, "llava's prefix is not anyres 2880")
    wave = [Request(rid=r.rid, prompt=r.prompt, max_new=SERVE_NEW)
            for r in first_wave]
    T = max(len(r.prompt) for r in wave)
    prefix = make_stub_prefix(torch.Generator(device=device).manual_seed(1),
                              cfg, len(wave), device)
    server = BatchedServer(cfg, model, SERVE_SLOTS, P + T + SERVE_NEW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    cur, host, state, pos = server.prefill_wave(wave, prefix)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    steps = server.decode_wave(wave, cur, host, state, pos)
    decode_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    expected = dict.fromkeys(counts, 0)
    expected["swa_attention"] = cfg.n_layers
    require(counts == expected, f"the prefix wave launched {counts}, not "
            f"{cfg.n_layers} swa_attention and no other kernel")
    require(pos == P + T, f"decode starts at {pos}, not P + T = {P + T}")
    require(all(len(r.out) == SERVE_NEW and all(0 <= t < cfg.vocab_size
                                                 for t in r.out) for r in wave),
            "prefix wave: tokens missing or out of the vocabulary")
    last = torch.tensor([r.out[-1] for r in wave], device=device)
    logits, _ = decode_step(model, cfg, last, state, pos + steps)
    require(bool(torch.isfinite(logits).all()), "prefix wave: non-finite logits")
    differs = sum(r.out != q.out for r, q in zip(wave, first_wave))
    rate = len(wave) * steps / decode_s
    print(f"[{tag}] prefix wave: {len(wave)} prompts {[len(r.prompt) for r in wave]} "
          f"behind {P} stub-frontend embeddings, prefill length {P + T}")
    print(f"[{tag}] prefix wave: time to first token {first:.4f} s; decode "
          f"{rate:.1f} tok/s ({steps} steps in {decode_s:.4f} s); launches "
          f"{counts}; max_memory_allocated {peak / 2**30:.2f} GiB; "
          f"{differs} of {len(wave)} requests' tokens differ from the "
          f"unprefixed wave's")
    return dict(first_token_s=first, decode_tok_s=rate, peak_bytes=peak,
                launches=counts["swa_attention"], length=P + T)


def serve_card_vs_cpu(device) -> None:
    """Phase 7: the reduced RecurrentGemma (float32) on the card and on the
    CPU from the same weights: logits of every step within 1e-4 and the
    same greedy tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.transformer import decode_step, init_model, prefill

    cfg = get_config(ARCH).reduced()
    cpu = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    card = init_model(cfg, None, device=device)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in rng.integers(65, 201, size=6)]
    T = max(len(p) for p in prompts[:4])
    toks = torch.zeros((4, T), dtype=torch.int64)
    for j, p in enumerate(prompts[:4]):
        toks[j, T - len(p):] = torch.from_numpy(p)
    lg, sg = prefill(card, cfg, toks.to(device), T + 16)
    lc, sc = prefill(cpu, cfg, toks, T + 16)
    err = float((lg.cpu() - lc).abs().max())
    for i in range(15):
        tok = lc.argmax(-1)
        require(torch.equal(lg.argmax(-1).cpu(), tok), f"step {i}: tokens differ")
        lg, sg = decode_step(card, cfg, tok.to(device), sg, T + i)
        lc, sc = decode_step(cpu, cfg, tok, sc, T + i)
        err = max(err, float((lg.cpu() - lc).abs().max()))
    outs = []
    for model in (card, cpu):
        reqs = [Request(rid=i, prompt=p, max_new=16) for i, p in enumerate(prompts)]
        BatchedServer(cfg, model, 4, 216).run(reqs)
        outs.append([r.out for r in reqs])
    print(f"[7] {cfg.name} card vs CPU: prompts {[len(p) for p in prompts]} "
          f"(window {cfg.attn_window}); max |logits| err over prefill and 15 "
          f"decode steps {err:.3e}; server tokens identical: {outs[0] == outs[1]}")
    require(err <= 1e-4, f"card and CPU logits disagree by {err}")
    require(outs[0] == outs[1], "card and CPU greedy tokens differ")


def moe_card_vs_cpu(device) -> None:
    """Phase 21: reduced grok-1 and arctic (float32) on the card and on the
    CPU from the same weights -- as reduced (one dispatch group), grok-1
    with two dispatch groups (every prefill's N = 4·T divides), and arctic
    with a capacity factor of 0.25 (each expert holds a quarter of the
    pairs routed to it on average, so most are dropped): prefill and 15
    decode steps with logits within 1e-4 and the same greedy tokens, the
    server's tokens identical, ``lm_loss`` and its router gradient within
    1e-4."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.transformer import (decode_step, flat_params,
                                                init_model, lm_loss, prefill)

    cases = [(get_config(a).reduced(), over) for a, over in (
        ("grok-1-314b", {}), ("grok-1-314b", dict(moe_groups=2)),
        ("arctic-480b", {}), ("arctic-480b", dict(moe_capacity_factor=0.25)))]
    for cfg, over in cases:
        cfg = dataclasses.replace(cfg, **over)
        cpu = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
        card = init_model(cfg, None, device=device)
        card.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in rng.integers(40, 121, size=6)]
        T = max(len(p) for p in prompts[:4])
        toks = torch.zeros((4, T), dtype=torch.int64)
        for j, p in enumerate(prompts[:4]):
            toks[j, T - len(p):] = torch.from_numpy(p)
        lg, sg = prefill(card, cfg, toks.to(device), T + 16)
        lc, sc = prefill(cpu, cfg, toks, T + 16)
        err = float((lg.cpu() - lc).abs().max())
        for i in range(15):
            tok = lc.argmax(-1)
            require(torch.equal(lg.argmax(-1).cpu(), tok),
                    f"{cfg.name} {over}: step {i}: tokens differ")
            lg, sg = decode_step(card, cfg, tok.to(device), sg, T + i)
            lc, sc = decode_step(cpu, cfg, tok, sc, T + i)
            err = max(err, float((lg.cpu() - lc).abs().max()))
        outs = []
        for model in (card, cpu):
            reqs = [Request(rid=i, prompt=p, max_new=8)
                    for i, p in enumerate(prompts)]
            BatchedServer(cfg, model, 4, 136).run(reqs)
            outs.append([r.out for r in reqs])
        losses, grads = [], []
        for model, dev in ((card, device), (cpu, torch.device("cpu"))):
            batch = {"tokens": toks[:, :64].to(dev)}
            flat = flat_params(model)
            losses.append(float(lm_loss(flat, cfg, batch)))
            grads.append(torch.func.grad(lambda r: lm_loss(
                dict(flat, **{"layers.ffn.router": r}), cfg, batch))(
                    flat["layers.ffn.router"]).cpu())
        gerr = float((grads[0] - grads[1]).abs().max())
        print(f"[21] {cfg.name} {over or '(as reduced)'} card vs CPU: prompts "
              f"{[len(p) for p in prompts]}; max |logits| err over prefill "
              f"and 15 decode steps {err:.3e}; server tokens identical: "
              f"{outs[0] == outs[1]}; lm_loss {losses[0]:.6f} / "
              f"{losses[1]:.6f}, router gradient err {gerr:.3e}")
        require(err <= 1e-4, f"{cfg.name} {over}: logits disagree by {err}")
        require(outs[0] == outs[1], f"{cfg.name} {over}: greedy tokens differ")
        require(abs(losses[0] - losses[1]) <= 1e-4 and gerr <= 1e-4,
                f"{cfg.name} {over}: lm_loss or its gradient disagree")


def mm_card_vs_cpu(device) -> None:
    """Phase 25: reduced rwkv6, musicgen and llava (float32) on the card and
    on the CPU from the same weights: prefill of a ragged T (64-200 tokens,
    behind an 8-embedding stub prefix for musicgen and llava) and 15
    decode steps with logits within 1e-4 and the same greedy tokens, the
    server's tokens identical, ``lm_loss`` (with the prefix) within 1e-4,
    and for rwkv6 the gradient of ``lm_loss`` at T = 100 (64 + 36) within
    1e-4; ``swa_attention`` once per layer in an audio / vlm prefill, never
    for rwkv6."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.transformer import (decode_step, flat_params,
                                                init_model, lm_loss, prefill)

    for arch, _ in MM_SERVE:
        cfg = get_config(arch).reduced()
        cpu = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
        card = init_model(cfg, None, device=device)
        card.load_state_dict(cpu.state_dict())
        rng = np.random.default_rng(3)
        prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                   for n in rng.integers(64, 201, size=6)]
        T = max(len(p) for p in prompts[:4])
        toks = torch.zeros((4, T), dtype=torch.int64)
        for j, p in enumerate(prompts[:4]):
            toks[j, T - len(p):] = torch.from_numpy(p)
        P = cfg.n_prefix_tokens
        pre = (torch.from_numpy(rng.normal(size=(4, P, cfg.d_model)) * 0.02).float()
               if P else None)
        to_card = (lambda t: None if t is None else t.to(device))
        reset_counts()
        lg, sg = prefill(card, cfg, toks.to(device), P + T + 16, to_card(pre))
        counts = read_counts()
        expected = dict.fromkeys(counts, 0)
        expected["swa_attention"] = 0 if cfg.family == "ssm" else cfg.n_layers
        require(counts == expected, f"{cfg.name}: the prefill launched {counts}")
        lc, sc = prefill(cpu, cfg, toks, P + T + 16, pre)
        err = float((lg.cpu() - lc).abs().max())
        for i in range(15):
            tok = lc.argmax(-1)
            require(torch.equal(lg.argmax(-1).cpu(), tok),
                    f"{cfg.name}: step {i}: tokens differ")
            lg, sg = decode_step(card, cfg, tok.to(device), sg, P + T + i)
            lc, sc = decode_step(cpu, cfg, tok, sc, P + T + i)
            err = max(err, float((lg.cpu() - lc).abs().max()))
        outs = []
        for model in (card, cpu):
            reqs = [Request(rid=i, prompt=p, max_new=8)
                    for i, p in enumerate(prompts)]
            BatchedServer(cfg, model, 4, 216).run(reqs)
            outs.append([r.out for r in reqs])
        losses, grads = [], []
        for model, dev in ((card, device), (cpu, torch.device("cpu"))):
            batch = {"tokens": toks[:, :100].to(dev), "prefix": (
                None if pre is None else pre.to(dev))}
            losses.append(float(lm_loss(model, cfg, batch)))
            if cfg.family == "ssm":
                grads.append(torch.func.grad(lambda p: lm_loss(p, cfg, batch))(
                    flat_params(model)))
        gerr = max((float((grads[0][k].cpu() - grads[1][k]).abs().max())
                    for k in grads[1]), default=0.0) if grads else None
        print(f"[25] {cfg.name} card vs CPU: prompts {[len(p) for p in prompts]}"
              f"{f' behind a {P}-embedding prefix' if P else ''}; max |logits| "
              f"err over prefill and 15 decode steps {err:.3e}; server tokens "
              f"identical: {outs[0] == outs[1]}; lm_loss {losses[0]:.6f} / "
              f"{losses[1]:.6f}" + (f"; gradient err {gerr:.3e} over "
                                   f"{len(grads[1])} leaves" if grads else ""))
        require(err <= 1e-4, f"{cfg.name}: logits disagree by {err}")
        require(outs[0] == outs[1], f"{cfg.name}: greedy tokens differ")
        require(abs(losses[0] - losses[1]) <= 1e-4,
                f"{cfg.name}: lm_loss disagrees")
        require(gerr is None or gerr <= 1e-4, f"{cfg.name}: gradients disagree")


# ---------------------------------------------------------------------------
# phases 9-12: the per-event and fused modes, and the batched mix
# ---------------------------------------------------------------------------

def state_err(a, b) -> float:
    """Max |a − b| over two trainers' W, S and y (any devices)."""
    err = 0.0
    for x, y in [(a.W[k], b.W[k]) for k in a.W] + \
                [(a.S[k], b.S[k]) for k in a.S] + [(a.y, b.y)]:
        err = max(err, float((x.cpu().float() - y.cpu().float()).abs().max()))
    return err


def same_counters(ra, rb) -> bool:
    """Event counts, virtual times and copies identical, history and totals."""
    return (len(ra.history) == len(rb.history) and all(
        (p.k, p.time, p.comm_param_copies) == (q.k, q.time, q.comm_param_copies)
        for p, q in zip(ra.history, rb.history))
        and (ra.total_events, ra.total_time, ra.total_comm_copies)
        == (rb.total_events, rb.total_time, rb.total_comm_copies))


def per_event_paths(device) -> dict:
    """Phases 9 and 10: per_event at N=256, then per_event against the
    dense scan on the card and against itself on the CPU at N=64."""
    import torch
    from repro_torch.xp import build_trainer, mlp2nn_init

    tr = build_trainer(paper_spec(mode="per_event"), "dsgd_aau", N_MAIN, 0,
                       device=device)
    require(tr.mode == "per_event", f"per_event path took mode {tr.mode}")
    res, setup, wall, counts = drive(tr, 256, 64)
    check_history(res, "per_event dsgd_aau N=256")
    eps = res.total_events / wall
    print(f"[9] dsgd_aau N={N_MAIN} per_event: {res.total_events} events in "
          f"{wall:.3f} s = {eps:.1f} events/s (set-up {setup:.2f} s); "
          f"launches {counts}; loss {res.history[0].loss:.4f} -> "
          f"{res.history[-1].loss:.4f}")
    require(counts["gossip_mix"] > 0 and counts["masked_gossip"] == 0,
            f"per_event must launch gossip_mix and no masked_gossip: {counts}")
    require(res.history[-1].loss < res.history[0].loss,
            "the loss did not fall on the per_event path")

    w0 = mlp2nn_init()(torch.Generator().manual_seed(0))
    runs = {}
    for what, dev, mode in (
            ("per_event on the card", device, "per_event"),
            ("scan on the card", device, "scan"),
            ("per_event on the CPU", torch.device("cpu"), "per_event")):
        t = build_trainer(paper_spec(scales=(64,), mode=mode), "dsgd_aau", 64,
                          0, device=dev, batch_pool=128,
                          init_params={k: v.to(dev) for k, v in w0.items()})
        runs[what] = (t, t.run(max_events=128, eval_every=32))
    tp, rp = runs["per_event on the card"]
    for what in ("scan on the card", "per_event on the CPU"):
        t, r = runs[what]
        err = state_err(tp, t)
        loss_err = max(abs(p.loss - q.loss) for p, q in zip(rp.history, r.history))
        print(f"[10] dsgd_aau N=64, 128 events: per_event on the card vs {what}: "
              f"max |W,S,y| err {err:.3e}, max loss err {loss_err:.3e}")
        require(err <= 1e-4 and loss_err <= 1e-4,
                f"per_event and {what} disagree: {err}, {loss_err}")
        require(same_counters(rp, r), f"per_event and {what}: counters differ")
    require(int(runs["scan on the card"][0]._ptr.max()) <= 128,
            "the scan's pool wrapped")
    return dict(eps=eps, launches=counts, trainer64=tp)


def fused_paths(device) -> dict:
    """Phase 11: fused AD-PSGD and AGP at N=256, then fused on the card
    against fused on the CPU at N=16."""
    import torch
    from repro_torch.xp import build_trainer, mlp2nn_init

    out = {}
    spec = paper_spec(mode="fused", max_time=None, max_events=1024,
                      block_size=32)
    for alg in ("ad_psgd", "agp"):
        tr = build_trainer(spec, alg, N_MAIN, 0, batch_pool=64, device=device)
        require(tr.mode == "fused", f"fused path took mode {tr.mode}")
        require(all(len(nb) for nb in tr.scheduler.graph.neighbor_lists),
                "the N=256 graph has an isolated worker")
        copies = int(tr.scheduler.fused_spec()["copies_pair"])
        res, setup, wall, counts = drive(tr, 1024, 256)
        check_history(res, f"fused {alg} N=256")
        eps = res.total_events / wall
        ptr_sum = int(tr._ptr.sum())
        print(f"[11] {alg} N={N_MAIN} fused: {res.total_events} events in "
              f"{wall:.3f} s = {eps:.1f} events/s (set-up {setup:.2f} s); "
              f"launches {counts}; comm {res.total_comm_copies} "
              f"(= {copies} x events: {res.total_comm_copies == 1024 * copies}); "
              f"ptr sum {ptr_sum}; loss {res.history[0].loss:.4f} -> "
              f"{res.history[-1].loss:.4f}")
        require(counts["sparse_gossip"] > 0 and counts["scatter_rows"] > 0,
                f"fused {alg} launched no active-set kernel: {counts}")
        require(res.total_comm_copies == 1024 * copies and ptr_sum == 1024,
                f"fused {alg}: event accounting is off")
        require(res.history[-1].loss < res.history[0].loss,
                f"the loss did not fall on fused {alg}")
        out[alg] = dict(eps=eps, launches=counts)

    w0 = mlp2nn_init()(torch.Generator().manual_seed(0))
    spec16 = paper_spec(scales=(16,), mode="fused", max_time=None,
                        max_events=96, block_size=16)
    for alg in ("ad_psgd", "agp"):
        runs = []
        for dev in (device, torch.device("cpu")):
            t = build_trainer(spec16, alg, 16, 0, device=dev, batch_pool=96,
                              init_params={k: v.to(dev) for k, v in w0.items()})
            runs.append((t, t.run(max_events=96, eval_every=24)))
        (tg, rg), (tc, rc) = runs
        err = state_err(tg, tc)
        print(f"[11] {alg} N=16 fused card vs CPU, 96 events: max |W,S,y| err "
              f"{err:.3e}; total_time {rg.total_time} / {rc.total_time}, comm "
              f"{rg.total_comm_copies} / {rc.total_comm_copies}")
        require(err <= 1e-4, f"fused {alg}: card and CPU state disagree by {err}")
        require(same_counters(rg, rc), f"fused {alg}: card and CPU counters differ")
        require(bool(torch.equal(tg._ptr.cpu(), tc._ptr)), f"fused {alg}: ptr differs")
    return out


def batched_on_events(device, trainer) -> dict:
    """Phase 12: the (E, N, N) consensus matrices of a real DSGD-AAU
    EventBatch at N=64 through gossip_mix_batched on E copies of each
    trainer leaf, held against gossip_mix_dense one event at a time."""
    import itertools

    import torch
    from repro_torch.core.aau import gossip_mix_dense
    from repro_torch.core.scheduler import EventBatch
    from repro_torch.kernels.gossip_mix.ops import gossip_mix_batched
    from repro_torch.xp import build_trainer

    sched = build_trainer(paper_spec(scales=(64,)), "dsgd_aau", 64, 0,
                          device=device).scheduler
    batch = EventBatch.from_events(list(itertools.islice(sched.events(), 32)),
                                   edge_bound=sched.edge_bound())
    P = torch.as_tensor(batch.P, dtype=torch.float32).to(device)
    E = P.shape[0]
    stacks = {k: w.unsqueeze(0).expand((E,) + tuple(w.shape)).contiguous()
              for k, w in trainer.W.items()}
    torch.cuda.synchronize()
    reset_counts()
    mixed = {k: gossip_mix_batched(x, P) for k, x in stacks.items()}
    torch.cuda.synchronize()
    counts = read_counts()
    err = 0.0
    for e in range(E):
        one = gossip_mix_dense(trainer.W, P[e])
        for k in one:
            err = max(err, close(mixed[k][e], one[k], "float32"))
    print(f"[12] gossip_mix_batched on a DSGD-AAU EventBatch (E={E}, N=64): "
          f"{len(stacks)} leaves, launches {counts['gossip_mix_batched']}; max "
          f"|batched - gossip_mix_dense| {err:.3e}")
    require(counts["gossip_mix_batched"] == len(stacks),
            f"phase 12 launched {counts}")
    return dict(launches=counts["gossip_mix_batched"], err=err)


# ---------------------------------------------------------------------------
# phases 13-15: the experiment CLI, telemetry and trace, the sanitizer
# ---------------------------------------------------------------------------

def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def xp_cli(device, n: int = N_MAIN, card: str = "cpu") -> dict:
    """Phase 13: ``python -m repro_torch.xp`` in-process on one
    ``paper_figures`` cell at N=``n`` with telemetry, trace and a run log;
    returns the launch counts of the call and each run's figures."""
    import contextlib
    import io
    import tempfile

    from repro_torch.obs import load_run_log
    from repro_torch.xp.__main__ import main as xp_main

    with tempfile.TemporaryDirectory() as tmp:
        out, log = Path(tmp) / "paper_figures.json", Path(tmp) / "run.jsonl"
        argv = ["--preset", "paper_figures", "--scales", str(n), "--seeds",
                "0", "--scenarios", "paper_default", "--telemetry", "--trace",
                "--run-log", str(log), "--out", str(out),
                "--device", device.type]
        csv = io.StringIO()
        sync(device)
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(csv):
            rc = xp_main(argv)
        sync(device)
        wall = time.perf_counter() - t0
        counts = read_counts()
        art = json.loads(out.read_text())
        records = load_run_log(str(log))
    require(rc == 0, f"the CLI returned {rc}")
    for line in csv.getvalue().splitlines():
        print(f"    {line}")
    # (a CPU rehearsal of this phase launches no kernel)
    require(device.type == "cpu" or (
        counts["sparse_gossip"] > 0 and counts["scatter_rows"] > 0
        and counts["masked_gossip"] > 0),
        f"the CLI's cell missed a kernel of its path: {counts}")
    algs = ("dsgd_aau", "ad_psgd", "prague", "agp")
    require(sorted(r["algorithm"] for r in art["speedup_vs_n"]) == sorted(algs),
            f"speedup_vs_n rows: {art['speedup_vs_n']}")
    require(len(art["convergence"]) == 5 and all(
        math.isfinite(float(p["loss_mean"])) for r in art["convergence"]
        for p in r["points"]), "convergence rows missing or not finite")
    require(len(art["trace"]) == 5, f"{len(art['trace'])} trace rows")
    tel = {r["algorithm"]: r for r in art["telemetry"]}
    require(sorted(tel) == sorted(("dsgd_sync",) + algs),
            f"telemetry rows for {sorted(tel)}")
    require(tel["dsgd_aau"]["staleness_bound"]["ok"],
            f"DSGD-AAU staleness bound: {tel['dsgd_aau']['staleness_bound']}")
    require((art["meta"]["device"], art["meta"]["power_limit"])
            == tuple(card.split(", ", 1)) if device.type == "cuda"
            else art["meta"]["device"] == "cpu",
            f"artifact meta {art['meta']} does not name the card {card}")
    # the run log: one start and one end per run, the sweep's five cells
    # first (reference, then the algorithms), then the dtype probe's two
    starts = [r for r in records if r["event"] == "run_start"]
    ends = [r for r in records if r["event"] == "run_end"]
    require(len(starts) == len(ends) == 7, f"run log: {len(starts)} starts, "
            f"{len(ends)} ends")
    # each run's set-up (pools drawn, first calls paid: the sweep warms up
    # only the dtype probe) ends at its first block_dispatch record
    firsts = []
    for st in starts[:5]:
        i = records.index(st)
        firsts.append(next(r for r in records[i:]
                           if r["event"] == "block_dispatch"))
    runs = {}
    for st, first, en in zip(starts[:5], firsts, ends[:5]):
        alg = st["algorithm"]
        require(tel[alg]["comm_copies"] == en["comm"],
                f"{alg}: telemetry counted {tel[alg]['comm_copies']} copies, "
                f"the run {en['comm']}")
        w, setup = en["ts"] - st["ts"], first["ts"] - st["ts"]
        runs[alg] = dict(mode=st["mode"], events=en["rounds"], wall_s=w,
                         eps=en["rounds"] / w, setup_s=setup,
                         steady_eps=en["rounds"] / (w - setup))
        print(f"[13] {alg} N={n} {st['mode']}: {en['rounds']} events in "
              f"{w:.3f} s = {en['rounds'] / w:.1f} events/s, of which "
              f"set-up {setup:.3f} s, after it "
              f"{runs[alg]['steady_eps']:.1f} events/s (telemetry and "
              f"trace on); vtime {en['t']:.2f}; comm {en['comm']}")
    for r in art["dtype_policy"]:
        print(f"[13] dtype probe {r['dtype']} {r['algorithm']} N={r['n']}: "
              f"{r['events']} events, {r['events_per_s']} events/s, final "
              f"loss {float(r['final_loss']):.4f}")
    print(f"[13] CLI call {wall:.1f} s; launches {counts}; meta "
          f"{ {k: v for k, v in art['meta'].items() if k != 'spec'} }")
    return dict(launches=counts, runs=runs, wall=wall)


TRACE_ARRAYS = ("times", "copies", "lane_ev", "lane_worker", "lane_fin",
                "lane_grad", "lane_restart", "edge_ev", "edge_src", "edge_dst")
SUMMARY_FLOATS = ("busy_t", "idle_t", "utilization", "utilization_mean",
                  "mix_age", "stale_mean")


def observed_card_vs_cpu(device, events: int = 128) -> None:
    """Phase 14: telemetry and trace on the card against the CPU, from one
    W0 (a NumPy draw carried with ``params_from_numpy``)."""
    import numpy as np
    import torch
    from repro_torch.xp import build_trainer, mlp2nn_init, params_from_numpy

    w0 = {k: v.numpy() for k, v in
          mlp2nn_init()(torch.Generator().manual_seed(0)).items()}
    cpu = torch.device("cpu")
    for alg, n, mode in (("dsgd_aau", 64, "sparse_scan"),
                         ("dsgd_aau", 64, "per_event"),
                         ("dsgd_sync", 64, "scan"), ("ad_psgd", 16, "fused")):
        spec = paper_spec(scales=(n,), mode=mode, max_time=None,
                          max_events=events, telemetry=True, trace=True)
        runs = []
        for dev in (device, cpu):
            tr = build_trainer(spec, alg, n, 0, device=dev, batch_pool=events,
                               init_params=params_from_numpy(w0, device=dev))
            runs.append((tr, tr.run(max_events=events, eval_every=32)))
        (tg, rg), (tc, rc) = runs
        a, b = rc.telemetry, rg.telemetry
        require(a.keys() == b.keys(), f"{alg} {mode}: summary keys differ")
        float_err = max(float(np.max(np.abs(np.subtract(b[k], a[k]))))
                        for k in SUMMARY_FLOATS)
        ints_same = all(b[k] == a[k] for k in a
                        if k not in SUMMARY_FLOATS + ("bucket_occupancy",))
        trace_same = all(np.array_equal(getattr(tg.last_trace, k),
                                        getattr(tc.last_trace, k))
                         for k in TRACE_ARRAYS)
        tax_err = max(abs(rg.trace[k] - rc.trace[k]) for k in (
            "straggler_tax", "busy_t", "wait_t", "blame_total",
            "residual_wait"))
        merged = (mode == "sparse_scan"
                  and tg._events_per_step(tg.scheduler.active_buckets()[0]) > 1)
        print(f"[14] {alg} N={n} {mode}{' (merged rows)' if merged else ''}, "
              f"{events} events, card vs CPU: integer counters equal "
              f"{ints_same}, max float err {float_err:.3e}, trace arrays "
              f"equal {trace_same}, straggler_tax {rg.trace['straggler_tax']}"
              f" / {rc.trace['straggler_tax']} (max err {tax_err:.3e}); "
              f"stale_max {b['stale_max']}, comm {b['comm_copies']}")
        require(ints_same and float_err <= 1e-4,
                f"{alg} {mode}: card and CPU telemetry disagree")
        require(trace_same and tax_err <= 1e-6,
                f"{alg} {mode}: card and CPU traces disagree")
        require(same_counters(rg, rc), f"{alg} {mode}: counters differ")


# (algorithm, mode, events per run, eval every, pool draws per worker: two
# runs of the fused cell restart a fast worker up to ~130 times)
OVERHEAD_CELLS = (("ad_psgd", "fused", 1024, 256, 192),
                  ("dsgd_aau", "sparse_scan", 512, 256, 64),
                  ("dsgd_sync", "scan", 64, 32, 64),
                  ("dsgd_aau", "per_event", 128, 64, 64))


def observing_cost(device, n: int = N_MAIN, cells=OVERHEAD_CELLS) -> dict:
    """Phase 15: events/s with and without telemetry, one trainer each,
    runs in turns (off, on, on, off); then a sanitized sparse_scan run."""
    import statistics

    from repro_torch.xp import build_trainer

    out = {}
    for alg, mode, events, eval_every, pool in cells:
        spec = paper_spec(mode=mode, scales=(n,), max_time=None,
                          max_events=events, block_size=32)
        trainers = {}
        for tel in (False, True):
            trainers[tel] = tr = build_trainer(
                spec.replace(telemetry=tel), alg, n, 0, batch_pool=pool,
                device=device)
            tr.warmup(max_events=events)
        eps = {False: [], True: []}
        for tel in (False, True, True, False):
            sync(device)
            t0 = time.perf_counter()
            res = trainers[tel].run(max_events=events, eval_every=eval_every)
            sync(device)
            eps[tel].append(res.total_events / (time.perf_counter() - t0))
            check_history(res, f"{alg} {mode} telemetry={tel}")
        off, on = statistics.mean(eps[False]), statistics.mean(eps[True])
        overhead = off / on - 1.0
        out[mode] = dict(off=eps[False], on=eps[True], overhead=overhead)
        print(f"[15] {alg} N={n} {mode}, {events} events: events/s without "
              f"telemetry {', '.join(f'{x:.1f}' for x in eps[False])}, with "
              f"{', '.join(f'{x:.1f}' for x in eps[True])}: overhead "
              f"{100 * overhead:.1f} % (mean of each side)")
    spec = paper_spec(scales=(n,), max_time=None, max_events=256,
                      telemetry=True, trace=True)
    tr = build_trainer(spec, "dsgd_aau", n, 0, batch_pool=64, device=device)
    tr.sanitize = True
    tr.warmup(max_events=256)
    sync(device)
    t0 = time.perf_counter()
    res = tr.run(max_events=256, eval_every=64)
    wall = time.perf_counter() - t0
    stats = tr.sanitizer_stats
    print(f"[15] sanitized dsgd_aau N={n} sparse_scan (telemetry, trace): "
          f"{res.total_events} events in {wall:.3f} s, passed; explicit "
          f"fetches {stats.fetches}")
    require(stats.fetches == 2,
            f"the sanitized run made {stats.fetches} fetches, not 2")
    out["sanitized"] = dict(fetches=stats.fetches, wall=wall)
    return out


# ---------------------------------------------------------------------------
# phases 17-18: decentralized LM training
# ---------------------------------------------------------------------------

def steady_window(trainer, events: int, device) -> dict:
    """A profiled run of ``events`` more events after the timed one: the
    device's busy ms and idle share of the window and its top device
    operators."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.profiling import window_summary
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(max_events=events, eval_every=events)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return window_summary(prof, wall, 4)


def train_lm(tag: str, what: str, trainer, events: int, eval_every: int,
             device, window_events: int, kernels) -> dict:
    """Set up and run ``trainer`` once with the counters zeroed just before
    (``drive``); the history finite and falling, each of ``kernels``
    launched, DSGD-AAU's staleness bound 2N−4 held; then a profiled steady
    window.  Returns the figures and W as the run left it (on the host)."""
    res, setup, wall, counts = drive(trainer, events, eval_every)
    state = {k: w.to("cpu", copy=True) for k, w in trainer.W.items()}
    check_history(res, what)
    eps = res.total_events / wall
    sb = res.telemetry["staleness_bound"]
    win = steady_window(trainer, window_events, device)
    print(f"[{tag}] {what}: mode {trainer.mode}, {len(trainer.W)} leaves, "
          f"{res.total_events} events in {wall:.3f} s = {eps:.2f} events/s "
          f"after set-up ({setup:.2f} s); launches {counts}; loss "
          f"{res.history[0].loss:.4f} -> {res.history[-1].loss:.4f}; "
          f"staleness max {sb['observed_max']} <= 2N-4 = {sb['bound']}: "
          f"{sb['ok']}; comm {res.total_comm_copies} copies")
    print(f"[{tag}] {what}: steady window of {window_events} events "
          f"{win['wall_ms']:.1f} ms, device busy {win['device_busy_ms']:.1f} "
          f"ms, idle {100 * win['device_idle_share']:.1f} %; top device "
          f"{[(k, c, round(ms, 2)) for k, c, ms in win['top_device_ms']]}")
    require(all(counts[k] > 0 for k in kernels),
            f"{what} missed a kernel of its path: {counts}")
    require(res.history[-1].loss < res.history[0].loss,
            f"the loss did not fall on {what}")
    require(sb["ok"] and sb["bound"] == 2 * trainer.n - 4,
            f"{what}: staleness bound {sb}")
    return dict(eps=eps, setup=setup, launches=counts,
                idle=win["device_idle_share"], busy_ms=win["device_busy_ms"],
                wall_ms=win["wall_ms"], loss=(res.history[0].loss,
                                              res.history[-1].loss)), state


def lm_training(device) -> dict:
    """Phase 17: the LM example's 100m preset at N=8 in the dense scan and in
    the active-set path, then the paper's char-LM at N=256."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.runner import DecentralizedTrainer
    from repro_torch.data import CharLMData
    from repro_torch.examples import decentralized_lm as dlm
    from repro_torch.models import flat_params, init_model, lm_loss, param_count
    from repro_torch.xp import build_trainer

    out = {}
    cfg = dlm.preset_config(LM_PRESET)
    print(f"[17] {cfg.name}: {param_count(cfg):,} parameters, float32, "
          f"eta0 {LM_ETA0}")
    states = {}
    for label, kw, kernels in (
            ("auto", dict(mode="auto"), ("masked_gossip",)),
            ("sparse_scan", dict(mode="sparse_scan", events_per_step=1),
             ("sparse_gossip", "scatter_rows"))):
        t0 = time.perf_counter()
        tr = dlm.build_trainer(cfg, LM_N, LM_SEQ, LM_BATCH, device=device,
                               eta0=LM_ETA0, telemetry=True, **kw)
        print(f"[17] {cfg.name} N={LM_N} {label}: trainer built in "
              f"{time.perf_counter() - t0:.2f} s")
        res, states[label] = train_lm(
            "17", f"{cfg.name} N={LM_N} dsgd_aau {label}", tr, LM_EVENTS,
            LM_EVENTS // 6, device, 10, kernels)
        out[label] = res
        require(tr.mode == ("scan" if label == "auto" else label),
                f"{label} took mode {tr.mode}")
        del tr
        torch.cuda.empty_cache()
    # both runs replay one stream, one event a row: eq. (5) by two routes
    # (masked_gossip's 3xTF32 sums against sparse_gossip's CUDA-core ones)
    diff = max(float((states["auto"][k] - states["sparse_scan"][k]).abs().max())
               for k in states["auto"])
    print(f"[17] {cfg.name}: max |W| of scan against sparse_scan after "
          f"{LM_EVENTS} events {diff:.3e}")
    require(diff <= 1e-4, f"scan and sparse_scan disagree by {diff}")
    del states

    # the paper's char-LM on the main path's event stream (N=256)
    cfg = get_config("paper-char-lm")
    data = CharLMData(n_workers=CHAR_N, vocab=cfg.vocab_size, seq_len=64,
                      seed=0)
    sched = build_trainer(paper_spec(), "dsgd_aau", CHAR_N, 0,
                          device="cpu").scheduler
    t0 = time.perf_counter()
    tr = DecentralizedTrainer(
        sched, lambda p, b: lm_loss(p, cfg, b),
        lambda gen: flat_params(init_model(cfg, gen, device)),
        lambda w, s: data.batch(w, s, batch_size=8), data.eval_batch(16),
        eta0=0.5, eta_decay=0.999, mode="sparse_scan", batch_pool=CHAR_POOL,
        device=device, telemetry=True)
    print(f"[17] {cfg.name}: {param_count(cfg):,} parameters, float32; "
          f"trainer built in {time.perf_counter() - t0:.2f} s; ladder "
          f"{sched.active_buckets()}")
    out["char_lm"], _ = train_lm(
        "17", f"{cfg.name} N={CHAR_N} dsgd_aau sparse_scan", tr, CHAR_EVENTS,
        CHAR_EVENTS // 4, device, 64, ("sparse_gossip", "scatter_rows"))
    del tr
    torch.cuda.empty_cache()
    return out


def lm_card_vs_cpu(device, events: int = 16) -> None:
    """Phase 18: the LM example's tiny preset at N=8 on the card and on the CPU
    (both draw W0 on the host from seed 0), in the dense scan and the
    active-set path."""
    import torch
    from repro_torch.examples import decentralized_lm as dlm

    cfg = dlm.preset_config("tiny")
    for kw in (dict(mode="scan"), dict(mode="sparse_scan", events_per_step=1)):
        runs = []
        for dev in (device, torch.device("cpu")):
            tr = dlm.build_trainer(cfg, LM_N, LM_SEQ, LM_BATCH, device=dev, **kw)
            runs.append((tr, tr.run(max_events=events, eval_every=8)))
        (tg, rg), (tc, rc) = runs
        err = state_err(tg, tc)
        loss_err = max(abs(p.loss - q.loss) for p, q in zip(rg.history, rc.history))
        print(f"[18] {cfg.name} N={LM_N} {kw['mode']}, {events} events, card vs "
              f"CPU: max |W,S,y| err {err:.3e}, max loss err {loss_err:.3e}; "
              f"total_time {rg.total_time} / {rc.total_time}, comm "
              f"{rg.total_comm_copies} / {rc.total_comm_copies}")
        require(err <= 1e-4 and loss_err <= 1e-4,
                f"tiny LM {kw['mode']}: card and CPU disagree by {err}, {loss_err}")
        require(same_counters(rg, rc), f"tiny LM {kw['mode']}: counters differ")
        require(bool(torch.equal(tg._ptr.cpu(), tc._ptr)),
                f"tiny LM {kw['mode']}: ptr differs")


# ---------------------------------------------------------------------------
# phases 26-27: the production training launcher
# ---------------------------------------------------------------------------

def _column_chunks(*leaves, width: int = 1 << 24):
    """The (N, ...) leaves as (N, ≤ width) column slices, in step (so a
    check's float32 temporaries stay ~N·width·4 bytes)."""
    flat = [x.reshape(x.shape[0], -1) for x in leaves]
    for a in range(0, flat[0].shape[1], width):
        yield [x[:, a:a + width] for x in flat]


def ring_err(before, after, P) -> float:
    """The largest |after − Pᵀ·before| of one gossip over what one bf16
    rounding of the float32 sum and its float32 error allow: 2⁻⁸·|Pᵀ·x| +
    2⁻¹⁶·(Pᵀ·|x|), the sum taken in float32 with P as the step casts it.
    Within 1 the output is the ring's mix; weights off by the workers' one-
    step spread (η·g) show wherever |x| is below ~2⁸ times that spread."""
    import torch
    Pf = P.to(torch.float32)
    x = before.to(torch.float32)
    ref = torch.einsum("nd,nj->jd", x, Pf)
    bound = (ref.abs() * 2.0**-8
             + torch.einsum("nd,nj->jd", x.abs(), Pf.abs()) * 2.0**-16)
    return float(((after.to(torch.float32) - ref).abs()
                  / bound.clamp_min(1e-30)).max())


def train_full_width(device) -> dict:
    """Phase 26: recurrentgemma-2b at full width and depth (26 layers, d
    2560, window 2048, vocab 256,000; 3,549,934,080 parameters a worker,
    bf16) trained through ``launch/train.py:main`` as its users run it: 4
    workers stacked on the card, seq 4096, global batch 8, 3 steps, the
    default straggler probability.  Counters zeroed just before the steps
    and read just after: ``gossip_mix`` once per leaf per step, no other
    kernel.  Every loss and leaf finite; after step 0 three leaves are the
    ring's mix of their pre-gossip workers (``ring_err`` ≤ 1) and keep the
    workers' mean (bf16 bound); step 2, a straggler round (P = I), leaves
    every post-SGD leaf bit-equal."""
    import math
    import numpy as np
    import torch
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train

    n = int(TRAIN_ARGV[TRAIN_ARGV.index("--workers") + 1])
    P = ST.ring_matrix(n, ST.default_gossip_weights(n, False)).to(
        device, torch.bfloat16)
    draws = np.random.default_rng(0).random(len(TRAIN_STRAGGLERS))
    require(tuple(bool(d < 0.1) for d in draws) == TRAIN_STRAGGLERS,
            f"default_rng(0) drew {draws}")
    drift, mixed, same, losses, secs, leaves = {}, {}, {}, [], [], []

    def on_mix(k, key, before, after):
        if k == 0 and key in TRAIN_MEAN_LEAVES:
            tol = TOL["bfloat16"]
            worst = mix = 0.0
            for b, a in _column_chunks(before, after):
                mb, ma = b.float().mean(0), a.float().mean(0)
                worst = max(worst, float(((ma - mb).abs()
                                          - tol["rtol"] * mb.abs()).max()))
                mix = max(mix, ring_err(b, a, P))
            drift[key], mixed[key] = worst, mix
        if TRAIN_STRAGGLERS[k]:
            same[key] = all(bool(torch.equal(b, a))
                            for b, a in _column_chunks(before, after))

    def on_step(k, loss, seconds, W):
        losses.append(loss)
        secs.append(seconds)
        leaves.append(len(W))
        bad = [key for key, w in W.items() if not bool(torch.isfinite(w).all())]
        require(math.isfinite(loss) and not bad,
                f"phase 26 step {k}: loss {loss}, non-finite leaves {bad[:4]}")

    gc.collect()
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    rc = train.main(list(TRAIN_ARGV), on_mix=on_mix, on_step=on_step)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    require(rc == 0 and len(losses) == len(TRAIN_STRAGGLERS), f"rc {rc}")
    n_leaves = leaves[0]
    require(counts == dict({k: 0 for k in counts},
                           gossip_mix=n_leaves * len(TRAIN_STRAGGLERS)),
            f"phase 26 launched {counts} for {n_leaves} leaves")
    require(set(mixed) == set(TRAIN_MEAN_LEAVES) and max(mixed.values()) <= 1.0,
            f"a leaf is not the ring's mix of its workers: {mixed}")
    require(max(drift.values()) <= TOL["bfloat16"]["atol"],
            f"the ring moved the workers' mean: {drift}")
    require(len(same) == n_leaves and all(same.values()),
            "the straggler round changed leaves: "
            f"{[k for k, v in same.items() if not v][:4]}")
    tokens = int(TRAIN_ARGV[TRAIN_ARGV.index("--global-batch") + 1]) * int(
        TRAIN_ARGV[TRAIN_ARGV.index("--seq") + 1])
    steady = sum(secs[1:]) / len(secs[1:])
    out = dict(losses=losses, seconds=secs, steady_s=steady,
               tokens_per_s=tokens / steady, peak_bytes=peak, wall=wall,
               launches=counts, leaves=n_leaves, drift=drift, mixed=mixed)
    print(f"[26] {ARCH} trained through launch/train.py ({' '.join(TRAIN_ARGV)}): "
          f"losses {', '.join(f'{x:.4f}' for x in losses)}; step seconds "
          f"{', '.join(f'{x:.3f}' for x in secs)}; {steady:.3f} s/step after "
          f"step 0 = {tokens / steady:.1f} tokens/s; peak "
          f"{peak / 2**30:.2f} GiB ({resident / 2**30:.2f} resident before); "
          f"launches {counts} ({n_leaves} leaves); after step 0 ring_err "
          f"{ {k: f'{v:.3f}' for k, v in mixed.items()} } (≤ 1), "
          f"worker-mean drift over the bf16 bound "
          f"{ {k: f'{v:.3e}' for k, v in drift.items()} }; straggler step "
          f"bit-equal; {wall:.1f} s in main; card {card_line()}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_card_vs_cpu(device) -> None:
    """Phase 27: one ``build_train_step`` step at N = 2 (the default ring,
    self 1/2) from one float32 W0 on the card and on the CPU, for each of
    the ten assigned archs reduced (seq 64, the CLI's demo length and
    logit chunk 16) and for reduced recurrentgemma-2b and minicpm-2b at T =
    1280 (blockwise attention, the chunked scan): W within 1e-5, the loss
    within 1e-5.  Beside the error it prints the step's largest change of
    W on the CPU, the scale the limit is read against."""
    import numpy as np
    import torch
    from repro_torch.configs import ASSIGNED, get_config
    from repro_torch.launch import steps as ST

    worst = {}
    for arch, T in [(a, 64) for a in ASSIGNED] + list(TRAIN_LONG):
        cfg = get_config(arch).reduced()
        W0 = ST.stacked_init(cfg, 2, torch.Generator().manual_seed(0), "cpu")
        toks = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 2, T)).astype(np.int32))
        gw = ST.default_gossip_weights(2, False)
        res = {}
        for dev in (device, torch.device("cpu")):
            batch = {"tokens": toks.to(dev)}
            if cfg.frontend:
                batch["prefix"] = torch.zeros(
                    (2, 2, cfg.n_prefix_tokens, cfg.d_model), device=dev)
            W = {k: v.to(dev, copy=True) for k, v in W0.items()}
            step = ST.build_train_step(cfg, 2, logit_chunk=16, device=dev)
            res[dev.type] = step(W, batch, 0.05, gw)
        (Wg, lg), (Wc, lc) = res["cuda"], res["cpu"]
        err = max(float((Wg[k].cpu() - Wc[k]).abs().max()) for k in Wc)
        moved = max(float((Wc[k] - W0[k]).abs().max()) for k in Wc)
        lerr = abs(float(lg) - float(lc))
        worst[f"{arch}@{T}"] = (err, lerr, moved)
        require(err <= 1e-5 and lerr <= 1e-5,
                f"phase 27 {arch} T={T}: card and CPU disagree, W {err}, loss {lerr}")
    print("[27] one train step at N=2, card vs CPU (max |W| err, |loss| err; "
          "max |W1 - W0|): " + ", ".join(f"{k} {e:.2e} / {l:.2e}; {m:.2e}"
                                         for k, (e, l, m) in worst.items()))


# ---------------------------------------------------------------------------
# phases 28-29: the inter-pod edge, the sharded step, the dry run
# ---------------------------------------------------------------------------

def train_multipod(device) -> dict:
    """Phase 28: one step of ``launch/train.py:main`` for recurrentgemma-2b
    at full width and depth, 4 workers stacked as 2 pods × 2, seq 1024,
    global batch 4.  Counters zeroed just before and read just after:
    ``gossip_mix`` once per leaf, no other kernel.  Every leaf's output is
    the two-pod matrix's mix of its pre-gossip workers (``ring_err`` ≤ 1,
    phase 26's bound) and keeps the workers' mean within the bf16 bound."""
    import math
    import torch
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train

    P = ST.ring_matrix(4, ST.default_gossip_weights(2, True), pods=2).to(
        device, torch.bfloat16)
    mixed, drift, losses, secs, leaves = {}, {}, [], [], []

    def on_mix(k, key, before, after):
        tol = TOL["bfloat16"]
        worst = mix = 0.0
        for b, a in _column_chunks(before, after):
            mb, ma = b.float().mean(0), a.float().mean(0)
            worst = max(worst, float(((ma - mb).abs()
                                      - tol["rtol"] * mb.abs()).max()))
            mix = max(mix, ring_err(b, a, P))
        drift[key], mixed[key] = worst, mix

    def on_step(k, loss, seconds, W):
        losses.append(loss)
        secs.append(seconds)
        leaves.append(len(W))
        bad = [key for key, w in W.items() if not bool(torch.isfinite(w).all())]
        require(math.isfinite(loss) and not bad,
                f"phase 28: loss {loss}, non-finite leaves {bad[:4]}")

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts()
    t0 = time.perf_counter()
    rc = train.main(list(POD_ARGV), on_mix=on_mix, on_step=on_step)
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(device)
    require(rc == 0 and len(losses) == 1, f"phase 28 rc {rc}")
    n_leaves = leaves[0]
    require(counts == dict({k: 0 for k in counts}, gossip_mix=n_leaves),
            f"phase 28 launched {counts} for {n_leaves} leaves")
    require(len(mixed) == n_leaves and max(mixed.values()) <= 1.0,
            "a leaf is not the two-pod mix of its workers: "
            f"{sorted(mixed.items(), key=lambda kv: -kv[1])[:3]}")
    require(max(drift.values()) <= TOL["bfloat16"]["atol"],
            f"the pod gossip moved the workers' mean: {max(drift.values())}")
    out = dict(loss=losses[0], seconds=secs[0], wall=wall, peak_bytes=peak,
               launches=counts, leaves=n_leaves,
               ring_err=max(mixed.values()), drift=max(drift.values()))
    print(f"[28] {ARCH} one stacked step with the inter-pod edge "
          f"({' '.join(POD_ARGV)}): loss {losses[0]:.4f}, step "
          f"{secs[0]:.3f} s, {wall:.1f} s in main, peak {peak / 2**30:.2f} "
          f"GiB; launches {counts} ({n_leaves} leaves); worst ring_err "
          f"{out['ring_err']:.3f} (≤ 1), worker-mean drift over the bf16 "
          f"bound {out['drift']:.3e}; card {card_line()}")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _step_equal(before: dict, sharded: dict, stacked: dict,
                units: int = 1) -> dict:
    """The sharded and the stacked path's W after a step from ``before``
    (the stacked path's W before it), element by element.  ``over`` counts
    elements further apart than ``units`` × (one unit in the last place of
    the leaf's dtype + 1 % of the leaf's largest change in the step): well
    below one step's change, so that a step that skipped SGD or applied
    another update shows in the elements it moved most, while a rounding of
    the leaf's dtype or the order of a sum (the CPU's embedding gradient
    accumulates in a varying order) does not.  ``differ`` counts elements
    not bit for bit equal, ``moved`` those the stacked step moved by more
    than one unit, of ``total``."""
    import torch
    out = dict(over=0, differ=0, moved=0, total=0)
    for k, b in stacked.items():
        a, w0 = sharded[k].float(), before[k].float()
        eps = torch.finfo(b.dtype).eps
        b = b.float()
        step = (b - w0).abs()
        limit = units * (eps * torch.maximum(a.abs(), b.abs())
                         + 0.01 * step.max())
        out["over"] += int(((a - b).abs() > limit).sum())
        out["differ"] += int((a != b).sum())
        out["moved"] += int((step > eps * torch.maximum(b.abs(), w0.abs())).sum())
        out["total"] += b.numel()
    return out


def train_sharded(device, scratch: Path) -> dict:
    """Phase 29: ``build_sharded_train_step`` on NCCL at world size 1 (a
    ``FileStore`` under ``scratch``), recurrentgemma-2b at full width, 1
    worker, seq 4096, batch 2, one step (no kernel launched) against one
    step of the stacked ``build_train_step`` at N = 1 from the same W0 and
    tokens: W bit-equal leaf for leaf, the loss within 1e-5 relative."""
    import datetime
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as S
    from repro_torch.launch import steps as ST
    from repro_torch.launch.mesh import hierarchical_view

    scratch.mkdir(parents=True, exist_ok=True)
    store = scratch / "nccl_store"
    if store.exists():
        store.unlink()
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=300))
    try:
        base = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        view, axes = hierarchical_view(base, 1, 1)
        cfg = get_config(ARCH)
        W0 = ST.stacked_init(cfg, 1, torch.Generator(device=device).manual_seed(0),
                             device)
        before = {k: v[0].clone() for k, v in W0.items()}
        specs = S.param_pspecs(ST.stacked_init(cfg, 1, None, "meta"), view,
                               fsdp=axes.fsdp, model=axes.model,
                               worker_axes=axes.worker_axes)
        # the step updates a clone of each shard: ``before`` stays as it is
        W = ST.shard_replica(before, view, axes, specs)
        toks = torch.as_tensor(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (1, SHARDED_BATCH, SHARDED_SEQ)).astype(np.int32),
            device=device)
        gw = ST.default_gossip_weights(1, False)
        chunk = min(512, max(SHARDED_SEQ // 4, 16))
        step = ST.build_sharded_train_step(cfg, 1, axes, view, specs,
                                           logit_chunk=chunk)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        W, loss = step(W, {"tokens": toks[0]}, 0.05, gw)
        loss = float(loss)
        torch.cuda.synchronize(device)
        sharded_s = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(device)
        require(not any(counts.values()),
                f"phase 29: the sharded step launched {counts}")
        stacked = ST.build_train_step(cfg, 1, logit_chunk=chunk, device=device)
        t0 = time.perf_counter()
        W0, loss_s = stacked(W0, {"tokens": toks}, 0.05, gw)
        loss_s = float(loss_s)
        torch.cuda.synchronize(device)
        stacked_s = time.perf_counter() - t0
        eq = _step_equal(before, {k: w.to_local() for k, w in W.items()},
                         {k: w[0] for k, w in W0.items()})
        rel = abs(loss - loss_s) / abs(loss_s)
        require(eq["over"] == 0 and eq["moved"] > 0 and rel <= 1e-5,
                f"phase 29: the sharded step vs the stacked one {eq}, loss {rel}")
        out = dict(loss=loss, stacked_loss=loss_s, sharded_s=sharded_s,
                   stacked_s=stacked_s, peak_bytes=peak, loss_rel=rel,
                   leaves=len(W), bit_equal=eq["differ"] == 0, **eq)
        print(f"[29] {ARCH} sharded step on NCCL at world size 1 ({len(W)} "
              f"DTensor leaves, seq {SHARDED_SEQ}, batch {SHARDED_BATCH}): "
              f"{sharded_s:.3f} s, peak {peak / 2**30:.2f} GiB, launches "
              f"{counts}; the stacked step {stacked_s:.3f} s; loss {loss:.6f} "
              f"vs {loss_s:.6f} (rel {rel:.2e}); W: {eq['over']} elements "
              f"over one unit in the last place, {eq['differ']} not bit-equal, "
              f"{eq['moved']} of {eq['total']} moved by the step; torch "
              f"{torch.__version__}, DeviceMesh._unflatten "
              f"{hasattr(type(base), '_unflatten')}; card {card_line()}")
    finally:
        W = W0 = before = None
        dist.destroy_process_group()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_sharded_cli(device, scratch: Path) -> dict:
    """Phase 29, the launcher: ``launch/train.py:main`` as ``torchrun``
    starts it at world size 1 (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``
    and a rendezvous on localhost in the environment), so that it creates
    the NCCL group itself (``init_distributed``), builds the demo mesh
    (``_sharded_setup``), feeds its worker's batch and checkpoints every
    worker gathered (``gather_workers``); ``--demo`` (the reduced
    recurrentgemma-2b, seq 64), 2 steps.  Held bit for bit against the
    stacked ``main`` with ``--workers 1`` after each step, its checkpoint
    restored bit for bit; no kernel launched."""
    import os
    import shutil
    import socket
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as ST
    from repro_torch.launch import train

    argv = ["--arch", ARCH, "--demo", "--steps", "2", "--device", "cuda"]
    ckpt = scratch / "sharded_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    runs = {"sharded": ([], []), "stacked": ([], [])}

    def hook(tag, local):
        def on_step(k, loss, seconds, W):
            runs[tag][0].append(loss)
            runs[tag][1].append({key: local(w).clone() for key, w in W.items()})
        return on_step

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = {"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
           "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        reset_counts()
        t0 = time.perf_counter()
        rc = train.main(argv + ["--ckpt-dir", str(ckpt), "--ckpt-every", "2"],
                        on_step=hook("sharded", lambda w: w.to_local()))
        wall = time.perf_counter() - t0
        counts = read_counts()
        destroyed = not dist.is_initialized()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    require(rc == 0 and destroyed and not any(counts.values()),
            f"phase 29 launcher: rc {rc}, group left behind "
            f"{not destroyed}, launches {counts}")
    rc = train.main(argv + ["--workers", "1"],
                    on_step=hook("stacked", lambda w: w[0]))
    require(rc == 0, f"phase 29 launcher: the stacked run's rc {rc}")
    (ls, Ws), (lt, Wt) = runs["sharded"], runs["stacked"]
    require(len(Ws) == len(Wt) == 2 and all(
        abs(a - b) <= 1e-5 * abs(b) for a, b in zip(ls, lt)),
            f"phase 29 launcher: losses {ls} (sharded) vs {lt} (stacked)")
    W0 = {k: v[0] for k, v in ST.stacked_init(
        get_config(ARCH).reduced(), 1,
        torch.Generator(device=device).manual_seed(0), device).items()}
    eqs = [_step_equal(Wt[k - 1] if k else W0, Ws[k], Wt[k], units=k + 1)
           for k in range(2)]
    for k, eq in enumerate(eqs):
        require(eq["over"] == 0 and eq["moved"] > 0,
                f"phase 29 launcher step {k}: sharded vs stacked {eq}")
    restored, extra = Checkpointer(str(ckpt)).restore(
        {k: w[None] for k, w in Ws[1].items()})
    differ = [k for k, w in restored.items() if not torch.equal(w[0], Ws[1][k])]
    require(not differ and extra["stream"]["cursor"] == [2],
            f"phase 29 launcher: the checkpoint differs in {differ[:4]}, "
            f"extra {extra}")
    print(f"[29] {ARCH} --demo through launch/train.py:main at WORLD_SIZE=1 "
          f"(NCCL from the environment, 2 steps, {wall:.1f} s): losses "
          f"{', '.join(f'{x:.6f}' for x in ls)} (stacked --workers 1: "
          f"{', '.join(f'{x:.6f}' for x in lt)}); W against the stacked run "
          f"after each step ({len(Wt[1])} leaves): {eqs}; the checkpoint "
          f"restores bit for bit; launches {counts}")
    shutil.rmtree(ckpt, ignore_errors=True)
    return dict(losses=ls, wall=wall, bit_equal=all(
        eq["differ"] == 0 for eq in eqs))


def dry_run_pair() -> dict:
    """After phase 29: ``python -m repro_torch.launch.dryrun`` on one pair
    in a subprocess (the fake 256-rank group), its record printed."""
    import os
    arch, shape = DRYRUN_PAIR
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--arch", arch, "--shape", shape],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=DRYRUN_TIMEOUT)
    wall = time.perf_counter() - t0
    require(out.returncode == 0, f"the dry run failed: {out.stderr[-3000:]}")
    rec = json.loads([ln for ln in out.stdout.splitlines()
                      if ln.startswith("{")][-1])
    require("error" not in rec and rec["flops"] > 0, f"dry run record {rec}")
    print(f"[29] dry run {arch} x {shape} on the 16x16 mesh of a fake 256-rank "
          f"group ({wall:.1f} s): " + json.dumps(rec))
    return rec


# ---------------------------------------------------------------------------
# phase 30: the example drivers
# ---------------------------------------------------------------------------

def _example_stdout(main, argv) -> tuple:
    """(stdout lines, wall seconds) of one example's ``main(argv)``."""
    import contextlib
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    wall = time.perf_counter() - t0
    require(rc == 0, f"{main.__module__}.main({argv}) returned {rc}")
    return buf.getvalue().splitlines(), wall


def run_examples(device) -> dict:
    """Phase 30: the example drivers as their users run them, each with the
    launch counters zeroed just before and read just after.  quickstart
    whole (five algorithms at N = 16 for 50 virtual seconds; ``auto``
    takes the dense scan, so ``masked_gossip``), one ``straggler_ablation``
    cell (its own trainer, DSGD-AAU at the default protocol), and
    ``serve_batched`` at its default (reduced rwkv6, no kernel) and with
    ``--arch recurrentgemma-2b`` (``linear_scan``, ``swa_attention``).
    Every number printed is finite and non-zero."""
    import re
    from repro_torch.examples import quickstart, serve_batched, straggler_ablation
    dev_arg = ["--device", str(device)]
    out = {}

    reset_counts()
    lines, wall = _example_stdout(quickstart.main, dev_arg)
    sync(device)
    counts = read_counts()
    rows = {ln.split()[0]: [float(x) for x in ln.split()[1:]] for ln in lines[1:]}
    print(f"[30] quickstart ({wall:.1f} s; launches {counts}):")
    for ln in lines:
        print("     " + ln)
    require(list(rows) == list(quickstart.ALGORITHMS),
            f"quickstart printed rows {list(rows)}")
    require(all(math.isfinite(v) and v > 0 for r in rows.values() for v in r),
            f"quickstart printed a zero or non-finite number: {rows}")
    require(counts["masked_gossip"] > 0 and sum(counts.values())
            == counts["masked_gossip"],
            f"quickstart at N=16 should launch masked_gossip alone: {counts}")
    out["quickstart"] = dict(wall=wall, launches=counts, rows=rows)

    reset_counts()
    t0 = time.perf_counter()
    res = straggler_ablation.make_classification_trainer(
        "dsgd_aau", straggler_ablation.N_WORKERS, device=device).run(
        max_time=straggler_ablation.BUDGET, eval_every=10**6)
    sync(device)
    wall, counts = time.perf_counter() - t0, read_counts()
    print(f"[30] straggler_ablation cell dsgd_aau (prob 0.1, 10x; {wall:.1f} s): "
          f"acc {res.final_metric:.4f}, loss {res.final_loss:.4f}, "
          f"{res.total_events} events; launches {counts}")
    require(math.isfinite(res.final_loss) and res.final_loss > 0
            and res.final_metric > 0 and res.total_events > 0,
            f"straggler_ablation cell: {res}")
    require(counts["masked_gossip"] > 0, f"ablation cell launches {counts}")
    out["ablation_cell"] = dict(wall=wall, launches=counts,
                                events=res.total_events)

    tail = re.compile(r"^(\S+) \((\S+)\): (\d+) requests, (\d+) tokens, "
                      r"([\d.]+)s \(([\d.]+) tok/s greedy, slots=(\d+)\)$")
    for arch, argv, needs in (("rwkv6-1.6b", [], ()),
                              ("recurrentgemma-2b",
                               ["--arch", "recurrentgemma-2b"],
                               ("linear_scan", "swa_attention"))):
        reset_counts()
        lines, wall = _example_stdout(serve_batched.main, argv + dev_arg)
        sync(device)
        counts = read_counts()
        m = tail.match(lines[-1])
        require(m is not None and m.group(1) == arch,
                f"serve_batched {arch}: last line {lines[-1]!r}")
        n_req, n_tok, secs, tok_s = (int(m.group(3)), int(m.group(4)),
                                     float(m.group(5)), float(m.group(6)))
        print(f"[30] serve_batched {arch} ({wall:.1f} s; launches {counts}): "
              f"{lines[-1]}")
        require(n_tok == n_req * 24 and secs > 0 and math.isfinite(tok_s)
                and tok_s > 0, f"serve_batched {arch}: {lines[-1]!r}")
        require(all(counts[k] > 0 for k in needs),
                f"serve_batched {arch} launched {counts}, needs {needs}")
        out[f"serve_{arch}"] = dict(wall=wall, launches=counts, tok_s=tok_s)
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"no port sources under {SRC}: run from a checkout's root")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this test needs a CUDA GPU")
    import repro_torch  # noqa: F401  (sets the float32 matmul policy)
    from repro_torch.kernels import build
    from repro_torch.xp import build_trainer, mlp2nn_init

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] card: {card}")
    print(f"    torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    print(f"[1] built {', '.join(build.SOURCES)} for sm_90a in {build_s:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {src}: {line.strip()}")

    # wall seconds of each phase, in the order run (build: phase 1)
    phase_s, clock = {"1": build_s}, [time.perf_counter()]

    def lap(tag: str) -> None:
        now = time.perf_counter()
        phase_s[tag], clock[0] = now - clock[0], now

    # -- 2. kernels vs plain versions ---------------------------------------
    t0 = time.perf_counter()
    rows, part_s = [], {}
    for check in (check_kernels, check_mix_kernels, check_sequence_kernels,
                  check_lm_kernels, check_prefill_kernels, train_mix_row):
        t1 = time.perf_counter()
        rows += check(device)
        part_s[check.__name__] = time.perf_counter() - t1
    _FLUSH.clear()   # else its buffer counts in phase 6's peak memory
    print(f"[2] {len(rows)} kernel comparisons within tolerance "
          f"({time.perf_counter() - t0:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in part_s.items())
          + "); times in ms:")
    for r in rows:
        if "ms" in r:
            print("    " + json.dumps({k: v for k, v in r.items()
                                       if k != "spent_s"}))
    main_rows = [r for r in rows if not (r.get("lm") or "arch" in r)]
    for r in rows:
        if r.get("train"):
            print(f"[2] gossip_mix N={r['N']} D={r['D']} bf16 (the training "
                  f"gossip of the embed leaf): call {r['ms']:.4f} ms, device "
                  f"{r['device_ms']:.4f}, host {r['host_us']:.1f} us; plain "
                  f"{r['plain_ms']:.4f}; torch.matmul bf16 call "
                  f"{r['library_ms']:.4f} (device {r['library_device_ms']:.4f}); "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}); seconds "
                  "spent: " + ", ".join(f"{k} {v:.1f}"
                                        for k, v in r["spent_s"].items()))
            continue
        if r["kernel"] == "gossip_mix" and "ms" in r:
            print(f"[2] gossip_mix N={r['N']} D={r['D']} {r['dtype']} (a per_event "
                  f"width): kernel {r['ms']:.4f} ms (device {r['device_ms']:.4f}), "
                  f"torch.matmul {r['library_ms']:.4f} ms (device "
                  f"{r['library_device_ms']:.4f}), bound {r['bound_ms']:.4f} ms")
        if (r["kernel"] == "sparse_gossip" and "ms" in r and r["D"] == 65536
                and r["dtype"] == "float32"):
            print(f"[2] sparse_gossip A={r['A']} D={r['D']} {r['lanes']} "
                  f"({r['valid']} valid, {r['kernels']} device kernels a call): "
                  f"device (L2 cold) {r['device_ms']:.4f} ms, call "
                  f"{r['ms']:.4f} ms, host {r['host_us']:.1f} us; library "
                  f"device {r['library_device_ms']:.4f} ms, call "
                  f"{r['library_ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']})")
        if r["kernel"] == "scatter_rows" and "ms" in r and r["dtype"] == "float32":
            print(f"[2] scatter_rows A={r['A']} D={r['D']} {r['lanes']}: device "
                  f"(L2 cold) {r['device_ms']:.4f} ms, call {r['ms']:.4f} ms, host "
                  f"{r['host_us']:.1f} us per call; index_copy_ device (L2 cold) "
                  f"{r['library_device_ms']:.4f} ms, call {r['library_ms']:.4f} "
                  f"ms; bound {r['bound_ms']:.4f} ms")

    lap("2")

    # -- 3. main path: bucketed DSGD-AAU at N=256 ---------------------------
    spec = paper_spec()
    tr = build_trainer(spec, "dsgd_aau", N_MAIN, 0, batch_pool=64,
                       device=device)
    require(tr.mode == "sparse_scan", f"main path took mode {tr.mode}")
    require(tr.scheduler.active_buckets() == (16, 64, 256),
            f"unexpected ladder {tr.scheduler.active_buckets()}")
    with ActiveSets() as active:
        res, setup, wall, counts_sparse = drive(tr, 1024, 256, active)
    check_history(res, "dsgd_aau N=256")
    print(f"[3] dsgd_aau N={N_MAIN} sparse_scan: {res.total_events} events in "
          f"{wall:.3f} s = {res.total_events / wall:.1f} events/s "
          f"(set-up {setup:.2f} s); launches {counts_sparse}")
    print("    history (k, t, loss, acc): " + ", ".join(
        f"({p.k}, {p.time:.2f}, {p.loss:.4f}, {p.metric:.3f})"
        for p in res.history))
    require(counts_sparse["sparse_gossip"] > 0 and counts_sparse["scatter_rows"] > 0,
            f"the main path launched no active-set kernel: {counts_sparse}")
    n_leaves = len(tr.W)
    print(f"[3] sparse_gossip launches by (A, valid lanes), {n_leaves} per "
          f"row: " + ", ".join(f"({a}, {v}): {c * n_leaves}" for (a, v), c
                               in sorted(active.rows.items())))
    by_rung = {}
    for (a, v), c in active.rows.items():
        by_rung[a] = by_rung.get(a, 0) + c * n_leaves
    print(f"[3] sparse_gossip launches by A: {dict(sorted(by_rung.items()))}; "
          f"cliques (workers: count) {dict(sorted(active.cliques.items()))}, "
          f"median {active.median_clique()}")
    require(sum(by_rung.values()) == counts_sparse["sparse_gossip"],
            f"rows recorded {by_rung} do not account for the "
            f"{counts_sparse['sparse_gossip']} sparse_gossip launches")
    require(res.history[-1].loss < res.history[0].loss,
            "the loss did not fall on the main path")
    eps_sparse = res.total_events / wall

    lap("3")

    # -- 4. dense path: sync DSGD at N=256 ----------------------------------
    tr = build_trainer(spec, "dsgd_sync", N_MAIN, 0, device=device)
    require(tr.mode == "scan", f"dense path took mode {tr.mode}")
    res_d, setup_d, wall_d, counts_dense = drive(tr, spec.ref_max_events,
                                                 spec.ref_eval_every)
    check_history(res_d, "dsgd_sync N=256")
    print(f"[4] dsgd_sync N={N_MAIN} scan: {res_d.total_events} events in "
          f"{wall_d:.3f} s = {res_d.total_events / wall_d:.1f} events/s "
          f"(set-up {setup_d:.2f} s); "
          f"launches {counts_dense}; loss {res_d.history[0].loss:.4f} -> "
          f"{res_d.history[-1].loss:.4f}")
    require(counts_dense["masked_gossip"] > 0,
            f"the dense path launched no masked_gossip: {counts_dense}")

    lap("4")

    # -- 5. card vs CPU: DSGD-AAU at N=64 from the same W0 ------------------
    w0 = mlp2nn_init()(torch.Generator().manual_seed(0))
    spec64 = paper_spec(scales=(64,))
    runs = {}
    for dev in (device, torch.device("cpu")):
        t = build_trainer(spec64, "dsgd_aau", 64, 0, device=dev,
                          init_params={k: v.to(dev) for k, v in w0.items()})
        require(t.mode == "sparse_scan", f"N=64 took mode {t.mode}")
        t0 = time.perf_counter()
        r = t.run(max_events=128, eval_every=32)
        runs[dev.type] = (t, r, time.perf_counter() - t0)
    (tg, rg, _), (tc, rc, _) = runs["cuda"], runs["cpu"]
    err = 0.0
    for a, b in [(tg.W[k], tc.W[k]) for k in tg.W] + \
                [(tg.S[k], tc.S[k]) for k in tg.S] + [(tg.y, tc.y)]:
        err = max(err, float((a.cpu() - b).abs().max()))
    loss_err = max(abs(p.loss - q.loss) for p, q in zip(rg.history, rc.history))
    print(f"[5] dsgd_aau N=64 card vs CPU, 128 events: max |W,S,y| err {err:.3e}, "
          f"max loss err {loss_err:.3e}")
    require(err <= 1e-4, f"card and CPU state disagree by {err}")
    require(loss_err <= 1e-4, f"card and CPU losses disagree by {loss_err}")
    require(len(rg.history) == len(rc.history) and all(
        (p.k, p.time, p.comm_param_copies) == (q.k, q.time, q.comm_param_copies)
        for p, q in zip(rg.history, rc.history)),
        "card and CPU histories differ in counters or times")
    require((rg.total_events, rg.total_time, rg.total_comm_copies)
            == (rc.total_events, rc.total_time, rc.total_comm_copies),
            "card and CPU totals differ")
    require(bool(torch.equal(tg._ptr.cpu(), tc._ptr)), "ptr differs")

    lap("5")

    # -- 6. serve path: RecurrentGemma-2B at full width ---------------------
    served = serve_full_width(device, build_s)

    lap("6")

    # -- 7. card vs CPU: the reduced RecurrentGemma -------------------------
    serve_card_vs_cpu(device)

    lap("7")

    # -- 9-10. per_event at N=256; per_event vs scan and CPU at N=64 ---------
    per_event = per_event_paths(device)

    lap("9-10")

    # -- 11. fused AD-PSGD and AGP at N=256; card vs CPU at N=16 --------------
    fused = fused_paths(device)

    lap("11")

    # -- 12. gossip_mix_batched on a real EventBatch -------------------------
    batched = batched_on_events(device, per_event["trainer64"])

    lap("12")

    # -- 13. the experiment CLI on one paper_figures cell at N=256 -----------
    xp = xp_cli(device, card=card)

    lap("13")

    # -- 14. telemetry and trace, card vs CPU --------------------------------
    observed_card_vs_cpu(device)

    lap("14")

    # -- 15. the cost of observing; the sanitizer ----------------------------
    observing = observing_cost(device)

    lap("15")

    # -- 16. dense serve path: qwen3-8b at full width ------------------------
    served_dense = serve_full_width(device, build_s, DENSE_ARCH, tag="16")

    lap("16")

    # -- 17. decentralized LM training: the 100m preset, the char-LM ---------
    trained = lm_training(device)

    lap("17")

    # -- 18. card vs CPU: the LM example's tiny preset ---------------------------
    lm_card_vs_cpu(device)

    lap("18")

    # -- 19-20. MoE serve path: grok-1-314b and arctic-480b, depth cut --------
    served_moe = {}
    for arch, layers, tag in MOE_SERVE:
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{tag}] resident before the model: "
              f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB")
        served_moe[arch] = serve_full_width(device, build_s, arch, tag, layers)
    gc.collect()
    torch.cuda.empty_cache()

    lap("19-20")

    # -- 21. card vs CPU: reduced grok-1 and arctic ----------------------------
    moe_card_vs_cpu(device)

    lap("21")

    # -- 22-24. rwkv6-1.6b, musicgen-large, llava-next at full width and depth --
    served_mm = {}
    for arch, tag in MM_SERVE:
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[{tag}] resident before the model: "
              f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB")
        served_mm[arch] = serve_full_width(device, build_s, arch, tag)
    gc.collect()
    torch.cuda.empty_cache()

    lap("22-24")

    # -- 25. card vs CPU: reduced rwkv6, musicgen and llava ----------------------
    mm_card_vs_cpu(device)

    lap("25")

    # -- 26. training at full width and depth: recurrentgemma-2b -------------
    trained_full = train_full_width(device)

    lap("26")

    # -- 27. card vs CPU: one train step of every assigned arch, reduced --------
    train_card_vs_cpu(device)

    lap("27")

    # -- 28. the stacked multi-pod step ----------------------------------------
    pod_step = train_multipod(device)

    lap("28")

    # -- 29. the sharded step on NCCL at world size 1; then the dry run --------
    sharded = train_sharded(device, ROOT / "build" / "chip_smoke")
    launcher = train_sharded_cli(device, ROOT / "build" / "chip_smoke")
    dry = dry_run_pair()

    lap("29")

    # -- 30. the example drivers ---------------------------------------------
    examples = run_examples(device)

    lap("30")

    # -- 8. summary ----------------------------------------------------------
    launches = {"masked_gossip": counts_dense["masked_gossip"],
                "gossip_mix": per_event["launches"]["gossip_mix"],
                "gossip_mix_batched": batched["launches"],
                "sparse_gossip": counts_sparse["sparse_gossip"],
                "scatter_rows": counts_sparse["scatter_rows"],
                **served["launches"]}
    B, T, W = SCAN_MAIN
    _, _, H, KV, dh, window = SWA_MAIN
    gossip = dict(dtype="float32", N=N_MAIN, D=65536)
    # kernel -> (source, TPU kernel it replaces, the timed row of phase 2)
    meta = {
        "masked_gossip": ("src/repro_torch/csrc/masked_gossip.cu",
                          "src/repro/kernels/gossip_mix/kernel.py:76",
                          dict(gossip, A=None)),
        "gossip_mix": ("src/repro_torch/csrc/gossip_mix.cu",
                       "src/repro/kernels/gossip_mix/kernel.py:45",
                       dict(gossip, E=None)),
        "gossip_mix_batched": ("src/repro_torch/csrc/gossip_mix.cu",
                               "src/repro/kernels/gossip_mix/kernel.py:109",
                               dict(dtype="float32", E=BATCHED_MAIN[0],
                                    N=BATCHED_MAIN[1], D=BATCHED_MAIN[2])),
        "sparse_gossip": ("src/repro_torch/csrc/sparse_gossip.cu",
                          "src/repro/kernels/sparse_gossip/kernel.py:61",
                          dict(gossip, A=64, lanes="full")),
        "scatter_rows": ("src/repro_torch/csrc/scatter_rows.cu",
                         "src/repro/kernels/sparse_gossip/kernel.py:117",
                         dict(gossip, A=64, lanes="full")),
        "linear_scan": ("src/repro_torch/csrc/linear_scan.cu",
                        "src/repro/kernels/linear_scan/kernel.py:43",
                        dict(dtype="float32", B=B, T=T, W=W, decay="gate")),
        "swa_attention": ("src/repro_torch/csrc/swa_attention.cu",
                          "src/repro/kernels/swa_attention/kernel.py:71",
                          dict(dtype="bfloat16", B=B, T=T, H=H, KV=KV, dh=dh,
                               window=window)),
    }
    # launches on the dense LM paths: qwen3-8b's two serve waves (16), the
    # 100m preset's two runs and the char-LM's run (17)
    lm_paths = {"serve_qwen3_8b": served_dense["launches"],
                "train_100m_scan": trained["auto"]["launches"],
                "train_100m_sparse_scan": trained["sparse_scan"]["launches"],
                "train_char_lm_n256": trained["char_lm"]["launches"]}
    # launches on the MoE (19-20) and ssm / audio / vlm (22-24) serve paths: two
    # waves each, and the audio / vlm prefix waves
    serve_paths = {f"serve_{a.replace('-', '_').replace('.', '_')}":
                   served_moe[a]["launches"] for a, _, _ in MOE_SERVE}
    serve_paths.update({f"serve_{a.replace('-', '_').replace('.', '_')}":
                        served_mm[a]["launches"] for a, _ in MM_SERVE})
    serve_paths.update({f"prefix_wave_{a.replace('-', '_')}":
                        {"swa_attention": served_mm[a]["prefixed"]["launches"]}
                        for a, _ in MM_SERVE[1:]})
    timed_keys = ("ms", "device_ms", "host_us", "plain_ms", "bound_ms",
                  "bound_by", "library_ms", "library_device_ms", "max_abs_err")
    kernels = []
    for kname, (source, replaces, sel) in meta.items():
        mine = [r for r in rows if r["kernel"] == kname]
        at = [r for r in main_rows if r["kernel"] == kname and "ms" in r
              and all(r.get(k) == v for k, v in sel.items())][0]
        lm_at = [r for r in mine if r.get("lm") and "ms" in r]
        prefills = [r for r in mine if "arch" in r]
        train_at = [r for r in mine if r.get("train")]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in mine
                               if r["dtype"] == "float32"),
            "max_abs_err_bf16": max(r["max_abs_err"] for r in mine
                                    if r["dtype"] == "bfloat16"),
            "ms": at["ms"], "device_ms": at["device_ms"],
            "host_us": at["host_us"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"],
            "library_device_ms": at["library_device_ms"],
            "launches_xp": xp["launches"][kname],
            "shape": sel,
            "launches_lm": {path: c.get(kname, 0) for path, c in lm_paths.items()},
            "lm_shape": ({k: lm_at[0][k] for k in ("dtype", "N", "A", "D", "B",
                                                   "T", "H", "KV", "dh", "window",
                                                   "lanes") if k in lm_at[0]}
                         if lm_at else None),
            "lm": ({k: lm_at[0][k] for k in timed_keys} if lm_at else None),
            "launches_serve": {path: c.get(kname, 0)
                               for path, c in serve_paths.items()},
            "launches_train": trained_full["launches"][kname],
            "launches_multipod": pod_step["launches"][kname],
            "launches_examples": {path: e["launches"][kname]
                                  for path, e in examples.items()},
            "train": ({k: train_at[0][k] for k in ("dtype", "N", "D")
                       + timed_keys} if train_at else None),
            "prefills": [{k: r[k] for k in ("arch", "prefix", "dtype", "B", "T",
                                            "H", "KV", "dh", "window")
                          + timed_keys if k in r} for r in prefills],
        })
    cli_eps = ", ".join(f"{a} {r['eps']:.1f} ({r['steady_eps']:.1f} after "
                        f"set-up)" for a, r in xp["runs"].items())
    overheads = ", ".join(f"{m} {100 * o['overhead']:.1f} %"
                          for m, o in observing.items() if m != "sanitized")
    print(f"[8] main path events/s: dsgd_aau N=256 sparse_scan {eps_sparse:.1f}, "
          f"dsgd_sync N=256 scan {res_d.total_events / wall_d:.1f}, dsgd_aau "
          f"N=256 per_event {per_event['eps']:.1f}, fused N=256 ad_psgd "
          f"{fused['ad_psgd']['eps']:.1f} / agp {fused['agp']['eps']:.1f}; serve "
          f"{ARCH}: prefill {served['prefill_tok_s']:.1f} prompt tok/s, time to "
          f"first token {', '.join(f'{t:.4f}' for t in served['ttft'])} s, "
          f"decode {served['decode_tok_s']:.1f} tok/s, peak "
          f"{served['peak_bytes'] / 2**30:.2f} GiB; CLI cell {cli_eps} "
          f"events/s; telemetry overhead {overheads}; "
          f"total {time.perf_counter() - t_start:.1f} s")
    print(f"[8] dense LM paths: serve {DENSE_ARCH} ({served_dense['n_params']:,} "
          f"parameters): prefill {served_dense['prefill_tok_s']:.1f} prompt "
          f"tok/s, time to first token "
          f"{', '.join(f'{t:.4f}' for t in served_dense['ttft'])} s, decode "
          f"{served_dense['decode_tok_s']:.1f} tok/s, peak "
          f"{served_dense['peak_bytes'] / 2**30:.2f} GiB; train " + "; ".join(
              f"{k} {v['eps']:.2f} events/s (device idle "
              f"{100 * v['idle']:.1f} %, loss {v['loss'][0]:.4f} -> "
              f"{v['loss'][1]:.4f})" for k, v in trained.items()))
    for arch, layers, tag in MOE_SERVE:
        m = served_moe[arch]
        print(f"[8] MoE serve {arch} ({m['n_params']:,} parameters, "
              f"{m['n_layers']} of {m['published_layers']} layers): prefill "
              f"{m['prefill_tok_s']:.1f} prompt tok/s, time to first token "
              f"{', '.join(f'{t:.4f}' for t in m['ttft'])} s, decode "
              f"{m['decode_tok_s']:.1f} tok/s, peak per wave "
              f"{', '.join(f'{b / 2**30:.2f}' for b in m['wave_peaks'])} GiB")
    for arch, tag in MM_SERVE:
        m = served_mm[arch]
        pw = m["prefixed"]
        print(f"[8] serve {arch} ({m['n_params']:,} parameters, all "
              f"{m['n_layers']} layers): prefill {m['prefill_tok_s']:.1f} prompt "
              f"tok/s, time to first token "
              f"{', '.join(f'{t:.4f}' for t in m['ttft'])} s, decode "
              f"{m['decode_tok_s']:.1f} tok/s, peak per wave "
              f"{', '.join(f'{b / 2**30:.2f}' for b in m['wave_peaks'])} GiB"
              + (f"; prefix wave (length {pw['length']}): first token "
                 f"{pw['first_token_s']:.4f} s, decode {pw['decode_tok_s']:.1f} "
                 f"tok/s, peak {pw['peak_bytes'] / 2**30:.2f} GiB" if pw else
                 f"; decode state {m['state_bytes']:,} bytes"))
    print(f"[8] training {ARCH} at full width and depth (4 workers, seq 4096, "
          f"global batch 8): {trained_full['steady_s']:.3f} s/step, "
          f"{trained_full['tokens_per_s']:.1f} tokens/s, peak "
          f"{trained_full['peak_bytes'] / 2**30:.2f} GiB; losses "
          f"{', '.join(f'{x:.4f}' for x in trained_full['losses'])}; "
          f"total {time.perf_counter() - t_start:.1f} s")
    print(f"[8] the launch stack: phase 28 (stacked, 2 pods × 2 workers, seq "
          f"1024) {pod_step['seconds']:.3f} s a step, peak "
          f"{pod_step['peak_bytes'] / 2**30:.2f} GiB; phase 29 (sharded, NCCL, "
          f"world size 1) {sharded['sharded_s']:.3f} s vs stacked "
          f"{sharded['stacked_s']:.3f} s, peak "
          f"{sharded['peak_bytes'] / 2**30:.2f} GiB, bit-equal "
          f"{sharded['bit_equal']}; the launcher at WORLD_SIZE=1 "
          f"{launcher['wall']:.1f} s, bit-equal {launcher['bit_equal']}; dry run "
          f"{DRYRUN_PAIR[0]} x {DRYRUN_PAIR[1]}: "
          f"{dry['flops']:.4e} FLOP a rank, dominant {dry['dominant']}")
    print(f"[8] the example drivers: quickstart {examples['quickstart']['wall']:.1f} "
          f"s, a straggler_ablation cell {examples['ablation_cell']['wall']:.1f} s, "
          f"serve_batched rwkv6-1.6b "
          f"{examples['serve_rwkv6-1.6b']['tok_s']:.1f} tok/s, recurrentgemma-2b "
          f"{examples['serve_recurrentgemma-2b']['tok_s']:.1f} tok/s (reduced)")
    print("[8] seconds by phase: " + ", ".join(f"{k} {v:.1f}"
                                              for k, v in phase_s.items()))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
