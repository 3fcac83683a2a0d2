"""Times of the port's kernels on one source tree, for an A/B of two.

    python src/repro_torch/xp/kernel_times.py [--src DIR] [--kernels K]

Imports ``repro_torch`` from ``DIR`` (a tree's ``src`` directory; by
default the tree this file lies in) and, on one CUDA card, times the kernel
wrappers that every tree of the port has had since they were ported, at
``chip_smoke.py``'s phase-2 shapes (read from the ``chip_smoke.py`` beside
this file's tree) and with the timing functions of this file's tree
(``repro_torch/profiling.py``), whichever tree is timed:

- ``masked_gossip`` at N = 256, float32, at each leaf width of the paper's
  2-NN, and summed over the six leaves: the kernel's share of one dense
  event;
- ``scatter_rows`` at the rungs A = 2, 16, 64, 256 (all lanes valid)
  at each leaf width, float32, beside ``index_copy_``;
- ``sparse_gossip`` at D = 65536, float32, gathered from N = 256: all
  lanes valid at each rung (``full``), a merged row of the main path at
  A = 64 (``merged``, ``chip_smoke.lanes``) and, at the 100m preset's
  widest leaf, A = 8 of N = 8 (``lm``), beside ``index_select`` and
  two matrix products; and, where the tree's wrapper can force a body
  (``body=``), both bodies at A = 8-64 (``crossover``: the rows that set
  the dispatch rule of ``csrc/sparse_gossip.cu``);
- ``gossip_mix`` at N = 256 over the leaf widths and
  ``gossip_mix_batched`` at E = 32, N = 64, D = 65536, float32;
- ``gossip_mix`` and ``masked_gossip`` at D = 65536, float32 and
  bfloat16, N = 2-64 (``crossover``: the rows that set the dense rule,
  ``SMALL_N`` of ``csrc/small_mix.cuh``): both bodies where the tree's
  wrappers can force one (``body=``; the CUDA-core body to its
  ``CORES_MAX_N``), else the tree's rule; and at the LM paths' widths
  (``lm``): ``gossip_mix`` at
  phase 26's N = 4 of D = 655,360,000 and ``masked_gossip`` at the 100m
  preset's N = 8 of D = 21,233,664, both dtypes, beside the library call
  in bfloat16 and float32 respectively;
- ``swa_attention`` in bf16 through its (B·H, T, dh) entry at the seven
  no-window prefill shapes of ``chip_smoke.py`` phase 2 (qwen3-8b at
  ``SWA_DENSE``, then B = 4 at the longer serve wave, T = 3561, for each
  attention arch of phases 19-24, and behind the audio and vlm archs' stub
  prefix) and at the windowed ``SWA_MAIN``, beside SDPA with its own
  causal mask (with the band as a mask tensor at ``SWA_MAIN``), each with
  its bound.

``--kernels gossip`` or ``--kernels swa_attention`` times one family.

Each case reports ``device_ms`` (L2 emptied before each call; the count of
device events per call is held to whole multiples, since the trees'
kernels may launch different numbers), ``ms`` (CUDA events around
back-to-back calls) and ``host_us``, as ``chip_smoke.py`` phase 2 does,
and the library call's ``library_device_ms``.  Prints the card's name and
power limit, then one JSON object.  Two versions are compared by running
this script on both trees in one call on one card, in turns (A, B, B, A).
Needs a CUDA device; builds the kernels it times with the tree's own build
module.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve()
ROOT = HERE.parents[3]


def _module(name: str, path: Path):
    """Load the file ``path`` as module ``name``, apart from any tree's
    package (``profiling.py`` imports nothing of the port)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(smoke, timing) -> dict:
    import torch
    from repro_torch.kernels.gossip_mix import ops as gossip_ops
    from repro_torch.kernels.sparse_gossip import ops as sparse_ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    flush = timing.l2_flush(dev)
    reps = smoke.REPS

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    def figures(fn, library=None) -> dict:
        row = dict(device_ms=timing.device_ms(fn, reps, flush=flush),
                   ms=timing.time_ms(fn, reps), host_us=timing.host_us(fn, reps))
        if library is not None:
            row.update(library_device_ms=timing.device_ms(library, reps,
                                                          flush=flush),
                       library_ms=timing.time_ms(library, reps))
        return row

    N = smoke.N_MAIN
    P = torch.rand(N, N, generator=gen) + torch.eye(N)
    P = (P / P.sum(1, keepdim=True)).to(dev)
    mask = (torch.rand(N, generator=gen) < 0.5).float().to(dev) * 0.2
    Q = (mask[:, None] * P).contiguous()
    out = {"masked_gossip": {}, "gossip_mix": {}, "scatter_rows": {},
           "sparse_gossip": {}}
    for D in smoke.D_LEAVES:
        W, G = rnd(N, D, scale=0.1), rnd(N, D, scale=0.5)
        out["masked_gossip"][D] = figures(
            lambda: gossip_ops.masked_gossip_cuda(W, G, P, Q),
            lambda: P.T @ W - Q.T @ G)
        out["gossip_mix"][D] = figures(
            lambda: gossip_ops.gossip_mix_cuda(W, P),
            lambda: torch.matmul(P.T, W))
    for key in ("device_ms", "ms", "library_device_ms"):
        out["masked_gossip"][f"dense_event_{key}"] = sum(
            out["masked_gossip"][D][key] for D in smoke.NN_LEAVES)
    for A in smoke.A_RUNGS:
        w = torch.randperm(N, generator=gen)[:A].to(dev, torch.int32)
        wl = w.long()
        for D in smoke.D_LEAVES:
            X, rows = rnd(N, D), rnd(A, D)
            out["scatter_rows"][f"A={A},D={D}"] = figures(
                lambda: sparse_ops.scatter_rows_cuda(X, rows, w),
                lambda: X.index_copy_(0, wl, rows))
    D = 65536
    W = rnd(N, D, scale=0.1)
    bodies = ("cores", "tensor") if "body" in inspect.signature(
        sparse_ops.sparse_gossip_cuda).parameters else ()
    cases = [(A, "full") for A in smoke.A_RUNGS] + [(smoke.MERGED_A, "merged")]
    cases += [(A, "crossover") for A in (8, 16, 24, 32, 48, 64) if bodies]
    for A, kind in cases:
        w, block = smoke.lanes(gen, A, N, dev, "merged" if kind == "merged"
                               else "full")
        vf = (w >= 0).float()
        Ps = torch.rand(A, A, generator=gen).to(dev) * block.to(dev)
        Ps = (Ps * vf[:, None] * vf[None, :]).contiguous()
        Qs = (0.2 * vf[:, None] * Ps).contiguous()
        gidx = torch.where(w >= 0, w, 0).to(torch.int32)
        G = rnd(A, D, scale=0.5)
        library = lambda: Ps.T @ W.index_select(0, gidx.long()) - Qs.T @ G
        if kind != "crossover":
            out["sparse_gossip"][f"A={A},{kind}"] = figures(
                lambda: sparse_ops.sparse_gossip_cuda(W, G, Ps, Qs, gidx),
                library)
            continue
        for body in bodies:
            if body == "cores" and A > 32:
                continue
            out["sparse_gossip"][f"A={A},crossover,{body}"] = figures(
                lambda: sparse_ops.sparse_gossip_cuda(W, G, Ps, Qs, gidx,
                                                      body=body))
    # sparse_gossip at the 100m preset's widest leaf, A = 8 lanes of N = 8
    n, d = smoke.LM_N, smoke.LM_LEAF_D
    W, G = rnd(n, d, scale=0.1), rnd(n, d, scale=0.5)
    Ps = torch.rand(n, n, generator=gen) + torch.eye(n)
    Ps = (Ps / Ps.sum(1, keepdim=True)).to(dev)
    Qs = (0.2 * Ps).contiguous()
    gidx = torch.randperm(n, generator=gen).to(dev, torch.int32)
    out["sparse_gossip"][f"A={n},N={n},D={d},lm"] = figures(
        lambda: sparse_ops.sparse_gossip_cuda(W, G, Ps, Qs, gidx),
        lambda: Ps.T @ W.index_select(0, gidx.long()) - Qs.T @ G)
    del W, G
    measure_dense(smoke, timing, gossip_ops, out, dev, gen, figures, flush)
    E, n, D = smoke.BATCHED_MAIN
    Wb = rnd(E, n, D)
    Pb = torch.rand(E, n, n, generator=gen)
    Pb = (Pb / Pb.sum(-1, keepdim=True)).to(dev)
    out["gossip_mix_batched"] = {f"E={E},N={n},D={D}": figures(
        lambda: gossip_ops.gossip_mix_batched_cuda(Wb, Pb),
        lambda: torch.bmm(Pb.transpose(1, 2), Wb))}
    return out


def measure_dense(smoke, timing, gossip_ops, out, dev, gen, figures,
                  flush) -> None:
    """The dense products' ``crossover`` and ``lm`` rows (see the module's
    docstring) into ``out["gossip_mix"]`` and ``out["masked_gossip"]``."""
    import torch
    forced = "body" in inspect.signature(gossip_ops.gossip_mix_cuda).parameters
    widest = getattr(gossip_ops, "CORES_MAX_N", 0)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    def operands(n, d, dt):
        dg = torch.Generator(device=dev).manual_seed(n + d)
        W = torch.randn(n, d, generator=dg, device=dev).to(dt)
        G = (torch.randn(n, d, generator=dg, device=dev) * 0.5).to(dt)
        P = torch.rand(n, n, generator=gen) + torch.eye(n)
        P = (P / P.sum(1, keepdim=True)).to(dev, dt)
        Q = (0.2 * P).contiguous()
        return W, G, P, Q

    def bodies(n):
        if not forced:
            return {"rule": {}}
        return {b: dict(body=b) for b in ("cores", "tensor")
                if b == "tensor" or n <= widest}

    for dname, dt in dts.items():
        for n in (2, 4, 8, 16, 24, 32, 48, 64):
            W, G, P, Q = operands(n, 65536, dt)
            for b, kw in bodies(n).items():
                key = f"N={n},D=65536,{dname},crossover,{b}"
                out["gossip_mix"][key] = figures(
                    lambda: gossip_ops.gossip_mix_cuda(W, P, **kw))
                out["masked_gossip"][key] = figures(
                    lambda: gossip_ops.masked_gossip_cuda(W, G, P, Q, **kw))
            del W, G
    reps = getattr(smoke, "TRAIN_MIX_REPS", 5)

    def device_or_none(fn) -> dict:
        # the profiler has dropped events of a few-call window at these
        # shapes (a call whose events are not whole then fails every try):
        # the row keeps the CUDA-event time and says why it has no other
        try:
            return dict(device_ms=timing.device_ms(fn, reps, flush=flush))
        except RuntimeError as err:
            return dict(device_ms=None, device_ms_error=str(err)[:200])
    for kernel, (n, d), lib_dtype in (
            ("gossip_mix", smoke.TRAIN_MIX, "bfloat16"),
            ("masked_gossip", (smoke.LM_N, smoke.LM_LEAF_D), "float32")):
        for dname, dt in dts.items():
            W, G, P, Q = operands(n, d, dt)
            if kernel == "gossip_mix":
                del G
                call = lambda **kw: gossip_ops.gossip_mix_cuda(W, P, **kw)
                library = lambda: torch.matmul(P.T, W)
            else:
                call = lambda **kw: gossip_ops.masked_gossip_cuda(W, G, P, Q, **kw)
                library = lambda: P.T @ W - Q.T @ G
            for b, kw in bodies(n).items():
                row = dict(device_or_none(lambda: call(**kw)),
                           ms=timing.time_ms(lambda: call(**kw), reps))
                if dname == lib_dtype and b != "tensor":
                    lib = device_or_none(library)
                    row.update(library_device_ms=lib.pop("device_ms"),
                               library_ms=timing.time_ms(library, reps),
                               **{f"library_{k}": v for k, v in lib.items()})
                out[kernel][f"N={n},D={d},{dname},lm,{b}"] = row
            del W, P, Q
            if kernel == "masked_gossip":
                del G
            torch.cuda.empty_cache()


def swa_shapes(smoke) -> dict:
    """The timed ``swa_attention`` shapes, (B, T, H, KV, dh, window) by
    name, from ``chip_smoke.py``'s constants and the tree's configs."""
    from repro_torch.configs import get_config
    B, T, H, KV, dh, _ = smoke.SWA_DENSE
    shapes = {smoke.DENSE_ARCH: (B, T, H, KV, dh, T)}
    T0 = max(smoke.SERVE_PADDED)
    for arch in ([a for a, _, _ in smoke.MOE_SERVE]
                 + [a for a, _ in smoke.MM_SERVE]):
        cfg = get_config(arch)
        if cfg.is_attention_free:
            continue
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
        shapes[arch] = (4, T0, *heads, T0)
        P = cfg.n_prefix_tokens
        if P:
            shapes[f"{arch} + {P} prefix"] = (4, T0 + P, *heads, T0 + P)
    shapes[f"{smoke.ARCH} window"] = smoke.SWA_MAIN
    return shapes


def measure_swa(smoke, timing) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.swa_attention import ops as swa_ops

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    flush = timing.l2_flush(dev)
    out = {}
    for name, (B, T, H, KV, dh, window) in swa_shapes(smoke).items():
        g = H // KV
        q, k, v = (torch.randn(B * n, T, dh, generator=gen).to(dev, torch.bfloat16)
                   for n in (H, KV, KV))
        q4 = q.reshape(B, H, T, dh)
        k4, v4 = (t.reshape(B, KV, 1, T, dh).expand(B, KV, g, T, dh)
                  .reshape(B, H, T, dh) for t in (k, v))
        pos = torch.arange(T, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        mask = dict(is_causal=True) if window >= T else dict(attn_mask=band)
        fn = lambda: swa_ops.swa_attention_cuda(q, k, v, window=window, n_groups=g)
        library = lambda: F.scaled_dot_product_attention(q4, k4, v4, **mask)
        bound, by = smoke.bound_ms((2 * q.numel() + 2 * k.numel()) * 2,
                                   4.0 * B * H * smoke.band_pairs(T, window) * dh,
                                   "bfloat16")
        reps = 20
        out[name] = dict(
            shape=dict(B=B, T=T, H=H, KV=KV, dh=dh, window=window),
            device_ms=timing.device_ms(fn, reps, flush=flush),
            ms=timing.time_ms(fn, reps),
            library_device_ms=timing.device_ms(library, reps, flush=flush),
            library_ms=timing.time_ms(library, reps),
            library="SDPA " + ("is_causal" if window >= T else "band mask"),
            bound_ms=bound, bound_by=by)
        del q, k, v, q4, k4, v4, band
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=HERE.parents[2],
                    help="the src directory of the tree to time")
    ap.add_argument("--kernels", choices=("all", "gossip", "swa_attention"),
                    default="all", help="time one family of kernels")
    args = ap.parse_args(argv)
    src = args.src.resolve()
    smoke = _module("chip_smoke_shapes", ROOT / "chip_smoke.py")
    timing = _module("kernel_times_profiling",
                     HERE.parents[1] / "profiling.py")
    # run as a file, sys.path[0] is this file's directory: the tree's src
    # takes its place, so repro_torch is imported from that tree alone
    sys.path[0] = str(src)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs a CUDA device")
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise SystemExit(f"kernel_times: imported {repro_torch.__file__}, "
                         f"not the tree under {src}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    times = {}
    if args.kernels in ("all", "gossip"):
        times.update(measure(smoke, timing))
    if args.kernels in ("all", "swa_attention"):
        times["swa_attention"] = measure_swa(smoke, timing)
    print(json.dumps({"src": str(src), "card": card, **times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
