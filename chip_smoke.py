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
8. (printed last) a ``{"kernels": [...]}`` line, the card's name and power
   limit, and the final ``{"ok": true, "device": ...}`` line.
"""
from __future__ import annotations

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
    row = dict(ms=time_ms(fn, reps),
               device_ms=device_ms(fn, reps, launches, flush),
               host_us=host_us(fn, reps), plain_ms=time_ms(plain, plain_reps),
               library_ms=None, library_device_ms=None)
    if library is not None:
        row.update(library_ms=time_ms(library, reps),
                   library_device_ms=device_ms(library, reps, flush=flush))
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
              timed=False):
    import torch
    import torch.nn.functional as F
    q = torch.randn(B * H, T, dh, generator=gen).to(device, dt)
    k = torch.randn(B * KV, T, dh, generator=gen).to(device, dt)
    v = torch.randn(B * KV, T, dh, generator=gen).to(device, dt)
    g = H // KV
    out = swa_ops.swa_attention_cuda(q, k, v, window=window, n_groups=g)
    ref = swa_ops.swa_attention_plain(q, k, v, window=window, n_groups=g)
    torch.cuda.synchronize()
    row = dict(kernel="swa_attention", dtype=dname, B=B, T=T, H=H, KV=KV,
               dh=dh, window=window, max_abs_err=close(out, ref, dname, SWA_TOL))
    s = q.element_size()
    row["bound_ms"], row["bound_by"] = bound_ms(
        (2 * q.numel() + 2 * k.numel()) * s,
        4.0 * B * H * band_pairs(T, window) * dh, dname)
    if timed:
        pos = torch.arange(T, device=device)
        band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        q4 = q.reshape(B, H, T, dh)
        k4 = k.reshape(B, KV, 1, T, dh).expand(B, KV, g, T, dh).reshape(B, H, T, dh)
        v4 = v.reshape(B, KV, 1, T, dh).expand(B, KV, g, T, dh).reshape(B, H, T, dh)
        row.update(timings(
            lambda: swa_ops.swa_attention_cuda(q, k, v, window=window,
                                               n_groups=g), 20,
            lambda: swa_ops.swa_attention_plain(q, k, v, window=window,
                                                n_groups=g), 2,
            lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=band)))
    return row


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


def serve_full_width(device, build_s: float) -> dict:
    """Phase 6: RecurrentGemma-2B at full width behind BatchedServer."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.transformer import decode_step, init_model, prefill

    cfg = get_config(ARCH)
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
    print(f"[6] {ARCH}: {n_params:,} parameters in {cfg.param_dtype}; set-up "
          f"{build_s + setup:.2f} s (build {build_s:.2f}, init and warm-up "
          f"{setup:.2f}); cache_len {cache_len}")
    torch.cuda.reset_peak_memory_stats(device)
    launches = {"linear_scan": 0, "swa_attention": 0}
    n_rec = sum(1 for pt in cfg._pattern_expanded() if pt == "rec")
    n_attn = cfg.n_layers - n_rec
    for w, wave in enumerate(waves):
        reset_counts()
        server.run(wave)
        counts = read_counts()
        st = server.stats[-1]
        print(f"[6] wave {w}: batch {st.batch}, prompts "
              f"{[len(r.prompt) for r in wave]} padded to {st.padded_len}")
        print(f"[6] wave {w}: time to first token {st.first_token_s:.4f} s")
        print(f"[6] wave {w}: prefill {st.prompt_tokens / st.first_token_s:.1f} "
              f"prompt tok/s ({st.batch * st.padded_len / st.first_token_s:.1f} "
              f"with padding)")
        print(f"[6] wave {w}: decode {st.batch * st.decode_steps / st.decode_s:.1f} "
              f"tok/s ({st.decode_steps} steps in {st.decode_s:.4f} s)")
        print(f"[6] wave {w}: launches {counts}")
        require(st.padded_len > cfg.attn_window,
                f"wave {w} is not longer than the window")
        require(counts["linear_scan"] == n_rec and counts["swa_attention"] == n_attn,
                f"wave {w} launched {counts}, not {n_rec} linear_scan and "
                f"{n_attn} swa_attention")
        for k in launches:
            launches[k] += counts[k]
    peak = torch.cuda.max_memory_allocated(device)
    reqs = [r for w in waves for r in w]
    n_out = sum(len(r.out) for r in reqs)
    print(f"[6] {n_out} tokens for {len(reqs)} requests")
    print(f"[6] max_memory_allocated {peak / 2**30:.2f} GiB")
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
    logits2, _ = decode_step(model, cfg, cur, state, T)
    require(bool(torch.isfinite(logits).all() and torch.isfinite(logits2).all()),
            "non-finite logits")
    require(cur.tolist() == [r.out[0] for r in wave]
            and logits2.argmax(-1).tolist() == [r.out[1] for r in wave],
            "prefill/decode_step disagree with the server's tokens")
    ttft = [s.first_token_s for s in server.stats[1:]]
    return dict(launches=launches, peak_bytes=peak, ttft=ttft,
                prefill_tok_s=sum(s.prompt_tokens for s in server.stats[1:]) / sum(ttft),
                decode_tok_s=sum(s.batch * s.decode_steps for s in server.stats[1:])
                / sum(s.decode_s for s in server.stats[1:]))


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

    # -- 2. kernels vs plain versions ---------------------------------------
    t0 = time.perf_counter()
    rows = (check_kernels(device) + check_mix_kernels(device)
            + check_sequence_kernels(device))
    _FLUSH.clear()   # else its buffer counts in phase 6's peak memory
    print(f"[2] {len(rows)} kernel comparisons within tolerance "
          f"({time.perf_counter() - t0:.1f} s); times in ms:")
    for r in rows:
        if "ms" in r:
            print("    " + json.dumps(r))
    for r in rows:
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

    # -- 6. serve path: RecurrentGemma-2B at full width ---------------------
    served = serve_full_width(device, build_s)

    # -- 7. card vs CPU: the reduced RecurrentGemma -------------------------
    serve_card_vs_cpu(device)

    # -- 9-10. per_event at N=256; per_event vs scan and CPU at N=64 ---------
    per_event = per_event_paths(device)

    # -- 11. fused AD-PSGD and AGP at N=256; card vs CPU at N=16 --------------
    fused = fused_paths(device)

    # -- 12. gossip_mix_batched on a real EventBatch -------------------------
    batched = batched_on_events(device, per_event["trainer64"])

    # -- 13. the experiment CLI on one paper_figures cell at N=256 -----------
    xp = xp_cli(device, card=card)

    # -- 14. telemetry and trace, card vs CPU --------------------------------
    observed_card_vs_cpu(device)

    # -- 15. the cost of observing; the sanitizer ----------------------------
    observing = observing_cost(device)

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
    kernels = []
    for kname, (source, replaces, sel) in meta.items():
        mine = [r for r in rows if r["kernel"] == kname]
        at = [r for r in mine if "ms" in r
              and all(r.get(k) == v for k, v in sel.items())][0]
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
