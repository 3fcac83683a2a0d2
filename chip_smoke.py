"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root of a checkout (it imports ``src/repro_torch``
beside this file and builds the CUDA kernels from ``src/repro_torch/csrc``
with nvcc into ``build/repro_torch``).  It needs one CUDA device and exits
non-zero, printing no result, when there is none or when any phase fails:

1. build every kernel (one nvcc per source, in parallel) and name the card;
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes, in float32 and bfloat16, and time the kernel, the
   plain version and one PyTorch library call of the same function;
3. the main path: DSGD-AAU at N=256 with the full 2-NN through the bucketed
   active-set path (``sparse_scan``, rungs 16/64/256), 1024 events, with the
   kernels' launch counters set to 0 just before and read just after;
4. the dense path: synchronous DSGD at N=256 through the dense scan, 160
   events, counters likewise;
5. card vs CPU: DSGD-AAU at N=64 on both from the same W0;
6. a ``{"kernels": [...]}`` line, the card's name and power limit, and the
   final ``{"ok": true, "device": ...}`` line.
"""
from __future__ import annotations

import json
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
TOL = {"float32": dict(atol=2e-5, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
D_LEAVES = (16384, 65536, 256, 2560, 10)   # the 2-NN's leaf widths
N_MAIN = 256
A_RUNGS = (16, 64, 256)


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


def time_ms(fn, reps: int) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def close(out, ref, dtype: str) -> float:
    """Max |out − ref|; fails unless within the dtype's tolerance."""
    import torch
    o, r = out.to(torch.float32), ref.to(torch.float32)
    err = float((o - r).abs().max()) if o.numel() else 0.0
    tol = TOL[dtype]
    if not torch.allclose(o, r, **tol):
        fail(f"kernel disagrees with its plain version: max abs err {err} "
             f"over tolerance {tol}")
    return err


# ---------------------------------------------------------------------------
# phase 2: every kernel against its plain version
# ---------------------------------------------------------------------------

def lanes(gen, A: int, n: int, device, kind: str):
    """(A,) int32 workers: distinct, worker 0 active, ~1/4 of the lanes
    padded with -1 at random positions (``pads``), none padded (``full``),
    or all padded (``all_pad``)."""
    import torch
    if kind == "all_pad":
        return torch.full((A,), -1, dtype=torch.int32, device=device)
    perm = torch.randperm(n - 1, generator=gen)[:A - 1] + 1
    w = torch.cat([torch.zeros(1, dtype=torch.int64), perm])
    w = w[torch.randperm(A, generator=gen)]
    if kind == "pads":
        pad = torch.randperm(A, generator=gen)[:max(1, A // 4)]
        keep0 = (w[pad] == 0)
        pad = pad[~keep0]           # worker 0 stays active
        w[pad] = -1
    return w.to(torch.int32).to(device)


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
            b, by = bound_ms(nbytes, 4.0 * N * N * D, dname)
            reps = 20 if D >= 16384 else 200
            rows.append(dict(
                kernel="masked_gossip", dtype=dname, N=N, A=None, D=D,
                max_abs_err=err, bound_ms=b, bound_by=by,
                ms=time_ms(lambda: gossip_ops.masked_gossip_cuda(W, G, Pd, Q), reps),
                plain_ms=time_ms(lambda: gossip_ops.masked_gossip_plain(W, G, Pd, Q), reps),
                library_ms=time_ms(lambda: Pd.T @ W - Q.T @ G, reps)))
        # sparse_gossip and scatter_rows at the bucket rungs
        for A in A_RUNGS:
            for kind in ("full", "pads", "all_pad"):
                w = lanes(gen, A, N, device, kind)
                valid = w >= 0
                vf = valid.float()
                Ps = stochastic(A) * vf[:, None] * vf[None, :]
                ms_ = (torch.rand(A, generator=gen) < 0.7).float().to(device) * 0.2 * vf
                Ps_d = Ps.to(dt).contiguous()
                Qs = ((ms_ * vf).to(dt)[:, None] * Ps_d).contiguous()
                gidx = torch.where(valid, w, 0).to(torch.int32).contiguous()
                n_valid = int(valid.sum())
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
                    reps = 20 if D >= 16384 else 200
                    b, by = bound_ms(3 * n_valid * D * s + 2 * A * A * s + 4 * A,
                                     4.0 * n_valid * n_valid * D, dname)
                    wv = w[valid].long()
                    gv = out[valid]
                    row = dict(kernel="sparse_gossip", dtype=dname, N=N, A=A,
                               D=D, lanes=kind, max_abs_err=err, bound_ms=b,
                               bound_by=by)
                    row_s = dict(kernel="scatter_rows", dtype=dname, N=N, A=A,
                                 D=D, lanes=kind, max_abs_err=err_s)
                    row_s["bound_ms"], row_s["bound_by"] = bound_ms(
                        2 * n_valid * D * s + 4 * A, 0.0, dname)
                    if kind == "full" or (kind == "pads" and D == 65536):
                        row.update(
                            ms=time_ms(lambda: sparse_ops.sparse_gossip_cuda(
                                W, G, Ps_d, Qs, gidx), reps),
                            plain_ms=time_ms(lambda: sparse_ops.sparse_gossip_plain(
                                W, G, Ps_d, Qs, gidx), reps),
                            library_ms=time_ms(
                                lambda: Ps_d.T @ W.index_select(0, gidx.long())
                                - Qs.T @ G, reps))
                        row_s.update(
                            ms=time_ms(lambda: sparse_ops.scatter_rows_cuda(
                                Xk, out, w), reps),
                            plain_ms=time_ms(lambda: sparse_ops.scatter_rows_plain(
                                Xp, out, w), reps),
                            library_ms=time_ms(
                                lambda: Xp.index_copy_(0, wv, gv), reps))
                    rows += [row, row_s]
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


def reset_counts():
    from repro_torch.kernels.gossip_mix import ops as gossip_ops
    from repro_torch.kernels.sparse_gossip import ops as sparse_ops
    for fn in (gossip_ops.masked_gossip_cuda, sparse_ops.sparse_gossip_cuda,
               sparse_ops.scatter_rows_cuda):
        fn.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels.gossip_mix import ops as gossip_ops
    from repro_torch.kernels.sparse_gossip import ops as sparse_ops
    return {"masked_gossip": gossip_ops.masked_gossip_cuda.launches,
            "sparse_gossip": sparse_ops.sparse_gossip_cuda.launches,
            "scatter_rows": sparse_ops.scatter_rows_cuda.launches}


def drive(trainer, max_events: int, eval_every: int):
    """Set up, then run once with the launch counters zeroed just before;
    returns (result, set-up s, run wall s, launch counts of the run)."""
    import torch
    t0 = time.perf_counter()
    trainer.warmup(max_events=max_events)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    res = trainer.run(max_events=max_events, eval_every=eval_every)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    return res, setup, wall, counts


def check_history(res, what: str):
    import math
    for p in res.history:
        require(math.isfinite(p.loss) and math.isfinite(p.metric),
                f"{what}: non-finite eval {p}")


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
    print(f"[1] built {', '.join(build.SOURCES)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {src}: {line.strip()}")

    # -- 2. kernels vs plain versions ---------------------------------------
    t0 = time.perf_counter()
    rows = check_kernels(device)
    print(f"[2] {len(rows)} kernel comparisons within tolerance "
          f"({time.perf_counter() - t0:.1f} s); times in ms:")
    for r in rows:
        if "ms" in r:
            print("    " + json.dumps(r))

    # -- 3. main path: bucketed DSGD-AAU at N=256 ---------------------------
    spec = paper_spec()
    tr = build_trainer(spec, "dsgd_aau", N_MAIN, 0, batch_pool=64,
                       device=device)
    require(tr.mode == "sparse_scan", f"main path took mode {tr.mode}")
    require(tr.scheduler.active_buckets() == (16, 64, 256),
            f"unexpected ladder {tr.scheduler.active_buckets()}")
    res, setup, wall, counts_sparse = drive(tr, 1024, 256)
    check_history(res, "dsgd_aau N=256")
    print(f"[3] dsgd_aau N={N_MAIN} sparse_scan: {res.total_events} events in "
          f"{wall:.3f} s = {res.total_events / wall:.1f} events/s "
          f"(set-up {setup:.2f} s); launches {counts_sparse}")
    print("    history (k, t, loss, acc): " + ", ".join(
        f"({p.k}, {p.time:.2f}, {p.loss:.4f}, {p.metric:.3f})"
        for p in res.history))
    require(counts_sparse["sparse_gossip"] > 0 and counts_sparse["scatter_rows"] > 0,
            f"the main path launched no active-set kernel: {counts_sparse}")
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

    # -- 6. summary ----------------------------------------------------------
    launches = {"masked_gossip": counts_dense["masked_gossip"],
                "sparse_gossip": counts_sparse["sparse_gossip"],
                "scatter_rows": counts_sparse["scatter_rows"]}
    meta = {
        "masked_gossip": ("src/repro_torch/csrc/masked_gossip.cu",
                          "src/repro/kernels/gossip_mix/kernel.py:76",
                          dict(A=None)),
        "sparse_gossip": ("src/repro_torch/csrc/sparse_gossip.cu",
                          "src/repro/kernels/sparse_gossip/kernel.py:61",
                          dict(A=64, lanes="full")),
        "scatter_rows": ("src/repro_torch/csrc/scatter_rows.cu",
                         "src/repro/kernels/sparse_gossip/kernel.py:117",
                         dict(A=64, lanes="full")),
    }
    kernels = []
    for kname, (source, replaces, sel) in meta.items():
        mine = [r for r in rows if r["kernel"] == kname]
        at = [r for r in mine if r["dtype"] == "float32" and r["D"] == 65536
              and all(r.get(k) == v for k, v in sel.items())][0]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in mine
                               if r["dtype"] == "float32"),
            "max_abs_err_bf16": max(r["max_abs_err"] for r in mine
                                    if r["dtype"] == "bfloat16"),
            "ms": at["ms"], "plain_ms": at["plain_ms"],
            "bound_ms": at["bound_ms"], "bound_by": at["bound_by"],
            "library_ms": at["library_ms"],
            "shape": {"N": at["N"], "A": at["A"], "D": at["D"],
                      "dtype": "float32"},
        })
    print(f"[6] main path events/s: dsgd_aau N=256 sparse_scan {eps_sparse:.1f}, "
          f"dsgd_sync N=256 scan {res_d.total_events / wall_d:.1f}; "
          f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
