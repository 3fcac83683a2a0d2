"""Device times of the gossip products' CUDA-core body, variant by variant.

    python -m repro_torch.xp.small_mix_variants [--out FILE]

Builds ``small_mix_variants.cu`` (a copy of the body of
``csrc/small_mix.cuh`` with its accumulator template RB, its chunk width
CH and its grid chosen at run time, and the header's body itself) with
nvcc into ``build/repro_torch/`` and times, on one CUDA card, the choices
``csrc/small_mix.cuh`` fixes:

- CH: 4 columns a thread (8 bytes of bfloat16) against 8 (a 16-byte
  chunk) for bfloat16 at every RB, with each variant's registers, spilled
  bytes and resident blocks an SM;
- the grid: one tile of 64·CH columns a block (``tile``) against a grid
  of the resident blocks of every SM striding over the tiles, P loaded
  once a block (``stride``);
- the header's body (``body``: CH = 4, one tile a block, no tile loop),
  with its registers, beside the copy's ``tile`` at CH = 4;

at the LM paths' shapes (``gossip_mix`` at N = 4 of D = 655,360,000 in
bfloat16, phase 26's embed leaf; ``masked_gossip`` at N = 8 of
D = 21,233,664, the 100m preset's widest leaf, float32 and bfloat16) and
at D = 65536 for N = 2-32, one and two operand pairs.  ``--part
pairing`` times instead the two-pair product at N = 8 of D = 21,233,664,
float32, as ``masked_gossip`` (W[a] and G[a] copied in the same step)
and as ``sparse_gossip`` with its lanes gathered in order, reversed and
permuted, and with G placed at other offsets from W.  Device ms with L2
emptied before each call (``repro_torch/profiling.py``), each beside its
bound (bytes moved / 3.35 TB/s), and every output held against the plain
product.  Prints the card's name and power limit, then one JSON object.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

RBS = (2, 4, 8, 16, 32)
# (label, pairs, N, D, dtype, reps of a timing)
LM_CASES = (("gossip_mix train", 1, 4, 655_360_000, "bfloat16", 5),
            ("masked_gossip 100m", 2, 8, 21_233_664, "float32", 50),
            ("masked_gossip 100m", 2, 8, 21_233_664, "bfloat16", 50))
SMALL_D, SMALL_NS = 65536, (2, 4, 8, 16, 32)
PEAK_BYTES_PER_S = 3.35e12


def _rb(n: int) -> int:
    return next(r for r in RBS if r >= n)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("variants", "pairing"),
                    default="variants", help="which table to time")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.part == "pairing":
        return pairing(args.out)
    import torch
    from repro_torch.kernels import build
    from repro_torch.profiling import device_ms, l2_flush
    if not torch.cuda.is_available():
        raise SystemExit("small_mix_variants: needs a CUDA device")
    src = Path(__file__).with_suffix(".cu")
    lib_path = build.BUILD_DIR / "libsmall_mix_variants.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    built = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I",
                            str(build.CSRC), "-o", str(lib_path), str(src)],
                           capture_output=True, text=True)
    if built.returncode:
        raise SystemExit(f"nvcc failed:\n{built.stdout}{built.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.small_mix_variant.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
                                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.small_mix_variant.restype = ctypes.c_int
    lib.small_mix_attrs.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.small_mix_attrs.restype = ctypes.c_int
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    codes = {"float32": 0, "bfloat16": 1}
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    flush = l2_flush(dev)

    def attrs(dname, pairs, rb, ch, header=False):
        res = (ctypes.c_int * 3)()
        status = lib.small_mix_attrs(codes[dname], pairs, rb, ch, int(header),
                                     res)
        if status:
            raise RuntimeError(f"small_mix_attrs: status {status}")
        return dict(registers=res[0], spilled_bytes=res[1], resident=res[2])

    def chs(dname):
        return (4, 8) if dname == "bfloat16" else (4,)

    out = {"card": card, "sms": sms, "attrs": {}, "times": []}
    for dname in dts:
        for pairs in (1, 2):
            for rb in RBS:
                for ch in chs(dname):
                    out["attrs"][f"{dname} pairs={pairs} RB={rb} CH={ch}"] = \
                        attrs(dname, pairs, rb, ch)
                out["attrs"][f"{dname} pairs={pairs} RB={rb} body"] = \
                    attrs(dname, pairs, rb, 4, header=True)
    print(json.dumps(out["attrs"]))

    def case(label, pairs, n, d, dname, reps):
        dt = dts[dname]
        gen = torch.Generator(device=dev).manual_seed(n + d)
        W = torch.randn(n, d, generator=gen, device=dev).to(dt)
        G = (torch.randn(n, d, generator=gen, device=dev).to(dt)
             if pairs == 2 else None)
        P = torch.rand(n, n, generator=gen, device=dev)
        P = (P / P.sum(1, keepdim=True)).to(dt)
        Q = (P * 0.1).to(dt) if pairs == 2 else None
        o = torch.empty_like(W)
        f32 = torch.float32
        ref = P.to(f32).T @ W.to(f32)
        if pairs == 2:
            ref -= Q.to(f32).T @ G.to(f32)
        ref = ref.to(dt).to(f32)
        rb = _rb(n)
        nbytes = (2 + (pairs == 2)) * n * d * W.element_size()
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        stream = torch.cuda.current_stream().cuda_stream
        for ch in chs(dname):
            resident = out["attrs"][f"{dname} pairs={pairs} RB={rb} CH={ch}"][
                "resident"]
            grids = (("tile", 0), ("stride", resident * sms))
            if ch == 4:
                grids = (("body", -1),) + grids
            for grid, blocks in grids:
                def fn():
                    status = lib.small_mix_variant(
                        codes[dname], pairs, rb, ch, W.data_ptr(),
                        G.data_ptr() if G is not None else None, P.data_ptr(),
                        Q.data_ptr() if Q is not None else None, o.data_ptr(),
                        1, n, d, blocks, stream)
                    if status:
                        raise RuntimeError(f"small_mix_variant: status {status}")
                fn()
                torch.cuda.synchronize()
                err = float((o.to(f32) - ref).abs().max())
                tol = 2e-5 if dname == "float32" else 2e-2
                if not torch.allclose(o.to(f32), ref, atol=tol,
                                      rtol=1e-4 if dname == "float32" else 2e-2):
                    raise SystemExit(f"{label} {dname} N={n} CH={ch} {grid}: "
                                     f"max abs err {err}")
                ms = device_ms(fn, reps, 1, flush)
                row = dict(label=label, pairs=pairs, N=n, D=d, dtype=dname,
                           RB=rb, CH=ch, grid=grid,
                           blocks=blocks if blocks > 0 else None,
                           device_ms=ms, bound_ms=bound,
                           share=bound / ms, max_abs_err=err)
                out["times"].append(row)
                print(json.dumps(row))
        del W, G, o, ref
        torch.cuda.empty_cache()

    for label, pairs, n, d, dname, reps in LM_CASES:
        case(label, pairs, n, d, dname, reps)
    for dname in dts:
        for pairs in (1, 2):
            for n in SMALL_NS:
                case("D=65536", pairs, n, SMALL_D, dname, 200)
    print(card)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    return 0


def pairing(out_path) -> int:
    """The ``--part pairing`` table (see the module's docstring)."""
    import torch
    from repro_torch.kernels.gossip_mix import ops as gossip_ops
    from repro_torch.kernels.sparse_gossip import ops as sparse_ops
    from repro_torch.profiling import device_ms, l2_flush
    if not torch.cuda.is_available():
        raise SystemExit("small_mix_variants: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda", 0)
    flush = l2_flush(dev)
    n, d = 8, 21_233_664
    gen = torch.Generator(device=dev).manual_seed(8)
    W = torch.randn(n, d, generator=gen, device=dev)
    P = torch.rand(n, n, generator=gen, device=dev)
    P = P / P.sum(1, keepdim=True)
    Q = (0.1 * P).contiguous()
    bound = 3 * n * d * 4 / PEAK_BYTES_PER_S * 1e3
    rows = []

    def timed(label, fn, ref):
        torch.cuda.synchronize()
        err = float((fn() - ref).abs().max())
        if err > 1e-4:
            raise SystemExit(f"{label}: max abs err {err}")
        ms = device_ms(fn, 50, 1, flush)
        rows.append(dict(label=label, device_ms=ms, bound_ms=bound,
                         share=bound / ms, max_abs_err=err))
        print(json.dumps(rows[-1]))

    # G at offsets past a fresh allocation, in float32 elements
    for offset in (0, 1024, 262144 + 1024):
        buf = torch.randn(n * d + offset, generator=gen, device=dev)
        G = buf[offset:].view(n, d)
        ref = P.T @ W - Q.T @ G
        timed(f"masked_gossip, G {offset * 4} bytes into its buffer",
              lambda: gossip_ops.masked_gossip_cuda(W, G, P, Q, body="cores"),
              ref)
        if offset == 0:
            orders = {"in order": torch.arange(n),
                      "reversed": torch.arange(n - 1, -1, -1),
                      "permuted": torch.randperm(n, generator=torch.Generator()
                                                 .manual_seed(0))}
            for name, order in orders.items():
                gidx = order.to(dev, torch.int32)
                ref = P.T @ W.index_select(0, gidx.long()) - Q.T @ G
                timed(f"sparse_gossip, lanes {name} {order.tolist()}",
                      lambda: sparse_ops.sparse_gossip_cuda(W, G, P, Q, gidx),
                      ref)
        del buf, G
    print(card)
    out = {"card": card, "pairing": rows}
    print(json.dumps(out))
    if out_path:
        with open(out_path, "w", encoding="utf-8") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
