"""Peak rates of the tensor-core instructions open to the port's kernels.

    python -m repro_torch.xp.tensor_core_rates

Builds ``tensor_core_rates.cu`` with nvcc (into ``build/repro_torch/``) and
times three loops of back-to-back MMAs on the card, operands kept in
registers or shared memory so that only the MMA pipe is timed:
``mma.sync`` m16n8k8 TF32, ``mma.sync`` m16n8k16 bf16 and ``wgmma``
m64n64k8 TF32, each at one and two blocks of 256 threads per SM.  Prints
TFLOP/s per instruction beside the card's name and power limit: the
ceiling a kernel built on that instruction can reach (the gossip_mix
kernel's choice of wgmma over mma.sync rests on it).  Needs a CUDA device.
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

PROBES = ((0, "mma.sync m16n8k8 tf32", 16 * 16 * 8 * 8 * 2),
          (1, "mma.sync m16n8k16 bf16", 16 * 16 * 8 * 16 * 2),
          (2, "wgmma m64n64k8 tf32", 4 * 64 * 64 * 8 * 2))
ITERS = 4000


def main() -> int:
    import torch
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        raise SystemExit("tensor_core_rates: needs a CUDA device")
    src = Path(__file__).with_suffix(".cu")
    lib_path = build.BUILD_DIR / "libtensor_core_rates.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib_path), str(src)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.tensor_core_probe.argtypes = [ctypes.c_int, ctypes.c_void_p] + \
        [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.tensor_core_probe.restype = ctypes.c_int
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True).stdout.strip()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(2 * sms * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    print(f"card: {card}")
    for which, name, flop_per_iter in PROBES:
        for per_sm in (1, 2):
            blocks, threads = sms * per_sm, 256
            units = blocks * threads // (128 if which == 2 else 32)
            lib.tensor_core_probe(which, out.data_ptr(), blocks, threads, 10,
                                  stream)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            status = lib.tensor_core_probe(which, out.data_ptr(), blocks,
                                           threads, ITERS, stream)
            end.record()
            end.synchronize()
            if status:
                raise RuntimeError(f"{name}: launch failed with {status}")
            ms = start.elapsed_time(end)
            rate = units * ITERS * flop_per_iter / (ms * 1e-3) / 1e12
            print(f"{name}: {per_sm} block(s) of {threads} threads per SM: "
                  f"{rate:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
