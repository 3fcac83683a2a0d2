// gossip_mix: the plain consensus mix  out = Pᵀ·W, single and batched, on
// the tensor cores.
//
// Replaces the TPU kernels repro/kernels/gossip_mix/kernel.py:
// gossip_mix_pallas (body _gossip_kernel) and gossip_mix_batched_pallas
// (body _gossip_batched_kernel).  W is an (N, D) worker-stacked leaf and P
// the (N, N) consensus matrix; out[j, d] = Σ_i P[i, j]·W[i, d], summed in
// float32 and rounded once to W's dtype.  The batched entry point takes E
// such problems stacked as W (E, N, D), P (E, N, N); the single one is its
// E = 1 case.
//
// What bounds it on an H100.  A float32 product at float32 parity costs
// three TF32 tensor-core products (495 TFLOP/s, 165 TFLOP/s effective):
// - gossip_mix at N = 256, D = 65536, float32: 3·2·N²·D = 25.8 GFLOP /
//   495 TFLOP/s = 0.052 ms, against 2·N·D·4 B = 134 MB / 3.35 TB/s =
//   0.040 ms -- bound by operations, but only just, so the loads in flight
//   matter as much as the MMA rate.
// - gossip_mix_batched at E = 32, N = 64, D = 65536, float32: 1.07 GB of
//   W and out / 3.35 TB/s = 0.32 ms -- bound by bytes.
// - bfloat16: one TF32 product is exact, so half the bytes and a third of
//   the MMAs.
//
// Design: the one-operand-pair case of the 3xTF32 wgmma product in
// tf32_mix.cuh (split-Bᵀ prepass, 3-stage cp.async ring of W slabs, per-slab
// float32 partial sums), which masked_gossip.cu runs with a second pair.
#include "tf32_mix.cuh"

// out (N, D) = Pᵀ·W; every operand contiguous, one dtype; scratch holds
// 2·N·Kp float32 (Kp = N rounded up to a multiple of 32).
extern "C" int gossip_mix_launch(int dtype, const void* W, const void* P,
                                 void* out, void* scratch, int N, int D,
                                 void* stream) {
  return repro::tf32mix::dispatch<1>(dtype, W, nullptr, P, nullptr, out,
                                     scratch, 1, N, D, stream);
}

// out[e] (N, D) = P[e]ᵀ·W[e] for e < E; W, out (E, N, D), P (E, N, N);
// scratch holds E·2·N·Kp float32.
extern "C" int gossip_mix_batched_launch(int dtype, const void* W,
                                         const void* P, void* out,
                                         void* scratch, int E, int N, int D,
                                         void* stream) {
  return repro::tf32mix::dispatch<1>(dtype, W, nullptr, P, nullptr, out,
                                     scratch, E, N, D, stream);
}
