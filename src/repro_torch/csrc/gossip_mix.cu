// gossip_mix: the plain consensus mix  out = Pᵀ·W, single and batched.
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
// - N = 256, D = 65536, float32 (the per_event path): 3·2·N²·D = 25.8
//   GFLOP / 495 TFLOP/s = 0.052 ms, against 2·N·D·4 B = 134 MB / 3.35 TB/s
//   = 0.040 ms -- bound by operations, but only just.
// - N = 4, D = 655,360,000, bfloat16 (launch/steps.py's gossip of the
//   embed leaf, 4 workers): 10.5 GB read and written / 3.35 TB/s =
//   3.13 ms against 2·N = 8 FLOP an element -- bound by bytes.
// - gossip_mix_batched at E = 32, N = 64, D = 65536, float32: 1.07 GB of
//   W and out / 3.35 TB/s = 0.32 ms -- bound by bytes.
//
// Design: two bodies and the rule of small_mix.cuh (SMALL_N, with the
// crossover table that set it).
// - N > SMALL_N: the one-operand-pair case of the 3xTF32 wgmma product in
//   tf32_mix.cuh (split-Bᵀ prepass, 3-stage cp.async ring of W slabs,
//   per-slab float32 partial sums), which masked_gossip.cu runs with a
//   second pair.  Two launches.
// - N ≤ SMALL_N: small_mix.cuh's CUDA-core body with one pair: a thread
//   streams 4 columns of every row through its ring of copies and keeps
//   all N sums in registers.  One launch, no scratch.  At N = 4 the wgmma
//   body padded k to 32 and j to 64 and took 43.77 ms at the embed leaf,
//   behind cuBLAS's 32.60-33.26; this body takes 3.4585-3.7576 ms,
//   83.3-90.5 % of the bound (chip_smoke.py phase 2 and kernel_times.py's
//   lm rows; NVIDIA H100 80GB HBM3, 700.00 W).
#include "small_mix.cuh"

// Device kernels one call launches at N under the rule (the single and the
// batched entry alike): 1 at N ≤ SMALL_N, 2 above.
extern "C" int gossip_mix_kernels(int N) {
  return repro::smallmix::dense_kernels(N);
}

// out (N, D) = Pᵀ·W; every operand contiguous, one dtype.  body: 0 follows
// the rule, 1 forces the CUDA-core body (N ≤ MAX_RB), 2 the tensor-core
// body, which alone reads scratch: 2·N·Kp float32 (Kp = N rounded up to a
// multiple of 32), 16-byte aligned.
extern "C" int gossip_mix_launch(int dtype, const void* W, const void* P,
                                 void* out, void* scratch, int N, int D,
                                 int body, void* stream) {
  return repro::smallmix::dense_dispatch<1>(dtype, W, nullptr, P, nullptr,
                                            out, scratch, 1, N, D, body,
                                            stream);
}

// out[e] (N, D) = P[e]ᵀ·W[e] for e < E; W, out (E, N, D), P (E, N, N);
// body as above; scratch holds E·2·N·Kp float32.
extern "C" int gossip_mix_batched_launch(int dtype, const void* W,
                                         const void* P, void* out,
                                         void* scratch, int E, int N, int D,
                                         int body, void* stream) {
  return repro::smallmix::dense_dispatch<1>(dtype, W, nullptr, P, nullptr,
                                            out, scratch, E, N, D, body,
                                            stream);
}
