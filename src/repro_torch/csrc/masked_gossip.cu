// masked_gossip: the dense DSGD event update  out = Pᵀ·W − Qᵀ·G.
//
// Replaces the TPU kernel repro/kernels/gossip_mix/kernel.py:
// masked_gossip_pallas (body _masked_gossip_kernel).  W, G are (N, D)
// worker-stacked leaves, P the (N, N) consensus matrix and Q = diag(η·mask)·P
// (folded by the wrapper), so out = Pᵀ·(W − η·mask⊙G) in one pass without
// the masked-gradient intermediate.  out[j, d] = Σ_i P[i,j]·W[i,d] − Q[i,j]·G[i,d].
//
// What bounds it on an H100.
// - N = 256, D = 65536, float32 (the 2-NN's dense scan): 2·2·N²·D =
//   17.2 GFLOP against 3·N·D·4 B = 201 MB.  At float32 parity a product
//   costs three TF32 tensor-core products: 51.5 GFLOP / 495 TFLOP/s =
//   0.104 ms, against 0.060 ms for the bytes -- bound by operations.
// - N = 8, D = 21,233,664, float32 (the 100m LM preset's widest leaf):
//   2.04 GB / 3.35 TB/s = 0.61 ms against 4·N = 32 FLOP an element of W
//   -- bound by bytes.
//
// Design: two bodies and the rule of small_mix.cuh (SMALL_N, with the
// crossover table that set it).
// - N > SMALL_N: the update is one product of depth 2N over stacked
//   operands, out = [−Q; P]ᵀ·[G; W], so it runs the two-operand-pair case
//   of the 3xTF32 wgmma product in tf32_mix.cuh that gossip_mix.cu shares:
//   a prepass writes [−Qᵀ | Pᵀ] split into TF32 hi and lo, each half
//   padded to Kp on its own, and the main loop walks 2·Kp/32 slabs,
//   copying its A rows from G for the first half and from W for the
//   second, each from its own pointer (the stacked [G; W] is never written
//   to device memory).  Each slab sums into a fresh float32 partial sum,
//   as in gossip_mix; the step half goes first, so that its small partial
//   sums are rounded into a total that is still small.  Two launches.
// - N ≤ SMALL_N: small_mix.cuh's CUDA-core body with two pairs: a thread
//   copies its 4 columns of W[i] and G[i] for every i through its ring and
//   sums P[i][j]·w − Q[i][j]·g in float32 FMAs, one launch, no scratch.
//   At N = 8 of the 100m leaf the wgmma body issued ~8× the useful MMAs
//   and took 3.47-3.49 ms, behind P.T@W − Q.T@G's 2.58-2.62; this body
//   takes 0.6865-0.7717 ms, 78.9-88.6 % of the bound, the operands'
//   placement moving it, not lane order or G's offset (chip_smoke.py
//   phase 2, kernel_times.py's lm rows, python -m
//   repro_torch.xp.small_mix_variants --part pairing; NVIDIA H100 80GB
//   HBM3, 700.00 W).
#include "small_mix.cuh"

// Device kernels one call launches at N under the rule: 1 at N ≤ SMALL_N,
// 2 above.
extern "C" int masked_gossip_kernels(int N) {
  return repro::smallmix::dense_kernels(N);
}

// out (N, D) = Pᵀ·W − Qᵀ·G; every operand contiguous, one dtype.  body: 0
// follows the rule, 1 forces the CUDA-core body (N ≤ MAX_RB), 2 the
// tensor-core body, which alone reads scratch: 2·N·2·Kp float32 (Kp = N
// rounded up to a multiple of 32), 16-byte aligned.
extern "C" int masked_gossip_launch(int dtype, const void* W, const void* G,
                                    const void* P, const void* Q, void* out,
                                    void* scratch, int N, int D, int body,
                                    void* stream) {
  return repro::smallmix::dense_dispatch<2>(dtype, W, G, P, Q, out, scratch,
                                            1, N, D, body, stream);
}
