// masked_gossip: the dense DSGD event update  out = Pᵀ·W − Qᵀ·G.
//
// Replaces the TPU kernel repro/kernels/gossip_mix/kernel.py:
// masked_gossip_pallas (body _masked_gossip_kernel).  W, G are (N, D)
// worker-stacked leaves, P the (N, N) consensus matrix and Q = diag(η·mask)·P
// (folded by the wrapper), so out = Pᵀ·(W − η·mask⊙G) in one pass without
// the masked-gradient intermediate.  out[j, d] = Σ_i P[i,j]·W[i,d] − Q[i,j]·G[i,d].
//
// What bounds it on an H100: at the main path's N = 256 and the 2-NN's
// largest leaf D = 65536 it does 2·2·N²·D = 17.2 GFLOP against 3·N·D·4 B =
// 201 MB in float32.  At float32 parity a product costs three TF32
// tensor-core products: 51.5 GFLOP / 495 TFLOP/s = 0.104 ms, against
// 0.060 ms for the bytes -- bound by operations.
//
// Design: the update is one product of depth 2N over stacked operands,
// out = [−Q; P]ᵀ·[G; W], so it runs the two-operand-pair case of the
// 3xTF32 wgmma product in tf32_mix.cuh that gossip_mix.cu shares: a
// prepass writes [−Qᵀ | Pᵀ] split into TF32 hi and lo, each half padded
// to Kp on its own, and the main loop walks 2·Kp/32 slabs, copying its A
// rows from G for the first half and from W for the second, each from its
// own pointer (the stacked [G; W] is never written to device memory).
// Each slab sums into a fresh float32 partial sum, as in gossip_mix; the
// step half goes first, so that its small partial sums are rounded into a
// total that is still small.
#include "tf32_mix.cuh"

// out (N, D) = Pᵀ·W − Qᵀ·G; every operand contiguous, one dtype; scratch
// holds 2·N·2·Kp float32 (Kp = N rounded up to a multiple of 32).
extern "C" int masked_gossip_launch(int dtype, const void* W, const void* G,
                                    const void* P, const void* Q, void* out,
                                    void* scratch, int N, int D, void* stream) {
  return repro::tf32mix::dispatch<2>(dtype, W, G, P, Q, out, scratch, 1, N,
                                     D, stream);
}
