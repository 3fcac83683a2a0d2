// sparse_gossip: compact active-set mixing with the gather fused in.
//
// Replaces the TPU kernel src/repro/kernels/sparse_gossip/kernel.py:61
// sparse_gossip_pallas (body _sparse_gossip_kernel).  For an event whose A
// active workers are gidx[0..A), it computes the compact mixed rows
//
//     out[b, d] = Σ_a P_sub[a, b] · W[gidx[a], d]  −  Σ_a Q_sub[a, b] · G[a, d]
//               = ([−Q_sub; P_sub]ᵀ · [G; W[gidx]])[b, d]
//
// reading only the A gathered rows of the (N, D) carry W.  G is the (A, D)
// active-set gradient and Q_sub = diag(η·mask)·P_sub.  The wrapper clamps
// padded (-1) lanes to row 0 and zeroes their P/Q rows and columns, so their
// output rows are exactly zero; the kernels clamp indices into [0, N) on
// load as well (the gather semantics of the reference), so they never read
// outside W, and they write only out.
//
// What bounds it on an H100.  4·A²·D FLOP against 3·A·D elements moved
// (the gathered rows, G, out): 4·A/3 FLOP per element, A/3 FLOP per
// float32 byte.  At float32 parity a product costs three TF32 tensor-core
// products, 495/3 = 165 TFLOP/s, so the balance point is 165e12 / 3.35e12
// ≈ 49 FLOP/byte (the CUDA cores' 67 TFLOP/s would put it at 20).  At the
// 2-NN's widest leaf, D = 65536, float32:
// - A = 2 (the fused path): 1.6 MB, 0.0005 ms -- launch latency rules;
// - A = 16: 12.6 MB, 0.0038 ms, by bytes;
// - A = 64 (DSGD-AAU's merged and unmerged rows): 50 MB, 0.015 ms, by
//   bytes (21 FLOP/byte);
// - A = 256 (epoch barriers): 17.2 GFLOP, 0.104 ms, by operations
//   (85 FLOP/byte).
//
// Design: two bodies and one rule that picks between them.
// - A > SMALL_A: the two-pair 3xTF32 wgmma product of tf32_mix.cuh that
//   masked_gossip runs (a split prepass of [−Qᵀ | Pᵀ] into the caller's
//   scratch, then the 3-stage cp.async ring over [G; W] slabs), with the
//   W half gathered: each block copies gidx, clamped, into a table in
//   shared memory once and copies slab row k from W[table[k]].  The sum
//   order (the step half first, each slab's small terms before its large
//   ones) is masked_gossip's.  Two launches.
// - A ≤ SMALL_A: the CUDA-core body of small_mix.cuh, two pairs with W's
//   rows gathered (each block copies gidx, clamped, into shared memory):
//   a thread streams its 4 columns of W[gidx[a]] and G[a] through a ring
//   of copies and keeps all A sums in registers.  One launch, no scratch.
//   masked_gossip and gossip_mix run the same body, ungathered, at
//   N ≤ SMALL_N (its rule and table in small_mix.cuh).
// SMALL_A: at A ≤ 32 the wgmma body pads k to 32 and j to 64 columns, so
// most of its MMAs multiply zeros, and its prepass is a second launch; the
// CUDA-core body's A·4 accumulators a thread fit in its registers up to
// A = 32 (168-180 registers at RB = 32; only the bfloat16 element-wise
// variant spills, 16 bytes: ptxas -v, as kernels/build.py builds it).  The
// measurements that set the rule are at SMALL_A below.
#include "small_mix.cuh"

namespace {

// The rule: A ≤ SMALL_A runs the CUDA-core body, wider rows the wgmma body.
// Device ms with L2 emptied, float32, D = 65536, all lanes valid, wgmma
// body (prepass included) / CUDA-core body, two runs each (python
// src/repro_torch/xp/kernel_times.py, its "crossover" rows; NVIDIA H100
// 80GB HBM3, 700.00 W):
//   A =  8: 0.0143-0.0145 / 0.0042-0.0043
//   A = 16: 0.0149-0.0153 / 0.0067
//   A = 24: 0.0159-0.0163 / 0.0114
//   A = 32: 0.0176-0.0182 / 0.0142-0.0145
// and the wgmma body alone at A = 48: 0.0283-0.0284, A = 64: 0.0296-0.0297
// (the CUDA-core body's accumulators do not fit there).  The CUDA-core
// body wins at every A it can take, so the rule is its register limit.
constexpr int SMALL_A = 32;

// The wgmma body: out (A, D) = Pᵀ·W[gidx] − Qᵀ·G as tf32_mix.cuh's
// two-pair product with W's (n_w, D) rows gathered through gidx; scratch
// holds 2·A·2·Kp float32 (Kp = A rounded up to 32), 16-byte aligned.
int launch_tensor(int dtype, const void* W, const void* G, const void* P,
                  const void* Q, const int* gidx, void* out, void* scratch,
                  int n_w, int A, int D, void* stream) {
  namespace tm = repro::tf32mix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (A > tm::MAX_GATHER) return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (dtype == repro::kFloat32)
    return tm::launch<float, 2, true>(W, G, P, Q, out, scratch, 1, A, D, s,
                                      gidx, n_w);
  if (dtype == repro::kBFloat16)
    return tm::launch<__nv_bfloat16, 2, true>(W, G, P, Q, out, scratch, 1, A,
                                              D, s, gidx, n_w);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Device kernels one call launches at A lanes under the rule: 1 (the
// CUDA-core body) for A ≤ SMALL_A, 2 (prepass and wgmma body) above.
extern "C" int sparse_gossip_kernels(int A) { return A <= SMALL_A ? 1 : 2; }

// out (A, D) = P_subᵀ·W[gidx] − Q_subᵀ·G; W (N, D), G (A, D), P/Q (A, A),
// gidx (A,) int32; every operand contiguous, float operands one dtype.
// scratch: 2·A·2·Kp float32 (Kp = A rounded up to 32), 16-byte aligned,
// read only by the wgmma body.  body: 0 follows the rule, 1 forces the
// CUDA-core body (A ≤ SMALL_A), 2 the wgmma body.
extern "C" int sparse_gossip_launch(int dtype, const void* W, const void* G,
                                    const void* P, const void* Q,
                                    const void* gidx, void* out, void* scratch,
                                    int N, int A, int D, int body,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(gidx);
  if (N < 1 || body < 0 || body > 2 || (body == 1 && A > SMALL_A))
    return static_cast<int>(cudaErrorInvalidValue);
  if (body == 2 || (body == 0 && A > SMALL_A))
    return launch_tensor(dtype, W, G, P, Q, idx, out, scratch, N, A, D,
                         stream);
  return repro::smallmix::dispatch<2, true>(dtype, W, G, P, Q, idx, out, N, 1,
                                            A, D, s);
}
