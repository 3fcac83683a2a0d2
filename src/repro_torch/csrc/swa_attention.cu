// swa_attention: causal sliding-window attention for prefill, with GQA.
//
// Replaces the TPU kernel repro/kernels/swa_attention/kernel.py:
// swa_attention_pallas (body _swa_kernel).  Query i attends to keys j with
// i − window < j ≤ i; the softmax is taken online over key tiles and the
// final normaliser is clamped at 1e-30, as in the TPU kernel.  Positions are
// 0..T−1 for every row: left-padded prompts attend to their padding like any
// other token, as the reference does.  The KV head of q head h is
// h / n_groups within its batch row.
//
// What bounds it on an H100: the unmasked band is 4·dh FLOP a (query, key)
// pair, against q, k, v and the output read or written once.  At every
// served shape that is arithmetic: 0.26 ms at the bf16 tensor-core peak
// (989 TFLOP/s) for recurrentgemma's B=4, H=10, KV=1, dh=256, window 2048,
// T=4096 (~258 GFLOP against ~185 MB), 0.21-1.37 ms for the no-window
// prefills of qwen3-8b, grok-1, arctic, musicgen and llava.  Beside the
// products, the softmax needs one exp2 a pair on the SM's 16-a-clock MUFU
// unit: at dh 128 a 64 × 128 tile costs a warpgroup 512 clocks of exp2
// against 1024 of its two products, so run in sequence the exponentials
// alone would cap the kernel near two thirds of the peak.
//
// bfloat16 operands: a warp-specialised flash-attention kernel (the design
// of FlashAttention-3, Shah et al. 2024).  A block of three warpgroups owns
// 128 query rows of one head:
//   producer  one thread issues TMA loads: Q once (128 rows), then the K and
//             V tiles of the band, from the diagonal tile back to the tile of
//             the first row's oldest key, into a ring of STAGES slots.  Each
//             slot has a full and an empty mbarrier for K and for V; the
//             producer arms full with the tile's bytes, the consumers' eight
//             warps arrive on empty when their products have read it.  No
//             __syncthreads in the key loop, and the consumers spend no
//             registers or issue slots on addresses.  setmaxnreg moves
//             registers from the producer (24) to the consumers (240).
//   tiles     128 keys a tile at dh 64 and 128 (S is one m64n128k16 product
//             a k-step, so a softmax pass and a barrier cover twice the keys
//             of a 64-key tile); 64 at dh 256, where the registers of O (128
//             a thread) leave no room for a wider S.  Q and every tile are
//             64-column blocks of 128-byte rows with the 128-byte swizzle,
//             which TMA writes (CU_TENSOR_MAP_SWIZZLE_128B, box 64 columns ×
//             rows) in the layout wgmma's descriptors name: no bank
//             conflicts.  TMA zero-fills rows past T; those keys are masked.
//   overlap   two consumer warpgroups, 64 query rows each, take turns on the
//             tensor cores (named barriers 1 and 2: one issues its products
//             while the other runs its softmax), and each pipelines its own
//             loop: tile j's S = Q·Kᵀ is issued together with tile j−1's
//             O += P·V, and the exponentials of tile j run while that P·V
//             is on the tensor cores (wgmma_wait<1>, then <0>).  Every
//             product is issued outside any branch, and every register it
//             reads is pinned before the wgmma.fence that opens its stage:
//             otherwise ptxas serialises the products (C7515) and the
//             overlap is lost.  A tile outside a warpgroup's band is masked
//             whole instead of skipped.
//   softmax   only the diagonal tile, the band's far edge and the tile
//             holding T are masked (−1e30 as in the TPU kernel); elsewhere
//             exp2 takes (s·scale·log₂e − m) in one FMA.  Row max and sum from
//             the accumulator's fragment (two rows a thread, quad shuffles),
//             the sum reduced once at the end.  The running max moves only
//             when a row's max grows by more than 8 in log2 units (the lazy
//             rescale of FlashAttention-4), so P stays below 2⁸ and most
//             tiles skip O's rescale; O and l always share one max, so the
//             result is exact up to rounding.
//   O += P·V  P is the S accumulator rounded to bf16, which is the A
//             fragment as it stands; V is an MN-major operand read from the
//             same layout (no transpose pass), all dh columns in one
//             m64n{dh}k16 product a k-step.  O (64 × dh float32) stays in
//             registers.
//   order     q tiles run longest band first (blockIdx.x reversed), and
//             the q heads of a GQA group are adjacent in blockIdx.y, so
//             that their K/V tiles come from L2.
//   output    each warpgroup stages its normalised rows in its own Q
//             blocks and stores them with TMA; rows past T are not written.
// Measured (NVIDIA H100 80GB HBM3, 700 W; xp/kernel_times.py, device time
// with L2 emptied, against the previous cp.async kernel and SDPA in one
// run): 0.898 ms at qwen3-8b's prefill (B=4, T=4096, GQA 32/8, dh 128, no
// window; 61.9 % of its 0.556 ms bound; before 2.72-2.75, SDPA
// 0.880-0.887), 0.570 at musicgen's MHA dh 64 (36.9 %; before 1.12, SDPA
// 0.493-0.496), 0.387 at the windowed dh 256 row above (67.3 %; before
// 1.00-1.02).  At dh 64 the products are half as long as at dh 128 for
// the same exp2 a score, so the two warpgroups' softmaxes no longer hide
// under each other's products: that row trails SDPA by ~15 %.
// q, k, v and out are 4-d (batch, position, head, dh) tensors of any strides
// a tensor map takes (dh contiguous, the rest multiples of 16 bytes, bases
// 16-byte aligned), so the model's (B, T, H, dh) projections go in and out
// with no layout copy; the (B·H, T, dh) entry is the same kernel with other
// strides.  P is rounded to bf16 for the PV product (the TPU kernel
// multiplies float32 P): about 2⁻⁹ relative on each weight, well inside the
// bf16 output's own rounding.
//
// The training forward (swa_attention_train_bf16_launch) is the same kernel
// with TRAIN set.  It replaces no TPU kernel: the reference trains through
// repro/models/layers.py:blockwise_attention, plain jnp that XLA compiles,
// with no Pallas kernel, and the port's copy of it op for op in eager
// PyTorch issued ~4,300 launches a layer and worker a step (95 % of
// minicpm-2b's training launches).  The forward writes each row's
// log-sum-exp (m + log l, natural units, float32 (B, H, T)) for the
// backward (swa_attention_bwd.cu), and keeps P in float32 as the blockwise
// path multiplies it: each P fragment enters O += P·V as hi = bf16(P) and
// lo = bf16(P − hi) into the same float32 accumulator (16 of P's 24 bits;
// repro::split_bf16), so the product costs two passes.  At dh 128 the tile
// is 64 keys, so that O, S and both P fragments stay within the
// consumers' 240 registers.  Bound at minicpm-2b's shape (B=1, T=4096, 36
// heads of 64, causal): two products of 3.87e10 FLOP, 0.078 ms at the bf16
// peak, 0.117 with the lo pass.
//
// float32 operands keep the CUDA-core kernel of the first port (below,
// namespace simt): the reduced model runs in float32 and holds card against
// CPU to 1e-4, which bf16 tensor cores cannot meet.  One block of 256
// threads per (64-query tile, q head) stages q (pre-scaled), k and v tiles
// in float32 shared memory (222 KB at dh = 256), each thread owning a 4×4
// score micro-tile and 4 rows × dh/16 output columns, with the running max
// and sum in the 16 threads of a row group.  It takes contiguous (B·H, T,
// dh) q and (B·KV, T, dh) k and v.
#include <cstdint>

#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr float kMasked = -1e30f;

namespace simt {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per tile
constexpr int LD = BQ + 4;        // row length of the transposed tiles (floats)
constexpr int THREADS = 256;

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * DH * LD + BK * DH + BK * LD);
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Tn,
                     int n_groups, int window, float scale) {
  constexpr int NG = DH / 64;     // 64-column groups of the head
  extern __shared__ __align__(16) float smem[];
  float* sQt = smem;              // [DH][LD]  (q · scale)ᵀ of the tile
  float* sKt = sQt + DH * LD;     // [DH][LD]  kᵀ of the key tile
  float* sV = sKt + DH * LD;      // [BK][DH]  v of the key tile
  float* sPt = sV + BK * DH;      // [BK][LD]  probabilities, key-major

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const long long bh = blockIdx.y;
  const long long kvh = bh / n_groups;
  const T* qb = q + bh * Tn * DH;
  const T* kb = k + kvh * Tn * DH;
  const T* vb = v + kvh * Tn * DH;

  for (int e = tid; e < BQ * DH; e += THREADS) {
    const int r = e / DH, d = e % DH;
    const int row = q0 + r;
    sQt[d * LD + r] = row < Tn
        ? repro::to_f32(qb[static_cast<long long>(row) * DH + d]) * scale : 0.f;
  }

  float acc[4][NG][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][g][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
  }

  const int q_last = (q0 + BQ < Tn ? q0 + BQ : Tn) - 1;
  const int kt_hi = q_last / BK;                      // diagonal tile
  const int k_first = q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  const int kt_lo = k_first / BK;                     // oldest key of row q0

  for (int kt = kt_hi; kt >= kt_lo; --kt) {
    const int k0 = kt * BK;
    __syncthreads();              // the q tile is in; the last tile is read
    for (int e = tid; e < BK * DH; e += THREADS) {
      const int r = e / DH, d = e % DH;
      const int key = k0 + r;
      const bool in = key < Tn;
      const long long at = static_cast<long long>(key) * DH + d;
      sKt[d * LD + r] = in ? repro::to_f32(kb[at]) : 0.f;
      sV[r * DH + d] = in ? repro::to_f32(vb[at]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&sQt[d * LD + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&sKt[d * LD + tx * 4]);
      const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kr[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

    // mask and online softmax; the 16 threads of a row group (one half
    // warp) hold the row's 64 keys, so xor shuffles over 8, 4, 2, 1 reduce it
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx * 4 + j;
        const bool keep = key <= row && key > row - window && key < Tn;
        s[i][j] = keep ? s[i][j] : kMasked;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = s[i][j] == kMasked ? 0.f : expf(s[i][j] - m_new);
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&sPt[(tx * 4 + j) * LD + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int g = 0; g < NG; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][g][c] *= corr[i];
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float4 pp = *reinterpret_cast<const float4*>(&sPt[j * LD + ty * 4]);
      const float pr[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&sV[j * DH + g * 64 + tx * 4]);
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][g][c] = fmaf(pr[i], vc[c], acc[i][g][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Tn) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (bh * Tn + row) * DH;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        o[g * 64 + tx * 4 + c] = repro::from_f32<T>(acc[i][g][c] / denom);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Tn, int n_groups, int window, float scale,
           cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DH>();
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  cudaError_t err = repro::smem_limit_once(
      smem_set, reinterpret_cast<const void*>(swa_attention_kernel<T, DH>),
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(repro::ceil_div(Tn, BQ)),
                  static_cast<unsigned>(BH));
  swa_attention_kernel<T, DH><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Tn, n_groups, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(int dh, const void* q, const void* k, const void* v, void* out,
              int BH, int Tn, int n_groups, int window, float scale,
              cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, k, v, out, BH, Tn, n_groups, window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, BH, Tn, n_groups, window, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, BH, Tn, n_groups, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


}  // namespace simt

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;          // query rows a block: 64 a consumer warpgroup
constexpr int THREADS = 384;     // a producer and two consumer warpgroups
constexpr int ROW = 128;         // bytes of a swizzled row: 64 bf16
constexpr int QBLK = 64 * ROW;   // a 64-row × 64-column block of Q or O: 8 KB
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
// named barriers: BAR_TURN + wg is warpgroup wg's turn on the tensor cores,
// BAR_STORE + wg gathers its four warps before the output store
constexpr int BAR_TURN = 1;
constexpr int BAR_STORE = 3;

// TRAIN is the training forward: P enters O += P·V as two bf16 parts and
// each row's log-sum-exp is written
template <int DH, bool TRAIN>
struct Cfg {
  // keys a tile: 128 at dh 64 and 128, 64 at dh 256; the training forward
  // at dh 128 takes 64, where its second P fragment would leave O, S and P
  // of a 128-key tile no room in 240 registers
  static constexpr int BK = DH == 256 || (TRAIN && DH == 128) ? 64 : 128;
  static constexpr int NB = DH / 64;                // 64-column blocks of a row
  static constexpr int KBLK = BK * ROW;             // a column block of a K or V tile
  static constexpr int TILE = NB * KBLK;            // a K or V tile, bytes
  static constexpr int STAGES = TILE <= 16384 ? 3 : 2;   // slots of the K/V ring
  static constexpr int PF = TRAIN ? 2 : 1;          // bf16 parts of P: hi (+ lo)
  static constexpr int QWG = NB * QBLK;             // a warpgroup's 64 Q rows
  static constexpr int Q = 0;
  static constexpr int K = 2 * QWG;
  static constexpr int V = K + STAGES * TILE;
  // mbarriers: q_full, then k_full, v_full, k_empty, v_empty a slot each
  static constexpr int BARS = V + STAGES * TILE;
  static constexpr int BYTES = BARS + 8 * (1 + 4 * STAGES) + 1024;  // + 1 KB alignment
};

// Byte offset of (row, col) in a 64-row tile of Q or O: 64-column blocks of
// 8 KB, each 64 rows of 128 bytes whose 16-byte chunks are XOR-ed with
// row % 8 (the 128-byte swizzle; it repeats every 1 KB, so blocks are 1 KB
// aligned).
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  return (col / 64) * QBLK + row * ROW +
         ((((col % 64) / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 × 64 float32) (+)= A (64 × 16) · B (16 × 64), both bf16 K-major in
// shared memory; acc = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 × 128 float32) (+)= A (64 × 16) · B (16 × 128), both bf16 K-major in
// shared memory; acc = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 × 64 float32) += A (64 × 16, bf16 pairs in registers) · B (16 × 64,
// bf16 MN-major in shared memory, one 64-column block)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 × 128 float32) += A (64 × 16, bf16 pairs in registers) · B (16 ×
// 128, bf16 MN-major in shared memory, its 64-column blocks `lbo` apart in
// the descriptor)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 × 256 float32) += A (64 × 16, bf16 pairs in registers) · B (16 ×
// 256, bf16 MN-major in shared memory, its 64-column blocks `lbo` apart in
// the descriptor)
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, "
      "%126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// wgmma reads its register A fragment asynchronously: keep the registers
// of P allocated up to a point after the wait
template <int K>
__device__ __forceinline__ void fence_frag(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

template <int DH, bool TRAIN>
__global__ void __launch_bounds__(THREADS, 1)
swa_attention_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to,
                     float* __restrict__ lse, int Tn, int H, int n_groups,
                     int window, float scale_log2) {
  using C = Cfg<DH, TRAIN>;
  constexpr int BK = C::BK, NB = C::NB, STAGES = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = repro::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = repro::smem_addr(smem);
  const uint32_t q_full = base + C::BARS;
  const uint32_t k_full = q_full + 8;              // + 8 · slot
  const uint32_t v_full = k_full + 8 * STAGES;
  const uint32_t k_empty = v_full + 8 * STAGES;
  const uint32_t v_empty = k_empty + 8 * STAGES;

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // longest band first
  const int h = blockIdx.y % H, b = blockIdx.y / H;
  const int kvh = h / n_groups;
  const int q_last = (q0 + BQ < Tn ? q0 + BQ : Tn) - 1;
  const int kt_hi = q_last / BK;                       // diagonal tile
  const int k_first = q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  const int n_tiles = kt_hi - k_first / BK + 1;        // back to row q0's oldest key

  if (tid == 0) {
    repro::mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      repro::mbar_init(k_full + 8 * s, 1);
      repro::mbar_init(v_full + 8 * s, 1);
      repro::mbar_init(k_empty + 8 * s, 8);    // one arrival a consumer warp
      repro::mbar_init(v_empty + 8 * s, 8);
    }
    repro::mbar_init_fence();
  }
  __syncthreads();

  // warpgroup 0 produces, 1 and 2 consume.  Read through a shuffle, so that
  // the compiler sees it uniform over the warp and keeps the wgmma below,
  // under conditions on it, asynchronous
  const int role = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (role == 0) {
    repro::regs_release<PRODUCER_REGS>();
    if (tid == 0) {
      repro::mbar_expect_tx(q_full, BQ * DH * 2);
#pragma unroll
      for (int w = 0; w < 2; ++w)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          repro::tma_load_4d(base + C::Q + w * C::QWG + nb * QBLK, &tq, q_full,
                             64 * nb, q0 + 64 * w, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int k0 = (kt_hi - it) * BK;
        repro::mbar_wait(k_empty + 8 * s, ph ^ 1);
        repro::mbar_expect_tx(k_full + 8 * s, C::TILE);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          repro::tma_load_4d(base + C::K + s * C::TILE + nb * C::KBLK, &tk,
                             k_full + 8 * s, 64 * nb, k0, kvh, b);
        repro::mbar_wait(v_empty + 8 * s, ph ^ 1);
        repro::mbar_expect_tx(v_full + 8 * s, C::TILE);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          repro::tma_load_4d(base + C::V + s * C::TILE + nb * C::KBLK, &tv,
                             v_full + 8 * s, 64 * nb, k0, kvh, b);
      }
    }
    return;
  }

  repro::regs_claim<CONSUMER_REGS>();
  const int wg = role - 1;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r_lo = q0 + 64 * wg;             // this warpgroup's first row
  const int row0 = r_lo + 16 * warp + g;     // this thread's rows: row0, row0 + 8
  const bool active = r_lo < Tn;
  const uint32_t sQ = base + C::Q + wg * C::QWG;

  float o[DH / 2];                    // O: (row0 + 8h, 8(i/4) + 2t + i%2)
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  repro::fence_acc(o);
  float s[BK / 2];                   // S of one tile: (row0 + 8h, k0 + 8(i/4) + 2t + i%2)
  // P of a tile, bf16 A fragments: keys 16kk .. 16kk + 15 at p[kk], and in
  // training their lo parts at p[BK / 16 + kk]
  uint32_t p[C::PF * (BK / 16)][4];
  float m[2] = {kMasked, kMasked};   // running max (within 8), log2 units
  float l[2] = {0.f, 0.f};           // this thread's part of the running sum
  float corr[2];                     // exp2 of the last change of m

  // Every product below is issued unconditionally and outside any branch,
  // and every register a product reads is pinned (fence_acc, fence_frag)
  // before the wgmma.fence that opens its stage: ptxas serialises the
  // products of a stage into which it sees other instructions write their
  // registers.  A tile outside this warpgroup's band is masked whole.
  auto issue_s = [&](int it) {        // S = Q·Kᵀ of tile it
    const uint32_t sK = base + C::K + (it % STAGES) * C::TILE;
#pragma unroll
    for (int kd = 0; kd < DH / 16; ++kd)
      wgmma_ss(s, repro::sw128_desc(sQ + (kd / 4) * QBLK + (kd % 4) * 32, 0),
               repro::sw128_desc(sK + (kd / 4) * C::KBLK + (kd % 4) * 32, 0),
               kd > 0);
    repro::wgmma_commit();
  };
  auto issue_pv = [&](int it) {       // O += P·V of tile it (hi, then lo)
    const uint32_t sV = base + C::V + (it % STAGES) * C::TILE;
#pragma unroll
    for (int f = 0; f < C::PF * (BK / 16); ++f)
      wgmma_rs(o, p[f], repro::sw128_desc(sV + (f % (BK / 16)) * 16 * ROW,
                                          C::KBLK));
    repro::wgmma_commit();
  };
  auto wait_k = [&](int it) {
    repro::mbar_wait(k_full + 8 * (it % STAGES), (it / STAGES) & 1);
  };
  auto wait_v = [&](int it) {
    repro::mbar_wait(v_full + 8 * (it % STAGES), (it / STAGES) & 1);
  };
  // one arrival a warp once its products have read the slot
  auto release_k = [&](int it) {
    if (lane == 0) repro::mbar_arrive(k_empty + 8 * (it % STAGES));
  };
  auto release_v = [&](int it) {
    if (lane == 0) repro::mbar_arrive(v_empty + 8 * (it % STAGES));
  };
  // the online softmax of tile it: s becomes P (float32), m, l and corr move
  auto softmax = [&](int it) {
    const int k0 = (kt_hi - it) * BK;
    // mask only the diagonal tile, the band's far edge and the tile of T
    const bool edge = !(k0 + BK - 1 <= r_lo && k0 > r_lo + 63 - window &&
                        k0 + BK <= Tn);
    float mx[2] = {kMasked, kMasked};
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int hh = (i / 2) % 2;
        const int row = row0 + 8 * hh;
        const int key = k0 + 8 * (i / 4) + 2 * t + i % 2;
        const bool keep = key <= row && key > row - window && key < Tn;
        s[i] = keep ? s[i] * scale_log2 : kMasked;
        mx[hh] = fmaxf(mx[hh], s[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      // move the max only when it grew by more than 8 (log2 units): P stays
      // below 2⁸, O and l agree with the max they were taken against, and
      // most tiles skip O's rescale
      const float m_new = fmaxf(m[hh], edge ? mx[hh] : mx[hh] * scale_log2);
      if (m_new > m[hh] + 8.f) {
        corr[hh] = ex2(m[hh] - m_new);
        m[hh] = m_new;
        l[hh] *= corr[hh];
      } else {
        corr[hh] = 1.f;
      }
    }
    if (edge) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int hh = (i / 2) % 2;
        s[i] = s[i] == kMasked ? 0.f : ex2(s[i] - m[hh]);
        l[hh] += s[i];
      }
    } else {
      const float neg[2] = {-m[0], -m[1]};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int hh = (i / 2) % 2;
        s[i] = ex2(fmaf(s[i], scale_log2, neg[hh]));
        l[hh] += s[i];
      }
    }
  };
  // O to the new max; the accumulator of keys 16kk .. 16kk + 15 is the A
  // fragment of P
  auto rescale_and_pack = [&] {
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) o[i] *= corr[(i / 2) % 2];
    }
    repro::fence_acc(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (TRAIN) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          repro::split_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1],
                            p[kk][j], p[BK / 16 + kk][j]);
      } else {
        p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    }
    fence_frag(p);
    repro::fence_acc(s);
  };
  // the tensor cores to the other warpgroup (warpgroup 1 skips its last
  // hand-over, which nobody waits for)
  const int my_turn = BAR_TURN + wg, their_turn = BAR_TURN + 1 - wg;

  if (wg == 1) repro::named_arrive(BAR_TURN, 256);   // warpgroup 0 goes first
  repro::mbar_wait(q_full, 0);

  // step 0: S of the diagonal tile
  wait_k(0);
  repro::named_sync(my_turn, 256);
  repro::wgmma_fence();
  issue_s(0);
  repro::named_arrive(their_turn, 256);
  repro::wgmma_wait<0>();
  repro::fence_acc(s);
  release_k(0);
  softmax(0);
  rescale_and_pack();

  // step it: S of tile it with O += P·V of tile it − 1; the exponentials of
  // tile it run while that P·V is on the tensor cores
  for (int it = 1; it < n_tiles; ++it) {
    wait_k(it);
    wait_v(it - 1);
    repro::named_sync(my_turn, 256);
    repro::wgmma_fence();
    issue_s(it);
    issue_pv(it - 1);
    repro::named_arrive(their_turn, 256);
    repro::wgmma_wait<1>();              // S of tile it is in
    repro::fence_acc(s);
    release_k(it);
    softmax(it);
    repro::wgmma_wait<0>();              // O += P·V of tile it − 1 is in
    repro::fence_acc(o);
    fence_frag(p);
    release_v(it - 1);
    rescale_and_pack();
  }

  // last step: O += P·V of the last tile
  wait_v(n_tiles - 1);
  repro::named_sync(my_turn, 256);
  repro::wgmma_fence();
  issue_pv(n_tiles - 1);
  if (wg == 0) repro::named_arrive(their_turn, 256);
  repro::wgmma_wait<0>();
  repro::fence_acc(o);
  fence_frag(p);
  release_v(n_tiles - 1);

  if (!active) return;
  // normalise, stage in this warpgroup's Q blocks (its products are done
  // with them) and store with TMA, which drops rows past T
  float inv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    inv[hh] = 1.f / fmaxf(l[hh], 1e-30f);
    // the row's natural log-sum-exp, m + log l (m is in log2 units)
    const int row = row0 + 8 * hh;
    if (TRAIN && t == 0 && row < Tn)
      lse[(static_cast<long long>(b) * H + h) * Tn + row] =
          (m[hh] + log2f(fmaxf(l[hh], 1e-30f))) * 0.6931471805599453f;
  }
  unsigned char* sO = smem + C::Q + wg * C::QWG;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int cb = 0; cb < 8; ++cb)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * warp + g + 8 * hh;
        const int col = 64 * nb + 8 * cb + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(sO + tile_offset(row, col)) =
            __floats2bfloat162_rn(o[32 * nb + 4 * cb + 2 * hh] * inv[hh],
                                  o[32 * nb + 4 * cb + 2 * hh + 1] * inv[hh]);
      }
  repro::fence_proxy_async();
  repro::named_sync(BAR_STORE + wg, 128);
  if (tid % 128 == 0) {
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      repro::tma_store_4d(&to, sQ + nb * QBLK, 64 * nb, r_lo, h, b);
    repro::tma_store_commit();
    repro::tma_store_wait_read();
  }
}

// Element strides of the (batch, position, head) dims of q, k, v and out,
// in that order; dh is contiguous.
struct Strides {
  long long s[4][3];
};

template <int DH, bool TRAIN>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           int B, int Tn, int H, int KV, int window, float scale,
           const Strides& st, cudaStream_t stream) {
  using C = Cfg<DH, TRAIN>;
  const void* base[4] = {q, k, v, out};
  const int heads[4] = {H, KV, KV, H};
  const cuuint32_t rows[4] = {64, C::BK, C::BK, 64};
  CUtensorMap maps[4];
  for (int i = 0; i < 4; ++i) {
    const cuuint64_t dims[4] = {DH, static_cast<cuuint64_t>(Tn),
                                static_cast<cuuint64_t>(heads[i]),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s[i][1]) * 2,
                                   static_cast<cuuint64_t>(st.s[i][2]) * 2,
                                   static_cast<cuuint64_t>(st.s[i][0]) * 2};
    const cuuint32_t box[4] = {64, rows[i], 1, 1};
    if (!repro::encode_bf16_map(&maps[i], base[i], dims, strides, box))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  cudaError_t err = repro::smem_limit_once(
      smem_set,
      reinterpret_cast<const void*>(swa_attention_kernel<DH, TRAIN>),
      C::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(repro::ceil_div(Tn, BQ)),
                  static_cast<unsigned>(B * H));
  swa_attention_kernel<DH, TRAIN><<<grid, THREADS, C::BYTES, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, Tn, H, H / KV, window,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

int launch_dh(int dh, const void* q, const void* k, const void* v, void* out,
              int B, int Tn, int H, int KV, int window, float scale,
              const Strides& st, cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<64, false>(q, k, v, out, nullptr, B, Tn, H, KV, window,
                               scale, st, stream);
    case 128:
      return launch<128, false>(q, k, v, out, nullptr, B, Tn, H, KV, window,
                                scale, st, stream);
    case 256:
      return launch<256, false>(q, k, v, out, nullptr, B, Tn, H, KV, window,
                                scale, st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int launch_train_dh(int dh, const void* q, const void* k, const void* v,
                    void* out, float* lse, int B, int Tn, int H, int KV,
                    int window, float scale, const Strides& st,
                    cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<64, true>(q, k, v, out, lse, B, Tn, H, KV, window, scale,
                              st, stream);
    case 128:
      return launch<128, true>(q, k, v, out, lse, B, Tn, H, KV, window, scale,
                               st, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// float32: out (BH, T, dh) = softmax over the causal window of
// (q·kᵀ)·scale, times v; q (BH, T, dh), k and v (BH / n_groups, T, dh),
// contiguous; dh ∈ {64, 128, 256}, 1 ≤ window ≤ T.
extern "C" int swa_attention_f32_launch(const void* q, const void* k,
                                        const void* v, void* out, int BH,
                                        int Tn, int dh, int n_groups,
                                        int window, float scale, void* stream) {
  if (BH > 65535 || n_groups < 1 || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return simt::launch_dh<float>(dh, q, k, v, out, BH, Tn, n_groups, window,
                                scale, static_cast<cudaStream_t>(stream));
}

// bfloat16: the same with q and out (B, T, H, dh), k and v (B, T, KV, dh),
// H a multiple of KV, of any strides a tensor map takes: `strides` holds
// the element strides of the batch, position and head dims of q, k, v and
// out (12 values), dh is contiguous.  Fails if the driver refuses a map.
extern "C" int swa_attention_bf16_launch(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int Tn, int H, int KV, int dh,
                                         int window, float scale,
                                         const long long* strides,
                                         void* stream) {
  if (B * H > 65535 || KV < 1 || H % KV || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  tc::Strides st;
  for (int i = 0; i < 12; ++i) st.s[i / 3][i % 3] = strides[i];
  return tc::launch_dh(dh, q, k, v, out, B, Tn, H, KV, window, scale, st,
                       static_cast<cudaStream_t>(stream));
}

// The training forward, bfloat16: the same as swa_attention_bf16_launch
// with P entering O += P·V as hi + lo bf16 parts, and each row's
// log-sum-exp written to lse, (B, H, T) float32 contiguous; dh ∈ {64, 128}.
extern "C" int swa_attention_train_bf16_launch(
    const void* q, const void* k, const void* v, void* out, void* lse, int B,
    int Tn, int H, int KV, int dh, int window, float scale,
    const long long* strides, void* stream) {
  if (B * H > 65535 || KV < 1 || H % KV || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  tc::Strides st;
  for (int i = 0; i < 12; ++i) st.s[i / 3][i % 3] = strides[i];
  return tc::launch_train_dh(dh, q, k, v, out, static_cast<float*>(lse), B,
                             Tn, H, KV, window, scale, st,
                             static_cast<cudaStream_t>(stream));
}
