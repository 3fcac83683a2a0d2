// swa_attention_bwd: the backward of causal sliding-window attention with
// GQA, for training (the forward is swa_attention.cu's TRAIN variant).
//
// It replaces no TPU kernel.  The reference differentiates
// repro/models/layers.py:blockwise_attention, plain jnp under jax.grad that
// XLA compiles, with no Pallas kernel; the port's copy of it in eager
// PyTorch issued every block pair's ~15 operations three times over
// (forward, the layer's recompute, the q block's recompute) and autograd's
// backward of each: ~4,300 launches a layer and worker a step, 95 % of
// minicpm-2b's training launches.  Here the backward is two launches.
//
// The algorithm is FlashAttention-2's backward (Dao 2023), from the forward's
// output O and each row's log-sum-exp (LSE), with no (T, T) matrix in
// device memory:
//   D   = rowsum(dO ∘ O)                     (float32, a row)
//   S   = Q·Kᵀ,  P = exp(S·scale − LSE)      (masked: 0)
//   dV += Pᵀ·dO,  dP = dO·Vᵀ,  dS = P ∘ (dP − D)
//   dK += dSᵀ·Q · scale,  dQ += dS·K · scale
// Query i sees keys j with i − window < j ≤ i, as in the forward; only the
// band's tiles are visited.
//
// Precision: S and dP are bf16 × bf16 products summed in float32 (dO is
// bf16-exact: the output it is the gradient of is bf16).  P and dS are
// float32 in the blockwise path, and here each enters its products as two
// bf16 fragments, hi = bf16(x) and lo = bf16(x − hi), into one float32
// accumulator (repro::split_bf16): no operand the blockwise path holds in
// float32 is rounded once to bf16.  Every sum stays in float32 until the one
// rounding of dQ, dK and dV to bf16 (the blockwise path rounds each q
// block's part).  D is taken from the bf16 O, as FlashAttention does.
//
// Two kernels, both four warps on mma.sync m16n8k16 (bf16 in, float32
// accumulate), operands staged in shared memory by cp.async (two stages),
// rows padded by 16 bytes so ldmatrix reads them without bank conflicts:
//   dq_kernel   a block owns 64 query rows of one q head (16 a warp) and
//               walks the key tiles of its band (64 keys each).  It first
//               writes D of its rows, which the second kernel reads.  dQ
//               stays in registers: deterministic, no atomics.
//   dkv_kernel  a block owns 64 keys of one KV head (16 a warp) and walks,
//               for each of the head's G query heads, the query tiles of
//               its band (64 queries at dh 64, 32 at dh 128, where dK and
//               dV take 128 registers a thread): a KV head's dK and dV sum
//               over its G query heads inside the block, deterministic.
// S (dQ) and Sᵀ (dK, dV) come out of the tensor cores in the accumulator
// layout, which is the A fragment of the next product as it stands, so P
// and dS never leave registers.  dq_kernel recomputes S and dP, the price
// of a dQ without atomics: 7 products a band pair, with the lo passes 10.
//
// What bounds it at minicpm-2b's shape (B=1, T=4096, 36 heads of 64,
// causal): five products of 3.87e10 FLOP, 0.20 ms at the bf16 peak (989
// TFLOP/s), against ~75 MB of q, k, v, O, dO, their gradients and the LSE:
// arithmetic.  mma.sync reaches about two thirds of wgmma's rate on Hopper.
//
// Tensors are contiguous (B, T, heads, dh) bf16, dh ∈ {64, 128}; LSE and D
// are (B, H, T) float32.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;                     // four warps
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr) : "memory");
}

// d (16 × 8 float32) += a (16 × 16 bf16, A fragment) · b (16 × 8 bf16)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory addresses a lane hands ldmatrix (ld: elements a row):
// the A fragment of rows r0 .. r0 + 15, columns 16kk .. 16kk + 15
__device__ __forceinline__ uint32_t a_addr(uint32_t s, int ld, int r0, int kk,
                                           int lane) {
  return s + ((r0 + lane % 16) * ld + kk * 16 + (lane / 16) * 8) * 2;
}

// B fragments of two 8-column tiles, B = Xᵀ with X stored [n][k]: rows
// n0 .. n0 + 15 of X, columns 16kk .. 16kk + 15 (regs b0, b1 of tile n0/8,
// then of tile n0/8 + 1)
__device__ __forceinline__ uint32_t bt_addr(uint32_t s, int ld, int n0, int kk,
                                            int lane) {
  return s + ((n0 + (lane / 16) * 8 + lane % 8) * ld + kk * 16 +
              ((lane / 8) % 2) * 8) * 2;
}

// B fragments of two 8-column tiles, B = X stored [k][n] (ldmatrix .trans):
// rows 16kk .. 16kk + 15 of X, columns n0 .. n0 + 15
__device__ __forceinline__ uint32_t b_addr(uint32_t s, int ld, int kk, int n0,
                                           int lane) {
  return s + ((kk * 16 + ((lane / 8) % 2) * 8 + lane % 8) * ld + n0 +
              (lane / 16) * 8) * 2;
}

// the A fragment (k = 16j .. 16j + 15) of accumulator tiles 2j and 2j + 1,
// as bf16 hi and lo parts
__device__ __forceinline__ void split_frag(const float (&c0)[4],
                                           const float (&c1)[4],
                                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  repro::split_bf16(c0[0], c0[1], hi[0], lo[0]);
  repro::split_bf16(c0[2], c0[3], hi[1], lo[1]);
  repro::split_bf16(c1[0], c1[1], hi[2], lo[2]);
  repro::split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// Rows r0 .. r0 + R − 1 of one head of a (B, T, heads, DH) tensor (`src` at
// the head's row 0, rows `stride` elements apart) into shared memory at s,
// rows DH + 8 elements apart; rows past T are zero-filled.
template <int R, int DH>
__device__ __forceinline__ void load_rows(uint32_t s, const bf16* src,
                                          long long stride, int r0, int Tn) {
  constexpr int CH = DH / 8, LD = DH + 8;
  for (int c = threadIdx.x; c < R * CH; c += THREADS) {
    const int r = c / CH, col = (c % CH) * 8, row = r0 + r;
    const bool in = row < Tn;
    repro::cp_async16(s + (r * LD + col) * 2,
                      src + (in ? row : 0) * stride + col, in ? 16 : 0);
  }
}

template <int DH>
struct DqCfg {
  static constexpr int BM = 64;                    // query rows a block
  static constexpr int BN = 64;                    // keys a tile
  static constexpr int LD = DH + 8;                // elements a staged row
  static constexpr int ROWB = LD * 2;
  static constexpr int Q = 0;
  static constexpr int DO = Q + BM * ROWB;
  static constexpr int K = DO + BM * ROWB;         // two stages
  static constexpr int V = K + 2 * BN * ROWB;      // two stages
  static constexpr int LSE = V + 2 * BN * ROWB;    // BM floats (log2 units)
  static constexpr int D = LSE + BM * 4;           // BM floats
  static constexpr int BYTES = D + BM * 4;
};

template <int DH>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ o,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ dvec, bf16* __restrict__ dq, int Tn, int H,
          int n_groups, int window, float scale) {
  using C = DqCfg<DH>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = repro::smem_addr(smem);
  float* sLse = reinterpret_cast<float*>(smem + C::LSE);
  float* sD = reinterpret_cast<float*>(smem + C::D);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // longest band first
  const int h = blockIdx.y % H, b = blockIdx.y / H;
  const int KV = H / n_groups, kvh = h / n_groups;
  const long long qs = static_cast<long long>(H) * DH;    // row strides
  const long long ks = static_cast<long long>(KV) * DH;
  const long long qoff = (static_cast<long long>(b) * Tn * H + h) * DH;
  const long long koff = (static_cast<long long>(b) * Tn * KV + kvh) * DH;
  const long long loff = (static_cast<long long>(b) * H + h) * Tn;
  const int q_last = (q0 + BM < Tn ? q0 + BM : Tn) - 1;
  const int kt_lo = (q0 - window + 1 > 0 ? q0 - window + 1 : 0) / BN;
  const int n = q_last / BN - kt_lo + 1;

  load_rows<BM, DH>(base + C::Q, q + qoff, qs, q0, Tn);
  load_rows<BM, DH>(base + C::DO, dout + qoff, qs, q0, Tn);
  repro::cp_async_commit();
  load_rows<BN, DH>(base + C::K, k + koff, ks, kt_lo * BN, Tn);
  load_rows<BN, DH>(base + C::V, v + koff, ks, kt_lo * BN, Tn);
  repro::cp_async_commit();

  // D of this block's rows, a warp a row at a time, and the LSE in log2
  // units; D goes out for dkv_kernel too
  for (int r = warp; r < BM; r += THREADS / 32) {
    const int row = q0 + r;
    float acc = 0.f;
    if (row < Tn) {
      const bf16* orow = o + qoff + row * qs;
      const bf16* drow = dout + qoff + row * qs;
      for (int c = 2 * lane; c < DH; c += 64) {
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(orow + c));
        const float2 d = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(drow + c));
        acc = fmaf(a.x, d.x, fmaf(a.y, d.y, acc));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      sD[r] = acc;
      sLse[r] = row < Tn ? lse[loff + row] * kLog2e : 0.f;
      if (row < Tn) dvec[loff + row] = acc;
    }
  }

  const int w0 = 16 * warp;
  const int ra = q0 + w0 + g, rb = ra + 8;        // this thread's rows
  const float c = scale * kLog2e;
  float acc[DH / 8][4];                            // dQ: 16 rows × DH a warp
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) {
      const int st = (it + 1) & 1;
      const int r0 = (kt_lo + it + 1) * BN;
      load_rows<BN, DH>(base + C::K + st * BN * C::ROWB, k + koff, ks, r0, Tn);
      load_rows<BN, DH>(base + C::V + st * BN * C::ROWB, v + koff, ks, r0, Tn);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t sK = base + C::K + (it & 1) * BN * C::ROWB;
    const uint32_t sV = base + C::V + (it & 1) * BN * C::ROWB;
    const int k0 = (kt_lo + it) * BN;
    const float lse2[2] = {sLse[w0 + g], sLse[w0 + g + 8]};
    const float dd[2] = {sD[w0 + g], sD[w0 + g + 8]};

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4], bb[4];
      ldsm_x4(a, a_addr(base + C::Q, LD, w0, kk, lane));     // S = Q·Kᵀ
#pragma unroll
      for (int p = 0; p < BN / 16; ++p) {
        ldsm_x4(bb, bt_addr(sK, LD, 16 * p, kk, lane));
        mma(s[2 * p], a, bb[0], bb[1]);
        mma(s[2 * p + 1], a, bb[2], bb[3]);
      }
      ldsm_x4(a, a_addr(base + C::DO, LD, w0, kk, lane));    // dP = dO·Vᵀ
#pragma unroll
      for (int p = 0; p < BN / 16; ++p) {
        ldsm_x4(bb, bt_addr(sV, LD, 16 * p, kk, lane));
        mma(dp[2 * p], a, bb[0], bb[1]);
        mma(dp[2 * p + 1], a, bb[2], bb[3]);
      }
    }
    // dS = P ∘ (dP − D), into s
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? ra : rb;
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const bool keep = key <= row && key > row - window && row < Tn;
        const float p = keep ? exp2f(fmaf(s[j][e], c, -lse2[e / 2])) : 0.f;
        s[j][e] = p * (dp[j][e] - dd[e / 2]);
      }
    // dQ += dS·K, dS as hi + lo
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      uint32_t hi[4], lo[4];
      split_frag(s[2 * j], s[2 * j + 1], hi, lo);
#pragma unroll
      for (int p = 0; p < DH / 16; ++p) {
        uint32_t bb[4];
        ldsm_x4_t(bb, b_addr(sK, LD, j, 16 * p, lane));
        mma(acc[2 * p], hi, bb[0], bb[1]);
        mma(acc[2 * p], lo, bb[0], bb[1]);
        mma(acc[2 * p + 1], hi, bb[2], bb[3]);
        mma(acc[2 * p + 1], lo, bb[2], bb[3]);
      }
    }
    __syncthreads();   // this stage is read; the next prefetch may land
  }

#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (ra < Tn)
      *reinterpret_cast<__nv_bfloat162*>(dq + qoff + ra * qs + col) =
          __floats2bfloat162_rn(acc[j][0] * scale, acc[j][1] * scale);
    if (rb < Tn)
      *reinterpret_cast<__nv_bfloat162*>(dq + qoff + rb * qs + col) =
          __floats2bfloat162_rn(acc[j][2] * scale, acc[j][3] * scale);
  }
}

template <int DH>
struct DkvCfg {
  static constexpr int BN = 64;                    // keys a block
  static constexpr int BM = DH == 64 ? 64 : 32;    // query rows a step
  static constexpr int LD = DH + 8;
  static constexpr int ROWB = LD * 2;
  static constexpr int K = 0;
  static constexpr int V = K + BN * ROWB;
  static constexpr int Q = V + BN * ROWB;          // two stages
  static constexpr int DO = Q + 2 * BM * ROWB;     // two stages
  static constexpr int LSE = DO + 2 * BM * ROWB;   // two stages of BM floats
  static constexpr int D = LSE + 2 * BM * 4;       // two stages of BM floats
  static constexpr int BYTES = D + 2 * BM * 4;
};

template <int DH>
__global__ void __launch_bounds__(THREADS)
dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, const bf16* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ dvec,
           bf16* __restrict__ dk, bf16* __restrict__ dv, int Tn, int H,
           int n_groups, int window, float scale) {
  using C = DkvCfg<DH>;
  constexpr int BM = C::BM, BN = C::BN, LD = C::LD;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = repro::smem_addr(smem);
  float* sLse = reinterpret_cast<float*>(smem + C::LSE);
  float* sD = reinterpret_cast<float*>(smem + C::D);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * BN;                 // longest band first
  const int KV = H / n_groups;
  const int kvh = blockIdx.y % KV, b = blockIdx.y / KV;
  const long long qs = static_cast<long long>(H) * DH;
  const long long ks = static_cast<long long>(KV) * DH;
  const long long koff = (static_cast<long long>(b) * Tn * KV + kvh) * DH;
  const int k_last = (k0 + BN < Tn ? k0 + BN : Tn) - 1;
  const int q_end = k_last + window - 1 < Tn ? k_last + window - 1 : Tn - 1;
  const int qt_lo = k0 / BM;
  const int nq = q_end / BM - qt_lo + 1;          // query tiles of the band
  const int n = n_groups * nq;

  load_rows<BN, DH>(base + C::K, k + koff, ks, k0, Tn);
  load_rows<BN, DH>(base + C::V, v + koff, ks, k0, Tn);
  repro::cp_async_commit();
  // step it: query head kvh·G + it / nq, its query tile qt_lo + it % nq
  auto load_step = [&](int it, int st) {
    const int hq = kvh * n_groups + it / nq, r0 = (qt_lo + it % nq) * BM;
    const long long qoff = (static_cast<long long>(b) * Tn * H + hq) * DH;
    const long long loff = (static_cast<long long>(b) * H + hq) * Tn;
    load_rows<BM, DH>(base + C::Q + st * BM * C::ROWB, q + qoff, qs, r0, Tn);
    load_rows<BM, DH>(base + C::DO + st * BM * C::ROWB, dout + qoff, qs, r0,
                      Tn);
    repro::cp_async_commit();
    for (int r = tid; r < BM; r += THREADS) {
      const int row = r0 + r;
      sLse[st * BM + r] = row < Tn ? lse[loff + row] * kLog2e : 0.f;
      sD[st * BM + r] = row < Tn ? dvec[loff + row] : 0.f;
    }
  };
  load_step(0, 0);

  const int w0 = 16 * warp;
  const int ka = k0 + w0 + g, kb = ka + 8;        // this thread's keys
  const float c = scale * kLog2e;
  float dka[DH / 8][4], dva[DH / 8][4];           // 16 keys × DH a warp
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int it = 0; it < n; ++it) {
    if (it + 1 < n) {
      load_step(it + 1, (it + 1) & 1);
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    const int st = it & 1;
    const uint32_t sQ = base + C::Q + st * BM * C::ROWB;
    const uint32_t sO = base + C::DO + st * BM * C::ROWB;
    const float* L = sLse + st * BM;
    const float* Dd = sD + st * BM;
    const int q0 = (qt_lo + it % nq) * BM;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: keys × queries
    float sT[BM / 8][4], dpT[BM / 8][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4], bb[4];
      ldsm_x4(a, a_addr(base + C::K, LD, w0, kk, lane));
#pragma unroll
      for (int p = 0; p < BM / 16; ++p) {
        ldsm_x4(bb, bt_addr(sQ, LD, 16 * p, kk, lane));
        mma(sT[2 * p], a, bb[0], bb[1]);
        mma(sT[2 * p + 1], a, bb[2], bb[3]);
      }
      ldsm_x4(a, a_addr(base + C::V, LD, w0, kk, lane));
#pragma unroll
      for (int p = 0; p < BM / 16; ++p) {
        ldsm_x4(bb, bt_addr(sO, LD, 16 * p, kk, lane));
        mma(dpT[2 * p], a, bb[0], bb[1]);
        mma(dpT[2 * p + 1], a, bb[2], bb[3]);
      }
    }
    // Pᵀ into sT, dSᵀ = Pᵀ ∘ (dPᵀ − D) into dpT
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? ka : kb;
        const int col = 8 * j + 2 * t + (e & 1);
        const int row = q0 + col;
        const bool keep = key <= row && key > row - window && row < Tn;
        const float p = keep ? exp2f(fmaf(sT[j][e], c, -L[col])) : 0.f;
        sT[j][e] = p;
        dpT[j][e] = p * (dpT[j][e] - Dd[col]);
      }
    // dV += Pᵀ·dO and dK += dSᵀ·Q, Pᵀ and dSᵀ as hi + lo
#pragma unroll
    for (int j = 0; j < BM / 16; ++j) {
      uint32_t phi[4], plo[4], shi[4], slo[4];
      split_frag(sT[2 * j], sT[2 * j + 1], phi, plo);
      split_frag(dpT[2 * j], dpT[2 * j + 1], shi, slo);
#pragma unroll
      for (int p = 0; p < DH / 16; ++p) {
        uint32_t bb[4];
        ldsm_x4_t(bb, b_addr(sO, LD, j, 16 * p, lane));
        mma(dva[2 * p], phi, bb[0], bb[1]);
        mma(dva[2 * p], plo, bb[0], bb[1]);
        mma(dva[2 * p + 1], phi, bb[2], bb[3]);
        mma(dva[2 * p + 1], plo, bb[2], bb[3]);
        ldsm_x4_t(bb, b_addr(sQ, LD, j, 16 * p, lane));
        mma(dka[2 * p], shi, bb[0], bb[1]);
        mma(dka[2 * p], slo, bb[0], bb[1]);
        mma(dka[2 * p + 1], shi, bb[2], bb[3]);
        mma(dka[2 * p + 1], slo, bb[2], bb[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (ka < Tn) {
      *reinterpret_cast<__nv_bfloat162*>(dk + koff + ka * ks + col) =
          __floats2bfloat162_rn(dka[j][0] * scale, dka[j][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + koff + ka * ks + col) =
          __floats2bfloat162_rn(dva[j][0], dva[j][1]);
    }
    if (kb < Tn) {
      *reinterpret_cast<__nv_bfloat162*>(dk + koff + kb * ks + col) =
          __floats2bfloat162_rn(dka[j][2] * scale, dka[j][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + koff + kb * ks + col) =
          __floats2bfloat162_rn(dva[j][2], dva[j][3]);
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dvec, void* dq,
           void* dk, void* dv, int B, int Tn, int H, int KV, int window,
           float scale, cudaStream_t stream) {
  static std::atomic<bool> dq_set[repro::kMaxDevices];
  static std::atomic<bool> dkv_set[repro::kMaxDevices];
  cudaError_t err = repro::smem_limit_once(
      dq_set, reinterpret_cast<const void*>(dq_kernel<DH>), DqCfg<DH>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = repro::smem_limit_once(
      dkv_set, reinterpret_cast<const void*>(dkv_kernel<DH>),
      DkvCfg<DH>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* bq = static_cast<const bf16*>(q);
  const auto* bk = static_cast<const bf16*>(k);
  const auto* bv = static_cast<const bf16*>(v);
  const auto* bdo = static_cast<const bf16*>(dout);
  const dim3 grid_q(static_cast<unsigned>(repro::ceil_div(Tn, DqCfg<DH>::BM)),
                    static_cast<unsigned>(B * H));
  dq_kernel<DH><<<grid_q, THREADS, DqCfg<DH>::BYTES, stream>>>(
      bq, bk, bv, static_cast<const bf16*>(o), bdo, lse, dvec,
      static_cast<bf16*>(dq), Tn, H, H / KV, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_kv(static_cast<unsigned>(repro::ceil_div(Tn, DkvCfg<DH>::BN)),
                     static_cast<unsigned>(B * KV));
  dkv_kernel<DH><<<grid_kv, THREADS, DkvCfg<DH>::BYTES, stream>>>(
      bq, bk, bv, bdo, lse, dvec, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Tn, H, H / KV, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dq, dk, dv of causal sliding-window attention from the forward's q, k, v,
// its bf16 output o and log-sum-exp lse, and the output's gradient dout: q,
// o, dout, dq (B, T, H, dh) and k, v, dk, dv (B, T, KV, dh) bf16
// contiguous, lse and dvec (B, H, T) float32 contiguous (dvec is scratch
// that receives D = rowsum(dout ∘ o)); dh ∈ {64, 128}, 1 ≤ window ≤ T.
// Two launches: dq_kernel, then dkv_kernel.
extern "C" int swa_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dvec, void* dq, void* dk,
    void* dv, int B, int Tn, int H, int KV, int dh, int window, float scale,
    void* stream) {
  if (B * H > 65535 || KV < 1 || H % KV || window < 1 || window > Tn)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* l = static_cast<const float*>(lse);
  auto* d = static_cast<float*>(dvec);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, o, dout, l, d, dq, dk, dv, B, Tn, H, KV,
                        window, scale, s);
    case 128:
      return launch<128>(q, k, v, o, dout, l, d, dq, dk, dv, B, Tn, H, KV,
                         window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
