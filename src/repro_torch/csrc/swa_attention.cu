// swa_attention: causal sliding-window attention for prefill, with GQA.
//
// Replaces the TPU kernel repro/kernels/swa_attention/kernel.py:
// swa_attention_pallas (body _swa_kernel).  q is (B·H, T, dh) and k, v are
// (B·KV, T, dh), batch-major, so the KV head of q head bh is bh / n_groups.
// Query i attends to keys j with i − window < j ≤ i; the softmax is taken
// online over key tiles and the final normaliser is clamped at 1e-30, as in
// the TPU kernel.  Positions are 0..T−1 for every row: left-padded prompts
// attend to their padding like any other token, as the reference does.
//
// What bounds it on an H100: at the serve path's B=4, H=10, KV=1, dh=256,
// window 2048 and T=4096 the unmasked band is ~258 GFLOP against ~185 MB
// of bfloat16 q, k, v and output, so the bound is arithmetic: 0.26 ms at
// the bf16 tensor-core peak (989 TFLOP/s).
//
// bfloat16 operands: flash attention on wgmma.  A block holds 128 query
// rows of one head, 64 per consumer warpgroup (4 warps), and walks only the
// key tiles of the band (from the diagonal tile back to the tile of the
// first row's oldest key), 64 keys a tile.  Q stays in shared memory in
// bf16 for the whole band; K and V tiles go through a 2-stage ring filled
// with 16-byte cp.async copies by all 256 threads, so the next tile loads
// while this one computes, and both warpgroups share each tile.  Every tile
// is stored as 64-column blocks of 64 rows × 128 bytes with the 128-byte
// XOR swizzle that wgmma's descriptors name, so the copies and the tensor
// cores are free of bank conflicts (192 KB at dh = 256).
//   S = Q·Kᵀ  wgmma m64n64k16, both operands K-major from shared memory.
//   softmax   the scale goes on the float32 accumulator (in log2 units, for
//             exp2); only the diagonal tile, the band's far-edge tile and
//             the tile holding T are masked (−1e30 as in the TPU kernel);
//             row max and sum from the accumulator's fragment (two rows per
//             thread, quad shuffles), the sum reduced once at the end.
//   O += P·V  wgmma m64n64k16 per 64 columns of the head, with P from
//             registers (the S accumulator rounded to bf16 is the A
//             fragment as it stands) and V an MN-major (transposed) operand
//             read from the same layout: no transpose pass.  O (64 × dh
//             float32) stays in registers, 128 a thread at dh = 256.
// The output is staged through the Q tiles and written with 16-byte
// stores.  Ragged T is masked here (rows past T are never stored, keys past
// T never weigh), so nothing is padded.  P is rounded to bf16 for the PV
// product (the TPU kernel multiplies float32 P): about 2⁻⁹ relative on each
// weight, well inside the bf16 output's own rounding.
//
// float32 operands keep the CUDA-core kernel of the first port (below,
// namespace simt): the reduced model runs in float32 and holds card against
// CPU to 1e-4, which bf16 tensor cores cannot meet.  One block of 256
// threads per (64-query tile, q head) stages q (pre-scaled), k and v tiles
// in float32 shared memory (222 KB at dh = 256), each thread owning a 4×4
// score micro-tile and 4 rows × dh/16 output columns, with the running max
// and sum in the 16 threads of a row group.
#include <cstdint>

#include "common.cuh"

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

constexpr int BQ = 128;          // query rows per block: 64 per warpgroup
constexpr int BK = 64;           // keys per tile
constexpr int THREADS = 256;     // two consumer warpgroups
constexpr int ROW = 128;         // bytes of a swizzled row: 64 bf16
constexpr int BLOCK = 64 * ROW;  // one 64-row × 64-column block: 8 KB

template <int DH>
struct Smem {
  static constexpr int TILE = BK * DH * 2;       // a 64-row tile, bytes
  static constexpr int Q = 0;                    // 2 tiles: 128 query rows
  static constexpr int K = 2 * TILE;             // 2-stage ring
  static constexpr int V = 4 * TILE;             // 2-stage ring
  static constexpr int BYTES = 6 * TILE + 1024;  // + room to align to 1 KB
};

// Byte offset of (row, col) in a 64-row tile: 64-column blocks of 8 KB,
// each 64 rows of 128 bytes whose 16-byte chunks are XOR-ed with row % 8
// (the 128-byte swizzle; it repeats every 1 KB, so tiles are 1 KB aligned).
__device__ __forceinline__ uint32_t tile_offset(int row, int col) {
  return (col / 64) * BLOCK + row * ROW +
         ((((col % 64) / 8) ^ (row % 8)) * 16) + (col % 8) * 2;
}

// Rows r0 .. r0 + 64 of a (Tn, DH) matrix into a tile at dst, zero past Tn.
template <int DH>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int r0, int Tn, int tid) {
  constexpr int CPR = DH / 8;    // 16-byte chunks a row
#pragma unroll
  for (int c = tid; c < BK * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    const bool ok = r0 + r < Tn;
    const bf16* g = ok ? src + static_cast<long long>(r0 + r) * DH + col : src;
    repro::cp_async16(dst + tile_offset(r, col), g, ok ? 16 : 0);
  }
}

// d (64 × 64 float32) += A (64 × 16) · B (16 × 64), both bf16 K-major in
// shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
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
      : "l"(da), "l"(db), "r"(1));
}

// d (64 × 64 float32) += A (64 × 16, bf16 pairs in registers) · B (16 × 64,
// bf16 MN-major in shared memory)
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int DH>
__global__ void __launch_bounds__(THREADS, 1)
swa_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int Tn, int n_groups, int window, float scale_log2) {
  using L = Smem<DH>;
  constexpr int NB = DH / 64;     // 64-column blocks of the head
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = repro::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
  const uint32_t base = repro::smem_addr(smem);

  const int tid = threadIdx.x;
  // warpgroup: query rows 64·wg .. + 64.  Read through a shuffle, so that
  // the compiler sees it uniform over the warpgroup and keeps the wgmma
  // below, under conditions on it, asynchronous
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = blockIdx.x * BQ;
  const long long bh = blockIdx.y;
  const long long kvh = bh / n_groups;
  const bf16* qb = q + bh * Tn * DH;
  const bf16* kb = k + kvh * Tn * DH;
  const bf16* vb = v + kvh * Tn * DH;

  const int q_last = (q0 + BQ < Tn ? q0 + BQ : Tn) - 1;
  const int kt_hi = q_last / BK;                       // diagonal tile
  const int k_first = q0 - window + 1 > 0 ? q0 - window + 1 : 0;
  const int n_tiles = kt_hi - k_first / BK + 1;        // back to row q0's oldest key

  const int r_lo = q0 + 64 * wg;  // this warpgroup's first row
  const int row0 = r_lo + 16 * warp + g;   // this thread's rows: row0, row0 + 8
  const bool active = r_lo < Tn;
  const uint32_t sQ = base + L::Q + wg * L::TILE;

  load_tile<DH>(base + L::Q, qb, q0, Tn, tid);
  load_tile<DH>(base + L::Q + L::TILE, qb, q0 + 64, Tn, tid);
  load_tile<DH>(base + L::K, kb, kt_hi * BK, Tn, tid);
  load_tile<DH>(base + L::V, vb, kt_hi * BK, Tn, tid);
  repro::cp_async_commit();

  float o[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
  float m[2] = {kMasked, kMasked};   // running max, log2 units
  float l[2] = {0.f, 0.f};           // this thread's part of the running sum

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (kt_hi - it) * BK;
    if (it + 1 < n_tiles) {
      const int nxt = ((it + 1) & 1) * L::TILE;
      load_tile<DH>(base + L::K + nxt, kb, k0 - BK, Tn, tid);
      load_tile<DH>(base + L::V + nxt, vb, k0 - BK, Tn, tid);
    }
    repro::cp_async_commit();
    repro::cp_async_wait<1>();             // tile it is in
    repro::fence_proxy_async();
    __syncthreads();

    if (active && k0 <= r_lo + 63 && k0 + BK - 1 > r_lo - window) {
      const uint32_t sK = base + L::K + (it & 1) * L::TILE;
      const uint32_t sV = base + L::V + (it & 1) * L::TILE;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      repro::wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd) {
        const uint32_t at = (kd / 4) * BLOCK + (kd % 4) * 32;
        wgmma_ss(s, repro::sw128_desc(sQ + at, 0), repro::sw128_desc(sK + at, 0));
      }
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      repro::fence_acc(s);

      // s[4·nb + 2·h + c] is (row0 + 8h, key k0 + 8·nb + 2t + c)
      const bool edge = !(k0 + BK - 1 <= r_lo && k0 > r_lo + 63 - window &&
                          k0 + BK <= Tn);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) % 2;
        float x = s[i] * scale_log2;
        if (edge) {
          const int row = row0 + 8 * h;
          const int key = k0 + 8 * (i / 4) + 2 * t + i % 2;
          const bool keep = key <= row && key > row - window && key < Tn;
          x = keep ? x : kMasked;
        }
        s[i] = x;
        mx[h] = fmaxf(mx[h], x);
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = exp2f(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) % 2;
        s[i] = s[i] == kMasked ? 0.f : exp2f(s[i] - m[h]);
        l[h] += s[i];
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[nb][i] *= corr[(i / 2) % 2];

      // the accumulator of keys 16kk .. 16kk + 15 is the A fragment of P
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      repro::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          wgmma_rs(o[nb], pa[kk],
                   repro::sw128_desc(sV + nb * BLOCK + kk * 16 * ROW, 1024));
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) repro::fence_acc(o[nb]);
    }
    __syncthreads();                // both warpgroups are done with tile it
  }

  // normalise and stage the output in this warpgroup's Q tile (free now)
  if (active) {
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      inv[h] = 1.f / fmaxf(l[h], 1e-30f);
    }
    unsigned char* sO = smem + L::Q + wg * L::TILE;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int cb = 0; cb < 8; ++cb)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * warp + g + 8 * h;
          const int col = 64 * nb + 8 * cb + 2 * t;
          *reinterpret_cast<__nv_bfloat162*>(sO + tile_offset(row, col)) =
              __floats2bfloat162_rn(o[nb][4 * cb + 2 * h] * inv[h],
                                    o[nb][4 * cb + 2 * h + 1] * inv[h]);
        }
  }
  __syncthreads();
  constexpr int CPR = DH / 8;
  bf16* ob = out + bh * Tn * DH;
#pragma unroll
  for (int c = tid; c < BQ * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    if (q0 + r >= Tn) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(
        smem + L::Q + (r / 64) * L::TILE + tile_offset(r % 64, col));
    *reinterpret_cast<uint4*>(ob + static_cast<long long>(q0 + r) * DH + col) = val;
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out, int BH,
           int Tn, int n_groups, int window, float scale,
           cudaStream_t stream) {
  // 16-byte copies: every row (dh · 2 bytes) starts on a 16-byte boundary
  // when the tensors do
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int bytes = Smem<DH>::BYTES;
  static std::atomic<bool> smem_set[repro::kMaxDevices];
  cudaError_t err = repro::smem_limit_once(
      smem_set, reinterpret_cast<const void*>(swa_attention_kernel<DH>),
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(repro::ceil_div(Tn, BQ)),
                  static_cast<unsigned>(BH));
  swa_attention_kernel<DH><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), Tn, n_groups,
      window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

int launch_dh(int dh, const void* q, const void* k, const void* v, void* out,
              int BH, int Tn, int n_groups, int window, float scale,
              cudaStream_t stream) {
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, out, BH, Tn, n_groups, window, scale, stream);
    case 128:
      return launch<128>(q, k, v, out, BH, Tn, n_groups, window, scale, stream);
    case 256:
      return launch<256>(q, k, v, out, BH, Tn, n_groups, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace tc

}  // namespace

// out (BH, T, dh) = softmax over the causal window of (q·kᵀ)·scale, times v;
// q (BH, T, dh), k and v (BH / n_groups, T, dh), contiguous, one dtype;
// dh ∈ {64, 128, 256}, 1 ≤ window ≤ T.
extern "C" int swa_attention_launch(int dtype, const void* q, const void* k,
                                    const void* v, void* out, int BH, int Tn,
                                    int dh, int n_groups, int window,
                                    float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH > 65535 || n_groups < 1 || window < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kFloat32)
    return simt::launch_dh<float>(dh, q, k, v, out, BH, Tn, n_groups, window,
                                  scale, s);
  if (dtype == repro::kBFloat16)
    return tc::launch_dh(dh, q, k, v, out, BH, Tn, n_groups, window, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
