// The 3xTF32 wgmma product shared by gossip_mix.cu, masked_gossip.cu and
// sparse_gossip.cu:
//
//   out[e] = P[e]ᵀ·W[e]                (one operand pair: gossip_mix)
//   out    = Pᵀ·W − Qᵀ·G = [−Q; P]ᵀ·[G; W]   (two pairs: masked_gossip)
//   out    = Pᵀ·W[gidx] − Qᵀ·G              (two pairs, W's rows gathered:
//                                             sparse_gossip)
//
// W, G, out are (N, D) worker-stacked leaves (E of them for the batched
// mix), P, Q (N, N); the sum runs in float32 and is rounded once to W's
// dtype.  The two-pair product is one reduction of depth 2N over the
// stacked operands, so it runs the one-pair body with twice the slabs.
// Gathered, N is the number of lanes A and W may hold any number of rows:
// row k of the W half is W[gidx[k]], gidx clamped into W's rows.
//
// Where it runs.  Only above the rules of its callers: N > SMALL_N
// (small_mix.cuh, with its crossover table) for gossip_mix and
// masked_gossip, A > SMALL_A (sparse_gossip.cu).  It pads k to its BK =
// 32-row slab and j to its BJ = 64-column tile and spends a second launch
// on the prepass, so at N = 4 it issues 128 products for each useful one:
// 43.77 ms at phase 26's N = 4, D = 655,360,000 bf16 against a 3.13 ms
// bound, where the CUDA-core body of small_mix.cuh takes 3.46-3.76 ms
// (kernel_times.py, chip_smoke.py phase 2; NVIDIA H100 80GB HBM3,
// 700.00 W).  Its rows are the wide ones: N = 256 (the 2-NN paths) and the
// batched E = 32 × N = 64.
//
// Precision.  The port holds float32 parity with the reference (atol 2e-5
// / rtol 1e-4), which one TF32 pass does not meet.  Each float32 operand x
// is split into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x − hi) (lo is
// converted too: the MMA truncates unconverted low bits), and every k-step
// accumulates a_lo·b_hi, a_hi·b_lo and a_hi·b_hi in float32, small terms
// first; what is left out, a_lo·b_lo, is ~2⁻²² of each product.  bfloat16
// values are exact in TF32 (lo = 0), so the same body runs one MMA per
// k-step for them (SPLIT = 1).  The tensor cores' float32 sums truncate,
// relative to the largest addend, so each slab of 32 values of k sums into
// a fresh partial sum, added to the register total with round-to-nearest,
// and all of a slab's small terms go before its large ones.  For the same
// reason the two-pair product walks the step half −Qᵀ·G first: its partial
// sums (η·mask is small) then go into a total that is still small, and
// only the mix half's round the total at full size.
//
// Layout.  The kernel computes outᵀ = Aᵀ·B with A = [G; W] (or W) from
// registers and B = [−Q; P] (or P) from shared memory:
// - TF32 wgmma reads shared-memory operands K-major only, and neither W
//   (N-major: W[i][d]) nor P (P[i][j]) is.  P and Q are small: a first
//   kernel, split_kernel, writes Bᵀ split into hi and lo ((E, 2, N, KB)
//   float32 scratch, KB = pairs·Kp, Kp = N rounded up to 32): with two
//   pairs k < Kp holds −Qᵀ and Kp ≤ k < 2·Kp holds Pᵀ, each half
//   zero-padded from N to Kp on its own.  Negating Q there keeps the main
//   loop free of signs.  The main
//   kernel copies Bᵀ with 16-byte cp.async into 128-byte-swizzled K-major
//   tiles -- the layout wgmma's descriptors name.
// - A goes through a 3-stage cp.async ring as it lies (rows of i, 16-byte
//   copies where D and every pointer allow, else 4-byte copies for float32
//   and plain loads for bfloat16): with two pairs slab kt < Kp/32 copies
//   rows of G, a later slab rows of W, each from its own pointer, so the
//   stacked [G; W] never exists in device memory.  Gathered, the block
//   first copies gidx (clamped) into a table of Kp ints in shared memory,
//   and a W slab's row k is copied from row table[k]; the G half and the
//   order of k are as in masked_gossip.  Each thread loads its A fragment from
//   shared memory, splits it in registers and hands it to wgmma m64n64k8.
//   The A rows (d) are permuted so that each thread's four rows are
//   contiguous: its fragment of a k is one vector load, free of bank
//   conflicts (rows padded by 32 bytes), and it stores runs of 4 outputs
//   along d, 128 bytes per row of a warp.
// - A slab goes as two wgmma groups from two register buffers, so one
//   half's fragments load while the other half multiplies.
// A block is 2 warpgroups × two m64 tiles = 256 values of d against 64
// receivers j (the partial and total sums fill the registers, so j tiles
// are 64 wide), for one problem (blockIdx.z = e).  The j tile varies
// fastest over blockIdx.x, so the blocks that read one W tile run together
// and share it through L2.  Ragged N and D are masked here (zero-filled
// copies, skipped stores): the wrapper pads nothing.
// Why wgmma and not mma.sync: mma.sync's TF32 MMA runs at about two thirds
// of wgmma's rate on the H100 (python -m repro_torch.xp.tensor_core_rates),
// and its products are synchronous, so they do not overlap the loads.
#pragma once

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace repro {
namespace tf32mix {

constexpr int BD = 256;      // values of d per block: 2 warpgroups × 128
constexpr int BJ = 64;       // receivers j per block: the wgmma N
constexpr int BK = 32;       // values of k per slab: one 128-byte TF32 row
constexpr int STAGES = 3;    // slabs in flight
constexpr int THREADS = 256;

template <typename T>
struct Smem {
  // A rows padded by 32 bytes: a warp's fragment loads (i = t, d = 4g)
  // then fall on distinct banks
  static constexpr int LDW = BD + 32 / sizeof(T);
  static constexpr int B_TILE = BJ * 128;               // Bᵀ hi or lo: BJ rows
  static constexpr int A_SLAB = BK * LDW * sizeof(T);   // a multiple of 1 KB
  static constexpr int STAGE = 2 * B_TILE + A_SLAB;     // [Bᵀ hi][Bᵀ lo][A]
  static constexpr int BYTES = STAGES * STAGE + 1024;   // + room to align
};

// K contiguous elements, loaded and stored as one vector
template <typename T, int K>
struct alignas(sizeof(T) * K) Vec {
  T v[K];
};

// 4 bytes from src to dst in shared memory, zero-filled unless bytes == 4
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

// Copy rows r0 .. r0 + ROWS and columns c0 .. c0 + COLS of a row-major
// (n_rows, n_cols) matrix into dst (row length LD), zero outside it.
// GATHER: slab row r is the source's row table[r0 + r] (shared memory,
// valid for every r0 + r below the slab's end) instead of row r0 + r.
template <typename T, int ROWS, int COLS, int LD, bool VEC, bool GATHER = false>
__device__ __forceinline__ void load_slab(T* dst, const T* src, int r0,
                                          int n_rows, long long c0,
                                          long long n_cols, int tid,
                                          const int* table = nullptr) {
  auto row = [&](int r) -> long long {
    if constexpr (GATHER) return table[r0 + r];
    else return r0 + r;
  };
  if constexpr (VEC) {      // n_cols is a multiple of a 16-byte chunk
    constexpr int EPC = 16 / sizeof(T);
    constexpr int CPR = COLS / EPC;
#pragma unroll
    for (int c = tid; c < ROWS * CPR; c += THREADS) {
      const int r = c / CPR, cc = (c % CPR) * EPC;
      const bool ok = r0 + r < n_rows && c0 + cc < n_cols;
      const T* g = ok ? src + row(r) * n_cols + c0 + cc : src;
      cp_async16(smem_addr(dst + r * LD + cc), g, ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int c = tid; c < ROWS * COLS; c += THREADS) {
      const int r = c / COLS, cc = c % COLS;
      const bool ok = r0 + r < n_rows && c0 + cc < n_cols;
      const long long at = row(r) * n_cols + c0 + cc;
      if constexpr (sizeof(T) == 4) {
        cp_async4(dst + r * LD + cc, ok ? src + at : src, ok ? 4 : 0);
      } else {
        dst[r * LD + cc] = ok ? src[at] : from_f32<T>(0.f);
      }
    }
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo in TF32; for SPLIT == 1 (bfloat16 inputs, exact in TF32)
// only hi, which is x itself.
template <int SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (SPLIT == 3) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// Bt[e][0][j][h·Kp + i] = hi(±M[e][i][j]), Bt[e][1][...] = lo(...), zero
// for N ≤ i < Kp, with M = P (+) in the last half h = pairs − 1 and M = Q
// (−) in the first half of two; a 32 × 32 tile per block, transposed
// through shared memory.  blockIdx.x runs over the pairs·Kp/32 tiles of k.
// Rounding is symmetric, so the parts of −x are those of x negated.
template <typename T, int SPLIT>
__global__ void __launch_bounds__(256)
split_kernel(const T* __restrict__ P, const T* __restrict__ Q,
             float* __restrict__ Bt, int N, int Kp, int pairs) {
  __shared__ float tile[32][33];
  const long long e = blockIdx.z;
  const long long kb = static_cast<long long>(pairs) * Kp;
  const int tiles = Kp / 32;
  const int h = blockIdx.x / tiles;
  const bool step = h < pairs - 1;
  const T* M = (step ? Q : P) + e * N * N;
  const float sign = step ? -1.f : 1.f;
  Bt += e * 2 * N * kb;
  const int i0 = (blockIdx.x % tiles) * 32, j0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int i = i0 + r, j = j0 + tx;
    tile[r][tx] = i < N && j < N
        ? sign * to_f32(M[static_cast<long long>(i) * N + j]) : 0.f;
  }
  __syncthreads();
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int j = j0 + r;
    if (j >= N) continue;
    uint32_t hi, lo;
    split<SPLIT>(tile[tx][r], hi, lo);
    const long long k = static_cast<long long>(h) * Kp + i0 + tx;
    Bt[j * kb + k] = __uint_as_float(hi);
    if constexpr (SPLIT == 3) Bt[(N + j) * kb + k] = __uint_as_float(lo);
  }
}

// d (64 × 64 float32) = A (64 × 8, TF32 in registers) · B (8 × 64, TF32
// K-major in shared memory) + (add ? d : 0)
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t db, int add) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(add));
}

// outᵀ = [W; G]ᵀ·B over nk = PAIRS·Kp/BK slabs; G is read only when
// PAIRS == 2 (a template parameter, so that the one-pair body keeps no G).
// GATHER (two pairs, E = 1): the W half reads row gidx[k] of W's n_w rows
// for k < N, each index clamped into [0, n_w).
template <typename T, bool VEC, int PAIRS, bool GATHER>
__global__ void __launch_bounds__(THREADS, 1)
mix_kernel(const T* __restrict__ W, const T* __restrict__ G,
           const float* __restrict__ Bt, T* __restrict__ out, int N, int D,
           int Kp, int n_jt, const int* __restrict__ gidx, int n_w) {
  static_assert(!GATHER || PAIRS == 2, "the gather is of the W half of two");
  using L = Smem<T>;
  constexpr int SPLIT = std::is_same<T, float>::value ? 3 : 1;
  constexpr int NACC = BJ / 2;    // accumulator registers of an m64 tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);

  const long long e = blockIdx.z;
  const long long nd = static_cast<long long>(N) * D;
  const long long kb = static_cast<long long>(PAIRS) * Kp;
  W += e * nd;
  if constexpr (PAIRS == 2) G += e * nd;
  out += e * nd;
  Bt += e * 2 * N * kb;

  const int tid = threadIdx.x;
  // read through a shuffle, so that the compiler sees it uniform over the
  // warpgroup and keeps the wgmma below asynchronous
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int j0 = (blockIdx.x % n_jt) * BJ;
  const long long d0 = static_cast<long long>(blockIdx.x / n_jt) * BD;
  const int nk_half = Kp / BK;
  const int nk = PAIRS * nk_half;
  // the gather's row table, after the stages (Kp ints: rows N .. Kp pad)
  int* table = reinterpret_cast<int*>(smem + STAGES * L::STAGE);
  if constexpr (GATHER) {
    for (int k = tid; k < Kp; k += THREADS)
      table[k] = k < N ? min(max(gidx[k], 0), n_w - 1) : 0;
    __syncthreads();
  }

  auto load = [&](int kt) {
    unsigned char* st = smem + (kt % STAGES) * L::STAGE;
    // Bᵀ hi (and lo): rows j0 .. j0 + BJ, k = kt·BK .. + BK, swizzled
#pragma unroll
    for (int c = tid; c < (SPLIT == 3 ? 2 : 1) * BJ * 8; c += THREADS) {
      const int lo = c / (BJ * 8), r = (c / 8) % BJ, ch = c % 8;
      const bool ok = j0 + r < N;
      const float* src = ok ? Bt + (static_cast<long long>(lo) * N + j0 + r) * kb
                                   + kt * BK + ch * 4
                            : Bt;
      cp_async16(smem_addr(st + lo * L::B_TILE + r * 128 + ((ch ^ (r % 8)) * 16)),
                 src, ok ? 16 : 0);
    }
    // A: with two pairs rows of G for the first Kp values of k, then rows
    // of W (gathered through the table); with one, rows of W
    const bool step = PAIRS == 2 && kt < nk_half;
    T* a_dst = reinterpret_cast<T*>(st + 2 * L::B_TILE);
    const int r0 = (kt - (PAIRS == 2 && !step ? nk_half : 0)) * BK;
    if constexpr (GATHER) {
      if (step)
        load_slab<T, BK, BD, L::LDW, VEC>(a_dst, G, r0, N, d0, D, tid);
      else
        load_slab<T, BK, BD, L::LDW, VEC, true>(a_dst, W, r0, N, d0, D, tid,
                                                table);
    } else {
      load_slab<T, BK, BD, L::LDW, VEC>(a_dst, step ? G : W, r0, N, d0, D,
                                        tid);
    }
  };

  // A slab's 12 products go to a fresh partial sum (part), then added to
  // the total in registers, rounded to nearest.  One running sum over
  // N = 256 misses the float32 bound for outputs of order 10; the slab sums
  // stay closer to the exact product than cuBLAS's float32 product
  // (chip_smoke.py phase 2 prints both).
  float total[2][NACC], part[2][NACC];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int r = 0; r < NACC; ++r) total[mt][r] = 0.f;

  // A: this thread's rows are d = 128·wg + 32·warp + 4g + q, q < 4 (m64
  // tile q / 2, fragment row g + 8·(q % 2)); a k-step s reads them at
  // k = 8s + t and 8s + t + 4, one vector load each
  auto fragments = [&](const T* w, int s0, uint32_t (&hi)[2][2][4],
                       uint32_t (&lo)[2][2][4]) {
    w += 128 * wg + 32 * warp + 4 * g;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float x[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const Vec<T, 4> r = *reinterpret_cast<const Vec<T, 4>*>(
            w + (8 * (s0 + s) + t + 4 * u) * L::LDW);
#pragma unroll
        for (int q = 0; q < 4; ++q) x[u][q] = to_f32(r.v[q]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)   // a0..a3: (row, k) = (g, t) (g+8, t) (g, t+4) (g+8, t+4)
          split<SPLIT>(x[c / 2][2 * mt + c % 2], hi[s][mt][c], lo[s][mt][c]);
    }
  };
  // The products of k-steps s0, s0 + 1 of the slab in stage st: the small
  // terms a_lo·b_hi and a_hi·b_lo, and the large a_hi·b_hi.  The slab's
  // first product starts part afresh.
  auto small_terms = [&](const unsigned char* st, int s0,
                         const uint32_t (&hi)[2][2][4],
                         const uint32_t (&lo)[2][2][4]) {
    const uint32_t b_hi = smem_addr(st), b_lo = b_hi + L::B_TILE;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        wgmma_tf32(part[mt], lo[s][mt], sw128_desc(b_hi + 32 * (s0 + s), 0),
                   s0 + s > 0);
        wgmma_tf32(part[mt], hi[s][mt], sw128_desc(b_lo + 32 * (s0 + s), 0), 1);
      }
  };
  auto large_terms = [&](const unsigned char* st, int s0,
                         const uint32_t (&hi)[2][2][4]) {
    const uint32_t b_hi = smem_addr(st);
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        wgmma_tf32(part[mt], hi[s][mt], sw128_desc(b_hi + 32 * (s0 + s), 0),
                   SPLIT == 3 || s0 + s > 0);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s);
    cp_async_commit();
  }

  // A slab goes as two wgmma groups from two register buffers (k-steps
  // 0, 1 and 2, 3), so the second half's fragments are loaded and split
  // while the first half's products run; the wait at the slab's end frees
  // its stage and part.  In float32 the first group holds the small terms
  // of k-steps 0, 1 and the second those of 2, 3, then the four a_hi·b_hi
  // products: every small term is summed while part is still small, and
  // only the large products add to a part of full size.
  uint32_t hi0[2][2][4], lo0[2][2][4], hi1[2][2][4], lo1[2][2][4];
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();              // slab kt is in; slab kt − 1 is done
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1);
    cp_async_commit();
    const unsigned char* st = smem + (kt % STAGES) * L::STAGE;
    const T* a = reinterpret_cast<const T*>(st + 2 * L::B_TILE);
    fragments(a, 0, hi0, lo0);
    wgmma_fence();
    if constexpr (SPLIT == 3) small_terms(st, 0, hi0, lo0);
    else large_terms(st, 0, hi0);
    wgmma_commit();
    fragments(a, 2, hi1, lo1);
    wgmma_fence();
    if constexpr (SPLIT == 3) {
      small_terms(st, 2, hi1, lo1);
      large_terms(st, 0, hi0);
    }
    large_terms(st, 2, hi1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      fence_acc(part[mt]);
#pragma unroll
      for (int r = 0; r < NACC; ++r) total[mt][r] += part[mt][r];
    }
  }

  // total[mt][4·jn + 2·h + c] is (d = 128·wg + 32·warp + 4g + 2·mt + h,
  // j = 8·jn + 2t + c) of the block's tile: 4 contiguous d per (jn, c)
  const long long d = d0 + 128 * wg + 32 * warp + 4 * g;
#pragma unroll
  for (int jn = 0; jn < BJ / 8; ++jn)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = j0 + 8 * jn + 2 * t + c;
      if (j >= N) continue;
      Vec<T, 4> v;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v.v[q] = from_f32<T>(total[q / 2][4 * jn + 2 * (q % 2) + c]);
      T* o = out + static_cast<long long>(j) * D + d;
      if constexpr (VEC) {     // D is a multiple of 4: whole runs
        if (d < D) *reinterpret_cast<Vec<T, 4>*>(o) = v;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (d + q < D) o[q] = v.v[q];
      }
    }
}

// lanes the gather's row table holds at most: Kp ints beside the stages
constexpr int MAX_GATHER = 16384;

template <typename T, bool VEC, int PAIRS, bool GATHER>
int launch_tile(const T* W, const T* G, const float* Bt, T* out, int E, int N,
                int D, int Kp, const int* gidx, int n_w, cudaStream_t stream) {
  // the limit is set once, for the largest table; a launch asks for its own
  constexpr int limit = Smem<T>::BYTES + (GATHER ? 4 * MAX_GATHER : 0);
  const int bytes = Smem<T>::BYTES + (GATHER ? 4 * Kp : 0);
  static std::atomic<bool> smem_set[kMaxDevices];
  cudaError_t err = smem_limit_once(
      smem_set,
      reinterpret_cast<const void*>(mix_kernel<T, VEC, PAIRS, GATHER>), limit);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_jt = ceil_div(N, BJ);
  const long long blocks = n_jt * ceil_div(D, BD);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), 1, static_cast<unsigned>(E));
  mix_kernel<T, VEC, PAIRS, GATHER><<<grid, THREADS, bytes, stream>>>(
      W, G, Bt, out, N, D, Kp, static_cast<int>(n_jt), gidx, n_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int PAIRS, bool GATHER = false>
int launch(const void* W, const void* G, const void* P, const void* Q,
           void* out, void* scratch, int E, int N, int D, cudaStream_t stream,
           const int* gidx = nullptr, int n_w = 0) {
  constexpr int SPLIT = std::is_same<T, float>::value ? 3 : 1;
  const int Kp = static_cast<int>(ceil_div(N, BK) * BK);
  float* Bt = static_cast<float*>(scratch);
  const dim3 pgrid(static_cast<unsigned>(PAIRS * Kp / 32),
                   static_cast<unsigned>(ceil_div(N, 32)),
                   static_cast<unsigned>(E));
  split_kernel<T, SPLIT><<<pgrid, 256, 0, stream>>>(
      static_cast<const T*>(P), static_cast<const T*>(Q), Bt, N, Kp, PAIRS);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* w = static_cast<const T*>(W);
  const T* g = static_cast<const T*>(G);
  T* o = static_cast<T*>(out);
  // 16-byte copies need every row of W (and G), and every problem, to
  // start on a 16-byte boundary
  const bool vec = D % (16 / sizeof(T)) == 0 &&
      (reinterpret_cast<uintptr_t>(W) | reinterpret_cast<uintptr_t>(G) |
       reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  return vec ? launch_tile<T, true, PAIRS, GATHER>(w, g, Bt, o, E, N, D, Kp,
                                                   gidx, n_w, stream)
             : launch_tile<T, false, PAIRS, GATHER>(w, g, Bt, o, E, N, D, Kp,
                                                    gidx, n_w, stream);
}

// The product of E problems for dtype code `dtype`: PAIRS = 1 takes W and
// P (G and Q null), PAIRS = 2 also G and Q.  scratch holds
// E·2·N·PAIRS·Kp float32, 16-byte aligned.
template <int PAIRS>
int dispatch(int dtype, const void* W, const void* G, const void* P,
             const void* Q, void* out, void* scratch, int E, int N, int D,
             void* stream) {
  static_assert(PAIRS == 1 || PAIRS == 2, "one or two operand pairs");
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  if ((G != nullptr) != (PAIRS == 2) || (Q != nullptr) != (PAIRS == 2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(scratch) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (dtype == kFloat32)
    return launch<float, PAIRS>(W, G, P, Q, out, scratch, E, N, D, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16, PAIRS>(W, G, P, Q, out, scratch, E, N, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tf32mix
}  // namespace repro
