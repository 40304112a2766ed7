// Ragged grouped GEMM for the dropless MoE: out[m] = lhs[m] @ rhs[e(m)].
//
// Replaces the TPU kernel src/repro/kernels/moe/grouped_gemm.py::_kernel
// (reached through grouped_matmul_pallas).
//
// Layout.  The sort-based dispatch (repro_torch/kernels/moe/dispatch.py)
// permutes tokens into expert-contiguous rows and pads each expert's run to
// a multiple of BM = 64, so every 64-row tile belongs to one expert.  lhs is
// (m_pad, K), rhs (E, K, N) row-major, tile_expert (m_pad/64,) int32, out
// (m_pad, N) in lhs's dtype; f32 accumulation.  bf16 and f32 are taken.
//
// Transposed read (trans_rhs = 1).  The backward's d_lhs is the same product
// against every expert's transposed weights (the reference's
// _run(ct, rhs.transpose(0, 2, 1), ...), moe/ops.py:78).  With trans_rhs the
// kernel takes rhs as the forward's (E, N, K) weights and reads them
// transposed in place: each K chunk of a weight row is one 16-byte load into
// an (n, k) shared tile, which the tensor cores read column-major.  No
// transposed copy (369 MB per projection per layer at qwen2-moe's widths)
// is ever made.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16).  At qwen2-moe-a2.7b's
// decode shapes (4 slots, top-4: 16 routed rows) each projection reads at
// most 16 distinct 2048x1408 bf16 expert matrices (5.77 MB each, ~92 MB)
// for ~0.2 GFLOP of real work: memory-bound, ~27.5 us.  A 128-token-per-slot
// prefill touching all 60 experts reads ~346 MB, ~103 us, still on the
// bytes side of the roofline.  So the design aims at streaming each used
// expert's weights once and at doing no work for the dead tail:
//
//  * One 256-thread block per (64-row tile, 128-column tile).  The block
//    reads tile_expert[blockIdx.x] itself — the TPU kernel's scalar
//    prefetch of the per-tile expert id becomes a plain load.
//  * The TPU kernel keeps K whole per tile in VMEM; 2048 x 128 bf16 alone
//    is 512 KB, far past the 227 KB a Hopper block can hold, so K is walked
//    in 32-deep chunks through shared memory, the next chunk's global loads
//    (16 bytes a thread) issued before the current chunk is multiplied.
//  * bf16 multiplies on the tensor cores through WMMA 16x16x16 fragments,
//    8 warps each owning a 32x32 piece of the 64x128 output tile; f32 runs
//    on the CUDA cores (WMMA has no exact f32 mode).
//  * Dead tiles: the dispatch's padded buffer is sized for the worst case
//    (T*k + E*63 rows), so at decode 48 of its 64 tiles hold no rows at all.
//    n_used_tiles (a device int32, sum of padded group sizes / 64) is read
//    by every block; a tile at or past it writes zeros and returns, which
//    is exactly what the TPU kernel computes for its all-zero padding rows,
//    with no host sync to learn the count.
//
// On an H100 SXM at 700 W (chip_smoke.py) it runs at ~3.5x its bound at
// decode and ~2.2x at prefill.  Not yet done (later PRs): wgmma/TMA
// pipelines, persistent scheduling over
// the used tiles only, and reading each expert's weights once for all of
// its row tiles instead of once per row tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int LDC = BN + 4;             // f32 epilogue staging row stride
constexpr int SMEM_BYTES = BM * LDC * 4;  // >= both operand tiles

template <typename T>
struct Tile {
  static constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int LDA = BK + EPC;        // padded rows keep 16 B alignment
  static constexpr int LDB = BN + EPC;        // B tile as (k, n)
  static constexpr int LDBT = BK + EPC;       // B tile as (n, k): transposed read
  static constexpr int A_CHUNKS = BM * BK / EPC / THREADS;
  static constexpr int B_CHUNKS = BK * BN / EPC / THREADS;
  static_assert(BM * LDA * sizeof(T) + BK * LDB * sizeof(T) <= SMEM_BYTES,
                "operand tiles exceed the staging buffer");
  static_assert(BM * LDA * sizeof(T) + BN * LDBT * sizeof(T) <= SMEM_BYTES,
                "operand tiles exceed the staging buffer");
};

// B(k, n) of expert e: rhs_e[k * N + n], or rhs_e[n * K + k] when TB (the
// weights stored (N, K), read transposed).
template <typename T, bool TB>
__device__ __forceinline__ void load_chunks(const T* __restrict__ lhs,
                                            const T* __restrict__ rhs_e,
                                            int m0, int n0, int k0, int K, int N,
                                            uint4* ra, uint4* rb) {
  using L = Tile<T>;
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int i = 0; i < L::A_CHUNKS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int row = c / (BK / L::EPC);
    const int col = (c % (BK / L::EPC)) * L::EPC;
    const int gk = k0 + col;
    ra[i] = gk < K ? *reinterpret_cast<const uint4*>(lhs + (size_t)(m0 + row) * K + gk)
                   : zero;
  }
#pragma unroll
  for (int i = 0; i < L::B_CHUNKS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    if (TB) {
      const int row = c / (BK / L::EPC);            // n within the tile
      const int col = (c % (BK / L::EPC)) * L::EPC;  // k within the chunk
      const int gn = n0 + row, gk = k0 + col;
      rb[i] = (gk < K && gn < N)
                  ? *reinterpret_cast<const uint4*>(rhs_e + (size_t)gn * K + gk)
                  : zero;
    } else {
      const int row = c / (BN / L::EPC);
      const int col = (c % (BN / L::EPC)) * L::EPC;
      const int gk = k0 + row, gn = n0 + col;
      rb[i] = (gk < K && gn < N)
                  ? *reinterpret_cast<const uint4*>(rhs_e + (size_t)gk * N + gn)
                  : zero;
    }
  }
}

template <typename T, bool TB>
__device__ __forceinline__ void store_chunks(T* As, T* Bs, const uint4* ra,
                                             const uint4* rb) {
  using L = Tile<T>;
#pragma unroll
  for (int i = 0; i < L::A_CHUNKS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    const int row = c / (BK / L::EPC);
    const int col = (c % (BK / L::EPC)) * L::EPC;
    *reinterpret_cast<uint4*>(As + row * L::LDA + col) = ra[i];
  }
#pragma unroll
  for (int i = 0; i < L::B_CHUNKS; ++i) {
    const int c = threadIdx.x + i * THREADS;
    if (TB) {
      const int row = c / (BK / L::EPC);
      const int col = (c % (BK / L::EPC)) * L::EPC;
      *reinterpret_cast<uint4*>(Bs + row * L::LDBT + col) = rb[i];
    } else {
      const int row = c / (BN / L::EPC);
      const int col = (c % (BN / L::EPC)) * L::EPC;
      *reinterpret_cast<uint4*>(Bs + row * L::LDB + col) = rb[i];
    }
  }
}

// Zero the (BM x BN) output tile (dead tiles), 16-byte stores.
template <typename T>
__device__ __forceinline__ void zero_tile(T* __restrict__ out, int m0, int n0, int N) {
  constexpr int EPC = Tile<T>::EPC;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int c = threadIdx.x; c < BM * BN / EPC; c += THREADS) {
    const int row = c / (BN / EPC);
    const int gn = n0 + (c % (BN / EPC)) * EPC;
    if (gn < N) *reinterpret_cast<uint4*>(out + (size_t)(m0 + row) * N + gn) = zero;
  }
}

// ---------------------------------------------------------------- bf16 path

template <bool TB>
__global__ void __launch_bounds__(THREADS)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ lhs,
                const __nv_bfloat16* __restrict__ rhs,
                const int* __restrict__ tile_expert,
                const int* __restrict__ n_used_tiles,
                __nv_bfloat16* __restrict__ out, int K, int N, int E) {
  using namespace nvcuda;
  using L = Tile<__nv_bfloat16>;
  using LB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * L::LDA;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tile = blockIdx.x;
  const int m0 = tile * BM, n0 = blockIdx.y * BN;
  if (tile >= n_used_tiles[0]) {
    zero_tile(out, m0, n0, N);
    return;
  }
  const int e = min(max(tile_expert[tile], 0), E - 1);
  const __nv_bfloat16* rhs_e = rhs + (size_t)e * K * N;

  const int warp = threadIdx.x / 32;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  uint4 ra[L::A_CHUNKS], rb[L::B_CHUNKS];
  load_chunks<__nv_bfloat16, TB>(lhs, rhs_e, m0, n0, 0, K, N, ra, rb);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_chunks<__nv_bfloat16, TB>(As, Bs, ra, rb);
    __syncthreads();
    if (k0 + BK < K) load_chunks<__nv_bfloat16, TB>(lhs, rhs_e, m0, n0, k0 + BK, K, N, ra, rb);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + i * 16) * L::LDA + kk, L::LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j],
                               TB ? Bs + (wn + j * 16) * L::LDBT + kk
                                  : Bs + kk * L::LDB + wn + j * 16,
                               TB ? L::LDBT : L::LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + i * 16) * LDC + wn + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int c = threadIdx.x; c < BM * BN / 8; c += THREADS) {
    const int row = c / (BN / 8);
    const int col = (c % (BN / 8)) * 8;
    const int gn = n0 + col;
    if (gn >= N) continue;
    __align__(16) __nv_bfloat16 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = __float2bfloat16(Cs[row * LDC + col + q]);
    *reinterpret_cast<uint4*>(out + (size_t)(m0 + row) * N + gn) =
        *reinterpret_cast<const uint4*>(v);
  }
}

// ----------------------------------------------------------------- f32 path

template <bool TB>
__global__ void __launch_bounds__(THREADS)
gmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
               const int* __restrict__ tile_expert,
               const int* __restrict__ n_used_tiles, float* __restrict__ out,
               int K, int N, int E) {
  using L = Tile<float>;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + BM * L::LDA;

  const int tile = blockIdx.x;
  const int m0 = tile * BM, n0 = blockIdx.y * BN;
  if (tile >= n_used_tiles[0]) {
    zero_tile(out, m0, n0, N);
    return;
  }
  const int e = min(max(tile_expert[tile], 0), E - 1);
  const float* rhs_e = rhs + (size_t)e * K * N;

  // thread owns rows ty + 16*i (i < 4) and columns tx + 16*j (j < 8)
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  uint4 ra[L::A_CHUNKS], rb[L::B_CHUNKS];
  load_chunks<float, TB>(lhs, rhs_e, m0, n0, 0, K, N, ra, rb);
  for (int k0 = 0; k0 < K; k0 += BK) {
    store_chunks<float, TB>(As, Bs, ra, rb);
    __syncthreads();
    if (k0 + BK < K) load_chunks<float, TB>(lhs, rhs_e, m0, n0, k0 + BK, K, N, ra, rb);
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * L::LDA + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = TB ? Bs[(tx + 16 * j) * L::LDBT + kk] : Bs[kk * L::LDB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < N) out[(size_t)(m0 + ty + 16 * i) * N + gn] = acc[i][j];
    }
}

template <bool TB>
void launch(const void* lhs, const void* rhs, const void* tile_expert,
            const void* n_used_tiles, void* out, int K, int N, int E, int dtype,
            dim3 grid, cudaStream_t s) {
  if (dtype == 1) {
    gmm_bf16_kernel<TB><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(lhs), static_cast<const __nv_bfloat16*>(rhs),
        static_cast<const int*>(tile_expert), static_cast<const int*>(n_used_tiles),
        static_cast<__nv_bfloat16*>(out), K, N, E);
  } else {
    gmm_f32_kernel<TB><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(rhs),
        static_cast<const int*>(tile_expert), static_cast<const int*>(n_used_tiles),
        static_cast<float*>(out), K, N, E);
  }
}

}  // namespace

// rhs is (E, K, N), or (E, N, K) read transposed when trans_rhs is 1.
extern "C" int repro_grouped_gemm(const void* lhs, const void* rhs,
                                  const void* tile_expert, const void* n_used_tiles,
                                  void* out, int m_pad, int K, int N, int E,
                                  int block_m, int trans_rhs, int dtype, void* stream) {
  if (block_m != BM || m_pad % BM != 0 || K <= 0 || N <= 0 || E <= 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (m_pad == 0) return 0;
  const dim3 grid(m_pad / BM, (N + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans_rhs)
    launch<true>(lhs, rhs, tile_expert, n_used_tiles, out, K, N, E, dtype, grid, s);
  else
    launch<false>(lhs, rhs, tile_expert, n_used_tiles, out, K, N, E, dtype, grid, s);
  return (int)cudaGetLastError();
}
