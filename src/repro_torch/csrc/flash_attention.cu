// Flash attention for the training path: the forward (o and the row
// logsumexp), the dq backward pass and the dk/dv backward pass.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   flash_fwd_kernel  <- _kernel          (reached through flash_attention)
//   flash_dq_kernel   <- _bwd_dq_kernel   (reached through flash_attention_bwd)
//   flash_dkv_kernel  <- _bwd_dkv_kernel  (reached through flash_attention_bwd)
//
// Layout.  q/o/do/dq (B*H, Sq, hd), k/v/dk/dv (B*KV, Skv, hd), all
// contiguous; lse/delta (B*H, Sq) f32.  GQA: q head bh reads kv head bh / G
// (G = H / KV), as the TPU kernels' index maps do.  hd is 32, 64 or 128; Sq
// and Skv need not be multiples of the tiles (ragged edges are masked).
//
// Semantics.  Scores s = (q.k) * scale, then softcap: s = tanh(s / c) * c,
// then the causal / window mask sets s = NEG_INF (-1e30), exactly as the
// reference (flash_attention.py:40,86,100).  A row with no valid key at all
// therefore has p = exp(0) = 1 on every key: o = mean(v), lse = -1e30, which
// the forward reproduces.  The backward recomputes p = exp(s - lse) and gives
// masked entries p = ds = 0; on every row with a valid key that is what both
// reference backward paths compute.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16).  At the train path's
// shape (1 x 16 heads x 2048 x 128, bf16, causal) the forward does 17.2
// GFLOP against 33.6 MB of q/k/v/o: ~17 us on the tensor cores, compute
// side of the roofline.  The backward passes are likewise matrix products
// (2.5x the forward's flops between them).  So the design keeps every
// score tile on chip and multiplies on the tensor cores:
//
//  * One 128-thread block per (q tile, batch*q-head) in the forward and the
//    dq pass, and per (k tile, batch*kv-head) in the dk/dv pass.  The TPU
//    grid's sequential kv axis (or, for dk/dv, its (group, q) axis) is a
//    loop inside the block: Hopper blocks run in no order and cannot carry
//    scratch from one grid step to the next.  The dk/dv block loops over
//    every q head of its KV group, so the GQA sum happens in the kernel.
//  * All tiles live in shared memory: operands in the input dtype, scores,
//    their cotangents and the accumulators (o, dq, dk, dv) in f32.  The
//    online-softmax rescale of the o accumulator is an elementwise pass on
//    shared memory, so no accumulator layout has to be known.
//  * bf16 products run on the tensor cores through WMMA 16x16x16 fragments
//    with f32 accumulation (p and ds are rounded to bf16 before their
//    products, as every bf16 flash kernel does); 64 x 64 tiles.  f32
//    products stay on the FMA units, exact; 32 x 32 tiles.
//  * Dead tiles (fully masked by causal / window) are skipped in all three
//    passes by the reference's _tile_live rule, which is exact for a band
//    mask; the forward treats rows with no valid key in a short epilogue.
//
// Not yet done (later PRs): register-resident accumulators with mma.sync /
// wgmma, TMA or cp.async double buffering of the k/v (q/do) tiles, and a
// split of the dk/dv loop across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;

template <typename T> struct Tiles;
template <> struct Tiles<float> { static constexpr int BQ = 32, BK = 32, PAD = 4; };
template <> struct Tiles<bf16> { static constexpr int BQ = 64, BK = 64, PAD = 8; };

__host__ __device__ constexpr size_t rnd(size_t b) { return (b + 127) / 128 * 128; }

// Shared-memory plan of the three kernels; every region starts 128-byte
// aligned (WMMA wants 32).
template <typename T, int HD>
struct Dims {
  static constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  static constexpr int LDT = HD + Tiles<T>::PAD;  // q / k / v / do tiles (T)
  static constexpr int LDP = BK + Tiles<T>::PAD;  // p / ds tiles (T)
  static constexpr int LDS = BK + 4;              // score tiles (f32)
  static constexpr int LDO = HD + 4;              // accumulators (f32)
  static constexpr size_t TQ = rnd(sizeof(T) * BQ * LDT);
  static constexpr size_t TK = rnd(sizeof(T) * BK * LDT);
  static constexpr size_t TP = rnd(sizeof(T) * BQ * LDP);
  static constexpr size_t FS = rnd(4 * BQ * LDS);
  static constexpr size_t FQ = rnd(4 * BQ * LDO);
  static constexpr size_t FK = rnd(4 * BK * LDO);
  static constexpr size_t ROW = rnd(4 * BQ);
  static constexpr size_t FWD = TQ + 2 * TK + TP + FS + FQ + 3 * ROW;
  static constexpr size_t DQ = 2 * TQ + 2 * TK + TP + 2 * FS + FQ + 2 * ROW;
  static constexpr size_t DKV = 2 * TQ + 2 * TK + 2 * TP + 2 * FS + 2 * FK + 2 * ROW;
  static_assert(DKV <= 232448 && DQ <= 232448 && FWD <= 232448,
                "tiles exceed a block's shared memory");
};

struct Smem {
  unsigned char* p;
  template <typename U>
  __device__ __forceinline__ U* take(int n) {
    U* r = reinterpret_cast<U*>(p);
    p += rnd(sizeof(U) * (size_t)n);
    return r;
  }
};

struct Mask {
  int Sq, Skv, causal, has_window, window;
  float scale, softcap;  // softcap <= 0: none
};

__device__ __forceinline__ bool valid(const Mask& m, int q, int k) {
  bool ok = q < m.Sq && k < m.Skv;
  if (m.causal) ok = ok && q >= k;
  if (m.has_window) ok = ok && q - k < m.window;
  return ok;
}

// flash_attention.py:164 _tile_live: false iff the tile is fully masked
__device__ __forceinline__ bool tile_live(const Mask& m, int q0, int bq, int k0, int bk) {
  bool live = true;
  if (m.causal) live = live && q0 + bq - 1 >= k0;
  if (m.has_window) live = live && q0 - (k0 + bk - 1) < m.window;
  return live;
}

// scaled, soft-capped score; t = tanh(s / c) for the backward's chain rule
__device__ __forceinline__ float score(const Mask& m, float raw, float* t) {
  float s = raw * m.scale;
  *t = 0.f;
  if (m.softcap > 0.f) {
    *t = tanhf(s / m.softcap);
    s = *t * m.softcap;
  }
  return s;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// R rows of HD elements (row stride HD in global memory) into a tile with row
// stride LD; rows at or past `rows` are zero.  16-byte loads.
template <typename T, int R, int HD, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int rows) {
  constexpr int EPC = 16 / sizeof(T);
  constexpr int CPR = HD / EPC;
  for (int c = threadIdx.x; c < R * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * EPC;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows) v = *reinterpret_cast<const uint4*>(src + (size_t)r * HD + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = v;
  }
}

// C[M][N] (f32, row stride ldc) = (acc ? C : 0) + A * B, depth K.
// A(i, k) = A[i * lda + k] if A_ROW else A[k * lda + i];
// B(k, j) = B[k * ldb + j] if B_ROW else B[j * ldb + k].
// The caller synchronises before and after.
template <int M, int N, int K, bool A_ROW, bool B_ROW>
__device__ __forceinline__ void block_mm(float* C, int ldc, const float* A, int lda,
                                         const float* B, int ldb, bool acc) {
  for (int idx = threadIdx.x; idx < M * N; idx += THREADS) {
    const int i = idx / N, j = idx % N;
    float s = acc ? C[i * ldc + j] : 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float a = A_ROW ? A[i * lda + k] : A[k * lda + i];
      const float b = B_ROW ? B[k * ldb + j] : B[j * ldb + k];
      s = fmaf(a, b, s);
    }
    C[i * ldc + j] = s;
  }
}

template <int M, int N, int K, bool A_ROW, bool B_ROW>
__device__ __forceinline__ void block_mm(float* C, int ldc, const bf16* A, int lda,
                                         const bf16* B, int ldb, bool acc) {
  using namespace nvcuda;
  using LA = typename std::conditional<A_ROW, wmma::row_major, wmma::col_major>::type;
  using LB = typename std::conditional<B_ROW, wmma::row_major, wmma::col_major>::type;
  static_assert(M % 16 == 0 && N % 16 == 0 && K % 16 == 0, "WMMA tiles are 16x16x16");
  constexpr int TN = N / 16;
  for (int t = threadIdx.x / 32; t < (M / 16) * TN; t += NWARPS) {
    const int i0 = (t / TN) * 16, j0 = (t % TN) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (acc)
      wmma::load_matrix_sync(c, C + i0 * ldc + j0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.f);
#pragma unroll 4
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
      wmma::load_matrix_sync(a, A_ROW ? A + i0 * lda + k : A + k * lda + i0, lda);
      wmma::load_matrix_sync(b, B_ROW ? B + k * ldb + j0 : B + j0 * ldb + k, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + i0 * ldc + j0, c, ldc, wmma::mem_row_major);
  }
}

// ------------------------------------------------------------------ forward

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int G, Mask mk) {
  using D = Dims<T, HD>;
  constexpr int BQ = D::BQ, BK = D::BK, LDT = D::LDT, LDP = D::LDP, LDS = D::LDS,
                LDO = D::LDO;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int any_dead;
  Smem sm{smem_raw};
  T* Qs = sm.take<T>(BQ * LDT);
  T* Ks = sm.take<T>(BK * LDT);
  T* Vs = sm.take<T>(BK * LDT);
  T* Ps = sm.take<T>(BQ * LDP);
  float* Ss = sm.take<float>(BQ * LDS);
  float* Os = sm.take<float>(BQ * LDO);
  float* m_s = sm.take<float>(BQ);
  float* l_s = sm.take<float>(BQ);
  float* a_s = sm.take<float>(BQ);

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int q_rows = min(BQ, mk.Sq - q0);
  const T* kb = k + (size_t)(bh / G) * mk.Skv * HD;
  const T* vb = v + (size_t)(bh / G) * mk.Skv * HD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows<T, BQ, HD, LDT>(Qs, q + ((size_t)bh * mk.Sq + q0) * HD, q_rows);
  for (int i = threadIdx.x; i < BQ * LDO; i += THREADS) Os[i] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  if (threadIdx.x == 0) any_dead = 0;
  __syncthreads();

  const int nk = (mk.Skv + BK - 1) / BK;
  for (int jt = 0; jt < nk; ++jt) {
    const int k0 = jt * BK;
    if (!tile_live(mk, q0, BQ, k0, BK)) continue;
    const int k_rows = min(BK, mk.Skv - k0);
    load_rows<T, BK, HD, LDT>(Ks, kb + (size_t)k0 * HD, k_rows);
    load_rows<T, BK, HD, LDT>(Vs, vb + (size_t)k0 * HD, k_rows);
    __syncthreads();
    block_mm<BQ, BK, HD, true, false>(Ss, LDS, Qs, LDT, Ks, LDT, false);
    __syncthreads();
    for (int r = warp; r < BQ; r += NWARPS) {
      float mx = -INFINITY;
      for (int c = lane; c < BK; c += 32) {
        float t;
        float s = score(mk, Ss[r * LDS + c], &t);
        if (c >= k_rows) s = -INFINITY;  // past Skv: no key at all
        else if (!valid(mk, q0 + r, k0 + c)) s = NEG_INF;
        Ss[r * LDS + c] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(Ss[r * LDS + c] - m_new);
        Ps[r * LDP + c] = from_f<T>(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < BQ * HD; i += THREADS) Os[(i / HD) * LDO + i % HD] *= a_s[i / HD];
    __syncthreads();
    block_mm<BQ, HD, BK, true, true>(Os, LDO, Ps, LDP, Vs, LDT, true);
    __syncthreads();
  }

  // Rows with no valid key: every score is NEG_INF, so the reference's
  // p = exp(s - m) is 1 on all Skv keys and o = mean(v).  Skipped tiles left
  // their sums partial; redo them over every key.
  for (int r = threadIdx.x; r < q_rows; r += THREADS)
    if (m_s[r] == NEG_INF) any_dead = 1;
  __syncthreads();
  if (any_dead) {
    for (int i = threadIdx.x; i < BQ * HD; i += THREADS)
      if (m_s[i / HD] == NEG_INF) Os[(i / HD) * LDO + i % HD] = 0.f;
    for (int r = threadIdx.x; r < BQ; r += THREADS)
      if (m_s[r] == NEG_INF) l_s[r] = (float)mk.Skv;
    for (int jt = 0; jt < nk; ++jt) {
      const int k0 = jt * BK, k_rows = min(BK, mk.Skv - k0);
      __syncthreads();
      load_rows<T, BK, HD, LDT>(Vs, vb + (size_t)k0 * HD, k_rows);
      __syncthreads();
      for (int i = threadIdx.x; i < BQ * HD; i += THREADS) {
        const int r = i / HD, c = i % HD;
        if (m_s[r] != NEG_INF) continue;
        float s = Os[r * LDO + c];
        for (int j = 0; j < k_rows; ++j) s += to_f(Vs[j * LDT + c]);
        Os[r * LDO + c] = s;
      }
    }
    __syncthreads();
  }

  T* ob = o + ((size_t)bh * mk.Sq + q0) * HD;
  for (int i = threadIdx.x; i < q_rows * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    ob[(size_t)r * HD + c] = from_f<T>(Os[r * LDO + c] / fmaxf(l_s[r], 1e-30f));
  }
  for (int r = threadIdx.x; r < q_rows; r += THREADS)
    lse[(size_t)bh * mk.Sq + q0 + r] = m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

// ------------------------------------------------------------- backward

// Recompute one (q tile, k tile) pair: p = exp(s - lse) and the pre-scale
// score cotangent ds = p * (dp - delta) (softcap chain rule applied), both
// zero where masked.  Ss holds q.k^T and dPs holds do.v^T on entry.
template <typename T, int BQ, int BK, int LDS, int LDP, bool WANT_P>
__device__ __forceinline__ void p_ds_tile(const Mask& mk, int q0, int k0, const float* Ss,
                                          const float* dPs, const float* lse_s,
                                          const float* delta_s, T* Ps, T* dSs) {
  for (int i = threadIdx.x; i < BQ * BK; i += THREADS) {
    const int r = i / BK, c = i % BK;
    float t;
    const float s = score(mk, Ss[r * LDS + c], &t);
    float p = 0.f, ds = 0.f;
    if (valid(mk, q0 + r, k0 + c)) {
      p = expf(s - lse_s[r]);
      ds = p * (dPs[r * LDS + c] - delta_s[r]);
      if (mk.softcap > 0.f) ds *= 1.f - t * t;
    }
    if (WANT_P) Ps[r * LDP + c] = from_f<T>(p);
    dSs[r * LDP + c] = from_f<T>(ds);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int G, Mask mk) {
  using D = Dims<T, HD>;
  constexpr int BQ = D::BQ, BK = D::BK, LDT = D::LDT, LDP = D::LDP, LDS = D::LDS,
                LDO = D::LDO;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem sm{smem_raw};
  T* Qs = sm.take<T>(BQ * LDT);
  T* dOs = sm.take<T>(BQ * LDT);
  T* Ks = sm.take<T>(BK * LDT);
  T* Vs = sm.take<T>(BK * LDT);
  T* dSs = sm.take<T>(BQ * LDP);
  float* Ss = sm.take<float>(BQ * LDS);
  float* dPs = sm.take<float>(BQ * LDS);
  float* dQs = sm.take<float>(BQ * LDO);
  float* lse_s = sm.take<float>(BQ);
  float* delta_s = sm.take<float>(BQ);

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int q_rows = min(BQ, mk.Sq - q0);
  const size_t row0 = (size_t)bh * mk.Sq + q0;
  const T* kb = k + (size_t)(bh / G) * mk.Skv * HD;
  const T* vb = v + (size_t)(bh / G) * mk.Skv * HD;

  load_rows<T, BQ, HD, LDT>(Qs, q + row0 * HD, q_rows);
  load_rows<T, BQ, HD, LDT>(dOs, dout + row0 * HD, q_rows);
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    lse_s[r] = r < q_rows ? lse[row0 + r] : 0.f;
    delta_s[r] = r < q_rows ? delta[row0 + r] : 0.f;
  }
  for (int i = threadIdx.x; i < BQ * LDO; i += THREADS) dQs[i] = 0.f;
  __syncthreads();

  const int nk = (mk.Skv + BK - 1) / BK;
  for (int jt = 0; jt < nk; ++jt) {
    const int k0 = jt * BK;
    if (!tile_live(mk, q0, BQ, k0, BK)) continue;
    const int k_rows = min(BK, mk.Skv - k0);
    load_rows<T, BK, HD, LDT>(Ks, kb + (size_t)k0 * HD, k_rows);
    load_rows<T, BK, HD, LDT>(Vs, vb + (size_t)k0 * HD, k_rows);
    __syncthreads();
    block_mm<BQ, BK, HD, true, false>(Ss, LDS, Qs, LDT, Ks, LDT, false);
    block_mm<BQ, BK, HD, true, false>(dPs, LDS, dOs, LDT, Vs, LDT, false);
    __syncthreads();
    p_ds_tile<T, BQ, BK, LDS, LDP, false>(mk, q0, k0, Ss, dPs, lse_s, delta_s, nullptr, dSs);
    __syncthreads();
    block_mm<BQ, HD, BK, true, true>(dQs, LDO, dSs, LDP, Ks, LDT, true);
    __syncthreads();
  }

  T* dqb = dq + row0 * HD;
  for (int i = threadIdx.x; i < q_rows * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    dqb[(size_t)r * HD + c] = from_f<T>(dQs[r * LDO + c] * mk.scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int G, Mask mk) {
  using D = Dims<T, HD>;
  constexpr int BQ = D::BQ, BK = D::BK, LDT = D::LDT, LDP = D::LDP, LDS = D::LDS,
                LDO = D::LDO;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem sm{smem_raw};
  T* Qs = sm.take<T>(BQ * LDT);
  T* dOs = sm.take<T>(BQ * LDT);
  T* Ks = sm.take<T>(BK * LDT);
  T* Vs = sm.take<T>(BK * LDT);
  T* Ps = sm.take<T>(BQ * LDP);
  T* dSs = sm.take<T>(BQ * LDP);
  float* Ss = sm.take<float>(BQ * LDS);
  float* dPs = sm.take<float>(BQ * LDS);
  float* dKs = sm.take<float>(BK * LDO);
  float* dVs = sm.take<float>(BK * LDO);
  float* lse_s = sm.take<float>(BQ);
  float* delta_s = sm.take<float>(BQ);

  const int bkv = blockIdx.y, k0 = blockIdx.x * BK;
  const int k_rows = min(BK, mk.Skv - k0);
  const size_t krow0 = (size_t)bkv * mk.Skv + k0;
  load_rows<T, BK, HD, LDT>(Ks, k + krow0 * HD, k_rows);
  load_rows<T, BK, HD, LDT>(Vs, v + krow0 * HD, k_rows);
  for (int i = threadIdx.x; i < BK * LDO; i += THREADS) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }

  const int nq = (mk.Sq + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int bh = bkv * G + g;
    for (int it = 0; it < nq; ++it) {
      const int q0 = it * BQ;
      if (!tile_live(mk, q0, BQ, k0, BK)) continue;
      const int q_rows = min(BQ, mk.Sq - q0);
      const size_t row0 = (size_t)bh * mk.Sq + q0;
      __syncthreads();  // the previous tile's products are done with Qs / dOs
      load_rows<T, BQ, HD, LDT>(Qs, q + row0 * HD, q_rows);
      load_rows<T, BQ, HD, LDT>(dOs, dout + row0 * HD, q_rows);
      for (int r = threadIdx.x; r < BQ; r += THREADS) {
        lse_s[r] = r < q_rows ? lse[row0 + r] : 0.f;
        delta_s[r] = r < q_rows ? delta[row0 + r] : 0.f;
      }
      __syncthreads();
      block_mm<BQ, BK, HD, true, false>(Ss, LDS, Qs, LDT, Ks, LDT, false);
      block_mm<BQ, BK, HD, true, false>(dPs, LDS, dOs, LDT, Vs, LDT, false);
      __syncthreads();
      p_ds_tile<T, BQ, BK, LDS, LDP, true>(mk, q0, k0, Ss, dPs, lse_s, delta_s, Ps, dSs);
      __syncthreads();
      // dv += p^T do, dk += ds^T q: the (BQ x BK) tiles read transposed
      block_mm<BK, HD, BQ, false, true>(dVs, LDO, Ps, LDP, dOs, LDT, true);
      block_mm<BK, HD, BQ, false, true>(dKs, LDO, dSs, LDP, Qs, LDT, true);
    }
  }
  __syncthreads();

  T* dkb = dk + krow0 * HD;
  T* dvb = dv + krow0 * HD;
  for (int i = threadIdx.x; i < k_rows * HD; i += THREADS) {
    const int r = i / HD, c = i % HD;
    dkb[(size_t)r * HD + c] = from_f<T>(dKs[r * LDO + c] * mk.scale);
    dvb[(size_t)r * HD + c] = from_f<T>(dVs[r * LDO + c]);
  }
}

// ------------------------------------------------------------- launchers

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int HD>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int BH, int G,
        const Mask& mk, cudaStream_t s) {
  using D = Dims<T, HD>;
  auto kern = flash_fwd_kernel<T, HD>;
  cudaError_t e = set_smem(kern, D::FWD);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((mk.Sq + D::BQ - 1) / D::BQ, BH);
  kern<<<grid, THREADS, D::FWD, s>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                     static_cast<const T*>(v), static_cast<T*>(o),
                                     static_cast<float*>(lse), G, mk);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dq_pass(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dq, int BH, int G, const Mask& mk, cudaStream_t s) {
  using D = Dims<T, HD>;
  auto kern = flash_dq_kernel<T, HD>;
  cudaError_t e = set_smem(kern, D::DQ);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((mk.Sq + D::BQ - 1) / D::BQ, BH);
  kern<<<grid, THREADS, D::DQ, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), G, mk);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int dkv_pass(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dk, void* dv, int BKV, int G, const Mask& mk,
             cudaStream_t s) {
  using D = Dims<T, HD>;
  auto kern = flash_dkv_kernel<T, HD>;
  cudaError_t e = set_smem(kern, D::DKV);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((mk.Skv + D::BK - 1) / D::BK, BKV);
  kern<<<grid, THREADS, D::DKV, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), G, mk);
  return (int)cudaGetLastError();
}

bool make_mask(int B, int H, int KV, int Sq, int Skv, int hd, int causal, int has_window,
               int window, float softcap, float scale, Mask* mk) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Sq <= 0 || Skv <= 0) return false;
  if (hd != 32 && hd != 64 && hd != 128) return false;
  if ((long long)B * H > 65535) return false;
  *mk = Mask{Sq, Skv, causal != 0, has_window != 0, window, scale, softcap};
  return true;
}

}  // namespace

#define REPRO_HD_DISPATCH(T, CALL)                     \
  switch (hd) {                                        \
    case 32: { constexpr int HD = 32; return CALL; }   \
    case 64: { constexpr int HD = 64; return CALL; }   \
    case 128: { constexpr int HD = 128; return CALL; } \
  }                                                    \
  return (int)cudaErrorInvalidValue;

extern "C" int repro_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int H, int KV, int Sq, int Skv, int hd, int causal,
                               int has_window, int window, float softcap, float scale,
                               int dtype, void* stream) {
  Mask mk;
  if (!make_mask(B, H, KV, Sq, Skv, hd, causal, has_window, window, softcap, scale, &mk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  if (dtype == 1) {
    REPRO_HD_DISPATCH(bf16, (fwd<bf16, HD>(q, k, v, o, lse, B * H, G, mk, s)))
  } else if (dtype == 0) {
    REPRO_HD_DISPATCH(float, (fwd<float, HD>(q, k, v, o, lse, B * H, G, mk, s)))
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, int B, int H,
                                  int KV, int Sq, int Skv, int hd, int causal, int has_window,
                                  int window, float softcap, float scale, int dtype,
                                  void* stream) {
  Mask mk;
  if (!make_mask(B, H, KV, Sq, Skv, hd, causal, has_window, window, softcap, scale, &mk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  if (dtype == 1) {
    REPRO_HD_DISPATCH(bf16, (dq_pass<bf16, HD>(q, k, v, dout, lse, delta, dq, B * H, G, mk, s)))
  } else if (dtype == 0) {
    REPRO_HD_DISPATCH(float, (dq_pass<float, HD>(q, k, v, dout, lse, delta, dq, B * H, G, mk, s)))
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int repro_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dk, void* dv, int B,
                                   int H, int KV, int Sq, int Skv, int hd, int causal,
                                   int has_window, int window, float softcap, float scale,
                                   int dtype, void* stream) {
  Mask mk;
  if (!make_mask(B, H, KV, Sq, Skv, hd, causal, has_window, window, softcap, scale, &mk))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  if (dtype == 1) {
    REPRO_HD_DISPATCH(bf16, (dkv_pass<bf16, HD>(q, k, v, dout, lse, delta, dk, dv, B * KV, G, mk, s)))
  } else if (dtype == 0) {
    REPRO_HD_DISPATCH(float, (dkv_pass<float, HD>(q, k, v, dout, lse, delta, dk, dv, B * KV, G, mk, s)))
  }
  return (int)cudaErrorInvalidValue;
}
