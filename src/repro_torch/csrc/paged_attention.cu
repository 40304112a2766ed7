// Paged decode attention: one query position per slot, K/V read through a
// per-slot page table into a shared pool of physical pages.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py::_paged_kernel
// (reached through paged_attention_pallas).
//
// Shapes: q (B, H, hd); k/v pool (P, page, KV, hd); pos pool (P, page) int32
// (-1 = never written); page_table (B, n_pages) int32 (-1 = unmapped);
// t (B,) int32; out (B, H*hd) in q's dtype.  A position is attended when its
// page is mapped, pos >= 0, pos <= t[b], its logical index is below kv_len
// and, with a window, t[b] - pos < window.  Scores are scaled by hd^-0.5,
// optionally soft-capped (tanh(s/cap)*cap), and folded into a running
// max/sum in f32 page by page; out = acc / max(l, 1e-37).
//
// Bound on an H100 SXM (3.35 TB/s).  qwen2-moe-a2.7b at the serving smoke
// shape (4 slots, 36-126 cached positions each, 16 KV heads x 128, bf16)
// reads ~2.6 MB of valid K/V per layer: a bound of ~0.8 us.  This kernel
// takes ~0.1 ms there (chip_smoke.py on an H100 SXM at 700 W), ~126x the
// bound and far above a launch's cost: it is latency-bound.  For qwen2
// G = H/KV = 1, so the grid is 4 x 16 = 64 blocks on 132 SMs, and each block
// walks its pages one after another — per page a dependent chain of page
// table, pos, K and V loads split by four __syncthreads, with each head's
// max/exp/sum on a single thread — so few loads are in flight at once.  The
// next step is to split the pages over more blocks, flash-decoding style
// (partial m/l/acc per page range, then a reduce), with a warp-parallel
// softmax (ROADMAP.md queue 2).  This version is the simple one:
//
//  * One block (128 threads) per (slot b, kv head).  The block holds that
//    head's G = H/KV query heads.
//  * The TPU grid's sequential page axis, whose m/l/acc scratch carried
//    across grid steps, becomes a loop over pages inside the block; the
//    block reads page_table[b, j] and t[b] itself (the TPU kernel had them
//    scalar-prefetched).  Unmapped pages and pages past kv_len are skipped,
//    which leaves m/l/acc exactly as the masked TPU step would.
//  * Per page each warp takes (head, position) pairs: a coalesced read of
//    one K row (hd contiguous values), a warp-shuffle dot product, then the
//    mask; one thread per head updates the running max and sum; the threads
//    then accumulate p·V across hd, again one coalesced V row per position.
//  * window and softcap are runtime arguments (window <= 0 and softcap <= 0
//    mean "none"), so the twin's full parity grid applies to this kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool, const int* __restrict__ pos_pool,
                       const int* __restrict__ page_table, const int* __restrict__ tq,
                       T* __restrict__ out, int H, int KV, int hd, int P, int page,
                       int n_pages, int kv_len, int window, float softcap,
                       float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int G = H / KV;
  float* qs = sm;                  // (G, hd) query, f32
  float* acc = qs + G * hd;        // (G, hd) running P·V
  float* s = acc + G * hd;         // (G, page) scores, then probabilities
  float* m = s + G * page;         // (G,) running max
  float* l = m + G;                // (G,) running sum
  float* alpha = l + G;            // (G,) rescale of this page
  int* valid = reinterpret_cast<int*>(alpha + G);  // (page,)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_warps = THREADS / 32;
  for (int i = tid; i < G * hd; i += THREADS) {
    const int g = i / hd, d = i % hd;
    qs[i] = to_f(q[((size_t)b * H + kvh * G + g) * hd + d]);
    acc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m[g] = NEG_INF;
    l[g] = 0.0f;
  }
  const int t = tq[b];
  __syncthreads();

  for (int j = 0; j < n_pages && j * page < kv_len; ++j) {
    int phys = page_table[(size_t)b * n_pages + j];
    if (phys < 0) continue;                  // unmapped: contributes nothing
    phys = min(phys, P - 1);                 // the reference clips the index
    const size_t row0 = (size_t)phys * page;

    for (int p = tid; p < page; p += THREADS) {
      const int ps = pos_pool[row0 + p];
      bool ok = ps >= 0 && ps <= t && j * page + p < kv_len;
      if (window > 0) ok = ok && (t - ps) < window;
      valid[p] = ok;
    }
    __syncthreads();

    for (int idx = warp; idx < G * page; idx += n_warps) {
      const int g = idx / page, p = idx % page;
      const T* kr = k_pool + ((row0 + p) * KV + kvh) * hd;
      float dot = 0.0f;
      for (int d = lane; d < hd; d += 32) dot = fmaf(qs[g * hd + d], to_f(kr[d]), dot);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        float sc = dot * scale;
        if (softcap > 0.0f) sc = tanhf(sc / softcap) * softcap;
        s[idx] = valid[p] ? sc : NEG_INF;
      }
    }
    __syncthreads();

    for (int g = tid; g < G; g += THREADS) {
      float mx = m[g];
      for (int p = 0; p < page; ++p) mx = fmaxf(mx, s[g * page + p]);
      const float a = expf(m[g] - mx);
      float sum = 0.0f;
      for (int p = 0; p < page; ++p) {
        const float e = valid[p] ? expf(s[g * page + p] - mx) : 0.0f;
        s[g * page + p] = e;
        sum += e;
      }
      l[g] = l[g] * a + sum;
      m[g] = mx;
      alpha[g] = a;
    }
    __syncthreads();

    for (int i = tid; i < G * hd; i += THREADS) {
      const int g = i / hd, d = i % hd;
      float pv = 0.0f;
      for (int p = 0; p < page; ++p)
        if (valid[p]) pv = fmaf(s[g * page + p], to_f(v_pool[((row0 + p) * KV + kvh) * hd + d]), pv);
      acc[i] = acc[i] * alpha[g] + pv;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * hd; i += THREADS) {
    const int g = i / hd, d = i % hd;
    out[((size_t)b * H + kvh * G + g) * hd + d] = from_f<T>(acc[i] / fmaxf(l[g], 1e-37f));
  }
}

size_t smem_bytes(int G, int hd, int page) {
  return sizeof(float) * (2 * (size_t)G * hd + (size_t)G * page + 3 * (size_t)G) +
         sizeof(int) * (size_t)page;
}

}  // namespace

extern "C" int repro_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                     const void* pos_pool, const void* page_table,
                                     const void* t, void* out, int B, int H, int KV,
                                     int hd, int P, int page, int n_pages, int kv_len,
                                     int window, float softcap, int dtype, void* stream) {
  if (KV <= 0 || H % KV != 0 || hd <= 0 || P <= 0 || page <= 0 || n_pages < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = smem_bytes(H / KV, hd, page);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, KV);
  const float scale = (float)(1.0 / std::sqrt((double)hd));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    paged_attention_kernel<__nv_bfloat16><<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool), static_cast<const int*>(pos_pool),
        static_cast<const int*>(page_table), static_cast<const int*>(t),
        static_cast<__nv_bfloat16*>(out), H, KV, hd, P, page, n_pages, kv_len, window,
        softcap, scale);
  } else if (dtype == 0) {
    paged_attention_kernel<float><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), static_cast<const int*>(pos_pool),
        static_cast<const int*>(page_table), static_cast<const int*>(t),
        static_cast<float*>(out), H, KV, hd, P, page, n_pages, kv_len, window, softcap,
        scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
