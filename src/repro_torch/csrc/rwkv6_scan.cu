// RWKV6 wkv: the chunked linear recurrence with a per-channel,
// data-dependent decay and the u bonus, on the training path of rwkv6-3b.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py::_kernel
// (reached through rwkv6_scan).
//
// Shapes, all f32 and contiguous: r, k, v, lw (B, H, S, C) with lw the
// per-step log decay log(max(w, 1e-38)) <= 0 (the wrapper computes it), u
// (H, C), out (B, H, S, C).  Per head, with the (C x C) state S0 entering a
// chunk of T tokens, clw the inclusive and clw_prev the exclusive cumulative
// sum of lw over the chunk and endw = clw[T-1]:
//
//   A[t,s] = sum_c r[t,c] k[s,c] exp(clw_prev[t,c] - clw[s,c])   for s < t
//   A[t,t] = sum_c r[t,c] u[c] k[t,c]                            (the bonus)
//   o[t]   = sum_{s<=t} A[t,s] v[s] + (r[t] * exp(clw_prev[t])) @ S0
//   S_end  = exp(endw)^T * S0 + (k * exp(endw - clw))^T @ v
//
// Every exponent is <= 0, so nothing overflows at any decay: the decay of a
// pair (t, s) is one exp of the difference, never exp(clw_prev[t]) times
// exp(-clw[s]) (the second factor overflows f32 once a chunk's log decays
// sum below about -88: two steps at the 1e-38 clamp, or 20 at w = 0.01).
//
// Bound on an H100 SXM.  At the path's shape (1 x 40 heads x 2048 x 64) the
// inputs and the output are 5 x 21 MB (31 us at 3.35 TB/s); the work is
// ~2.4 GFLOP on the f32 FMA units (36 us at 67 TFLOP/s) plus ~176 M exps,
// most of them A's 129 k channel-pairs per head-chunk: operations bound it.
// This version is the simple one, ~60x that bound (chip_smoke.py):
//
//  * One block (256 threads) per (b, h): only B*H = 40 blocks on 132 SMs at
//    the path's shape.  The TPU grid's sequential chunk axis, whose (C x C)
//    state scratch carried across grid steps, becomes a loop over the S/T
//    chunks inside the block.  Splitting the intra-chunk work over
//    (b, h, chunk) blocks, with a second pass for the state carry, is later
//    work (ROADMAP.md queue 2).
//  * The state, the chunk's r/k/v tiles, the two cumulative sums and A live
//    in dynamic shared memory (~114 KB at T = C = 64); rows indexed by the
//    key position s are padded to C + 1 floats, so a warp walking s reads 32
//    banks.
//  * Per chunk: one thread per channel takes the cumulative sums; each
//    thread then computes (t, s) entries of A (one exp per channel), the
//    outputs (t, j) and the state entries (c, j), each a plain f32 dot
//    product over shared memory.  No tensor cores: exp sits inside A's
//    channel sum, so A has no matrix-product form.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <int T, int C>
struct Layout {
  static constexpr int LD = C + 1;            // padded row of a (T, C) tile
  static constexpr int R = 0;                 // r, then r * exp(clw_prev)
  static constexpr int K = R + T * LD;        // k, then k * exp(endw - clw)
  static constexpr int CP = K + T * LD;       // clw_prev (exclusive)
  static constexpr int CL = CP + T * LD;      // lw, then clw (inclusive)
  static constexpr int V = CL + T * LD;       // v (T, C)
  static constexpr int A = V + T * C;         // A (T, T)
  static constexpr int ST = A + T * T;        // state (C, C): [key c][value j]
  static constexpr int U = ST + C * C;        // u (C)
  static constexpr int EW = U + C;            // endw (C)
  static constexpr int FLOATS = EW + C;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <int T, int C>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ lw,
            const float* __restrict__ u, float* __restrict__ out, int H, int S) {
  using L = Layout<T, C>;
  extern __shared__ float sm[];
  float* r_s = sm + L::R;
  float* k_s = sm + L::K;
  float* cp_s = sm + L::CP;
  float* cl_s = sm + L::CL;
  float* v_s = sm + L::V;
  float* a_s = sm + L::A;
  float* st_s = sm + L::ST;
  float* u_s = sm + L::U;
  float* ew_s = sm + L::EW;

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const long long base = (long long)bh * S * C;

  for (int i = tid; i < C * C; i += THREADS) st_s[i] = 0.f;
  for (int c = tid; c < C; c += THREADS) u_s[c] = u[(bh % H) * C + c];

  for (int t0 = 0; t0 < S; t0 += T) {
    const long long off = base + (long long)t0 * C;
    for (int i = tid; i < T * C; i += THREADS) {
      const int t = i / C, c = i % C;
      r_s[t * L::LD + c] = r[off + i];
      k_s[t * L::LD + c] = k[off + i];
      cl_s[t * L::LD + c] = lw[off + i];
      v_s[i] = v[off + i];
    }
    __syncthreads();

    // cumulative log decays, one channel per thread
    for (int c = tid; c < C; c += THREADS) {
      float run = 0.f;
      for (int t = 0; t < T; ++t) {
        const float x = cl_s[t * L::LD + c];
        cp_s[t * L::LD + c] = run;
        run += x;
        cl_s[t * L::LD + c] = run;
      }
      ew_s[c] = run;
    }
    __syncthreads();

    // A: strictly causal pairs with the decay inside the channel sum, and
    // the bonus on the diagonal; zero above it
    for (int i = tid; i < T * T; i += THREADS) {
      const int t = i / T, s = i % T;
      const float* rt = r_s + t * L::LD;
      const float* ks = k_s + s * L::LD;
      float acc = 0.f;
      if (s < t) {
        const float* cpt = cp_s + t * L::LD;
        const float* cls = cl_s + s * L::LD;
#pragma unroll 8
        for (int c = 0; c < C; ++c) acc += rt[c] * ks[c] * expf(cpt[c] - cls[c]);
      } else if (s == t) {
#pragma unroll 8
        for (int c = 0; c < C; ++c) acc += rt[c] * u_s[c] * ks[c];
      }
      a_s[i] = acc;
    }
    __syncthreads();

    // r * exp(clw_prev) reads the state; k * exp(endw - clw) feeds it
    for (int i = tid; i < T * C; i += THREADS) {
      const int t = i / C, c = i % C;
      r_s[t * L::LD + c] *= expf(cp_s[t * L::LD + c]);
      k_s[t * L::LD + c] *= expf(ew_s[c] - cl_s[t * L::LD + c]);
    }
    __syncthreads();

    for (int i = tid; i < T * C; i += THREADS) {
      const int t = i / C, j = i % C;
      const float* at = a_s + t * T;
      const float* rt = r_s + t * L::LD;
      float acc = 0.f;
      for (int s = 0; s <= t; ++s) acc += at[s] * v_s[s * C + j];
#pragma unroll 8
      for (int c = 0; c < C; ++c) acc += rt[c] * st_s[c * C + j];
      out[off + i] = acc;
    }
    __syncthreads();

    for (int i = tid; i < C * C; i += THREADS) {
      const int c = i / C, j = i % C;
      float acc = expf(ew_s[c]) * st_s[i];
#pragma unroll 8
      for (int s = 0; s < T; ++s) acc += k_s[s * L::LD + c] * v_s[s * C + j];
      st_s[i] = acc;
    }
    __syncthreads();
  }
}

template <int T, int C>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, float* out, int B, int H, int S, cudaStream_t stream) {
  const size_t smem = Layout<T, C>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(wkv6_kernel<T, C>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  wkv6_kernel<T, C><<<B * H, THREADS, smem, stream>>>(r, k, v, lw, u, out, H, S);
  return (int)cudaGetLastError();
}

template <int C>
int launch_t(const float* r, const float* k, const float* v, const float* lw,
             const float* u, float* out, int B, int H, int S, int T, cudaStream_t stream) {
  switch (T) {
    case 16: return launch<16, C>(r, k, v, lw, u, out, B, H, S, stream);
    case 32: return launch<32, C>(r, k, v, lw, u, out, B, H, S, stream);
    case 64: return launch<64, C>(r, k, v, lw, u, out, B, H, S, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int repro_rwkv6_scan(const void* r, const void* k, const void* v, const void* lw,
                                const void* u, void* out, int B, int H, int S, int C, int T,
                                void* stream) {
  if (B < 0 || H <= 0 || S < 0 || T <= 0 || S % T != 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* lf = static_cast<const float*>(lw);
  const float* uf = static_cast<const float*>(u);
  float* of = static_cast<float*>(out);
  switch (C) {
    case 32: return launch_t<32>(rf, kf, vf, lf, uf, of, B, H, S, T, s);
    case 64: return launch_t<64>(rf, kf, vf, lf, uf, of, B, H, S, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
