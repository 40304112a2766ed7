// RMSNorm over the last dimension: out = x * rsqrt(mean(x^2) + eps) *
// (1 + scale), in f32, cast back to x's type.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::_kernel (reached
// through rmsnorm).  As in the JAX package, no model calls it: the models'
// norms are plain tensor code (models/common.py::rms_norm); this kernel is
// the standalone entry point kernels/rmsnorm.py::rmsnorm.
//
// Shapes: x and out (rows, d), contiguous, f32 or bf16; scale (d,) f32 (the
// wrapper casts it).
//
// Bound on an H100 SXM: bytes.  A row is read, reduced and written with 1
// flop per byte or less; at (2048, 2560) bf16 the call moves 21 MB (6.3 us
// at 3.35 TB/s).  The design follows from that:
//
//  * One warp per row, eight rows per 256-thread block.  Each lane takes
//    16-byte loads (4 f32 or 8 bf16) strided by the warp, sums their squares
//    in f32 registers, and a warp shuffle reduces the row: no shared memory,
//    no __syncthreads.
//  * The second pass reads the row again (a 5 KB row of the path's width is
//    still in L1/L2) and writes the scaled values with 16-byte stores.
//  * Rows whose byte width is not a multiple of 16, or buffers not 16-byte
//    aligned, take the same loops with one element per load.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename X> __device__ __forceinline__ X from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// one 16-byte vector of X as floats, and back
template <typename X>
struct Vec {
  static constexpr int N = 16 / sizeof(X);
  __device__ __forceinline__ static void load(const X* p, float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const X* e = reinterpret_cast<const X*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(e[j]);
  }
  __device__ __forceinline__ static void store(X* p, const float* f) {
    uint4 raw;
    X* e = reinterpret_cast<X*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) e[j] = from_f<X>(f[j]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename X>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const X* __restrict__ x, const float* __restrict__ scale, X* __restrict__ out,
               int rows, int d, float eps, int vec) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const X* xr = x + (long long)row * d;
  X* orow = out + (long long)row * d;
  constexpr int N = Vec<X>::N;

  float ss = 0.f;
  if (vec) {
    for (int c = lane * N; c < d; c += 32 * N) {
      float f[N];
      Vec<X>::load(xr + c, f);
#pragma unroll
      for (int j = 0; j < N; ++j) ss += f[j] * f[j];
    }
  } else {
    for (int c = lane; c < d; c += 32) {
      const float f = to_f(xr[c]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(warp_sum(ss) / (float)d + eps);

  if (vec) {
    for (int c = lane * N; c < d; c += 32 * N) {
      float f[N];
      Vec<X>::load(xr + c, f);
#pragma unroll
      for (int j = 0; j < N; ++j) f[j] = f[j] * inv * (1.f + scale[c + j]);
      Vec<X>::store(orow + c, f);
    }
  } else {
    for (int c = lane; c < d; c += 32) orow[c] = from_f<X>(to_f(xr[c]) * inv * (1.f + scale[c]));
  }
}

template <typename X>
int launch(const void* x, const void* scale, void* out, int rows, int d, float eps,
           cudaStream_t stream) {
  const bool vec = d % Vec<X>::N == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int grid = (rows + WARPS - 1) / WARPS;
  rmsnorm_kernel<X><<<grid, THREADS, 0, stream>>>(
      static_cast<const X*>(x), static_cast<const float*>(scale), static_cast<X*>(out), rows,
      d, eps, vec ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_rmsnorm(const void* x, const void* scale, void* out, int rows, int d,
                             float eps, int dtype, void* stream) {
  if (rows < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, scale, out, rows, d, eps, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, scale, out, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
