// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:_rmsnorm_kernel and
// computes exactly ref_rmsnorm (kernels/ref.py): per row of x [rows, d],
// y = x * rsqrt(mean(x^2) + eps) * (1 + g) in f32, cast back to x's dtype.
// x/out are float32 or bfloat16; g [d] is float32 or bfloat16 on its own.
//
// Bound.  A few operations per element, so the kernel is bound by bytes:
// each row read once and written once (plus g, which stays in L1/L2), over
// 3.35 TB/s of HBM.  At the co-execution path's shape (4096 rows x 4096,
// bf16) that is 32 MB in and 32 MB out, ~0.02 ms.  What the design does
// about it: one CTA per row streams the row with 16-byte vector loads and
// stores where d and the pointers allow (a scalar path otherwise), reduces
// the sum of squares in registers, then warp shuffles, then one shared
// array of per-warp sums.  The second pass re-reads the row (at most 64 KB
// for d = 16384 f32), which L1/L2 serve; HBM sees each byte once.  The TPU
// kernel's row blocks (a VMEM tile of rb rows) become one CTA per row:
// blocks run in parallel here and need no tiling to reach the bandwidth.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// VEC elements moved as one load/store (16 bytes for the vector path)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TX, typename TG, int VEC>
__global__ void rmsnorm_kernel(const TX* __restrict__ x,
                               const TG* __restrict__ g, TX* __restrict__ out,
                               int d, float eps) {
  __shared__ float part[32];
  const size_t row = blockIdx.x;
  const Pack<TX, VEC>* xr =
      reinterpret_cast<const Pack<TX, VEC>*>(x + row * (size_t)d);
  Pack<TX, VEC>* orow = reinterpret_cast<Pack<TX, VEC>*>(out + row * (size_t)d);
  const int nv = d / VEC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float ss = 0.f;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const Pack<TX, VEC> p = xr[i];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float f = to_f32(p.v[e]);
      ss += f * f;
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    ss = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f;
    ss = warp_sum(ss);
    if (lane == 0) part[0] = ss;
  }
  __syncthreads();
  const float inv = rsqrtf(part[0] / (float)d + eps);

  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    const Pack<TX, VEC> p = xr[i];
    Pack<TX, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float y = to_f32(p.v[e]) * inv;
      o.v[e] = from_f32<TX>(y * (1.f + to_f32(g[i * VEC + e])));
    }
    orow[i] = o;
  }
}

template <typename TX, typename TG>
cudaError_t launch(const void* x, const void* g, void* out, int rows, int d,
                   float eps, int vec, int threads, cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(TX);
#define REPRO_RMS_LAUNCH(V)                                                  \
  rmsnorm_kernel<TX, TG, V><<<rows, threads, 0, stream>>>(                  \
      (const TX*)x, (const TG*)g, (TX*)out, d, eps)
  if (vec == 1) {
    REPRO_RMS_LAUNCH(1);
  } else if (vec == kVec) {
    REPRO_RMS_LAUNCH(kVec);
  } else {
    return cudaErrorInvalidValue;
  }
#undef REPRO_RMS_LAUNCH
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes).  x_dtype / g_dtype: 0 = float32,
// 1 = bfloat16.  vec: 1, or 16 / sizeof(x's element) when d is a multiple
// of it and x/out are 16-byte aligned (the wrapper checks).  threads: a
// multiple of 32 up to 1024.  Returns cudaGetLastError() after the launch.
extern "C" int repro_rmsnorm(const void* x, const void* g, void* out,
                             int rows, int d, float eps, int x_dtype,
                             int g_dtype, int vec, int threads, void* stream) {
  if (rows <= 0 || d <= 0 || threads <= 0 || threads > 1024 || threads % 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == 0 && g_dtype == 0)
    return (int)launch<float, float>(x, g, out, rows, d, eps, vec, threads, st);
  if (x_dtype == 0 && g_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(x, g, out, rows, d, eps, vec, threads, st);
  if (x_dtype == 1 && g_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, g, out, rows, d, eps, vec, threads, st);
  if (x_dtype == 1 && g_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, g, out, rows, d, eps, vec, threads, st);
  return (int)cudaErrorInvalidValue;
}
