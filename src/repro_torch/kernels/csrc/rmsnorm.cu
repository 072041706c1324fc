// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:_rmsnorm_kernel and
// computes exactly ref_rmsnorm (kernels/ref.py): per row of x [rows, d],
// y = x * rsqrt(mean(x^2) + eps) * (1 + g) in f32, cast back to x's dtype.
// x/out are float32 or bfloat16; g [d] is float32 or bfloat16 on its own.
//
// Bound.  A few operations per element, so bytes bound it: each row read
// once and written once (g stays in L1/L2), over 3.35 TB/s of HBM.  At the
// co-execution path's shape ([4, 512, 4096] bf16: 2048 rows of 4096) that
// is 16.8 MB in and 16.8 MB out, 0.0100 ms.  The first kernel (one CTA per
// row, x read twice, g through scalar loads, two block barriers a row)
// read 0.0131 ms, 77 % of the HBM rate, slower than F.rms_norm's 0.0129
// ms.  This design reads 0.0109-0.0111 ms there, 90-92 % of the HBM rate,
// 0.85x F.rms_norm (chip_smoke.py phase 2, in turns; NVIDIA H100 80GB
// HBM3, 700.00 W).
//
// Design.  Two hand-written kernels; the wrapper picks one from d and the
// pointers' alignment (both static, never the data):
//  * rmsnorm_reg_kernel<TX, TG, PACKS> (d a multiple of the 16-byte vector
//    width, d <= 8192, x, out and g 16-byte aligned): the row lives in
//    registers.  A row is taken by `threads` threads (blockDim.x, 64 at
//    d = 4096 bf16), each holding PACKS 16-byte packs of x (8 at d = 4096
//    bf16, i.e. 64 values in 32 registers; 64 registers in all, no
//    spills), so x crosses HBM once and is read once with a streaming hint
//    (ld.global.cs: touched once, not kept in L1/L2), and out is written
//    once with st.global.cs.  g is read as 16-byte packs with the default
//    caching, since every row reuses it.  The sum of squares is reduced by
//    warp shuffles and, above one warp a row, one shared array of per-warp
//    sums behind a single barrier.  One row a CTA: in one-off probe turns
//    64 threads a row timed about as fast as 256 and faster than 128, and
//    two or four rows a CTA were no faster.
//  * rmsnorm_kernel<TX, TG, VEC> (ragged d such as 100, d above 8192,
//    unaligned pointers): one CTA per row, two passes over the row (the
//    second served by L1/L2), 16-byte loads of x and g where d and the
//    pointers allow (VEC = 16 / sizeof(x's element)), scalar otherwise.
// The TPU kernel's row blocks (a VMEM tile of rb rows) need no tiling
// here: CTAs run in parallel and reach the bandwidth on their own.

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

// N elements moved as one vector access (16-byte aligned from 16 bytes up:
// a 32-byte pack of f32 g is two 16-byte loads)
template <typename T, int N>
struct alignas(sizeof(T) * N >= 16 ? 16 : sizeof(T) * N) Pack {
  T v[N];
};

// a 16-byte pack in registers <-> its VEC values in f32, by bit operations
// (no address taken, so nothing leaves the registers)
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);          // bf16 -> f32 is exact
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  union { __nv_bfloat162 h; uint32_t u; } c;
  c.h = __floats2bfloat162_rn(lo, hi);
  return c.u;
}
__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- fast path: the row in registers --------------------------------------

template <typename TX, typename TG, int PACKS>
__global__ void rmsnorm_reg_kernel(const TX* __restrict__ x,
                                   const TG* __restrict__ g,
                                   TX* __restrict__ out, int d, float eps) {
  constexpr int VEC = 16 / (int)sizeof(TX);
  __shared__ float part[32];                  // per-warp sums of the row
  const int tx = threadIdx.x, T = blockDim.x;
  const size_t row = blockIdx.x;
  const int nv = d / VEC;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * (size_t)d);
  uint4* orow = reinterpret_cast<uint4*>(out + row * (size_t)d);

  uint4 r[PACKS];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < PACKS; ++k) {
    const int i = tx + k * T;
    r[k] = make_uint4(0u, 0u, 0u, 0u);
    if (i < nv) r[k] = __ldcs(xr + i);
    float f[VEC];
    unpack(r[k], f);
#pragma unroll
    for (int j = 0; j < VEC; ++j) ss += f[j] * f[j];
  }
  ss = warp_sum(ss);
  if (T > 32) {                               // one barrier a CTA
    if ((tx & 31) == 0) part[tx >> 5] = ss;
    __syncthreads();
    ss = 0.f;
    for (int w = 0; w < (T >> 5); ++w) ss += part[w];
  }
  const float inv = rsqrtf(ss / (float)d + eps);
  const Pack<TG, VEC>* gp = reinterpret_cast<const Pack<TG, VEC>*>(g);
#pragma unroll
  for (int k = 0; k < PACKS; ++k) {
    const int i = tx + k * T;
    if (i < nv) {
      const Pack<TG, VEC> gv = gp[i];
      float f[VEC];
      unpack(r[k], f);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        f[j] = f[j] * inv * (1.f + to_f32(gv.v[j]));
      __stcs(orow + i, pack(f));
    }
  }
}

// ---- generic path: one CTA a row, two passes ------------------------------

template <typename TX, typename TG, int VEC>
__global__ void rmsnorm_kernel(const TX* __restrict__ x,
                               const TG* __restrict__ g, TX* __restrict__ out,
                               int d, float eps) {
  __shared__ float part[32];
  const size_t row = blockIdx.x;
  const Pack<TX, VEC>* xr =
      reinterpret_cast<const Pack<TX, VEC>*>(x + row * (size_t)d);
  Pack<TX, VEC>* orow = reinterpret_cast<Pack<TX, VEC>*>(out + row * (size_t)d);
  const Pack<TG, VEC>* gp = reinterpret_cast<const Pack<TG, VEC>*>(g);
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
    const Pack<TG, VEC> gv = gp[i];
    Pack<TX, VEC> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      o.v[e] = from_f32<TX>(to_f32(p.v[e]) * inv * (1.f + to_f32(gv.v[e])));
    orow[i] = o;
  }
}

template <typename TX, typename TG>
cudaError_t launch(const void* x, const void* g, void* out, int rows, int d,
                   float eps, int vec, int threads, int packs,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / (int)sizeof(TX);
  if (packs > 0) {
    if (vec != kVec || d % kVec) return cudaErrorInvalidValue;
#define REPRO_RMS_REG(P)                                                     \
  rmsnorm_reg_kernel<TX, TG, P><<<rows, threads, 0, stream>>>(              \
      (const TX*)x, (const TG*)g, (TX*)out, d, eps)
    switch (packs) {
      case 1: REPRO_RMS_REG(1); break;
      case 2: REPRO_RMS_REG(2); break;
      case 4: REPRO_RMS_REG(4); break;
      case 8: REPRO_RMS_REG(8); break;
      default: return cudaErrorInvalidValue;
    }
#undef REPRO_RMS_REG
    return cudaGetLastError();
  }
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
// of it and x, out and g are 16-byte aligned (the wrapper checks).
// packs: 0 for the generic two-pass kernel (one CTA of `threads` a row);
// 1, 2, 4 or 8 for the register-resident kernel, with `threads` threads a
// row (a multiple of 32, threads * packs * vec >= d), one row a CTA.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_rmsnorm(const void* x, const void* g, void* out,
                             int rows, int d, float eps, int x_dtype,
                             int g_dtype, int vec, int threads, int packs,
                             void* stream) {
  if (rows <= 0 || d <= 0 || threads <= 0 || threads > 1024 || threads % 32 ||
      packs < 0 || (packs > 0 && (long long)threads * packs * vec < d))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_RMS_ARGS x, g, out, rows, d, eps, vec, threads, packs, st
  if (x_dtype == 0 && g_dtype == 0)
    return (int)launch<float, float>(REPRO_RMS_ARGS);
  if (x_dtype == 0 && g_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(REPRO_RMS_ARGS);
  if (x_dtype == 1 && g_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(REPRO_RMS_ARGS);
  if (x_dtype == 1 && g_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(REPRO_RMS_ARGS);
#undef REPRO_RMS_ARGS
  return (int)cudaErrorInvalidValue;
}
