// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:_paged_kernel
// and computes exactly ref_paged_attention (kernels/ref.py): for each row b
// and query head, softmax over the row's valid cache positions of
// (q * D^-0.5) . k, times v, with K/V read from a flat block arena
// kp/vp [num_blocks, bs, Hkv, D] through the row's block table bt[b, :].
// Positions at or past valid[b], and (window > 0) before valid[b] - window,
// are masked.  Accumulation is f32; the output is written in q's dtype.
//
// Bound.  At decode shapes the work is a few FLOPs per K/V byte, far below
// the card's ~295 operations per byte, so the kernel is bound by the bytes
// of the VALID K/V it must read: sum_b valid[b] * Hkv * D * 2 * sizeof(T),
// over 3.35 TB/s of HBM.  What the design does about it: each CTA reads only
// the blocks that hold valid (and in-window) positions — the TPU grid's
// per-block DMA through scalar-prefetched indices becomes the CTA reading
// bt[b, j] itself and skipping every block wholly past valid[b] or wholly
// before the window, whose softmax weight is exactly zero.  The G = Hq/Hkv
// query heads that share a KV head sit in one CTA, so each K/V byte is read
// once for all of them.  Tail table entries point at the trash block 0 and
// stay masked; inactive slots still decode (valid >= 1) without faulting.
//
// Design (simple and correct first).  One CTA of 128 threads per (KV head
// h, row b).  It keeps the G scaled query rows and the [G, D] accumulator
// in shared memory as f32, and loops over the row's blocks: one warp per
// token computes the G scores (lanes across D, shuffle reduction), one
// thread per query head updates the running max / denominator, and one
// thread per (g, d) rescales and accumulates p . v.  Not done yet (later
// work): split-K across blocks for more CTAs in flight, 16-byte vector or
// cp.async/TMA loads into a shared-memory ring, tensor-core products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int32_t* __restrict__ bt,
                    const int32_t* __restrict__ valid, T* __restrict__ out,
                    int Hkv, int bs, int nbps, int window, float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;              // [G][D] scaled query rows
  float* acc = q_s + G * D;       // [G][D] output accumulator
  float* s = acc + G * D;         // [G][bs] scores, then probabilities
  __shared__ float m_s[G], l_s[G], c_s[G];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int Hq = Hkv * G;

  // q[b, 0, h*G + g, :] for g < G: G*D contiguous values
  const T* qrow = q + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    q_s[e] = to_f32(qrow[e]) * scale;
    acc[e] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  const int vl = valid[b];
  int j_hi = (vl + bs - 1) / bs;          // blocks at or past valid: skipped
  if (j_hi > nbps) j_hi = nbps;
  int j_lo = 0;                           // blocks before the window: skipped
  if (window > 0 && vl - window > 0) j_lo = (vl - window) / bs;
  const size_t tok = (size_t)Hkv * D;     // stride between a block's tokens
  __syncthreads();

  for (int j = j_lo; j < j_hi; ++j) {
    const size_t blk = (size_t)bt[(size_t)b * nbps + j];
    const T* kblk = kp + blk * bs * tok + (size_t)h * D;
    const T* vblk = vp + blk * bs * tok + (size_t)h * D;

    // scores: one warp per token, lanes across D
    for (int t = warp; t < bs; t += kWarps) {
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
      const T* krow = kblk + (size_t)t * tok;
      for (int d = lane; d < D; d += 32) {
        const float kv = to_f32(krow[d]);
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] += q_s[g * D + d] * kv;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float v = part[g];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        part[g] = v;
      }
      if (lane == 0) {
        const int pos = j * bs + t;
        bool ok = pos < vl;
        if (window > 0) ok = ok && pos >= vl - window;
#pragma unroll
        for (int g = 0; g < G; ++g) s[g * bs + t] = ok ? part[g] : kNegInf;
      }
    }
    __syncthreads();

    // online-softmax statistics: one thread per query head
    if (tid < G) {
      float* sg = s + tid * bs;
      const float m_prev = m_s[tid];
      float mx = m_prev;
      for (int t = 0; t < bs; ++t) mx = fmaxf(mx, sg[t]);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float p = expf(sg[t] - mx);
        sg[t] = p;
        sum += p;
      }
      const float corr = expf(m_prev - mx);
      l_s[tid] = l_s[tid] * corr + sum;
      m_s[tid] = mx;
      c_s[tid] = corr;
    }
    __syncthreads();

    // accumulator: one thread per (g, d), reading v coalesced across d
    for (int e = tid; e < G * D; e += kThreads) {
      const int g = e / D;
      const int d = e - g * D;
      const float* pg = s + g * bs;
      float a = acc[e] * c_s[g];
      for (int t = 0; t < bs; ++t) a += pg[t] * to_f32(vblk[(size_t)t * tok + d]);
      acc[e] = a;
    }
    __syncthreads();
  }

  T* orow = out + ((size_t)b * Hq + (size_t)h * G) * D;
  for (int e = tid; e < G * D; e += kThreads) {
    store(orow + e, acc[e] / fmaxf(l_s[e / D], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* kp, const void* vp,
                     const void* bt, const void* valid, void* out, int B,
                     int Hkv, int G, int bs, int nbps, int window,
                     cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  const size_t smem = sizeof(float) * (size_t)(2 * G * D + G * bs);
  const float scale = rsqrtf((float)D);
#define REPRO_PA_LAUNCH(GG)                                                  \
  paged_decode_kernel<T, D, GG><<<grid, kThreads, smem, stream>>>(          \
      (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)bt,          \
      (const int32_t*)valid, (T*)out, Hkv, bs, nbps, window, scale)
  switch (G) {
    case 1: REPRO_PA_LAUNCH(1); break;
    case 2: REPRO_PA_LAUNCH(2); break;
    case 4: REPRO_PA_LAUNCH(4); break;
    case 8: REPRO_PA_LAUNCH(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_PA_LAUNCH
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* kp, const void* vp,
                     const void* bt, const void* valid, void* out, int B,
                     int Hkv, int G, int D, int bs, int nbps, int window,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(q, kp, vp, bt, valid, out, B, Hkv, G, bs, nbps, window, stream);
    case 32: return launch_d<T, 32>(q, kp, vp, bt, valid, out, B, Hkv, G, bs, nbps, window, stream);
    case 64: return launch_d<T, 64>(q, kp, vp, bt, valid, out, B, Hkv, G, bs, nbps, window, stream);
    case 128: return launch_d<T, 128>(q, kp, vp, bt, valid, out, B, Hkv, G, bs, nbps, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_paged_attention(const void* q, const void* kp,
                                     const void* vp, const void* bt,
                                     const void* valid, void* out, int B,
                                     int Hkv, int G, int D, int bs, int nbps,
                                     int window, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || bs <= 0 || nbps <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_t<float>(q, kp, vp, bt, valid, out, B, Hkv, G, D, bs, nbps, window, st);
  if (dtype == 1)
    return (int)launch_t<__nv_bfloat16>(q, kp, vp, bt, valid, out, B, Hkv, G, D, bs, nbps, window, st);
  return (int)cudaErrorInvalidValue;
}
