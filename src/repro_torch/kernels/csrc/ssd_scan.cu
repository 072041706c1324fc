// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:_ssd_kernel and
// computes what it computes (and what ref_ssd, kernels/ref.py, computes
// token by token): for each (b, h), with a_t = dt_t * A_h and the f32
// state h [P, N] carried across chunks,
//   y_i   = sum_{j<=i in chunk} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//           + exp(cs_i) (C_i . h_prev[p, :])            (cs: in-chunk cumsum)
//   h_new = exp(cs_last) h_prev + sum_j exp(cs_last - cs_j) dt_j x_j B_j^T
// in f32, y cast to x's dtype.  Optionally it writes the state after the
// last token, h_final [B, H, P, N] f32: the state the TPU kernel keeps in
// its VMEM scratch after its last chunk (the serving prefill needs it).
// x [B,S,H,P], dt [B,S,H], Bm/Cm [B,S,N] are read through their strides
// (last axis contiguous; the model hands over slices of the conv output);
// x/Bm/Cm are float32 or bfloat16, dt float32 or bfloat16, A [H] float32.
//
// Bound.  At the serving prefill (x [1, 1024, 24, 64] bf16, N = 128) the
// inputs, y and h_final are ~7.6 MB (2.3 us at 3.35 TB/s) and the work at
// the reference's chunk of 256 is ~1.7 GFLOP (1.7 us at the bf16
// tensor-core peak; C.B^T counted once for all heads): bytes bound it.
// This first kernel does every product as f32 FMAs on the CUDA cores, and
// each CTA recomputes the chunk's C.B^T (B and C are shared by all
// heads), so it sits far above that bound; tensor cores (mma/wgmma on
// bf16 B, C and x), sharing C.B^T across the heads of a CTA and TMA
// staging are later work.
//
// Design (simple and right first).  The TPU grid (B, H, chunks), with its
// sequential chunk axis carrying h in scratch, becomes one CTA of 256
// threads per (b, h, 16-row tile of P) that loops over 64-token chunks in
// order.  Splitting P is exact: row p of h and column p of y depend on
// row p alone; it gives 4 CTAs per (b, h) at P = 64, 96 for one request's
// prefill.  Per chunk the CTA stages B and C ([64, N]), its x tile and dt
// in shared memory as f32 (zeros past the sequence end, so a ragged last
// chunk needs no other mask and every length runs at this chunk: the
// reference's halving rule, which drives a prime length to a chunk of 1,
// is not needed), takes the inclusive cumsum of dt*A in one warp, forms
// M = (C.B^T) o exp(cs_i - cs_j) (lower triangle, 4x4 register tiles with
// float4 shared-memory reads), then y = M.(dt x) + exp(cs) C.h^T, then
// updates its h slice (shared memory, f32).  ~100 KB of shared memory at
// N = 128, above the 48 KB default, so the launch asks for it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 64;              // tokens per chunk (the cumsum warp takes 2 each)
constexpr int kPT = 16;             // rows of P per CTA
constexpr int kMP = kQ + 4;         // M row stride: float4-aligned
constexpr int kMaxN = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// shared memory, in floats: Bs, Cs [kQ][N+4]; Ms [kQ][kMP]; hs [kPT][N+4];
// xd (dt x), xw (exp(cs_last - cs_j) dt x) [kQ][kPT]; cs, dts [kQ]
size_t smem_bytes(int N) {
  const size_t ns = (size_t)N + 4;
  return sizeof(float) * (2 * kQ * ns + (size_t)kQ * kMP + kPT * ns +
                          2 * kQ * kPT + 2 * kQ);
}

template <typename T, typename TD>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ h_final, int S, int H, int P, int N,
                long long sxb, long long sxs, long long sxh, long long sdb,
                long long sds, long long sdh, long long sbb, long long sbs,
                long long scb, long long scs) {
  extern __shared__ __align__(16) float smem[];
  const int ns = N + 4;
  float* Bs = smem;
  float* Cs = Bs + kQ * ns;
  float* Ms = Cs + kQ * ns;
  float* hs = Ms + kQ * kMP;
  float* xd = hs + kPT * ns;
  float* xw = xd + kQ * kPT;
  float* cs = xw + kQ * kPT;
  float* dts = cs + kQ;

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float a_h = A[h];
  const T* xb = x + b * sxb + h * sxh + p0;
  const TD* dtb = dt + b * sdb + h * sdh;
  const T* Bb = Bm + b * sbb;
  const T* Cb = Cm + b * scb;
  const long long ys = (long long)H * P;            // y's token stride
  T* yb = y + (long long)b * S * ys + (long long)h * P + p0;

  for (int i = tid; i < kPT * ns; i += kThreads) hs[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int q = min(kQ, S - c0);                  // valid tokens
    __syncthreads();          // the last chunk's readers of Bs/xw/hs are done

    // ---- stage the chunk as f32, zeros past the sequence end -------------
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int j = i / N, n = i - j * N;
      float bv = 0.f, cv = 0.f;
      if (j < q) {
        bv = to_f32(Bb[(c0 + j) * sbs + n]);
        cv = to_f32(Cb[(c0 + j) * scs + n]);
      }
      Bs[j * ns + n] = bv;
      Cs[j * ns + n] = cv;
    }
    for (int i = tid; i < kQ * kPT; i += kThreads) {
      const int j = i / kPT, p = i - j * kPT;
      xd[i] = j < q ? to_f32(xb[(c0 + j) * sxs + p]) : 0.f;
    }
    if (tid < kQ) dts[tid] = tid < q ? to_f32(dtb[(c0 + tid) * sds]) : 0.f;
    __syncthreads();

    // ---- inclusive cumsum of a = dt * A (one warp, two tokens a lane) ----
    if (tid < 32) {
      const float a0 = dts[2 * tid] * a_h, a1 = dts[2 * tid + 1] * a_h;
      float s = a0 + a1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, s, o);
        if (tid >= o) s += t;
      }
      cs[2 * tid] = s - a1;
      cs[2 * tid + 1] = s;
    }
    __syncthreads();

    // ---- dt x, its decayed copy, and M = (C.B^T) o L ----------------------
    const float cl = cs[kQ - 1];                    // = cs[q - 1]: dt is 0 past q
    for (int i = tid; i < kQ * kPT; i += kThreads) {
      const int j = i / kPT;
      const float v = xd[i] * dts[j];
      xd[i] = v;
      xw[i] = v * expf(cl - cs[j]);
    }
    {
      const int ti = tid >> 4, tj = tid & 15;       // rows ti + 16r, cols tj + 16c
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          cv[r] = *reinterpret_cast<const float4*>(Cs + (ti + 16 * r) * ns + n);
          bv[r] = *reinterpret_cast<const float4*>(Bs + (tj + 16 * r) * ns + n);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] += dot4(cv[r], bv[c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti + 16 * r;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tj + 16 * c;
          Ms[i * kMP + j] = j <= i ? acc[r][c] * expf(cs[i] - cs[j]) : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = M.(dt x) + exp(cs) C.h_prev^T --------------------------------
    {
      const int p = tid & 15, ig = tid >> 4;        // rows ig + 16r
      float dg[4] = {0.f, 0.f, 0.f, 0.f}, off[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < kQ; j += 4) {
        const float4 xv = make_float4(xd[j * kPT + p], xd[(j + 1) * kPT + p],
                                      xd[(j + 2) * kPT + p],
                                      xd[(j + 3) * kPT + p]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          dg[r] += dot4(*reinterpret_cast<const float4*>(
                            Ms + (ig + 16 * r) * kMP + j), xv);
      }
      for (int n = 0; n < N; n += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + p * ns + n);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          off[r] += dot4(*reinterpret_cast<const float4*>(
                             Cs + (ig + 16 * r) * ns + n), hv);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ig + 16 * r;
        if (i < q) store(yb + (c0 + i) * ys + p, dg[r] + expf(cs[i]) * off[r]);
      }
    }
    __syncthreads();

    // ---- h = exp(cs_last) h + sum_j xw_j B_j^T ----------------------------
    {
      const float dtot = expf(cl);
      const int lane = tid & 31, w = tid >> 5;      // rows w and w + 8 of h
      for (int n = lane * 4; n < N; n += 128) {
        float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
        for (int j = 0; j < q; ++j) {
          const float4 bv = *reinterpret_cast<const float4*>(Bs + j * ns + n);
          const float w0 = xw[j * kPT + w], w1 = xw[j * kPT + w + 8];
          a0.x += w0 * bv.x; a0.y += w0 * bv.y; a0.z += w0 * bv.z; a0.w += w0 * bv.w;
          a1.x += w1 * bv.x; a1.y += w1 * bv.y; a1.z += w1 * bv.z; a1.w += w1 * bv.w;
        }
        float4* h0 = reinterpret_cast<float4*>(hs + w * ns + n);
        float4* h1 = reinterpret_cast<float4*>(hs + (w + 8) * ns + n);
        float4 v0 = *h0, v1 = *h1;
        *h0 = make_float4(v0.x * dtot + a0.x, v0.y * dtot + a0.y,
                          v0.z * dtot + a0.z, v0.w * dtot + a0.w);
        *h1 = make_float4(v1.x * dtot + a1.x, v1.y * dtot + a1.y,
                          v1.z * dtot + a1.z, v1.w * dtot + a1.w);
      }
    }
  }

  if (h_final != nullptr) {
    __syncthreads();
    float* hf = h_final + (((long long)b * H + h) * P + p0) * N;
    for (int i = tid; i < kPT * N; i += kThreads) {
      const int p = i / N, n = i - p * N;
      hf[i] = hs[p * ns + n];
    }
  }
}

template <typename T, typename TD>
cudaError_t launch(const void* x, const void* dt, const void* A,
                   const void* Bm, const void* Cm, void* y, void* h_final,
                   int B, int S, int H, int P, int N, const long long* st,
                   cudaStream_t stream) {
  static size_t configured = 0;     // dynamic shared memory granted so far
  const size_t smem = smem_bytes(N);
  auto kern = ssd_scan_kernel<T, TD>;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    configured = smem;
  }
  const dim3 grid(P / kPT, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)x, (const TD*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (T*)y, (float*)h_final, S, H, P, N, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes).  x_dtype (x, Bm, Cm, y) and dt_dtype:
// 0 = float32, 1 = bfloat16; A is float32.  Strides are in elements: x
// (batch, token, head), dt (batch, token, head), Bm and Cm (batch, token);
// each last axis is contiguous (the wrapper checks).  y is a contiguous
// [B, S, H, P]; h_final a contiguous [B, H, P, N] f32, or null.  P must be
// a multiple of 16, N a multiple of 4 up to 256.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* h_final, int B, int S, int H, int P,
                              int N, long long sxb, long long sxs,
                              long long sxh, long long sdb, long long sds,
                              long long sdh, long long sbb, long long sbs,
                              long long scb, long long scs, int x_dtype,
                              int dt_dtype, void* stream) {
  if (B <= 0 || S < 0 || H <= 0 || P <= 0 || P % kPT || N <= 0 || N % 4 ||
      N > kMaxN || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const long long st[10] = {sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs};
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0 && dt_dtype == 0)
    return (int)launch<float, float>(x, dt, A, Bm, Cm, y, h_final, B, S, H, P, N, st, s);
  if (x_dtype == 0 && dt_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(x, dt, A, Bm, Cm, y, h_final, B, S, H, P, N, st, s);
  if (x_dtype == 1 && dt_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(x, dt, A, Bm, Cm, y, h_final, B, S, H, P, N, st, s);
  if (x_dtype == 1 && dt_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, Bm, Cm, y, h_final, B, S, H, P, N, st, s);
  return (int)cudaErrorInvalidValue;
}
