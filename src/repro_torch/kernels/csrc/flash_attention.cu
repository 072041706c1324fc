// Forward flash attention (causal / sliding-window / GQA) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_attn_kernel
// and computes exactly ref_attention (kernels/ref.py): q [B,H,Sq,D],
// k/v [B,Hkv,Skv,D] (contiguous), query head h reading KV head
// h / (H / Hkv); scores (q * D^-0.5) . k in f32; a key is masked when
// causal and kpos > qpos, or window > 0 and kpos <= qpos - window, with
// positions counted from 0 for both axes (Sq != Skv allowed); an f32
// online softmax (running max, denominator, [rows, D] accumulator); the
// output acc / max(l, 1e-30) in q's dtype.  P stays f32 in the PV product:
// the TPU kernel's p.astype(v.dtype) casts to a v that it has already
// widened to f32 (flash_attention.py:50, :69), so it rounds nothing.
//
// Bound.  At the co-execution path's shape (B*H = 128, S = 1024, D = 128,
// causal, bf16) the work is ~34 GFLOP over ~134 MB of q/k/v/o: 0.035 ms at
// the bf16 tensor-core peak and 0.040 ms at 3.35 TB/s, so bytes bound it
// by a little.  This first kernel does its products with f32 FMAs on the
// CUDA cores (so it computes exactly what the plain version does, with no
// rounding of P), and so it sits far above that bound: the tensor cores
// (wgmma with bf16 P), TMA loads and warp specialisation are later work.
//
// Design (simple and correct first).  One CTA of 256 threads per (b, h,
// 64-query tile).  The tile's scaled queries live in shared memory as f32,
// transposed (Qt[d][row]); 32-key K (transposed) and V tiles stream
// through shared memory as f32.  Thread (tx, ty) owns rows 4*ty..4*ty+3:
// scores for keys tx and tx+16 of the tile, and accumulator columns
// tx + 16*c.  A row's 16 owners sit in one half-warp, so its max and sum
// are shuffle reductions; P goes through shared memory (Pt[key][row]) to
// the PV product.  The TPU grid's sequential KV axis becomes a loop in the
// CTA over the KV tiles that can hold an unmasked key: tiles wholly past
// the diagonal (causal) or wholly before the window are skipped, as the TPU
// kernel skips blocks past the diagonal.  Keys past Skv get weight 0
// exactly.  A row that no key can reach (window > 0 and qpos >= Skv +
// window - 1) gets the plain version's answer, the mean of v over all
// keys: its tile then walks every KV tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's masked score
constexpr int kThreads = 256;
constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 32;             // keys per streamed tile
constexpr int kQP = kBQ + 4;        // Qt / Pt row stride: float4-aligned
constexpr int kKP = kBK + 1;        // Kt row stride: conflict-free stores

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)D * kQP + (size_t)D * kKP + (size_t)kBK * D + (size_t)kBK * kQP;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int H, int Hkv,
                 int Sq, int Skv, int causal, int window, float scale) {
  constexpr int kC = D / 16;                // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                         // [D][kQP]   scaled q, transposed
  float* Kt = Qt + D * kQP;                 // [D][kKP]   k tile, transposed
  float* Vs = Kt + D * kKP;                 // [kBK][D]   v tile
  float* Pt = Vs + kBK * D;                 // [kBK][kQP] probabilities

  const int bh = blockIdx.x;                // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + ((size_t)b * Hkv + hk) * Skv * D;
  const T* vb = v + ((size_t)b * Hkv + hk) * Skv * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int qp = q0 + r;
    Qt[d * kQP + r] = qp < Sq ? to_f32(qb[(size_t)qp * D + d]) * scale : 0.f;
  }

  // the KV tiles that can hold an unmasked key for some row of this tile
  const int q_last = min(q0 + kBQ, Sq) - 1;
  int kv_lo = 0, kv_hi = Skv;
  const bool unreachable_row = window > 0 && q_last >= Skv + window - 1;
  if (!unreachable_row) {
    if (causal) kv_hi = min(Skv, q_last + 1);
    if (window > 0) kv_lo = max(0, q0 - window + 1);
  }
  const int t_lo = kv_lo / kBK;
  const int t_hi = (kv_hi + kBK - 1) / kBK;

  float m[4], l[4], acc[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e - c * D;
      const int kp = k0 + c;
      const bool ok = kp < Skv;
      Kt[d * kKP + c] = ok ? to_f32(kb[(size_t)kp * D + d]) : 0.f;
      Vs[e] = ok ? to_f32(vb[(size_t)kp * D + d]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * kQP + ty * 4]);
      const float ka = Kt[d * kKP + tx];
      const float kc = Kt[d * kKP + tx + 16];
      s[0][0] += qv.x * ka; s[0][1] += qv.x * kc;
      s[1][0] += qv.y * ka; s[1][1] += qv.y * kc;
      s[2][0] += qv.z * ka; s[2][1] += qv.z * kc;
      s[3][0] += qv.w * ka; s[3][1] += qv.w * kc;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j];
        if (kp >= Skv) {
          x = -INFINITY;                    // not a key: weight 0 exactly
        } else if ((causal && kp > qp) || (window > 0 && kp <= qp - window)) {
          x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_warp_max(mx);
      const float corr = expf(m[i] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[i][j] - mx);
        s[i][j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      *reinterpret_cast<float4*>(&Pt[(tx + 16 * j) * kQP + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&Pt[kk * kQP + ty * 4]);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
        acc[0][c] += p.x * vv;
        acc[1][c] += p.y * vv;
        acc[2][c] += p.z * vv;
        acc[3][c] += p.w * vv;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Sq) continue;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    T* orow = out + ((size_t)bh * Sq + qp) * D;
#pragma unroll
    for (int c = 0; c < kC; ++c) store(orow + tx + 16 * c, acc[i][c] * inv_l);
  }
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int Hkv, int Sq, int Skv, int causal,
                     int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  // above 48 KB a CTA's dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, Hkv, Sq, Skv, causal,
      window, (float)(1.0 / sqrt((double)D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int Hkv, int Sq, int Skv, int D, int causal,
                     int window, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, window, stream);
    case 32: return launch_d<T, 32>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, window, stream);
    case 64: return launch_d<T, 64>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, window, stream);
    case 128: return launch_d<T, 128>(q, k, v, out, B, H, Hkv, Sq, Skv, causal, window, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int Hkv, int Sq, int Skv, int D,
                                     int causal, int window, int dtype,
                                     void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Skv <= 0 ||
      window < 0 || (Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_t<float>(q, k, v, out, B, H, Hkv, Sq, Skv, D, causal, window, st);
  if (dtype == 1)
    return (int)launch_t<__nv_bfloat16>(q, k, v, out, B, H, Hkv, Sq, Skv, D, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
