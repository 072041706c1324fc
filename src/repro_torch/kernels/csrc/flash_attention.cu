// Forward flash attention (causal / sliding-window / GQA) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_attn_kernel
// and computes ref_attention (kernels/ref.py): q [B,H,Sq,D], k/v
// [B,Hkv,Skv,D] (contiguous), query head h reading KV head h / (H / Hkv);
// scores (q . k) * D^-0.5 in f32; a key is masked (-1e30) when causal and
// kpos > qpos, or window > 0 and kpos <= qpos - window, with positions
// counted from 0 on both axes (Sq != Skv allowed); a key past Skv gets
// weight 0 exactly; an f32 online softmax; the output acc / max(l, 1e-30)
// in q's dtype.  A row that no key can reach (window > 0 and qpos >= Skv +
// window - 1) gets the plain version's answer, the mean of v over all
// keys, so its tile walks every KV tile; otherwise tiles wholly past the
// diagonal or wholly before the window are skipped.  Any head dim d <= 256
// that is a multiple of 8 runs: D in {16, 32, 64, 128, 256} in its own
// instantiation, any other d in the masked instantiation of the next size
// (kMask), with q/k/v/out rows d values apart and the columns past d
// zero-filled in the loads and never stored, so they add nothing to q . k;
// the scale is d^-0.5, from the true d.  (A runtime d in every
// instantiation slowed the exact ones by a few per cent.)
//
// Bound.  On the scoring path kernel.attention hands over q/k/v
// [128, 1, 512, 128] bf16 causal (4 sequences x 32 heads, 512 tokens):
// 8.6 GFLOP of products and 67 MB of q/k/v/o, i.e. 0.0087 ms at the bf16
// tensor-core peak (989 TFLOP/s) against 0.020 ms at 3.35 TB/s, so bytes
// bound it.  At 67 TFLOP/s of f32 outside the tensor cores the same
// products need 0.128 ms, which is why the bf16 path runs on the tensor
// cores, and on wgmma, the only way to their full rate.  On whisper-small's
// scoring path (4 audio x 12 heads, D = 64, no mask) the encoder's
// [48, 1, 1500, 64] attention is bound by operations (27.6 GFLOP, 0.028
// ms) and the cross-attention's 128 queries x 1500 keys by bytes (20 MB,
// 0.006 ms).
//
// bf16 design (wgmma, FA2's load order).  One CTA of one warpgroup (4
// warps) per (b*h, 64-query tile), each warp owning 16 query rows; the
// tiles with the most keys are launched first (causal), so the causal tail
// does not run alone.  Q, K and V tiles (64 rows) sit in shared memory in
// the 128-byte swizzled layout wgmma reads (16-byte chunk c of row r at
// c ^ (r & 7) of each 128-byte column block), filled by 16-byte
// cp.async.cg copies and handed to the async proxy by a proxy fence.  One
// buffer each (48 KB at D = 128), so three CTAs share an SM: V(t) loads
// while S(t) and its softmax run, K(t+1) while P.V(t) runs.  S = Q.K^T is
// wgmma.m64n64k16 with both operands in shared memory (K-major); it is
// scaled by D^-0.5 * log2(e) in f32, then masked, then the online softmax
// runs on the accumulator fragments (a row's max and sum across the 4
// threads of a quad by shuffles, ex2).  P is rounded to bf16 in registers
// and is the register A operand of wgmma.m64nDk16, with V read from
// shared memory transposed (MN-major); O accumulates in f32 registers and
// leaves through shared memory as 16-byte stores.  Head dims below 64 are
// zero-padded to one 64-wide column block in shared memory.  160
// registers at D = 128, no spills.  D = 256 (recurrentgemma-2b's heads)
// is the same kernel with the O accumulator 64 x 256 (128 f32 registers
// a thread): P.V is two m64n128 products a k-step, one per 128-column
// half of V, sharing the softmax statistics; the Q, K and V tiles take
// 97 KB, so one CTA an SM (launch bounds 128 x 1): 208 registers, no
// spills.  Next (ROADMAP Queue 2): TMA loads from a
// producer warp, and two consumer warpgroups taking turns, so that one's
// softmax hides behind the other's products.
//
// Numerics contract.  P rounds to bf16 before P.V (the TPU kernel widens
// v to f32 and so rounds nothing: flash_attention.py:50, :69); the row
// sum l is taken over the unrounded f32 P.  So the bf16 path matches the
// plain version within the reference tests' bf16 tolerance (2e-2
// allclose, tests/test_kernels.py:42), not bit for bit.
//
// f32 design.  The float32 instantiation keeps the scalar design (one CTA
// of 256 threads per (b*h, 64-query tile), 32-key tiles widened in shared
// memory, every product an f32 FMA on the CUDA cores): it is exact f32,
// which the float32 equality gates (1e-4 with TF32 off, and the 2e-5
// sweep) need.  Tensor cores on f32 would mean TF32, which breaks both.
//
// Times: PERF.md section 6 (chip_smoke.py phase 2, device time, NVIDIA
// H100 80GB HBM3, 700.00 W).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // the reference's masked score

// --------------------------------------------------------------------------
// float32: scalar f32 FMAs (exact)
// --------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kBQ = 64;             // query rows per CTA (both paths)
constexpr int kBK = 32;             // keys per streamed tile
constexpr int kQP = kBQ + 4;        // Qt / Pt row stride: float4-aligned
constexpr int kKP = kBK + 1;        // Kt row stride: conflict-free stores

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

// The KV key range [lo, hi) that can hold an unmasked key for some row of
// the query tile [q0, q_last]; every key when a row of it reaches none.
__device__ __forceinline__ void kv_range(int q0, int q_last, int Skv,
                                         int causal, int window, int* lo,
                                         int* hi) {
  *lo = 0;
  *hi = Skv;
  if (window > 0 && q_last >= Skv + window - 1) return;   // unreachable row
  if (causal) *hi = min(Skv, q_last + 1);
  if (window > 0) *lo = max(0, q0 - window + 1);
}

template <int D>
constexpr size_t f32_smem_floats() {
  return (size_t)D * kQP + (size_t)D * kKP + (size_t)kBK * D + (size_t)kBK * kQP;
}

template <int D, bool kMask>
__global__ void __launch_bounds__(kThreads, 2)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int H,
                 int Hkv, int Sq, int Skv, int d_arg, int causal, int window,
                 float scale) {
  const int d_true = kMask ? d_arg : D;     // the true head dim
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

  const float* qb = q + (size_t)bh * Sq * d_true;
  const float* kb = k + ((size_t)b * Hkv + hk) * Skv * d_true;
  const float* vb = v + ((size_t)b * Hkv + hk) * Skv * d_true;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int qp = q0 + r;
    Qt[d * kQP + r] =
        qp < Sq && d < d_true ? qb[(size_t)qp * d_true + d] * scale : 0.f;
  }

  int kv_lo, kv_hi;
  kv_range(q0, min(q0 + kBQ, Sq) - 1, Skv, causal, window, &kv_lo, &kv_hi);
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
      const bool ok = kp < Skv && d < d_true;
      Kt[d * kKP + c] = ok ? kb[(size_t)kp * d_true + d] : 0.f;
      Vs[e] = ok ? vb[(size_t)kp * d_true + d] : 0.f;
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
    float* orow = out + ((size_t)bh * Sq + qp) * d_true;
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (tx + 16 * c < d_true) orow[tx + 16 * c] = acc[i][c] * inv_l;
  }
}

// --------------------------------------------------------------------------
// bfloat16: wgmma
// --------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kBN = 64;             // keys per tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte async copy; zero-fills the destination when !ok (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// makes this thread's shared-memory writes visible to wgmma (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// ties registers a wgmma wrote to a point after wgmma.wait_group, so no
// use of them is scheduled before it
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// d (64 x 64 f32) (+)= A (64 x 16, smem desc) . B (16 x 64, smem desc)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16, registers) . B (16 x 64, smem desc, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[8][4],
                                            const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[OFF .. OFF + 16) (64 x 128 f32) += A (64 x 16, registers) . B (16 x
// 128, smem desc, MN-major)
template <int OFF, int N>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[N][4],
                                            const uint32_t (&a)[4], uint64_t db) {
  static_assert(OFF + 16 <= N, "accumulator columns");
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[OFF + 0][0]), "+f"(d[OFF + 0][1]), "+f"(d[OFF + 0][2]), "+f"(d[OFF + 0][3]), "+f"(d[OFF + 1][0]), "+f"(d[OFF + 1][1]), "+f"(d[OFF + 1][2]), "+f"(d[OFF + 1][3]), "+f"(d[OFF + 2][0]), "+f"(d[OFF + 2][1]), "+f"(d[OFF + 2][2]), "+f"(d[OFF + 2][3]), "+f"(d[OFF + 3][0]), "+f"(d[OFF + 3][1]), "+f"(d[OFF + 3][2]), "+f"(d[OFF + 3][3]), "+f"(d[OFF + 4][0]), "+f"(d[OFF + 4][1]), "+f"(d[OFF + 4][2]), "+f"(d[OFF + 4][3]), "+f"(d[OFF + 5][0]), "+f"(d[OFF + 5][1]), "+f"(d[OFF + 5][2]), "+f"(d[OFF + 5][3]), "+f"(d[OFF + 6][0]), "+f"(d[OFF + 6][1]), "+f"(d[OFF + 6][2]), "+f"(d[OFF + 6][3]), "+f"(d[OFF + 7][0]), "+f"(d[OFF + 7][1]), "+f"(d[OFF + 7][2]), "+f"(d[OFF + 7][3]), "+f"(d[OFF + 8][0]), "+f"(d[OFF + 8][1]), "+f"(d[OFF + 8][2]), "+f"(d[OFF + 8][3]), "+f"(d[OFF + 9][0]), "+f"(d[OFF + 9][1]), "+f"(d[OFF + 9][2]), "+f"(d[OFF + 9][3]), "+f"(d[OFF + 10][0]), "+f"(d[OFF + 10][1]), "+f"(d[OFF + 10][2]), "+f"(d[OFF + 10][3]), "+f"(d[OFF + 11][0]), "+f"(d[OFF + 11][1]), "+f"(d[OFF + 11][2]), "+f"(d[OFF + 11][3]), "+f"(d[OFF + 12][0]), "+f"(d[OFF + 12][1]), "+f"(d[OFF + 12][2]), "+f"(d[OFF + 12][3]), "+f"(d[OFF + 13][0]), "+f"(d[OFF + 13][1]), "+f"(d[OFF + 13][2]), "+f"(d[OFF + 13][3]), "+f"(d[OFF + 14][0]), "+f"(d[OFF + 14][1]), "+f"(d[OFF + 14][2]), "+f"(d[OFF + 14][3]), "+f"(d[OFF + 15][0]), "+f"(d[OFF + 15][1]), "+f"(d[OFF + 15][2]), "+f"(d[OFF + 15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


__device__ __forceinline__ float ex2(float x) {     // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a [rows, d] bf16 array (d <= D) into a tile
// of [DP / 64][64][64] (DP = max(D, 64)) in the 128-byte swizzled layout:
// 16-byte chunk c of row r of a column block lands at chunk c ^ (r & 7).
// Rows past ``rows`` and columns past d are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int rows, int d, int tid) {
  constexpr int kChunks = (D < 64 ? 64 : D) / 8;
#pragma unroll
  for (int c = tid; c < 64 * kChunks; c += 128) {
    const int r = c / kChunks, ch = c - r * kChunks;
    const bool row_ok = row0 + r < rows;
    const bool ok = row_ok && ch < d / 8;
    cp_async16(dst + (ch >> 3) * 4096 + r * 64 + (((ch & 7) ^ (r & 7)) << 3),
               src + (size_t)(row_ok ? row0 + r : 0) * d + (ok ? ch * 8 : 0),
               ok);
  }
}

template <int D>
constexpr size_t wg_smem_bytes() {
  // Q, K and V tiles, and 1 KB to align them to the swizzle's period
  return sizeof(bf16) * 3 * 64 * (D < 64 ? 64 : D) + 1024;
}

template <int D, bool kMask>
__global__ void __launch_bounds__(128, D == 256 ? 1 : 3)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int H,
                  int Hkv, int Sq, int Skv, int d_arg, int causal,
                  int window, float scale_log2) {
  const int d_true = kMask ? d_arg : D;     // the true head dim
  constexpr int DP = D < 64 ? 64 : D;       // head dim in shared memory
  constexpr int kTile = 64 * DP;            // elements of a 64-row tile
  constexpr int kNO = DP / 8;               // 8-column n-tiles of O
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle repeats every 1024 bytes: the tiles start on its period
  const uint32_t pad = (1024u - (smem_addr(smem_raw) & 1023u)) & 1023u;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw + pad);
  bf16* sK = sQ + kTile;
  bf16* sV = sK + kTile;

  const int bh = blockIdx.x;                // b * H + h
  const int b = bh / H;
  const int h = bh - b * H;
  const int hk = h / (H / Hkv);
  // causal: the tiles with the most keys first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBQ;
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;                  // fragment row within 8
  const int t4 = lane & 3;                  // thread within the quad
  const int row_a = q0 + warp * 16 + g;     // rows row_a and row_a + 8

  const bf16* qb = q + (size_t)bh * Sq * d_true;
  const bf16* kb = k + ((size_t)b * Hkv + hk) * Skv * d_true;
  const bf16* vb = v + ((size_t)b * Hkv + hk) * Skv * d_true;

  int kv_lo, kv_hi;
  kv_range(q0, q_last, Skv, causal, window, &kv_lo, &kv_hi);
  const int t_lo = kv_lo / kBN;
  const int t_hi = (kv_hi + kBN - 1) / kBN;

  load_tile<D>(sQ, qb, q0, Sq, d_true, tid);
  load_tile<D>(sK, kb, t_lo * kBN, Skv, d_true, tid);
  cp_async_commit();

  float o[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};          // rows row_a and row_a + 8
  float l[2] = {0.f, 0.f};                  // this thread's part of the sum

  for (int t = t_lo; t < t_hi; ++t) {
    cp_async_wait_all();                    // K(t) has landed
    fence_async_smem();
    __syncthreads();                        // and every warp is done with V
    load_tile<D>(sV, vb, t * kBN, Skv, d_true, tid);
    cp_async_commit();

    // S = Q . K^T: 64 x 64 f32, both operands K-major in shared memory; a
    // k-step of 16 is 32 bytes into a 128-byte row of a column block
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd) {
      const int off = (kd >> 2) * 4096 + (kd & 3) * 16;
      wgmma_ss_n64(s, sw128_desc(sQ + off, 16, 1024),
                   sw128_desc(sK + off, 16, 1024), kd > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale in f32, then mask; a tile with no masked key skips the test.
    // Fragment (j, e): row row_a + 8 * (e >> 1), key k0 + 8j + 2 t4 + (e & 1)
    const int k0 = t * kBN;
    const bool full = k0 + kBN <= Skv && (!causal || k0 + kBN - 1 <= q0) &&
                      (window == 0 || k0 > q_last - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (!full) {
          const int kp = k0 + j * 8 + 2 * t4 + (e & 1);
          const int qp = row_a + (e >> 1) * 8;
          if (kp >= Skv) {
            x = -INFINITY;                  // not a key: weight 0 exactly
          } else if ((causal && kp > qp) ||
                     (window > 0 && kp <= qp - window)) {
            x = kNegInf;
          }
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    // online softmax on the fragments: a row's 4 owners are a quad
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[j][e] - mx[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < kNO; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    cp_async_wait_all();                    // V(t) has landed
    fence_async_smem();
    __syncthreads();                        // and every warp is done with K
    if (t + 1 < t_hi) {
      load_tile<D>(sK, kb, (t + 1) * kBN, Skv, d_true, tid);
      cp_async_commit();
    }

    // O += P . V: the S fragments of keys 16kk..16kk+15, rounded to bf16,
    // are the A fragment (the m16n8k16 layout per warp); V is the B
    // operand read transposed (MN-major): 8-key groups 1024 bytes apart,
    // 64-column blocks 64 rows x 128 bytes apart
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = sw128_desc(sV + kk * 16 * 64, 64 * 128, 1024);
      if constexpr (DP == 256) {
        wgmma_rs_n128<0>(o, pa[kk], dv);
        wgmma_rs_n128<16>(o, pa[kk],
                          sw128_desc(sV + 2 * 4096 + kk * 16 * 64, 64 * 128, 1024));
      } else if constexpr (DP == 128) {
        wgmma_rs_n128<0>(o, pa[kk], dv);
      } else {
        wgmma_rs_n64(o, pa[kk], dv);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
  }
  __syncthreads();                          // K and V are free

  // the row sums over the quad, then O / l through shared memory (padded
  // rows) to 16-byte stores
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  constexpr int kRow = D + 8;
  bf16* so = sK + warp * 16 * kRow;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t4;
    *reinterpret_cast<uint32_t*>(so + g * kRow + col) =
        pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(so + (g + 8) * kRow + col) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int r = c / kChunks, ch = c - r * kChunks;
    const int qp = q0 + warp * 16 + r;
    if (qp < Sq && ch < d_true / 8)
      *reinterpret_cast<uint4*>(out + ((size_t)bh * Sq + qp) * d_true +
                                ch * 8) =
          *reinterpret_cast<const uint4*>(so + r * kRow + ch * 8);
  }
}

// --------------------------------------------------------------------------

// D: the instantiation (the template head dim); d: the true head dim
template <int D, bool kMask>
cudaError_t launch_dm(const void* q, const void* k, const void* v, void* out,
                      int B, int H, int Hkv, int Sq, int Skv, int d,
                      int causal, int window, int dtype, cudaStream_t stream) {
  const dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  const double scale = 1.0 / sqrt((double)d);
  cudaError_t err;
  // above 48 KB a CTA's dynamic shared memory must be asked for
  if (dtype == 0) {
    const size_t smem = sizeof(float) * f32_smem_floats<D>();
    err = cudaFuncSetAttribute(flash_f32_kernel<D, kMask>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    flash_f32_kernel<D, kMask><<<grid, kThreads, smem, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, H,
        Hkv, Sq, Skv, d, causal, window, (float)scale);
  } else {
    const size_t smem = wg_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_bf16_kernel<D, kMask>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    flash_bf16_kernel<D, kMask><<<grid, 128, smem, stream>>>(
        (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, H, Hkv,
        Sq, Skv, d, causal, window, (float)(scale * 1.4426950408889634));
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int Hkv, int Sq, int Skv, int d,
                     int causal, int window, int dtype, cudaStream_t stream) {
  if (d == D)
    return launch_dm<D, false>(q, k, v, out, B, H, Hkv, Sq, Skv, d, causal,
                               window, dtype, stream);
  return launch_dm<D, true>(q, k, v, out, B, H, Hkv, Sq, Skv, d, causal,
                            window, dtype, stream);
}

}  // namespace

// C entry point (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// Returns cudaGetLastError() after the launch (0 on success).  The bf16
// path reads and writes 16-byte vectors: q, k, v and out must be 16-byte
// aligned (the wrapper sees to it).  D: any multiple of 8 up to 256.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int B, int H,
                                     int Hkv, int Sq, int Skv, int D,
                                     int causal, int window, int dtype,
                                     void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv || Sq <= 0 || Skv <= 0 ||
      window < 0 || (Sq + kBQ - 1) / kBQ > 65535 || (dtype != 0 && dtype != 1) ||
      D <= 0 || D > 256 || D % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (D <= 16) return (int)launch_d<16>(q, k, v, out, B, H, Hkv, Sq, Skv, D, causal, window, dtype, st);
  if (D <= 32) return (int)launch_d<32>(q, k, v, out, B, H, Hkv, Sq, Skv, D, causal, window, dtype, st);
  if (D <= 64) return (int)launch_d<64>(q, k, v, out, B, H, Hkv, Sq, Skv, D, causal, window, dtype, st);
  if (D <= 128) return (int)launch_d<128>(q, k, v, out, B, H, Hkv, Sq, Skv, D, causal, window, dtype, st);
  return (int)launch_d<256>(q, k, v, out, B, H, Hkv, Sq, Skv, D, causal, window, dtype, st);
}
