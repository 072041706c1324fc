// Paged single-token decode attention for Hopper (sm_90a): split-K.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention.py:_paged_kernel
// and computes ref_paged_attention (kernels/ref.py): for each row b and
// query head, softmax over the row's valid cache positions of
// (q * D^-0.5) . k, times v, with K/V read from a flat block arena
// kp/vp [num_blocks, bs, Hkv, D] through the row's block table bt[b, :].
// Positions at or past valid[b], and (window > 0) before valid[b] - window,
// are masked (-1e30 inside a visited block, as the reference does); blocks
// that hold no such position are never read.  Accumulation is f32; the
// output is written in q's dtype.  Rows must have valid[b] >= 1 (a row
// with none gets zeros).  Any head dim d <= 256 that is a multiple of 8
// runs: D in {16, 32, 64, 128, 256} in the instantiations below, any other
// d in a padded instantiation (kExact false) of the next size (the
// template D): the arena, q and out rows are read d values apart, the
// shared-memory rows keep D, the columns past d are zero-filled in the
// copies and never stored, the combine is its masked instantiation, and
// the scale is d^-0.5; the arena is never padded or copied.  (A runtime d
// in the exact instantiations slowed llama's row 3-6 % and the windowed
// families' 7-8 %.)  Any group size
// G = Hq/Hkv up to 16: G in {1, 2, 4, 5, 6, 8, 10} has its own
// instantiation, with G a compile-time constant (the registry's groups
// are 1, 4, 5, 6, 8 and 10), and any other G runs in a padded
// instantiation of 4, 8 or 16 query rows, its extra rows zero and never
// written (padded_group; kernels/paged_attention.py mirrors it).  Padded
// in place of exact, G 5, 6 and 10 ran 6 %, 17 % and 41 % slower at the
// families' shapes (PERF.md section 6, tools/paged_timers.py --arch).
//
// Bound.  Decode does a few FLOPs per K/V byte, far below the card's ~295
// operations per byte, so it is bound by the bytes of the valid K/V:
// sum_b valid[b] * Hkv * D * 2 * sizeof(T) over 3.35 TB/s; at the serving
// shape (8 rows up to 512 tokens, Hkv 8, D 128, bf16) that is 7.7 MB,
// 0.0023 ms.  The bytes are few and scattered over 16-token pages, so what
// bounds a simple kernel is latency: the design keeps as many bytes in
// flight as the card can take at once.
//
// Design (flash-decoding).  The row's blocks are cut into splits of bps
// blocks (split_plan in kernels/paged_attention.py, from the static shapes
// B, Hkv, nbps and bs alone, never from valid: 8 splits of 4 x 16 tokens at
// the serving shape, 8 x 8 x 8 = 512 CTAs for 132 SMs).  One CTA of 128
// threads per (split s, KV head h, row b) reads its table entries, and
// issues the whole split's K, then V, as 16-byte cp.async copies into
// shared memory (a 128-wide bf16 head row is 16 lanes x 8 values), so
// every byte of the split is in flight at once and V lands while the
// scores on K are computed.  The G = Hq/Hkv query heads of the KV head sit
// in one CTA, so each K/V byte serves all of them.  Scores: a group of
// D*sizeof(T)/16 lanes per token, q in registers, the dot product reduced
// by shuffles; the softmax statistics (max, sum) per query head by warp
// reductions; P.V with each thread owning one 16-byte column chunk of a
// subset of tokens, reduced by shuffles and across the 4 warps in shared
// memory.  At D = 256 a bf16 head row is one 16-byte chunk per lane of a
// warp and an f32 row two (the lane's chunks sit 32 chunks apart, so a
// warp's loads stay contiguous); q and the P.V accumulators stay in
// registers, G * 8 floats each, which the two phases of the kernel reuse.
// A split wholly past valid[b] or before the window exits at once
// and writes an empty partial (m = -inf, l = 0).  A second kernel merges a
// row's partials in f32: M = max m_s, w_s = exp(m_s - M) (0 for an empty
// split, never exp(-inf - -inf)), O = sum w_s acc_s / sum w_s l_s.  With
// one split the first kernel writes the output itself.  The wrapper
// allocates the partials (torch.empty); the kernels allocate nothing.
//
// Times (chip_smoke.py phase 2, device time of both kernels, NVIDIA H100
// 80GB HBM3, 700.00 W): 0.0115 ms at the serving shape against 0.0156 ms
// for scaled_dot_product_attention over K/V gathered beforehand (0.74x)
// and a 0.0023 ms bound; at 8 rows up to 2048 tokens 0.0278 ms against
// 0.0344 ms.  In steady decode (chip_smoke.py --profile, 8 rows of
// 128-176 tokens) the split kernel takes 0.0087 ms and the combine 0.0030
// ms per call.  PERF.md section 6 keeps every reading.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
// 16-byte async copy; zero-fills the destination when !ok (src unread)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one 16-byte chunk as f32 values
__device__ __forceinline__ void unpack(const float* p, float (&f)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The blocks [j_lo, j_hi) of a row that hold a valid, in-window position.
__device__ __forceinline__ void live_blocks(int vl, int bs, int nbps,
                                            int window, int* j_lo, int* j_hi) {
  *j_hi = min((vl + bs - 1) / bs, nbps);
  *j_lo = (window > 0 && vl - window > 0) ? (vl - window) / bs : 0;
}

// shared memory of the split kernel: K and V of a split, its scores, the
// cross-warp reduction and its table entries (kernels/paged_attention.py
// mirrors this to refuse a shape before launch)
template <typename T>
size_t split_smem_bytes(int D, int G, int bs, int bps) {
  const size_t tok = (size_t)bps * bs;
  return 2 * tok * D * sizeof(T) + sizeof(float) * (G * tok + (size_t)kWarps * G * D)
         + sizeof(int) * (size_t)bps;
}

// G with an instantiation of its own, where G is a compile-time constant
__host__ __device__ constexpr bool exact_group(int G) {
  return G == 1 || G == 2 || G == 4 || G == 5 || G == 6 || G == 8 ||
         G == 10;
}
// The padded instantiation of 4, 8 or 16 rows that runs G query heads a
// KV head (any G at a head dim between the instantiated ones); 0 past 16.
__host__ __device__ constexpr int padded_rows(int G) {
  return G <= 4 ? 4 : G <= 8 ? 8 : G <= 16 ? 16 : 0;
}
// The instantiated group that runs G query heads a KV head at an
// instantiated head dim: G itself where it has an instantiation, else
// padded_rows(G).
__host__ __device__ constexpr int padded_group(int G) {
  return exact_group(G) ? G : padded_rows(G);
}

// The split kernels' body.  GP: the instantiated group (padded_group(G)).
// kExact: GP is the real group, a compile-time constant; otherwise g_real
// query heads a KV head, and rows g >= g_real compute on a zero q and are
// never written, and the true head dim d_arg <= D is a runtime value
// (kExact: d = D).  The partials are laid out by the real group and the
// instantiated D, as the combine kernel reads them.
template <typename T, int D, int GP, bool kExact>
__device__ __forceinline__ void
paged_split(const T* __restrict__ q, const T* __restrict__ kp,
            const T* __restrict__ vp, const int32_t* __restrict__ bt,
            const int32_t* __restrict__ valid, T* __restrict__ out,
            float* __restrict__ part, int Hkv, int g_real, int d_arg, int bs,
            int nbps, int bps, int window, float scale) {
  const int G = kExact ? GP : g_real;
  const int d = kExact ? D : d_arg;
  constexpr int kVec = 16 / sizeof(T);      // values per 16-byte chunk
  constexpr int kCh = D / kVec;             // 16-byte chunks per token row
  constexpr int kL = kCh < 32 ? kCh : 32;   // lanes per token row
  constexpr int kC = kCh / kL;              // chunks per lane
  constexpr int kV = kC * kVec;             // values per lane
  constexpr int kTpw = 32 / kL;             // tokens per warp step
  static_assert(kL >= 1 && 32 % kL == 0 && kCh == kC * kL, "head row vs warp");
  const int ntok_max = bps * bs;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);           // [ntok_max][D]
  T* Vs = Ks + (size_t)ntok_max * D;                // [ntok_max][D]
  float* sc = reinterpret_cast<float*>(Vs + (size_t)ntok_max * D);  // [GP][ntok_max]
  float* red = sc + GP * ntok_max;                  // [kWarps][GP][D]
  int* blk = reinterpret_cast<int*>(red + kWarps * GP * D);  // [bps]
  __shared__ float m_s[GP], l_s[GP];

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ch = lane % kL;                 // this lane's first chunk
  const int Hq = Hkv * G;
  const int dch = d / kVec;                 // 16-byte chunks of a true row
  T* orow = out + ((size_t)b * Hq + (size_t)h * G) * d;
  float* pml = part + (((size_t)b * Hkv + h) * nsplit + s) * 2 * G;   // m, l
  float* pacc = part + (size_t)gridDim.z * Hkv * nsplit * 2 * G +
                (((size_t)b * Hkv + h) * nsplit + s) * G * D;

  // valid[b], the split's table entries and the q rows are independent
  // reads: one round trip for all three
  const int vl = valid[b];
  const int jb = s * bps;                   // the split's first column
  const int my_blk = (tid < bps && jb + tid < nbps)
                         ? bt[(size_t)b * nbps + jb + tid] : 0;
  float qf[GP][kV];                          // this lane's chunks, scaled
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        qf[g][c * kVec + i] =
            g < G && (kExact || ch + c * kL < dch)
                ? to_f32(q[((size_t)b * Hq + h * G + g) * d +
                           (ch + c * kL) * kVec + i]) * scale
                : 0.f;
  int j_lo, j_hi;
  live_blocks(vl, bs, nbps, window, &j_lo, &j_hi);
  const int j0 = max(jb, j_lo);
  const int j1 = min(jb + bps, j_hi);
  if (j0 >= j1) {                           // an empty split
    if (nsplit == 1) {
      for (int e = tid; e < G * d; e += kThreads) store(orow + e, 0.f);
    } else if (tid < G) {
      pml[tid] = -INFINITY;
      pml[G + tid] = 0.f;
    }
    return;
  }
  const int ntok = (j1 - j0) * bs;
  if (tid < bps) blk[tid] = my_blk;
  __syncthreads();
  blk += j0 - jb;                           // blk[i]: the block of column j0 + i
  // columns past d are zero-filled: K's would meet q's zeros, but the
  // shared memory is not zero, and 0 * NaN is NaN
  const size_t tok_stride = (size_t)Hkv * d;
  for (int c = tid; c < ntok * kCh; c += kThreads) {
    const int t = c / kCh, cc = c - t * kCh;
    const int r = t % bs;
    if constexpr (kExact) {
      cp_async16(Ks + (size_t)t * D + cc * kVec,
                 kp + ((size_t)blk[t / bs] * bs + r) * tok_stride + (size_t)h * D + cc * kVec);
    } else {
      const bool ok = cc < dch;
      cp_async16_zfill(Ks + (size_t)t * D + cc * kVec,
                       kp + ((size_t)blk[t / bs] * bs + r) * tok_stride + (size_t)h * d + (ok ? cc * kVec : 0),
                       ok);
    }
  }
  cp_async_commit();
  for (int c = tid; c < ntok * kCh; c += kThreads) {
    const int t = c / kCh, cc = c - t * kCh;
    const int r = t % bs;
    if constexpr (kExact) {
      cp_async16(Vs + (size_t)t * D + cc * kVec,
                 vp + ((size_t)blk[t / bs] * bs + r) * tok_stride + (size_t)h * D + cc * kVec);
    } else {
      const bool ok = cc < dch;
      cp_async16_zfill(Vs + (size_t)t * D + cc * kVec,
                       vp + ((size_t)blk[t / bs] * bs + r) * tok_stride + (size_t)h * d + (ok ? cc * kVec : 0),
                       ok);
    }
  }
  cp_async_commit();
  cp_async_wait<1>();                       // K has landed; V in flight
  __syncthreads();

  // scores: kL lanes per token, kTpw tokens per warp step
  const int pos0 = j0 * bs;
  for (int t0 = warp * kTpw; t0 < ntok; t0 += kWarps * kTpw) {
    const int t = t0 + lane / kL;
    float kf[kV];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float f[kVec];
      if (t < ntok) {
        unpack(Ks + (size_t)t * D + (ch + c * kL) * kVec, f);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) f[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) kf[c * kVec + i] = f[i];
    }
    float dot[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < kV; ++i) a += qf[g][i] * kf[i];
#pragma unroll
      for (int o = kL / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      dot[g] = a;
    }
    if (t < ntok && ch == 0) {
      const int pos = pos0 + t;
      const bool ok = pos < vl && (window == 0 || pos >= vl - window);
#pragma unroll
      for (int g = 0; g < GP; ++g) sc[g * ntok_max + t] = ok ? dot[g] : kNegInf;
    }
  }
  __syncthreads();

  // softmax statistics of the split: one warp per query head
  for (int g = warp; g < G; g += kWarps) {
    float* sg = sc + g * ntok_max;
    float mx = -INFINITY;
    for (int t = lane; t < ntok; t += 32) mx = fmaxf(mx, sg[t]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int t = lane; t < ntok; t += 32) {
      const float p = expf(sg[t] - mx);
      sg[t] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = sum;
    }
  }
  cp_async_wait<0>();                       // V has landed
  __syncthreads();

  // P.V: each thread one 16-byte column chunk over a subset of the tokens
  float acc[GP][kV];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int i = 0; i < kV; ++i) acc[g][i] = 0.f;
  for (int t = tid / kL; t < ntok; t += kThreads / kL) {
    float vf[kV];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      float f[kVec];
      unpack(Vs + (size_t)t * D + (ch + c * kL) * kVec, f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) vf[c * kVec + i] = f[i];
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float p = sc[g * ntok_max + t];
#pragma unroll
      for (int i = 0; i < kV; ++i) acc[g][i] += p * vf[i];
    }
  }
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      float a = acc[g][i];
#pragma unroll
      for (int o = 16; o >= kL; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      acc[g][i] = a;
    }
  if (lane < kL) {
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          red[(warp * GP + g) * D + (ch + c * kL) * kVec + i] = acc[g][c * kVec + i];
  }
  __syncthreads();
  for (int e = tid; e < G * D; e += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[w * GP * D + e];
    if (nsplit > 1) {
      pacc[e] = a;
    } else if constexpr (kExact) {
      store(orow + e, a / fmaxf(l_s[e / D], 1e-30f));
    } else {
      const int g = e / D, col = e - g * D;
      if (col < d) store(orow + g * d + col, a / fmaxf(l_s[g], 1e-30f));
    }
  }
  if (nsplit > 1 && tid < G) {
    pml[tid] = m_s[tid];
    pml[G + tid] = l_s[tid];
  }
}

// An instantiated group: G query heads a KV head, G a compile-time constant.
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int32_t* __restrict__ bt,
                   const int32_t* __restrict__ valid, T* __restrict__ out,
                   float* __restrict__ part, int Hkv, int d, int bs, int nbps,
                   int bps, int window, float scale) {
  paged_split<T, D, G, true>(q, kp, vp, bt, valid, out, part, Hkv, G, d, bs,
                             nbps, bps, window, scale);
}

// Any other group: g_real query heads run in GP rows.
template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads)
paged_split_padded_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp,
                          const int32_t* __restrict__ bt,
                          const int32_t* __restrict__ valid,
                          T* __restrict__ out, float* __restrict__ part,
                          int Hkv, int g_real, int d, int bs, int nbps,
                          int bps, int window, float scale) {
  paged_split<T, D, GP, false>(q, kp, vp, bt, valid, out, part, Hkv, g_real,
                               d, bs, nbps, bps, window, scale);
}

// Merge a row's split partials: one CTA per (KV head, row).  The
// weights w_s = exp(m_s - M) per (split, query head) first, one warp per
// head (an empty split gets w_s = 0, and a row with no live split
// M = -inf and zeros); then each thread merges one 16-byte column chunk
// over the splits.  D: the partials' row (the instantiated head dim); d:
// the output's, the true one (kMaskD; otherwise d = D).
template <typename T, bool kMaskD>
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                     int B, int Hkv, int G, int D, int d_arg, int nsplit) {
  const int d = kMaskD ? d_arg : D;
  extern __shared__ float wsm[];            // [nsplit][G] weights, [G] 1/den
  float* inv_den = wsm + nsplit * G;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t base = ((size_t)b * Hkv + h) * nsplit;
  const float* pml = part + base * 2 * G;
  const float* pacc = part + (size_t)B * Hkv * nsplit * 2 * G + base * G * D;
  for (int g = warp; g < G; g += kWarps) {
    float M = -INFINITY;
    for (int s = lane; s < nsplit; s += 32) M = fmaxf(M, pml[s * 2 * G + g]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    float den = 0.f;
    for (int s = lane; s < nsplit; s += 32) {
      const float ms = pml[s * 2 * G + g];
      const float w = ms == -INFINITY ? 0.f : expf(ms - M);
      wsm[s * G + g] = w;
      den += w * pml[s * 2 * G + G + g];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) den += __shfl_xor_sync(0xffffffffu, den, o);
    if (lane == 0) inv_den[g] = 1.f / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  T* orow = out + ((size_t)b * Hkv * G + (size_t)h * G) * d;
  for (int e = threadIdx.x * 4; e < G * D; e += kThreads * 4) {
    const int g = e / D, col = e - g * D;
    if (kMaskD && col >= d) continue;       // d % 8 == 0: a chunk is all in
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    // every split's chunk is loaded, live or not, so the loads issue
    // together; an empty split's (unwritten) chunk is selected away, so
    // it adds exactly 0
#pragma unroll 8
    for (int s = 0; s < nsplit; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(pacc + (size_t)s * G * D + e);
      const float w = wsm[s * G + g];
      if (w != 0.f) {
        num.x += w * a.x; num.y += w * a.y; num.z += w * a.z; num.w += w * a.w;
      }
    }
    const float r = inv_den[g];
    T* o = kMaskD ? orow + g * d + col : orow + e;
    store(o, num.x * r);
    store(o + 1, num.y * r);
    store(o + 2, num.z * r);
    store(o + 3, num.w * r);
  }
}

template <typename T, int D, int GP, bool kExact>
cudaError_t launch_g(const void* q, const void* kp, const void* vp,
                     const void* bt, const void* valid, void* out, void* part,
                     int B, int Hkv, int G, int d, int bs, int nbps, int bps,
                     int nsplit, int window, cudaStream_t stream) {
  const size_t smem = split_smem_bytes<T>(D, GP, bs, bps);
  const dim3 grid(nsplit, Hkv, B);
  const float scale = rsqrtf((float)d);
  // above 48 KB a CTA's dynamic shared memory must be asked for
  cudaError_t err;
  if constexpr (kExact) {
    err = cudaFuncSetAttribute(paged_split_kernel<T, D, GP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    paged_split_kernel<T, D, GP><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)bt,
        (const int32_t*)valid, (T*)out, (float*)part, Hkv, d, bs, nbps, bps,
        window, scale);
  } else {
    err = cudaFuncSetAttribute(paged_split_padded_kernel<T, D, GP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    paged_split_padded_kernel<T, D, GP><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)kp, (const T*)vp, (const int32_t*)bt,
        (const int32_t*)valid, (T*)out, (float*)part, Hkv, G, d, bs, nbps,
        bps, window, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const dim3 cgrid(Hkv, B);
  const size_t csmem = sizeof(float) * (size_t)(nsplit + 1) * G;
  if (d == D)
    paged_combine_kernel<T, false><<<cgrid, kThreads, csmem, stream>>>(
        (const float*)part, (T*)out, B, Hkv, G, D, d, nsplit);
  else
    paged_combine_kernel<T, true><<<cgrid, kThreads, csmem, stream>>>(
        (const float*)part, (T*)out, B, Hkv, G, D, d, nsplit);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_d(const void* q, const void* kp, const void* vp,
                     const void* bt, const void* valid, void* out, void* part,
                     int B, int Hkv, int G, int d, int bs, int nbps, int bps,
                     int nsplit, int window, cudaStream_t stream) {
#define REPRO_PAGED_GROUP(GP, EXACT)                                        \
  return launch_g<T, D, GP, EXACT>(q, kp, vp, bt, valid, out, part, B, Hkv, \
                                   G, d, bs, nbps, bps, nsplit, window,     \
                                   stream);
  if (exact_group(G) && d == D) {
    switch (G) {
      case 1: REPRO_PAGED_GROUP(1, true)
      case 2: REPRO_PAGED_GROUP(2, true)
      case 4: REPRO_PAGED_GROUP(4, true)
      case 5: REPRO_PAGED_GROUP(5, true)
      case 6: REPRO_PAGED_GROUP(6, true)
      case 8: REPRO_PAGED_GROUP(8, true)
      case 10: REPRO_PAGED_GROUP(10, true)
    }
  }
  // another group, or another head dim: the padded instantiations
  switch (d == D ? padded_group(G) : padded_rows(G)) {
    case 4: REPRO_PAGED_GROUP(4, false)
    case 8: REPRO_PAGED_GROUP(8, false)
    case 16: REPRO_PAGED_GROUP(16, false)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_PAGED_GROUP
}

template <typename T>
cudaError_t launch_t(const void* q, const void* kp, const void* vp,
                     const void* bt, const void* valid, void* out, void* part,
                     int B, int Hkv, int G, int d, int bs, int nbps, int bps,
                     int nsplit, int window, cudaStream_t stream) {
  if (d <= 16) return launch_d<T, 16>(q, kp, vp, bt, valid, out, part, B, Hkv, G, d, bs, nbps, bps, nsplit, window, stream);
  if (d <= 32) return launch_d<T, 32>(q, kp, vp, bt, valid, out, part, B, Hkv, G, d, bs, nbps, bps, nsplit, window, stream);
  if (d <= 64) return launch_d<T, 64>(q, kp, vp, bt, valid, out, part, B, Hkv, G, d, bs, nbps, bps, nsplit, window, stream);
  if (d <= 128) return launch_d<T, 128>(q, kp, vp, bt, valid, out, part, B, Hkv, G, d, bs, nbps, bps, nsplit, window, stream);
  return launch_d<T, 256>(q, kp, vp, bt, valid, out, part, B, Hkv, G, d, bs, nbps, bps, nsplit, window, stream);
}

}  // namespace

// C entry point (bound with ctypes).  dtype: 0 = float32, 1 = bfloat16.
// bps blocks per split, nsplit = ceil(nbps / bps) splits; part: f32
// scratch of B * Hkv * nsplit * G * (2 + DI) values when nsplit > 1, DI
// the instantiated head dim that runs D (any multiple of 8 up to 256).  K/V
// are read as 16-byte vectors: kp and vp must be 16-byte aligned.  One
// call launches the split kernel and, when nsplit > 1, the combine kernel.
// Returns cudaGetLastError() after the launches (0 on success).
extern "C" int repro_paged_attention(const void* q, const void* kp,
                                     const void* vp, const void* bt,
                                     const void* valid, void* out, void* part,
                                     int B, int Hkv, int G, int D, int bs,
                                     int nbps, int bps, int nsplit, int window,
                                     int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || bs <= 0 || nbps <= 0 || bps <= 0 ||
      bps > kThreads || nsplit != (nbps + bps - 1) / bps || nsplit > 65535 ||
      Hkv > 65535 || B > 65535 || G <= 0 || padded_group(G) == 0 ||
      D <= 0 || D > 256 || D % 8 ||
      (nsplit + 1) * G > 12288 ||
      (nsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_t<float>(q, kp, vp, bt, valid, out, part, B, Hkv, G, D, bs, nbps, bps, nsplit, window, st);
  if (dtype == 1)
    return (int)launch_t<__nv_bfloat16>(q, kp, vp, bt, valid, out, part, B, Hkv, G, D, bs, nbps, bps, nsplit, window, st);
  return (int)cudaErrorInvalidValue;
}
