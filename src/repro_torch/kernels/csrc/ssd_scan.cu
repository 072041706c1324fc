// Mamba-2 SSD chunked scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py:_ssd_kernel and
// computes what it computes (and what ref_ssd, kernels/ref.py, computes
// token by token): for each (b, h), with a_t = dt_t * A_h, cs the inclusive
// cumsum of a within a chunk of Q tokens and the f32 state h [P, N] carried
// across chunks,
//   y_i   = sum_{j<=i in chunk} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//           + exp(cs_i) (C_i . h_in[p, :])
//   h_out = exp(cs_last) h_in + sum_j exp(cs_last - cs_j) dt_j x_j B_j^T
// in f32, y cast to x's dtype.  Optionally it writes the state after the
// last token, h_final [B, H, P, N] f32 (the serving prefill needs it; the
// TPU kernel keeps it in VMEM scratch).  x [B,S,H,P], dt [B,S,H], Bm/Cm
// [B,S,N] are read through their strides (last axis contiguous; the model
// hands over slices of the conv output, rows 1792 elements apart); x/Bm/Cm
// are float32 or bfloat16, dt float32 or bfloat16, A [H] float32.
//
// Bound.  At the serving prefill (x [1, 1024, 24, 64] bf16, N = 128) the
// inputs, y and h_final are ~7.6 MB (2.3 us at 3.35 TB/s); the work at the
// reference's chunk of 256 is ~1.7 GFLOP (1.7 us at the bf16 tensor-core
// peak; C.B^T counted once for all heads): bytes bound it, as at the eval
// forward [4, 2048] (0.0164 ms).  The first kernel (one CTA per (b, h,
// 16-row tile of P) walking the chunks in order, every product an f32 FMA,
// C.B^T redone by every CTA) read 0.423 ms at the prefill and 1.81 ms at
// the forward: 96 CTAs on 132 SMs, five barriers a chunk.  This design
// reads 0.0324 ms (14x the bound) and 0.225 ms (13.7x) of device time over
// its three kernels (chip_smoke.py phase 2; NVIDIA H100 80GB HBM3, 700.00
// W); by CUDA events a call reads 0.06-0.11 ms at the prefill, where the
// host's three launches set the pace.  What holds it there is its
// scratch: the chunk states (f32) and the carried states (bf16 hi + lo)
// are each written and read once, 4 bytes an element of [B, nc, H, P, N]
// each way (25 MB at the prefill, 201 MB at the forward), several times
// the bytes of the work itself.
//
// Design: Mamba-2's own GPU decomposition, three launches from the one C
// entry point, no cross-CTA waiting, the chunks in parallel CTAs.  The
// wrapper allocates the scratch (kernels allocate nothing): states
// [B, nc, H, P, N] f32, decay [B, nc, H] f32 and, for bf16, hsplit.
//  (a) chunk pass, ssd_state_*: one CTA per (b, chunk c, group of heads).
//      It stages B_c [Q, N] once for its heads; per head it takes the
//      cumsum of dt*A (one warp), writes exp(cs_last) to decay and the
//      chunk state s_c = sum_j exp(cs_last - cs_j) dt_j x_j^T B_j [P, N]
//      to states.  Only chunks whose state is needed run: all but the
//      last, and the last too for h_final.
//  (b) state pass, ssd_pass_kernel: one thread per 4 elements of (b, h)'s
//      P*N, sequential over the chunks (loads four chunks ahead): h_in(0) =
//      0, h_in(c+1) = exp(cs_last,c) h_in(c) + s_c in f32, written for the
//      output pass (bf16: as hi + lo bf16 into hsplit [B, nc, H, 2, P, N];
//      f32: over s_c in place), and h_final when asked.
//  (c) output pass, ssd_out_*: one CTA per (b, chunk, group of heads).  It
//      stages C_c and B_c and forms C_c.B_c^T [Q, Q] once for its heads;
//      per head y = exp(cs_i) C_i.h_in(c)^T + (C.B^T o L).(dt x), L_ij =
//      exp(cs_i - cs_j) on the lower triangle only (above it the
//      difference is positive and exp could overflow into 0 * inf), cast
//      to x's dtype.  The intra-chunk product lives here rather than in
//      (a) so that y is one sum, written once, with no f32 y_diag scratch.
// Chunks of Q = 64 tokens: Q = 128 (half the chunk states) timed slower
// at both path shapes, its output pass (8 warps, 164 registers) costing
// more than the smaller scratch saved.
// bfloat16 (ssd_state_bf16 / ssd_out_bf16, 4 warps, each warp 16 rows):
// every product is mma.sync.m16n8k16 bf16 x bf16 -> f32 on the tensor
// cores, operands from shared memory by ldmatrix.  B, C and x enter as
// they come.  An operand computed in f32 enters as two bf16 terms, hi =
// bf16(v) and lo = bf16(v - hi), in two products (about 16 bits of v): the
// decayed dt x of the chunk state, h_in, and M' = (C.B^T o L) dt_j, in
// which dt is folded so that x stays exact.  Rounding each of them once to
// bf16 put the path shape outside the 5e-2 rule against the recurrence and
// the plain chunked math (|C.B^T| ~ 11 at N = 128); the split costs
// tensor-core issue slots, which this bytes-bound kernel has to spare
// (kernels/ref.ssd_chunk_parallel emulates exactly this).  C.B^T stays in
// the accumulator registers across the heads; M' is built from it in
// registers (two n-tiles of the accumulator are one k-tile of the A
// operand) and only the k-tiles at or below the warp's diagonal run.  B, C
// and x are staged by 16-byte cp.async through the strides, rows padded by
// 16 bytes against bank conflicts; a ragged last chunk is zero-filled (dt =
// 0 past S keeps the decay exact), so every length runs.
// float32 (ssd_state_f32 / ssd_out_f32, 128 threads each): the same
// chunk-parallel structure with exact f32 FMAs on the CUDA cores and no
// TF32, as the f32 equality gates (logits card vs CPU within 1e-4) need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>


namespace {

constexpr int kMaxN = 256;
constexpr int kPB = 64;             // columns of P per block of the output
constexpr int kXP = kPB + 8;        // bf16 pitch of the staged x block
constexpr int kQ = 64;              // tokens a chunk
constexpr int kT = 2 * kQ;          // threads a CTA: kQ / 16 warps
constexpr int kPT32 = 16;           // rows of P per step of the f32 kernels

struct Args {
  const void* x;
  const void* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  void* y;
  float* h_final;
  float* states;                    // [B, nc, H, P, N]
  float* decay;                     // [B, nc, H]
  __nv_bfloat16* hsplit;            // [B, nc, H, 2, P, N] or null
  int B, S, H, P, N, nc, hg;        // hg: heads per CTA
  long long sxb, sxs, sxh, sdb, sds, sdh, sbb, sbs, scb, scs;
  int vec;                          // x, Bm, Cm take 16-byte loads
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  union { __nv_bfloat162 h; uint32_t u; } c;
  c.h = __floats2bfloat162_rn(lo, hi);
  return c.u;
}

// (a, b) as bf16 pairs hi = bf16(v) and lo = bf16(v - hi): hi + lo keeps
// about 16 significant bits of v
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  union { __nv_bfloat162 h; uint32_t u; } c;
  c.h = __floats2bfloat162_rn(a, b);
  const float2 r = __bfloat1622float2(c.h);
  hi = c.u;
  lo = pack_bf16(a - r.x, b - r.y);
}

// 16-byte async copy; zero-fills the destination when !ok (src unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
// d += a . b: m16n8k16, a row-major [16 x 16], b column-major [16 x 8]
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [0, rows) of a [rows, cols] tile of T into shared memory at `pitch`
// elements a row: row j from src + j * rstride, columns past cols_valid
// and rows past rows_valid zero.  vec: 16-byte cp.async (the caller waits);
// else element by element.
template <typename T>
__device__ void stage_rows(T* dst, int pitch, const T* src, long long rstride,
                           int rows_valid, int rows, int cols_valid, int cols,
                           bool vec) {
  if (vec) {
    constexpr int E = 16 / (int)sizeof(T);
    const int cpr = cols / E;
    for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
      const int j = i / cpr, c = (i - j * cpr) * E;
      const bool ok = j < rows_valid && c < cols_valid;
      cp_async16(dst + j * pitch + c, ok ? src + j * rstride + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int j = i / cols, c = i - j * cols;
      dst[j * pitch + c] =
          j < rows_valid && c < cols_valid ? src[j * rstride + c] : T(0.f);
    }
  }
}

// One warp: dts[j] = dt of token c0 + j (0 past q) and cs[j] = the
// inclusive cumsum of dts * A_h over the chunk of kQ = 32 E tokens;
// returns cs[kQ - 1] in every lane.  The chunk and output passes run this
// same code, so they agree on cs to the bit.
template <typename TD>
__device__ __forceinline__ float chunk_cumsum(const Args& a, int b, int c0,
                                              int q, int h, float* dts,
                                              float* cs) {
  constexpr int E = kQ / 32;
  const int lane = threadIdx.x & 31;
  const TD* dtp = (const TD*)a.dt + b * a.sdb + h * a.sdh;
  const float ah = a.A[h];
  float d[E], p[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = lane * E + e;
    d[e] = j < q ? to_f32(dtp[(long long)(c0 + j) * a.sds]) : 0.f;
    run += d[e] * ah;
    p[e] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    dts[lane * E + e] = d[e];
    cs[lane * E + e] = excl + p[e];
  }
  return __shfl_sync(0xffffffffu, excl + p[E - 1], 31);
}

// ============================ bfloat16 =====================================

__host__ __device__ constexpr int kpad(int N) { return (N + 15) / 16 * 16; }

// (a) chunk pass: one CTA of kQ/16 warps per (chunk, head group, b)
template <typename TD>
__global__ void __launch_bounds__(kT) ssd_state_bf16(Args a) {
  constexpr int Q = kQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NK = kpad(a.N), NP = NK + 8;
  __nv_bfloat16* Bs = (__nv_bfloat16*)smem_raw;           // [Q][NP]
  __nv_bfloat16* Xs = Bs + Q * NP;                        // [Q][kXP]
  float* dts = (float*)(Xs + Q * kXP);                    // [Q]
  float* cs = dts + Q;                                    // [Q]
  float* wts = cs + Q;                                    // [Q]
  constexpr int W = Q / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int c = blockIdx.x, b = blockIdx.z, c0 = c * Q;
  const int q = min(Q, a.S - c0);
  const int h0 = blockIdx.y * a.hg, h1 = min(h0 + a.hg, a.H);

  stage_rows(Bs, NP,
             (const __nv_bfloat16*)a.Bm + b * a.sbb + (long long)c0 * a.sbs,
             a.sbs, q, Q, a.N, NK, a.vec);

  for (int h = h0; h < h1; ++h) {
    float* st = a.states + (((long long)b * a.nc + c) * a.H + h) * a.P * a.N;
    for (int p0 = 0; p0 < a.P; p0 += kPB) {
      const int pw = min(kPB, a.P - p0);
      __syncthreads();                // the last readers of Xs / wts are done
      stage_rows(Xs, kXP,
                 (const __nv_bfloat16*)a.x + b * a.sxb + h * a.sxh + p0 +
                     (long long)c0 * a.sxs,
                 a.sxs, q, Q, pw, pw, a.vec);
      if (p0 == 0 && warp == 0) {     // overlaps the copies in flight
        const float cl = chunk_cumsum<TD>(a, b, c0, q, h, dts, cs);
        __syncwarp();
        for (int j = lane; j < Q; j += 32) wts[j] = expf(cl - cs[j]) * dts[j];
        if (lane == 0) a.decay[((long long)b * a.nc + c) * a.H + h] = expf(cl);
      }
      cp_async_wait_all();
      __syncthreads();
      // s[p][n] = sum_j w_j x[j][p] Bs[j][n]: items of 16 rows of P x 64
      // of N; the A operand (w x)^T is scaled in registers and enters as
      // hi + lo
      const int nbk = (NK + 63) / 64, items = (pw / 16) * nbk;
      for (int it = warp; it < items; it += W) {
        const int pt = it / nbk, n0 = (it - pt * nbk) * 64;
        float acc[8][4];
#pragma unroll
        for (int t = 0; t < 8; ++t)
          acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
        const int mat = lane >> 3, r = lane & 7;
#pragma unroll
        for (int kt = 0; kt < Q / 16; ++kt) {
          uint32_t xf[4];             // A[p][j] = x[j][p]: transposed
          ldsm_x4_t(xf, Xs + (kt * 16 + r + (mat >> 1) * 8) * kXP + pt * 16 +
                            (mat & 1) * 8);
          // xf[0], xf[1]: columns j0, j0 + 1; xf[2], xf[3]: j0 + 8, j0 + 9
          const int j0 = kt * 16 + 2 * t4;
          const float w0 = wts[j0], w1 = wts[j0 + 1];
          const float w8 = wts[j0 + 8], w9 = wts[j0 + 9];
          uint32_t ah[4], al[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float wl = k < 2 ? w0 : w8, wh = k < 2 ? w1 : w9;
            split_bf16(__uint_as_float(xf[k] << 16) * wl,
                       __uint_as_float(xf[k] & 0xffff0000u) * wh, ah[k],
                       al[k]);
          }
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (n0 + np * 16 < NK) {
              uint32_t bf[4];         // B[j][n] = Bs[j][n]: transposed
              ldsm_x4_t(bf, Bs + (kt * 16 + r + (mat & 1) * 8) * NP + n0 +
                                np * 16 + (mat >> 1) * 8);
              mma16816(acc[2 * np], ah, bf[0], bf[1]);
              mma16816(acc[2 * np + 1], ah, bf[2], bf[3]);
              mma16816(acc[2 * np], al, bf[0], bf[1]);
              mma16816(acc[2 * np + 1], al, bf[2], bf[3]);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int n = n0 + t * 8 + 2 * t4;
          if (n < a.N) {
            const int p = p0 + pt * 16 + g;
            *reinterpret_cast<float2*>(st + (long long)p * a.N + n) =
                make_float2(acc[t][0], acc[t][1]);
            *reinterpret_cast<float2*>(st + (long long)(p + 8) * a.N + n) =
                make_float2(acc[t][2], acc[t][3]);
          }
        }
      }
    }
  }
}

// (c) output pass: one CTA of kQ/16 warps per (chunk, head group, b)
template <typename TD>
__global__ void __launch_bounds__(kT) ssd_out_bf16(Args a) {
  constexpr int Q = kQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int NK = kpad(a.N), NP = NK + 8;
  __nv_bfloat16* Cs = (__nv_bfloat16*)smem_raw;           // [Q][NP]
  __nv_bfloat16* Bs = Cs + Q * NP;                        // [Q][NP]
  __nv_bfloat16* Hh = Bs + Q * NP;                        // [kPB][NP]
  __nv_bfloat16* Hl = Bs;             // [kPB][NP], over Bs after C.B^T
  __nv_bfloat16* Xs = Hh + kPB * NP;                      // [Q][kXP]
  float* dts = (float*)(Xs + Q * kXP);                    // [Q]
  float* cs = dts + Q;                                    // [Q]
  constexpr int W = Q / 16, NT = Q / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, mat = lane >> 3, r = lane & 7;
  const int c = blockIdx.x, b = blockIdx.z, c0 = c * Q;
  const int q = min(Q, a.S - c0);
  const int h0 = blockIdx.y * a.hg, h1 = min(h0 + a.hg, a.H);
  const int i0 = warp * 16;           // this warp's rows: i0 + g, i0 + g + 8

  stage_rows(Cs, NP,
             (const __nv_bfloat16*)a.Cm + b * a.scb + (long long)c0 * a.scs,
             a.scs, q, Q, a.N, NK, a.vec);
  stage_rows(Bs, NP,
             (const __nv_bfloat16*)a.Bm + b * a.sbb + (long long)c0 * a.sbs,
             a.sbs, q, Q, a.N, NK, a.vec);
  cp_async_wait_all();
  __syncthreads();

  // C.B^T for this warp's 16 rows, columns up to its diagonal (n-tile
  // pairs 0..warp), kept in registers for all the heads
  float cb[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) cb[t][0] = cb[t][1] = cb[t][2] = cb[t][3] = 0.f;
  for (int k0 = 0; k0 < NK; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, Cs + (i0 + (lane & 15)) * NP + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int tp = 0; tp < Q / 16; ++tp) {
      if (tp <= warp) {
        uint32_t bf[4];               // B[n][j] = Bs[j][n]: as stored
        ldsm_x4(bf, Bs + (tp * 16 + r + (mat >> 1) * 8) * NP + k0 +
                        (mat & 1) * 8);
        mma16816(cb[2 * tp], af, bf[0], bf[1]);
        mma16816(cb[2 * tp + 1], af, bf[2], bf[3]);
      }
    }
  }

  const __nv_bfloat16* hin =
      c > 0 ? a.hsplit + ((long long)b * a.nc + c - 1) * a.H * 2 * a.P * a.N
            : nullptr;
  for (int h = h0; h < h1; ++h) {
    for (int p0 = 0; p0 < a.P; p0 += kPB) {
      const int pw = min(kPB, a.P - p0);
      __syncthreads();                // the last readers are done
      // x as it comes (dt goes into M'), h_in as hi + lo (state pass)
      stage_rows(Xs, kXP,
                 (const __nv_bfloat16*)a.x + b * a.sxb + h * a.sxh + p0 +
                     (long long)c0 * a.sxs,
                 a.sxs, q, Q, pw, pw, a.vec);
      if (hin != nullptr) {
        const __nv_bfloat16* hp = hin + ((long long)h * 2 * a.P + p0) * a.N;
        stage_rows(Hh, NP, hp, a.N, pw, pw, a.N, NK, a.N % 8 == 0);
        stage_rows(Hl, NP, hp + (long long)a.P * a.N, a.N, pw, pw, a.N, NK,
                   a.N % 8 == 0);
      }
      if (p0 == 0 && warp == 0)       // overlaps the copies in flight
        chunk_cumsum<TD>(a, b, c0, q, h, dts, cs);
      cp_async_wait_all();
      __syncthreads();
      const float cs_lo = cs[i0 + g], cs_hi = cs[i0 + g + 8];
      const float e_lo = expf(cs_lo), e_hi = expf(cs_hi);

      float acc[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t)
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
      if (hin != nullptr) {           // exp(cs_i) C_i . h_in^T
        for (int k0 = 0; k0 < NK; k0 += 16) {
          uint32_t af[4];
          ldsm_x4(af, Cs + (i0 + (lane & 15)) * NP + k0 + (lane >> 4) * 8);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (np * 16 < pw) {
              uint32_t bh[4], bl[4];  // B[n][p] = H[p][n]: as stored
              const int ho = (np * 16 + r + (mat >> 1) * 8) * NP + k0 +
                             (mat & 1) * 8;
              ldsm_x4(bh, Hh + ho);
              ldsm_x4(bl, Hl + ho);
              mma16816(acc[2 * np], af, bh[0], bh[1]);
              mma16816(acc[2 * np + 1], af, bh[2], bh[3]);
              mma16816(acc[2 * np], af, bl[0], bl[1]);
              mma16816(acc[2 * np + 1], af, bl[2], bl[3]);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          acc[t][0] *= e_lo; acc[t][1] *= e_lo;
          acc[t][2] *= e_hi; acc[t][3] *= e_hi;
        }
      }
      // + M.x, M = (C.B^T o L) dt_j from the registers, k-tiles 0..warp
#pragma unroll
      for (int kt = 0; kt < Q / 16; ++kt) {
        if (kt <= warp) {
          const int j0 = kt * 16 + 2 * t4;
          float m[2][4];              // [n-tile 2kt, 2kt+1][c0..c3]
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int j = j0 + 8 * u;
            const float csj0 = cs[j], csj1 = cs[j + 1];
            const float d0 = dts[j], d1 = dts[j + 1];
            const float* v = cb[2 * kt + u];
            const int ilo = i0 + g, ihi = ilo + 8;
            m[u][0] = j <= ilo ? v[0] * expf(cs_lo - csj0) * d0 : 0.f;
            m[u][1] = j + 1 <= ilo ? v[1] * expf(cs_lo - csj1) * d1 : 0.f;
            m[u][2] = j <= ihi ? v[2] * expf(cs_hi - csj0) * d0 : 0.f;
            m[u][3] = j + 1 <= ihi ? v[3] * expf(cs_hi - csj1) * d1 : 0.f;
          }
          uint32_t ah[4], al[4];      // M as hi + lo
          split_bf16(m[0][0], m[0][1], ah[0], al[0]);
          split_bf16(m[0][2], m[0][3], ah[1], al[1]);
          split_bf16(m[1][0], m[1][1], ah[2], al[2]);
          split_bf16(m[1][2], m[1][3], ah[3], al[3]);
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            if (np * 16 < pw) {
              uint32_t bf[4];         // B[j][p] = x[j][p]: transposed
              ldsm_x4_t(bf, Xs + (kt * 16 + r + (mat & 1) * 8) * kXP +
                                np * 16 + (mat >> 1) * 8);
              mma16816(acc[2 * np], ah, bf[0], bf[1]);
              mma16816(acc[2 * np + 1], ah, bf[2], bf[3]);
              mma16816(acc[2 * np], al, bf[0], bf[1]);
              mma16816(acc[2 * np + 1], al, bf[2], bf[3]);
            }
          }
        }
      }
      __nv_bfloat16* yp = (__nv_bfloat16*)a.y +
                          ((long long)b * a.S + c0) * a.H * a.P +
                          (long long)h * a.P + p0;
      const long long ys = (long long)a.H * a.P;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int p = t * 8 + 2 * t4;
        if (p < pw) {
          if (i0 + g < q)
            *reinterpret_cast<uint32_t*>(yp + (i0 + g) * ys + p) =
                pack_bf16(acc[t][0], acc[t][1]);
          if (i0 + g + 8 < q)
            *reinterpret_cast<uint32_t*>(yp + (i0 + g + 8) * ys + p) =
                pack_bf16(acc[t][2], acc[t][3]);
        }
      }
    }
  }
}

size_t smem_state_bf16(int N) {
  constexpr int Q = kQ;
  return sizeof(__nv_bfloat16) * ((size_t)Q * (kpad(N) + 8) + Q * kXP) +
         sizeof(float) * 3 * Q;
}
size_t smem_out_bf16(int N) {
  constexpr int Q = kQ;
  return sizeof(__nv_bfloat16) *
             ((size_t)(2 * Q + kPB) * (kpad(N) + 8) + Q * kXP) +
         sizeof(float) * 2 * Q;
}

// ============================ float32 ======================================

// (a) chunk pass, exact f32: one CTA of kT threads per (chunk, head
// group, b), P in steps of 16 rows
template <typename TD>
__global__ void __launch_bounds__(kT) ssd_state_f32(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int Q = kQ;
  const int N = a.N, NS = N + 1;
  float* Bs = (float*)smem_raw;                           // [Q][NS]
  float* Xw = Bs + Q * NS;                                // [Q][kPT32]
  float* dts = Xw + Q * kPT32;
  float* cs = dts + Q;
  float* wts = cs + Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x, b = blockIdx.z, c0 = c * Q;
  const int q = min(Q, a.S - c0);
  const int h0 = blockIdx.y * a.hg, h1 = min(h0 + a.hg, a.H);
  stage_rows(Bs, NS, (const float*)a.Bm + b * a.sbb + (long long)c0 * a.sbs,
             a.sbs, q, Q, N, N, false);
  const float* xb = (const float*)a.x + b * a.sxb;
  for (int h = h0; h < h1; ++h) {
    __syncthreads();
    if (warp == 0) {
      const float cl = chunk_cumsum<TD>(a, b, c0, q, h, dts, cs);
      __syncwarp();
      for (int j = lane; j < Q; j += 32) wts[j] = expf(cl - cs[j]) * dts[j];
      if (lane == 0) a.decay[((long long)b * a.nc + c) * a.H + h] = expf(cl);
    }
    __syncthreads();
    float* st = a.states + (((long long)b * a.nc + c) * a.H + h) * a.P * N;
    for (int p0 = 0; p0 < a.P; p0 += kPT32) {
      if (p0) __syncthreads();
      for (int i = threadIdx.x; i < Q * kPT32; i += kT) {
        const int j = i / kPT32, p = i - j * kPT32;
        Xw[i] = j < q ? xb[(long long)(c0 + j) * a.sxs + h * a.sxh + p0 + p] *
                            wts[j]
                      : 0.f;
      }
      __syncthreads();
      for (int o = threadIdx.x; o < kPT32 * N; o += kT) {
        const int p = o / N, n = o - p * N;
        float s = 0.f;
        for (int j = 0; j < q; ++j) s += Xw[j * kPT32 + p] * Bs[j * NS + n];
        st[(long long)(p0 + p) * N + n] = s;
      }
    }
  }
}

// (c) output pass, exact f32
template <typename TD>
__global__ void __launch_bounds__(kT) ssd_out_f32(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int Q = kQ, QS = Q + 1;
  const int N = a.N, NS = N + 1;
  float* Cs = (float*)smem_raw;                           // [Q][NS]
  float* Bs = Cs + Q * NS;                                // [Q][NS]
  float* CB = Bs + Q * NS;                                // [Q][QS]
  float* M = CB + Q * QS;                                 // [Q][QS]
  float* Hs = M + Q * QS;                                 // [kPT32][NS]
  float* Xs = Hs + kPT32 * NS;                            // [Q][kPT32]
  float* dts = Xs + Q * kPT32;
  float* cs = dts + Q;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.x, b = blockIdx.z, c0 = c * Q;
  const int q = min(Q, a.S - c0);
  const int h0 = blockIdx.y * a.hg, h1 = min(h0 + a.hg, a.H);
  stage_rows(Cs, NS, (const float*)a.Cm + b * a.scb + (long long)c0 * a.scs,
             a.scs, q, Q, N, N, false);
  stage_rows(Bs, NS, (const float*)a.Bm + b * a.sbb + (long long)c0 * a.sbs,
             a.sbs, q, Q, N, N, false);
  __syncthreads();
  for (int o = threadIdx.x; o < Q * Q; o += kT) {
    const int i = o / Q, j = o - i * Q;
    float s = 0.f;
    if (j <= i)
      for (int n = 0; n < N; ++n) s += Cs[i * NS + n] * Bs[j * NS + n];
    CB[i * QS + j] = s;
  }
  const float* hin = c > 0 ? a.states + ((long long)b * a.nc + c - 1) *
                                            a.H * a.P * N
                           : nullptr;
  const float* xb = (const float*)a.x + b * a.sxb;
  float* yb = (float*)a.y + ((long long)b * a.S + c0) * a.H * a.P;
  for (int h = h0; h < h1; ++h) {
    __syncthreads();
    if (warp == 0) chunk_cumsum<TD>(a, b, c0, q, h, dts, cs);
    __syncthreads();
    for (int o = threadIdx.x; o < Q * Q; o += kT) {
      const int i = o / Q, j = o - i * Q;
      M[i * QS + j] = j <= i ? CB[i * QS + j] * expf(cs[i] - cs[j]) : 0.f;
    }
    for (int p0 = 0; p0 < a.P; p0 += kPT32) {
      __syncthreads();
      for (int i = threadIdx.x; i < Q * kPT32; i += kT) {
        const int j = i / kPT32, p = i - j * kPT32;
        Xs[i] = j < q ? xb[(long long)(c0 + j) * a.sxs + h * a.sxh + p0 + p] *
                            dts[j]
                      : 0.f;
      }
      if (hin != nullptr)
        for (int i = threadIdx.x; i < kPT32 * N; i += kT) {
          const int p = i / N, n = i - p * N;
          Hs[p * NS + n] = hin[((long long)h * a.P + p0 + p) * N + n];
        }
      __syncthreads();
      for (int o = threadIdx.x; o < Q * kPT32; o += kT) {
        const int i = o / kPT32, p = o - i * kPT32;
        if (i >= q) continue;
        float off = 0.f, dg = 0.f;
        if (hin != nullptr)
          for (int n = 0; n < N; ++n) off += Cs[i * NS + n] * Hs[p * NS + n];
        for (int j = 0; j <= i; ++j) dg += M[i * QS + j] * Xs[j * kPT32 + p];
        yb[(long long)i * a.H * a.P + h * a.P + p0 + p] =
            expf(cs[i]) * off + dg;
      }
    }
  }
}

size_t smem_state_f32(int N) {
  return sizeof(float) * ((size_t)kQ * (N + 1) + kQ * kPT32 + 3 * kQ);
}
size_t smem_out_f32(int N) {
  return sizeof(float) * ((size_t)(2 * kQ + kPT32) * (N + 1) +
                          2 * (size_t)kQ * (kQ + 1) + kQ * kPT32 +
                          2 * kQ);
}

// ============================ state pass ===================================

// (b) one thread per 4 elements of (b, h)'s [P, N] state, over the chunks
// in order, loads four chunks ahead: h_in(c + 1) for c < nc - 1 goes to
// hsplit as bf16 hi + lo (the bf16 output pass reads it so) or, for f32,
// over states[c]; the state after the last chunk to h_final when asked
__global__ void __launch_bounds__(128) ssd_pass_kernel(Args a, int steps) {
  const long long PN = (long long)a.P * a.N;
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long cstride = (long long)a.H * PN;
  float* sp = a.states + ((long long)b * a.nc * a.H + h) * PN + e;
  const float* dp = a.decay + (long long)b * a.nc * a.H + h;
  float4 hv = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < steps; c0 += 4) {
    float4 s[4];
    float d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k < steps) {
        s[k] = *reinterpret_cast<const float4*>(sp + (c0 + k) * cstride);
        d[k] = dp[(long long)(c0 + k) * a.H];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 + k;
      if (c >= steps) break;
      hv = make_float4(fmaf(d[k], hv.x, s[k].x), fmaf(d[k], hv.y, s[k].y),
                       fmaf(d[k], hv.z, s[k].z), fmaf(d[k], hv.w, s[k].w));
      if (c == a.nc - 1) {
        *reinterpret_cast<float4*>(a.h_final + ((long long)b * a.H + h) * PN +
                                   e) = hv;
      } else if (a.hsplit != nullptr) {
        __nv_bfloat16* hs =
            a.hsplit + (((long long)b * a.nc + c) * a.H + h) * 2 * PN + e;
        uint32_t h0, h1, l0, l1;
        split_bf16(hv.x, hv.y, h0, l0);
        split_bf16(hv.z, hv.w, h1, l1);
        *reinterpret_cast<uint2*>(hs) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(hs + PN) = make_uint2(l0, l1);
      } else {
        *reinterpret_cast<float4*>(sp + c * cstride) = hv;
      }
    }
  }
}

// ============================ launch =======================================

template <typename K>
cudaError_t run(K kern, dim3 grid, int threads, size_t smem, cudaStream_t st,
                const Args& a) {
  // dynamic shared memory above 48 KB is granted per kernel and per
  // device: asked before every launch, on the current device (a cheap
  // host call)
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename TD>
cudaError_t launch_bf16(Args& a, cudaStream_t st) {
  const int groups = (a.H + a.hg - 1) / a.hg;
  const int steps = a.h_final ? a.nc : a.nc - 1;    // chunk states needed
  cudaError_t e;
  if (steps > 0) {
    e = run(ssd_state_bf16<TD>, dim3(steps, groups, a.B), kT,
            smem_state_bf16(a.N), st, a);
    if (e != cudaSuccess) return e;
    const long long n4 = (long long)a.P * a.N / 4;
    ssd_pass_kernel<<<dim3((unsigned)((n4 + 127) / 128), a.H, a.B), 128, 0,
                      st>>>(a, steps);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return run(ssd_out_bf16<TD>, dim3(a.nc, groups, a.B), kT,
             smem_out_bf16(a.N), st, a);
}

template <typename TD>
cudaError_t launch_f32(Args& a, cudaStream_t st) {
  const int groups = (a.H + a.hg - 1) / a.hg;
  const int steps = a.h_final ? a.nc : a.nc - 1;
  cudaError_t e;
  if (steps > 0) {
    e = run(ssd_state_f32<TD>, dim3(steps, groups, a.B), kT,
            smem_state_f32(a.N), st, a);
    if (e != cudaSuccess) return e;
    const long long n4 = (long long)a.P * a.N / 4;
    ssd_pass_kernel<<<dim3((unsigned)((n4 + 127) / 128), a.H, a.B), 128, 0,
                      st>>>(a, steps);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return run(ssd_out_f32<TD>, dim3(a.nc, groups, a.B), kT,
             smem_out_f32(a.N), st, a);
}

}  // namespace

// C entry point (bound with ctypes).  x_dtype (x, Bm, Cm, y) and dt_dtype:
// 0 = float32, 1 = bfloat16; A is float32.  Strides are in elements: x
// (batch, token, head), dt (batch, token, head), Bm and Cm (batch, token);
// each last axis is contiguous (the wrapper checks).  y is a contiguous
// [B, S, H, P]; h_final a contiguous [B, H, P, N] f32, or null.  states
// [B, nc, H, P, N] and decay [B, nc, H] are f32 scratch with nc =
// ceil(S / 64) (unused, and may be null, when nc == 1 and h_final is
// null); hsplit [B, nc, H, 2, P, N] bf16 is scratch for bfloat16 when
// nc > 1, null otherwise.  heads_per_cta: heads of one CTA in the chunk
// and output passes.  vec: x, Bm and Cm are 16-byte aligned with strides
// and N in 16-byte units (16-byte loads).
// P must be a multiple of 16, N a multiple of 4 up to 256.  Launches up to
// three kernels; returns the first CUDA error, 0 when all launched.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* A,
                              const void* Bm, const void* Cm, void* y,
                              void* h_final, void* states, void* decay,
                              void* hsplit,
                              int B, int S, int H, int P, int N,
                              long long sxb, long long sxs, long long sxh,
                              long long sdb, long long sds, long long sdh,
                              long long sbb, long long sbs, long long scb,
                              long long scs, int x_dtype, int dt_dtype,
                              int heads_per_cta, int vec, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P % 16 || N <= 0 || N % 4 ||
      N > kMaxN || B > 65535 || H > 65535 || heads_per_cta <= 0)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.dt = dt; a.A = (const float*)A; a.Bm = Bm; a.Cm = Cm; a.y = y;
  a.h_final = (float*)h_final;
  a.states = (float*)states;
  a.decay = (float*)decay;
  a.hsplit = (__nv_bfloat16*)hsplit;
  a.B = B; a.S = S; a.H = H; a.P = P; a.N = N;
  a.nc = (S + kQ - 1) / kQ;
  a.hg = heads_per_cta;
  a.sxb = sxb; a.sxs = sxs; a.sxh = sxh; a.sdb = sdb; a.sds = sds;
  a.sdh = sdh; a.sbb = sbb; a.sbs = sbs; a.scb = scb; a.scs = scs;
  a.vec = vec;
  if (((a.nc > 1 || h_final) && (!states || !decay)) ||
      (x_dtype == 1 && a.nc > 1 && !hsplit) || (x_dtype == 0 && hsplit))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_dtype == 0)
    return (int)(dt_dtype == 0 ? launch_f32<float>(a, s)
                               : launch_f32<__nv_bfloat16>(a, s));
  if (x_dtype != 1) return (int)cudaErrorInvalidValue;
  return (int)(dt_dtype == 0 ? launch_bf16<float>(a, s)
                             : launch_bf16<__nv_bfloat16>(a, s));
}
