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
//
// The backward (repro_ssd_scan_bwd) replaces no TPU kernel: the reference
// has none, and XLA differentiates its chunked math
// (src/repro/models/ssm.py:34).  It was added because, on the card, the
// training path differentiated the kernel's plain version instead, which
// took most of a mamba2 training step.  With dy the cotangent of y and
// D_c that of the state leaving chunk c (D_last = dh_final or 0), per
// (b, h) it runs the forward's passes (a) and (b) again for the states
// h_c entering each chunk (f32 over the chunk states; the forward saves
// only its inputs), then
//  (a') the chunk pass on dy and C (ssd_state_*<TD, true>): g_c = sum_i
//       exp(cs_i) dy_i C_i^T, the gradient reaching h_c from y;
//  (b') the reverse state pass, ssd_rpass_kernel: D_(c-1) = exp(cs_last,c)
//       D_c + g_c over the chunks from the last, in f32;
//  (c') the gradient pass (ssd_grad_bf16, ssd_grad_f32): one CTA per (b,
//       chunk, group of heads) stages C_c, B_c and C.B^T once; per head
//       du = (C.B^T o L)^T dy + exp(cs_last - cs_j) D_c B_j (dx = dt du),
//       T = L o (dy u^T), dC = T B + exp(cs_i) dy^T h_c, dB = T^T C +
//       exp(cs_last - cs_j) u^T D_c, and the decay's gradient dcs (row
//       sums of C.B^T o T minus its column sums, and the state terms)
//       reverse-summed into da: ddt = x . du + A da, dA's partial;
//  and ssd_bwd_finish sums the per-CTA partials of dB and dC (over head
//  groups) and of dA (over b and chunks) in a fixed order: no atomics,
//  so two calls give equal bits.
// bfloat16 (ssd_grad_bf16, 16 warps, 128 registers, 232,000 bytes of
// shared memory at N = 128: one CTA a SM): every product of (c') runs on
// the bf16 tensor cores as mma.sync m16n8k16 with ldmatrix fragments; C,
// B, x and dy enter as they come, and h_c, D_c, M = C.B^T o L and T enter
// as bf16 hi + lo in two products (the forward's rule; the chunk passes
// already take theirs so), whose rounding points
// kernels/ref.ref_ssd_bwd(..., round_bf16=True) emulates.  N below a
// multiple of 16 is zero-padded; P runs in blocks of 64.  C.B^T stays in
// registers across the heads, and so do dB and dC, written once a CTA; the
// next item's tiles (dy, x, f32 h_c and D_c, the next head's dt) are in
// flight by cp.async while one computes, and h_c and D_c are split into
// hi + lo once, in shared memory.  f32 (ssd_grad_f32, 8 warps): the same
// passes in exact f32 FMAs on the CUDA cores, as the f32 gates (1e-4)
// need.
// Bound at the training shape (x [8, 2048, 24, 64] bf16, N = 128): x, dt,
// B, C and dy read once and their gradients written once are 169.4 MB
// (0.0506 ms at 3.35 TB/s); the products over the causal token pairs of
// the 64-token chunks are ~42 GFLOP (0.043 ms at the bf16 tensor-core
// peak): bytes bound it.  The gradient pass alone moves ~0.58 GB (its
// f32 h_c and D_c the most), ~0.17 ms.  What holds it above that
// (tools/ssd_grad_parts.py switches its parts off one at a time): no
// single part; its products, loads, split and tails each cost a share,
// and with one CTA a SM (the f32 tiles of the next item and the bf16
// split fill shared memory) latency is hidden by 16 warps only.  8 warps
// a CTA (kCW = 2, 232 registers) were slower, and wgmma would shorten
// only the products' share.  The other passes stream the recomputed
// states and g/D, [B, nc, H, P, N] f32 each written and read (0.4 GB at
// the training shape); PERF.md has the times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>


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
// 4-byte async copy; zero-fills the destination when !ok (src unread)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
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

// One warp, from d = this lane's dt of tokens lane * E + e (0 past the
// chunk's end): cs[j] = the inclusive cumsum of dt * ah over the chunk of
// kQ = 32 E tokens; returns cs[kQ - 1] in every lane
template <int E>
__device__ __forceinline__ float cumsum_core(const float (&d)[E], float ah,
                                             float* cs) {
  const int lane = threadIdx.x & 31;
  float p[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
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
  for (int e = 0; e < E; ++e) cs[lane * E + e] = excl + p[e];
  return __shfl_sync(0xffffffffu, excl + p[E - 1], 31);
}

// One warp: dts[j] = dt of token c0 + j (0 past q) and cs[j] = the
// inclusive cumsum of dts * A_h over the chunk; returns cs[kQ - 1] in
// every lane.  Every pass runs this same arithmetic (cumsum_core), so they
// agree on cs to the bit.
template <typename TD>
__device__ __forceinline__ float chunk_cumsum(const Args& a, int b, int c0,
                                              int q, int h, float* dts,
                                              float* cs) {
  constexpr int E = kQ / 32;
  const int lane = threadIdx.x & 31;
  const TD* dtp = (const TD*)a.dt + b * a.sdb + h * a.sdh;
  float d[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int j = lane * E + e;
    d[e] = j < q ? to_f32(dtp[(long long)(c0 + j) * a.sds]) : 0.f;
    dts[j] = d[e];
  }
  return cumsum_core(d, a.A[h], cs);
}

// ============================ bfloat16 =====================================

__host__ __device__ constexpr int kpad(int N) { return (N + 15) / 16 * 16; }

// (a) chunk pass: one CTA of kQ/16 warps per (chunk, head group, b).
// kGrad: the backward's chunk pass (a') instead, on x = dy and B = C with
// weights exp(cs_j), for chunks 1.. (chunk c = blockIdx.x + 1 writes slot
// blockIdx.x of states and decay)
template <typename TD, bool kGrad>
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
  const int slot = blockIdx.x, c = slot + kGrad, b = blockIdx.z, c0 = c * Q;
  const int q = min(Q, a.S - c0);
  const int h0 = blockIdx.y * a.hg, h1 = min(h0 + a.hg, a.H);

  stage_rows(Bs, NP,
             (const __nv_bfloat16*)a.Bm + b * a.sbb + (long long)c0 * a.sbs,
             a.sbs, q, Q, a.N, NK, a.vec);

  for (int h = h0; h < h1; ++h) {
    float* st =
        a.states + (((long long)b * a.nc + slot) * a.H + h) * a.P * a.N;
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
        for (int j = lane; j < Q; j += 32)
          wts[j] = kGrad ? expf(cs[j]) : expf(cl - cs[j]) * dts[j];
        if (lane == 0)
          a.decay[((long long)b * a.nc + slot) * a.H + h] = expf(cl);
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
// group, b), P in steps of 16 rows; kGrad as ssd_state_bf16
template <typename TD, bool kGrad>
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
  const int slot = blockIdx.x, c = slot + kGrad, b = blockIdx.z, c0 = c * Q;
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
      for (int j = lane; j < Q; j += 32)
        wts[j] = kGrad ? expf(cs[j]) : expf(cl - cs[j]) * dts[j];
      if (lane == 0) a.decay[((long long)b * a.nc + slot) * a.H + h] = expf(cl);
    }
    __syncthreads();
    float* st = a.states + (((long long)b * a.nc + slot) * a.H + h) * a.P * N;
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

// ============================ backward =====================================

constexpr int kTB = 256;            // threads of the f32 gradient pass
constexpr int kMaxNB = 128;         // largest N the gradient pass takes
constexpr int kCW = 4;              // column groups of the bf16 pass's warps
constexpr int kGW = 4 * kCW;        // its warps: 4 tiles of 16 rows x kCW
constexpr int kTBG = 32 * kGW;      // its threads
static_assert(kQ * kQ / 16 == kTB, "one 4 x 4 tile of dy.x^T a thread");
static_assert(kPB == kQ && kQ / kCW >= 16 && kMaxNB / kCW >= 16,
              "the bf16 gradient pass's warp tiles");

struct Grad {
  const void* dy;                   // [B, S, H, P] through sdyb/sdys/sdyh
  const float* dh;                  // dh_final [B, H, P, N] contiguous, or null
  void* dx;                         // [B, S, H, P] contiguous, x's dtype
  void* ddt;                        // [B, S, H] contiguous, dt's dtype
  float* dA;                        // [H]
  void* dB;                         // [B, S, N] contiguous, x's dtype
  void* dC;
  float* gs;                        // [B, nc, H, P, N]: g_(c+1), then D_c
  float* gdecay;                    // [B, nc, H]: exp(cs_last) of chunk c + 1
  float* dBp;                       // [B, nc, groups, Q, N] per-CTA partials
  float* dCp;
  float* dAp;                       // [B, nc, H]
  long long sdyb, sdys, sdyh;
  int pt;                           // rows of P a tile of the f32 pass
};

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ void st_u32(__nv_bfloat16* p, uint32_t v) {
  *reinterpret_cast<uint32_t*>(p) = v;
}
__device__ __forceinline__ float2 ld_bf16x2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A matrix in shared memory: element (r, k) at p[r * rs + k * cs].
struct Op {
  const float* p;
  int rs, cs;
};

// The f32 gradient pass's products A.B over an [M, Nn] output (M, Nn
// multiples of 4), exact f32 FMAs on the CUDA cores: a thread holds a
// 4 x 4 tile, rows tm + i M/4 and columns tn + j Nn/4.
// acc += A.B over k < K for the thread's elements
__device__ __forceinline__ void fma_tile(float (&acc)[4][4], Op A, Op B,
                                         int tm, int tn, int Mt, int Nt,
                                         int K) {
  const float* ap = A.p + tm * A.rs;
  const float* bp = B.p + tn * B.cs;
  const int ar = Mt * A.rs, bc = Nt * B.cs;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ap[i * ar];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bp[j * bc];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    ap += A.cs;
    bp += B.rs;
  }
}

// The CTA's product A.B (first A1.B1 over K1, its rows scaled by
// scale(r), then + A2.B2 over K2 when K2 > 0): each thread hands its
// elements to epi(r, c, v), which returns the element's share of its row's
// partial; the thread's sum of a row goes to red[r * RW + tn] when red is
// not null (the same slot for the same thread in every product of one
// shape: no atomics, a fixed order)
template <typename S, typename F>
__device__ __forceinline__ void cta_mm(int M, int Nn, Op A1, Op B1, int K1,
                                       S&& scale, Op A2, Op B2, int K2,
                                       float* red, int RW, F&& epi) {
  const int Mt = M / 4, Nt = Nn / 4;
  for (int t = threadIdx.x; t < Mt * Nt; t += blockDim.x) {
    const int tm = t / Nt, tn = t - tm * Nt;
    float acc[4][4] = {};
    fma_tile(acc, A1, B1, tm, tn, Mt, Nt, K1);
    if (K2 > 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float sc = scale(tm + i * Mt);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= sc;
      }
      fma_tile(acc, A2, B2, tm, tn, Mt, Nt, K2);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tm + i * Mt;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s += epi(r, tn + j * Nt, acc[i][j]);
      if (red != nullptr) red[r * RW + tn] = s;
    }
  }
}

// one product, no second term
template <typename F>
__device__ __forceinline__ void cta_mm(int M, int Nn, int K, Op A, Op B,
                                       float* red, int RW, F&& epi) {
  cta_mm(M, Nn, A, B, K, [](int) { return 1.f; }, A, B, 0, red, RW, epi);
}

// (b') reverse state pass: one thread per 4 elements of (b, h)'s [P, N];
// D_(nc-1) = dh_final (or 0), D_(c-1) = exp(cs_last,c) D_c + g_c over the
// chunks from the last, loads four chunks ahead; D_c over slot c of gs,
// which held g_(c+1)
__global__ void __launch_bounds__(128) ssd_rpass_kernel(Args a, Grad g) {
  const long long PN = (long long)a.P * a.N;
  const long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= PN) return;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long cstride = (long long)a.H * PN;
  float* gp = g.gs + ((long long)b * a.nc * a.H + h) * PN + e;
  const float* dp = g.gdecay + (long long)b * a.nc * a.H + h;
  float4 D = make_float4(0.f, 0.f, 0.f, 0.f);
  if (g.dh != nullptr)
    D = *reinterpret_cast<const float4*>(g.dh + ((long long)b * a.H + h) * PN +
                                         e);
  *reinterpret_cast<float4*>(gp + (a.nc - 1) * cstride) = D;
  for (int c0 = a.nc - 2; c0 >= 0; c0 -= 4) {
    float4 s[4];
    float d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 - k >= 0) {
        s[k] = *reinterpret_cast<const float4*>(gp + (c0 - k) * cstride);
        d[k] = dp[(long long)(c0 - k) * a.H];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int c = c0 - k;
      if (c < 0) break;
      D = make_float4(fmaf(d[k], D.x, s[k].x), fmaf(d[k], D.y, s[k].y),
                      fmaf(d[k], D.z, s[k].z), fmaf(d[k], D.w, s[k].w));
      *reinterpret_cast<float4*>(gp + c * cstride) = D;
    }
  }
}

// (c') gradient pass, float32: one CTA of kTB threads per (chunk, head
// group, b), exact f32 FMAs on the CUDA cores.  C_c, B_c and C.B^T are
// staged once for the heads; per head, P in tiles of pt rows (dy, x, h_c,
// D_c), then the chunk's [Q, Q] terms.  dx and ddt are written directly;
// dB and dC summed over the group's heads into the CTA's own partials,
// dA's per (b, chunk, head) into dAp (no atomics: ssd_bwd_finish sums them
// in a fixed order).  Pitches are odd, so that the rows and columns a
// thread's neighbours read fall in distinct banks.
template <typename TD>
__global__ void __launch_bounds__(kTB, 1) ssd_grad_f32(Args a, Grad g) {
  using T = float;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int Q = kQ, QS = Q + 1;
  const int N = a.N, P = a.P, PT = g.pt, NS = N + 1, PS = PT + 1;
  const int RW = N / 4 > 16 ? N / 4 : 16, UR = PT / 4;
  const int nslots = N / 4, uslots = PT / 4;
  float* Cs = (float*)smem_raw;                           // [Q][NS]
  float* Bs = Cs + Q * NS;                                // [Q][NS]
  float* G = Bs + Q * NS;                                 // [Q][QS] C.B^T
  float* M = G + Q * QS;                                  // [Q][QS] G o L; T
  float* Y = M + Q * QS;                                  // [Q][PS] dy
  float* X = Y + Q * PS;                                  // [Q][PS] x
  float* Ht = X + Q * PS;                                 // [PT][NS] h_c
  float* Dt = Ht + PT * NS;                               // [PT][NS] D_c
  float* redu = Dt + PT * NS;                             // [Q][UR]
  float* redb = redu + Q * UR;                            // [Q][RW]
  float* redc = redb + Q * RW;                            // [Q][RW]
  float* dts = redc + Q * RW;                             // [Q]
  float* cs = dts + Q;                                    // [Q]
  float* ein = cs + Q;                                    // [Q] exp(cs_i)
  float* eout = ein + Q;                                  // [Q] exp(cl-cs_j)
  float* xdu = eout + Q;                                  // [Q] x_j . du_j
  float* dyw = xdu + Q;                                   // [Q] dy_i . w_i
  float* uv = dyw + Q;                                    // [Q] u_j . v_j
  float* dcs = uv + Q;                                    // [Q] dcs, then da
  float* dhp = dcs + Q;                                   // [PT + 1]
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z, c0 = c * Q;
  const int q = min(Q, a.S - c0);
  const int h0 = grp * a.hg, h1 = min(h0 + a.hg, a.H);
  const bool has_h = c > 0;                 // h_0 = 0
  const long long PN = (long long)P * N;
  const long long part =
      (((long long)b * a.nc + c) * gridDim.y + grp) * Q * N;
  float* dCp = g.dCp + part;
  float* dBp = g.dBp + part;

  const T* cp = (const T*)a.Cm + b * a.scb + (long long)c0 * a.scs;
  const T* bp = (const T*)a.Bm + b * a.sbb + (long long)c0 * a.sbs;
  for (int o = threadIdx.x; o < Q * N; o += kTB) {
    const int j = o / N, n = o - j * N;
    dCp[o] = 0.f;
    dBp[o] = 0.f;
    Cs[j * NS + n] = j < q ? cp[j * a.scs + n] : 0.f;
    Bs[j * NS + n] = j < q ? bp[j * a.sbs + n] : 0.f;
  }
  __syncthreads();
  cta_mm(Q, Q, N, Op{Cs, NS, 1}, Op{Bs, 1, NS}, nullptr, 0,
         [&](int r, int k, float v) {
           G[r * QS + k] = v;
           return 0.f;
         });
  // this thread's 4 x 4 tile (tm, tn) of S = dy.x^T
  const int s0 = threadIdx.x >> 4, s1 = threadIdx.x & 15;

  for (int h = h0; h < h1; ++h) {
    __syncthreads();                // G is complete; the last head is done
    if (threadIdx.x < 32) {
      chunk_cumsum<TD>(a, b, c0, q, h, dts, cs);
    } else if (threadIdx.x < 32 + Q) {
      const int i = threadIdx.x - 32;
      xdu[i] = dyw[i] = uv[i] = 0.f;
    } else if (threadIdx.x == 32 + Q) {
      dhp[PT] = 0.f;
    }
    __syncthreads();
    const float cl = cs[Q - 1];
    for (int i = threadIdx.x; i < Q; i += kTB) {
      ein[i] = expf(cs[i]);
      eout[i] = expf(cl - cs[i]);
    }
    for (int o = threadIdx.x; o < Q * Q; o += kTB) {
      const int i = o / Q, j = o - i * Q;
      M[i * QS + j] = j <= i ? G[i * QS + j] * expf(cs[i] - cs[j]) : 0.f;
    }
    float S[4][4] = {};             // S_ij = dy_i . x_j over the P tiles
    const T* xb = (const T*)a.x + b * a.sxb + (long long)c0 * a.sxs +
                  h * a.sxh;
    const T* yb = (const T*)g.dy + b * g.sdyb + (long long)c0 * g.sdys +
                  h * g.sdyh;
    const float* hb =
        has_h ? a.states + (((long long)b * a.nc + c - 1) * a.H + h) * PN
              : nullptr;
    const float* db = g.gs + (((long long)b * a.nc + c) * a.H + h) * PN;
    T* dxb = (T*)g.dx + (((long long)b * a.S + c0) * a.H + h) * P;
    const long long dxs = (long long)a.H * P;

    for (int p0 = 0; p0 < P; p0 += PT) {
      __syncthreads();              // M, ein, eout are built; the last
                                    // tile is done
      for (int o = threadIdx.x; o < Q * PT; o += kTB) {
        const int j = o / PT, p = o - j * PT;
        const bool ok = j < q;
        Y[j * PS + p] = ok ? yb[j * g.sdys + p0 + p] : 0.f;
        X[j * PS + p] = ok ? xb[j * a.sxs + p0 + p] : 0.f;
      }
      for (int o = threadIdx.x; o < PT * N; o += kTB) {
        const int p = o / N, n = o - p * N;
        Ht[p * NS + n] = has_h ? hb[(long long)(p0 + p) * N + n] : 0.f;
        Dt[p * NS + n] = db[(long long)(p0 + p) * N + n];
      }
      __syncthreads();
      fma_tile(S, Op{Y, PS, 1}, Op{X, 1, PS}, s0, s1, 16, 16, PT);
      // du_j = exp(cs_last - cs_j) B_j.D^T + sum_i M_ij dy_i; dx = dt du;
      // the x_j . du_j partials
      cta_mm(Q, PT, Op{Bs, NS, 1}, Op{Dt, 1, NS}, N,
             [&](int j) { return eout[j]; }, Op{M, 1, QS}, Op{Y, PS, 1}, Q,
             redu, UR, [&](int j, int p, float v) {
               if (j < q) store(dxb + j * dxs + p0 + p, dts[j] * v);
               return X[j * PS + p] * v;
             });
      // Z'_j = x_j^T D_c: dB_j += exp(cs_last - cs_j) dt_j Z'_j, and the
      // B_j . Z'_j partials (u_j . v_j = dt_j B_j . Z'_j)
      cta_mm(Q, N, PT, Op{X, PS, 1}, Op{Dt, NS, 1}, redb, RW,
             [&](int j, int n, float v) {
               dBp[j * N + n] += eout[j] * dts[j] * v;
               return Bs[j * NS + n] * v;
             });
      if (has_h) {
        // Z_i = dy_i^T h_c: dC_i += exp(cs_i) Z_i, and the C_i . Z_i
        // partials (dy_i . w_i = C_i . Z_i); <D_c, h_c> by rows of P
        cta_mm(Q, N, PT, Op{Y, PS, 1}, Op{Ht, NS, 1}, redc, RW,
               [&](int i, int n, float v) {
                 dCp[i * N + n] += ein[i] * v;
                 return Cs[i * NS + n] * v;
               });
        for (int p = threadIdx.x; p < PT; p += kTB) {
          float s = 0.f;
          for (int n = 0; n < N; ++n)
            s = fmaf(Dt[p * NS + n], Ht[p * NS + n], s);
          dhp[p] = s;
        }
      }
      __syncthreads();
      if (threadIdx.x < Q) {
        const int j = threadIdx.x;
        float s = 0.f;
        for (int k = 0; k < uslots; ++k) s += redu[j * UR + k];
        xdu[j] += s;
        s = 0.f;
        for (int k = 0; k < nslots; ++k) s += redb[j * RW + k];
        uv[j] += dts[j] * s;
        if (has_h) {
          s = 0.f;
          for (int k = 0; k < nslots; ++k) s += redc[j * RW + k];
          dyw[j] += s;
        }
      } else if (has_h && threadIdx.x == Q) {
        float s = 0.f;
        for (int p = 0; p < PT; ++p) s += dhp[p];
        dhp[PT] += s;
      }
    }
    __syncthreads();                // the vectors are complete, M is free
    // T = L o (dy.u^T) over M, R = G o T: R's row partials into redc and
    // column partials into redb
    {
      float rr[4] = {0.f, 0.f, 0.f, 0.f}, rc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = s0 + i * 16;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = s1 + k * 16;
          const float t =
              j <= r ? expf(cs[r] - cs[j]) * dts[j] * S[i][k] : 0.f;
          M[r * QS + j] = t;
          const float v = G[r * QS + j] * t;
          rr[i] += v;
          rc[k] += v;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        redc[(s0 + i * 16) * RW + s1] = rr[i];
        redb[(s1 + i * 16) * RW + s0] = rc[i];
      }
    }
    __syncthreads();
    if (threadIdx.x < Q) {          // dcs_i
      const int i = threadIdx.x;
      float r = 0.f;
      for (int k = 0; k < Q / 4; ++k) r += redc[i * RW + k];
      for (int k = 0; k < Q / 4; ++k) r -= redb[i * RW + k];
      dcs[i] = r + ein[i] * dyw[i] - eout[i] * uv[i];
    }
    // the intra-chunk terms: dC_i += sum_j T_ij B_j, dB_j += sum_i T_ij C_i
    cta_mm(Q, N, Q, Op{M, QS, 1}, Op{Bs, NS, 1}, nullptr, 0,
           [&](int i, int n, float v) {
             dCp[i * N + n] += v;
             return 0.f;
           });
    cta_mm(Q, N, Q, Op{M, 1, QS}, Op{Cs, NS, 1}, nullptr, 0,
           [&](int j, int n, float v) {
             dBp[j * N + n] += v;
             return 0.f;
           });
    __syncthreads();
    if (threadIdx.x == 0) {
      // the last token's terms, da_k = sum_(i >= k) dcs_i, dA's partial
      float run = expf(cl) * dhp[PT];
      for (int j = 0; j < Q; ++j) run = fmaf(eout[j], uv[j], run);
      float da = 0.f;
      for (int k = Q - 1; k >= 0; --k) {
        run += dcs[k];
        dcs[k] = run;
        da = fmaf(dts[k], run, da);
      }
      g.dAp[((long long)b * a.nc + c) * a.H + h] = da;
    }
    __syncthreads();
    if (threadIdx.x < q) {
      const int k = threadIdx.x;
      store((TD*)g.ddt + ((long long)b * a.S + c0 + k) * a.H + h,
            xdu[k] + a.A[h] * dcs[k]);
    }
  }
}

size_t smem_grad_f32(int N, int PT) {
  const int NS = N + 1, QS = kQ + 1, PS = PT + 1;
  const int RW = N / 4 > 16 ? N / 4 : 16;
  return sizeof(float) * ((size_t)2 * kQ * NS + 2 * kQ * QS + 2 * kQ * PS +
                          2 * PT * NS + kQ * (PT / 4) + 2 * kQ * RW + 8 * kQ +
                          PT + 1);
}

// (c') gradient pass, bfloat16: one CTA of kGW = 16 warps per (chunk,
// head group, b), every product mma.sync m16n8k16 bf16 x bf16 -> f32 with
// fragments loaded by ldmatrix (the transposed operands by
// ldmatrix.trans).  C_c, B_c, dy and x enter as they come; h_c, D_c, M = G
// o L and T enter as bf16 hi + lo in two products (the forward's rule).
// Warp w owns rows 16 (w % 4) of the chunk and, by w / 4, a quarter of
// the columns: of the [Q, Q] tiles (G = C.B^T, kept in registers for all
// the heads, S = dy.x^T; tiles wholly above the diagonal skipped), of
// du's [Q, 64] and of dB's and dC's [Q, N], whose sums over the CTA's
// heads stay in registers and are written once, as 16-byte stores, into
// the CTA's partials.  A CTA works through items (head, block of 64 rows
// of P): while one item computes, the next one's dy and x (strided) and
// f32 h_c and D_c, and the next head's dt, are in flight by cp.async; at
// an item's start its h_c and D_c are split into bf16 hi + lo in shared
// memory, once.  Row sums are shuffles within quads (columns: across the
// eight row groups) into per-warp slots; <D_c, h_c> a warp reduction;
// da's reverse sum over the chunk a warp scan, on the last warp while the
// first scans the next head's dt; all in a fixed order, so two calls give
// equal bits.
template <typename TD>
__global__ void __launch_bounds__(kTBG, 1) ssd_grad_bf16(Args a, Grad g) {
  using T = __nv_bfloat16;
  static_assert(std::is_same<TD, float>::value, "the backward's dt is f32");
  constexpr int Q = kQ, XP = kXP, KT = Q / 16;
  // a warp's columns: of the [Q, Q] tiles, of du's block and of dB and dC
  constexpr int QW = Q / kCW, PW = kPB / kCW, NW = kMaxNB / kCW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = a.N, P = a.P, NK = kpad(N), NP = NK + 8;
  T* Cs = (T*)smem_raw;                                   // [Q][NP]
  T* Bs = Cs + Q * NP;                                    // [Q][NP]
  T* Hh = Bs + Q * NP;                // [kPB][NP] h_c hi, lo; D_c hi, lo
  T* Hl = Hh + kPB * NP;
  T* Dh = Hl + kPB * NP;
  T* Dl = Dh + kPB * NP;
  T* Mh = Dl + kPB * NP;              // [Q][XP] M = G o L, then T: hi, lo
  T* Ml = Mh + Q * XP;
  T* Ys = Ml + Q * XP;                // [2][Q][XP] dy by item parity
  T* Xs = Ys + 2 * Q * XP;            // [2][Q][XP] x
  float* Rh = (float*)(Xs + 2 * Q * XP);  // [kPB][NK] the next item's h_c
  float* Rd = Rh + kPB * NK;                                   // D_c
  float* dtr = Rd + kPB * NK;         // [2][Q] dt of the next head (parity)
  float* vec = dtr + 2 * Q;           // [2][2][Q] dt, cs by head parity
  float* rowR = vec + 4 * Q;          // [kCW][Q] R = G o T, by columns
  float* colR = rowR + kCW * Q;       // [4][Q] by row tile
  float* dywp = colR + 4 * Q;         // [kCW][Q] C_i . Z_i, by columns
  float* uvp = dywp + kCW * Q;        // [kCW][Q] B_j . Z'_j
  float* xdup = uvp + kCW * Q;        // [kCW][Q] x_j . du_j
  float* dhp = xdup + kCW * Q;        // [kGW] <D_c, h_c> by warp
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g4 = lane >> 2, t4 = lane & 3, mat = lane >> 3, r8 = lane & 7;
  const int m = warp & 3, hq = warp >> 2, i0 = 16 * m;
  const int c = blockIdx.x, grp = blockIdx.y, b = blockIdx.z, c0 = c * Q;
  const int q = min(Q, a.S - c0);
  const int h0 = grp * a.hg, h1 = min(h0 + a.hg, a.H);
  const bool has_h = c > 0;                 // h_0 = 0
  const long long PN = (long long)P * N;
  const int nb = (P + kPB - 1) / kPB, items = (h1 - h0) * nb;

  const T* xg = (const T*)a.x + b * a.sxb + (long long)c0 * a.sxs;
  const T* yg = (const T*)g.dy + b * g.sdyb + (long long)c0 * g.sdys;
  const float* hsrc =
      has_h ? a.states + ((long long)b * a.nc + c - 1) * a.H * PN : nullptr;
  const float* dsrc = g.gs + ((long long)b * a.nc + c) * a.H * PN;
  // dt of head h (0 past q) into dtr[(h - h0) % 2]
  auto stage_dt = [&](int h) {
    const float* dp = (const float*)a.dt + b * a.sdb + h * a.sdh +
                      (long long)c0 * a.sds;
    const int j = threadIdx.x;
    if (j < Q)
      cp_async4(dtr + ((h - h0) & 1) * Q + j, j < q ? dp + j * a.sds : dp,
                j < q);
  };
  // item k: head h0 + k / nb, rows (k % nb) * kPB of P: its dy and x (into
  // the buffers of parity k), then its f32 h_c and D_c (and, with a head's
  // first item, dt of the next head), a cp.async group each
  auto stage_dyx = [&](int k) {
    const int h = h0 + k / nb, p0 = (k % nb) * kPB, pw = min(kPB, P - p0);
    stage_rows(Ys + (k & 1) * Q * XP, XP, yg + h * g.sdyh + p0, g.sdys, q, Q,
               pw, pw, a.vec);
    stage_rows(Xs + (k & 1) * Q * XP, XP, xg + h * a.sxh + p0, a.sxs, q, Q,
               pw, pw, a.vec);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  auto stage_raw = [&](int k) {
    const int h = h0 + k / nb, p0 = (k % nb) * kPB, pw = min(kPB, P - p0);
    const long long o = h * PN + (long long)p0 * N;
    if (has_h) stage_rows(Rh, NK, hsrc + o, N, pw, pw, N, NK, true);
    stage_rows(Rd, NK, dsrc + o, N, pw, pw, N, NK, true);
    if (k % nb == 0 && h + 1 < h1) stage_dt(h + 1);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  stage_rows(Cs, NP, (const T*)a.Cm + b * a.scb + (long long)c0 * a.scs,
             a.scs, q, Q, N, NK, a.vec);
  stage_rows(Bs, NP, (const T*)a.Bm + b * a.sbb + (long long)c0 * a.sbs,
             a.sbs, q, Q, N, NK, a.vec);
  stage_dt(h0);
  asm volatile("cp.async.commit_group;\n" ::);
  stage_dyx(0);
  stage_raw(0);
  asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  __syncthreads();                    // C, B and the first dt have landed

  // G = C.B^T on this warp's tiles, in registers for all the heads
  float G[QW / 8][4];
#pragma unroll
  for (int t = 0; t < QW / 8; ++t) G[t][0] = G[t][1] = G[t][2] = G[t][3] = 0.f;
  for (int k0 = 0; k0 < NK; k0 += 16) {
    uint32_t af[4];
    ldsm_x4(af, Cs + (i0 + (lane & 15)) * NP + k0 + (lane >> 4) * 8);
#pragma unroll
    for (int tp = 0; tp < QW / 16; ++tp) {
      if (QW * hq + 16 * tp <= i0) {  // columns at or left of the diagonal
        uint32_t bf[4];               // B[n][j] = Bs[j][n]: as stored
        ldsm_x4(bf, Bs + (QW * hq + 16 * tp + r8 + (mat >> 1) * 8) * NP +
                        k0 + (mat & 1) * 8);
        mma16816(G[2 * tp], af, bf[0], bf[1]);
        mma16816(G[2 * tp + 1], af, bf[2], bf[3]);
      }
    }
  }
  float dBa[NW / 8][4], dCa[NW / 8][4];  // dB, dC: rows i0, columns NW hq
#pragma unroll
  for (int t = 0; t < NW / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dBa[t][e] = dCa[t][e] = 0.f;
  const int ilo = i0 + g4, ihi = ilo + 8;    // this thread's two rows

  // Z = A.S^T over a block of P (A = x and S = D_c, or A = dy and S =
  // h_c, as hi + lo) on this warp's [16, NW] of [Q, N]: acc_r += w(r) Z_r,
  // and the V_r . Z_r partials (V = B or C) into red's slot hq
  auto zterm = [&](const T* A, const T* Sh, const T* Sl, const T* V,
                   float* red, float (&acc)[NW / 8][4], int pw, int blk,
                   auto w) {
    float z[NW / 8][4];
#pragma unroll
    for (int t = 0; t < NW / 8; ++t)
      z[t][0] = z[t][1] = z[t][2] = z[t][3] = 0.f;
    for (int kt = 0; kt < pw / 16; ++kt) {
      uint32_t af[4];
      ldsm_x4(af, A + (i0 + (lane & 15)) * XP + kt * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NW / 16; ++np) {
        const int n = NW * hq + 16 * np;
        if (n < NK) {
          uint32_t bh[4], bl[4];      // B[p][n] = S[p][n]: transposed
          const int o = (kt * 16 + r8 + (mat & 1) * 8) * NP + n +
                        (mat >> 1) * 8;
          ldsm_x4_t(bh, Sh + o);
          ldsm_x4_t(bl, Sl + o);
          mma16816(z[2 * np], af, bh[0], bh[1]);
          mma16816(z[2 * np + 1], af, bh[2], bh[3]);
          mma16816(z[2 * np], af, bl[0], bl[1]);
          mma16816(z[2 * np + 1], af, bl[2], bl[3]);
        }
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int j = hr ? ihi : ilo;
      const float wj = w(j);
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < NW / 8; ++t) {
        const int n = NW * hq + 8 * t + 2 * t4;
        if (n < NK) {
          const float z0 = z[t][2 * hr], z1 = z[t][2 * hr + 1];
          const float2 vv = ld_bf16x2(V + j * NP + n);
          s += vv.x * z0 + vv.y * z1;
          acc[t][2 * hr] += wj * z0;
          acc[t][2 * hr + 1] += wj * z1;
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (t4 == 0) red[hq * Q + j] = (blk ? red[hq * Q + j] : 0.f) + s;
    }
  };

  int k = 0;                          // the item
  for (int h = h0; h < h1; ++h) {
    float* dts = vec + ((h - h0) & 1) * 2 * Q;            // [Q]
    float* cs = dts + Q;                                  // [Q]
    if (warp == 0) {                  // beside the last head's tails
      const float* dp = dtr + ((h - h0) & 1) * Q;
      const float d[2] = {dp[2 * lane], dp[2 * lane + 1]};
      dts[2 * lane] = d[0];
      dts[2 * lane + 1] = d[1];
      cumsum_core(d, a.A[h], cs);
    }
    __syncthreads();                  // cs; the last head's T is read
    const float csl = cs[ilo], csh = cs[ihi], cl = cs[Q - 1];
    // exp(cs_i) and exp(cs_last - cs_j), where they are needed
    auto ein = [&](int i) { return expf(cs[i]); };
    auto eout = [&](int j) { return expf(cl - cs[j]); };
    // M = G o L (L_ij = exp(cs_i - cs_j), j <= i) as hi + lo
#pragma unroll
    for (int t = 0; t < QW / 8; ++t) {
      const int j = QW * hq + 8 * t + 2 * t4;
      const float v0 = j <= ilo ? G[t][0] * expf(csl - cs[j]) : 0.f;
      const float v1 = j + 1 <= ilo ? G[t][1] * expf(csl - cs[j + 1]) : 0.f;
      const float v2 = j <= ihi ? G[t][2] * expf(csh - cs[j]) : 0.f;
      const float v3 = j + 1 <= ihi ? G[t][3] * expf(csh - cs[j + 1]) : 0.f;
      uint32_t hi, lo;
      split_bf16(v0, v1, hi, lo);
      st_u32(Mh + ilo * XP + j, hi);
      st_u32(Ml + ilo * XP + j, lo);
      split_bf16(v2, v3, hi, lo);
      st_u32(Mh + ihi * XP + j, hi);
      st_u32(Ml + ihi * XP + j, lo);
    }
    float S[QW / 8][4];               // S = dy.x^T over the blocks of P
#pragma unroll
    for (int t = 0; t < QW / 8; ++t) S[t][0] = S[t][1] = S[t][2] = S[t][3] = 0.f;

    for (int blk = 0; blk < nb; ++blk, ++k) {
      const int p0 = blk * kPB, pw = min(kPB, P - p0);
      const T* Yc = Ys + (k & 1) * Q * XP;
      const T* Xc = Xs + (k & 1) * Q * XP;
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
      __syncthreads();                // the item's tiles have landed; M is
                                      // written; the last item is done
      if (k + 1 < items) stage_dyx(k + 1);  // in flight from here on
      {                               // h_c, D_c -> hi + lo; <D_c, h_c>
        float part = 0.f;
        const int n4 = NK / 4;
#pragma unroll 4
        for (int o = threadIdx.x; o < pw * n4; o += kTBG) {
          const int p = o / n4, n = (o - p * n4) * 4;
          const float4 d = *reinterpret_cast<const float4*>(Rd + p * NK + n);
          uint32_t hi0, hi1, lo0, lo1;
          split_bf16(d.x, d.y, hi0, lo0);
          split_bf16(d.z, d.w, hi1, lo1);
          *reinterpret_cast<uint2*>(Dh + p * NP + n) = make_uint2(hi0, hi1);
          *reinterpret_cast<uint2*>(Dl + p * NP + n) = make_uint2(lo0, lo1);
          if (has_h) {
            const float4 v =
                *reinterpret_cast<const float4*>(Rh + p * NK + n);
            split_bf16(v.x, v.y, hi0, lo0);
            split_bf16(v.z, v.w, hi1, lo1);
            *reinterpret_cast<uint2*>(Hh + p * NP + n) = make_uint2(hi0, hi1);
            *reinterpret_cast<uint2*>(Hl + p * NP + n) = make_uint2(lo0, lo1);
            part = fmaf(d.x, v.x, part);
            part = fmaf(d.y, v.y, part);
            part = fmaf(d.z, v.z, part);
            part = fmaf(d.w, v.w, part);
          }
        }
        part = warp_sum(part);
        if (lane == 0) dhp[warp] = (blk ? dhp[warp] : 0.f) + part;
      }
      __syncthreads();                // the split tiles are complete
      if (k + 1 < items) stage_raw(k + 1);  // in flight while this computes

      // S += dy.x^T
      for (int kt = 0; kt < pw / 16; ++kt) {
        uint32_t af[4];
        ldsm_x4(af, Yc + (i0 + (lane & 15)) * XP + kt * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int tp = 0; tp < QW / 16; ++tp) {
          if (QW * hq + 16 * tp <= i0) {
            uint32_t bf[4];           // B[p][j] = x[j][p]: as stored
            ldsm_x4(bf, Xc + (QW * hq + 16 * tp + r8 + (mat >> 1) * 8) * XP +
                            kt * 16 + (mat & 1) * 8);
            mma16816(S[2 * tp], af, bf[0], bf[1]);
            mma16816(S[2 * tp + 1], af, bf[2], bf[3]);
          }
        }
      }

      // du_j = exp(cs_last - cs_j) B_j.D_c^T + sum_(i >= j) M_ij dy_i on
      // columns PW hq of the block; dx = dt du and the x_j . du_j partials
      {
        float du[PW / 8][4];
#pragma unroll
        for (int t = 0; t < PW / 8; ++t)
          du[t][0] = du[t][1] = du[t][2] = du[t][3] = 0.f;
        for (int k0 = 0; k0 < NK; k0 += 16) {
          uint32_t af[4];
          ldsm_x4(af, Bs + (i0 + (lane & 15)) * NP + k0 + (lane >> 4) * 8);
#pragma unroll
          for (int tp = 0; tp < PW / 16; ++tp) {
            const int pc = PW * hq + 16 * tp;
            if (pc < pw) {
              uint32_t bh[4], bl[4];  // B[n][p] = D[p][n]: as stored
              const int o = (pc + r8 + (mat >> 1) * 8) * NP + k0 +
                            (mat & 1) * 8;
              ldsm_x4(bh, Dh + o);
              ldsm_x4(bl, Dl + o);
              mma16816(du[2 * tp], af, bh[0], bh[1]);
              mma16816(du[2 * tp + 1], af, bh[2], bh[3]);
              mma16816(du[2 * tp], af, bl[0], bl[1]);
              mma16816(du[2 * tp + 1], af, bl[2], bl[3]);
            }
          }
        }
        const float el = eout(ilo), eh = eout(ihi);
#pragma unroll
        for (int t = 0; t < PW / 8; ++t) {
          du[t][0] *= el; du[t][1] *= el;
          du[t][2] *= eh; du[t][3] *= eh;
        }
        for (int kt = m; kt < KT; ++kt) {
          uint32_t ah[4], al[4];      // A[j][i] = M[i][j]: transposed
          const int o = (kt * 16 + r8 + (mat >> 1) * 8) * XP + i0 +
                        (mat & 1) * 8;
          ldsm_x4_t(ah, Mh + o);
          ldsm_x4_t(al, Ml + o);
#pragma unroll
          for (int tp = 0; tp < PW / 16; ++tp) {
            const int pc = PW * hq + 16 * tp;
            if (pc < pw) {
              uint32_t bf[4];         // B[i][p] = dy[i][p]: transposed
              ldsm_x4_t(bf, Yc + (kt * 16 + r8 + (mat & 1) * 8) * XP + pc +
                                (mat >> 1) * 8);
              mma16816(du[2 * tp], ah, bf[0], bf[1]);
              mma16816(du[2 * tp + 1], ah, bf[2], bf[3]);
              mma16816(du[2 * tp], al, bf[0], bf[1]);
              mma16816(du[2 * tp + 1], al, bf[2], bf[3]);
            }
          }
        }
        T* dxb = (T*)g.dx + (((long long)b * a.S + c0) * a.H + h) * P + p0;
        const long long dxs = (long long)a.H * P;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int j = hr ? ihi : ilo;
          const float dj = dts[j];
          float s = 0.f;
#pragma unroll
          for (int t = 0; t < PW / 8; ++t) {
            const int p = PW * hq + 8 * t + 2 * t4;
            if (p < pw) {
              const float v0 = du[t][2 * hr], v1 = du[t][2 * hr + 1];
              if (j < q) st_u32(dxb + j * dxs + p, pack_bf16(dj * v0, dj * v1));
              const float2 xv = ld_bf16x2(Xc + j * XP + p);
              s += xv.x * v0 + xv.y * v1;
            }
          }
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          if (t4 == 0) xdup[hq * Q + j] = (blk ? xdup[hq * Q + j] : 0.f) + s;
        }
      }

      // Z'_j = x_j^T D_c: dB_j += exp(cs_last - cs_j) dt_j Z'_j and the
      // B_j . Z'_j partials; Z_i = dy_i^T h_c: dC_i += exp(cs_i) Z_i and the
      // C_i . Z_i partials
      zterm(Xc, Dh, Dl, Bs, uvp, dBa, pw, blk,
            [&](int j) { return eout(j) * dts[j]; });
      if (has_h)
        zterm(Yc, Hh, Hl, Cs, dywp, dCa, pw, blk,
              [&](int j) { return ein(j); });
    }
    __syncthreads();                  // M is read; the partials are written

    // T = L o (dy.u^T) (T_ij = L_ij dt_j S_ij) over M as hi + lo; R = G o T
    // (f32): row partials by column group, column partials by row tile
    {
      float R[QW / 8][4];
#pragma unroll
      for (int t = 0; t < QW / 8; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? ilo : ihi;
          const int j = QW * hq + 8 * t + 2 * t4 + (e & 1);
          const float v =
              j <= i ? expf(cs[i] - cs[j]) * dts[j] * S[t][e] : 0.f;
          S[t][e] = v;
          R[t][e] = G[t][e] * v;
        }
        const int j = QW * hq + 8 * t + 2 * t4;
        uint32_t hi, lo;
        split_bf16(S[t][0], S[t][1], hi, lo);
        st_u32(Mh + ilo * XP + j, hi);
        st_u32(Ml + ilo * XP + j, lo);
        split_bf16(S[t][2], S[t][3], hi, lo);
        st_u32(Mh + ihi * XP + j, hi);
        st_u32(Ml + ihi * XP + j, lo);
      }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < QW / 8; ++t) s += R[t][2 * hr] + R[t][2 * hr + 1];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (t4 == 0) rowR[hq * Q + (hr ? ihi : ilo)] = s;
      }
#pragma unroll
      for (int t = 0; t < QW / 8; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float s = R[t][e] + R[t][e + 2];
          s += __shfl_xor_sync(0xffffffffu, s, 4);
          s += __shfl_xor_sync(0xffffffffu, s, 8);
          s += __shfl_xor_sync(0xffffffffu, s, 16);
          if (g4 == 0) colR[m * Q + QW * hq + 8 * t + 2 * t4 + e] = s;
        }
    }
    __syncthreads();                  // T is complete

    // the intra-chunk terms: dC_i += sum_(j <= i) T_ij B_j, dB_j +=
    // sum_(i >= j) T_ij C_i
    for (int kt = 0; kt <= m; ++kt) {
      uint32_t ah[4], al[4];          // A[i][j] = T[i][j]: as stored
      const int o = (i0 + (lane & 15)) * XP + kt * 16 + (lane >> 4) * 8;
      ldsm_x4(ah, Mh + o);
      ldsm_x4(al, Ml + o);
#pragma unroll
      for (int np = 0; np < NW / 16; ++np) {
        const int n = NW * hq + 16 * np;
        if (n < NK) {
          uint32_t bf[4];             // B[j][n] = Bs[j][n]: transposed
          ldsm_x4_t(bf, Bs + (kt * 16 + r8 + (mat & 1) * 8) * NP + n +
                            (mat >> 1) * 8);
          mma16816(dCa[2 * np], ah, bf[0], bf[1]);
          mma16816(dCa[2 * np + 1], ah, bf[2], bf[3]);
          mma16816(dCa[2 * np], al, bf[0], bf[1]);
          mma16816(dCa[2 * np + 1], al, bf[2], bf[3]);
        }
      }
    }
    for (int kt = m; kt < KT; ++kt) {
      uint32_t ah[4], al[4];          // A[j][i] = T[i][j]: transposed
      const int o = (kt * 16 + r8 + (mat >> 1) * 8) * XP + i0 + (mat & 1) * 8;
      ldsm_x4_t(ah, Mh + o);
      ldsm_x4_t(al, Ml + o);
#pragma unroll
      for (int np = 0; np < NW / 16; ++np) {
        const int n = NW * hq + 16 * np;
        if (n < NK) {
          uint32_t bf[4];             // B[i][n] = Cs[i][n]: transposed
          ldsm_x4_t(bf, Cs + (kt * 16 + r8 + (mat & 1) * 8) * NP + n +
                            (mat >> 1) * 8);
          mma16816(dBa[2 * np], ah, bf[0], bf[1]);
          mma16816(dBa[2 * np + 1], ah, bf[2], bf[3]);
          mma16816(dBa[2 * np], al, bf[0], bf[1]);
          mma16816(dBa[2 * np + 1], al, bf[2], bf[3]);
        }
      }
    }

    if (warp == kGW - 1) {
      // dcs_k = rowsum R - colsum R + exp(cs_k) dy_k . w_k - exp(cs_last -
      // cs_k) u_k . v_k; da_k = the last token's terms + sum_(i >= k) dcs_i
      // (a warp scan, two tokens a lane); ddt = x . du + A da; dA's partial
      float dc[2], euv = 0.f;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int j = 2 * lane + u;
        float su = 0.f, sr = 0.f, sw = 0.f;
#pragma unroll
        for (int w = 0; w < kCW; ++w) {
          su += uvp[w * Q + j];
          sr += rowR[w * Q + j];
          sw += dywp[w * Q + j];
        }
        const float uv = dts[j] * su;
        float v = sr -
                  (((colR[j] + colR[Q + j]) + colR[2 * Q + j]) +
                   colR[3 * Q + j]) -
                  eout(j) * uv;
        if (has_h) v += ein(j) * sw;
        dc[u] = v;
        euv = fmaf(eout(j), uv, euv);
      }
      euv = warp_sum(euv);
      float dh = 0.f;
      if (has_h)
        for (int w = 0; w < kGW; ++w) dh += dhp[w];
      const float run = expf(cl) * dh + euv;
      float suf = dc[0] + dc[1];      // sum over this lane's tokens and on
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_down_sync(0xffffffffu, suf, o);
        if (lane + o < 32) suf += t;
      }
      float after = __shfl_down_sync(0xffffffffu, suf, 1);
      if (lane == 31) after = 0.f;
      const float da1 = run + (after + dc[1]);
      const float da0 = run + ((after + dc[1]) + dc[0]);
      const int j = 2 * lane;
      const float dap = warp_sum(fmaf(dts[j], da0, dts[j + 1] * da1));
      if (lane == 0) g.dAp[((long long)b * a.nc + c) * a.H + h] = dap;
      const float Ah = a.A[h];
      float x0 = 0.f, x1 = 0.f;
#pragma unroll
      for (int w = 0; w < kCW; ++w) {
        x0 += xdup[w * Q + j];
        x1 += xdup[w * Q + j + 1];
      }
      TD* dd = (TD*)g.ddt + ((long long)b * a.S + c0) * a.H + h;
      if (j < q) store(dd + (long long)j * a.H, x0 + Ah * da0);
      if (j + 1 < q) store(dd + (long long)(j + 1) * a.H, x1 + Ah * da1);
    }
  }

  // dB and dC: the registers through shared memory (over the split tiles,
  // unread since the last head's products) into the CTA's partials by
  // 16-byte stores, once
  __syncthreads();
  const int SP = NK + 4;
  float* Sb = (float*)Hh;                                 // [Q][SP]
  float* Sc = Sb + Q * SP;                                // [Q][SP]
#pragma unroll
  for (int t = 0; t < NW / 8; ++t) {
    const int n = NW * hq + 8 * t + 2 * t4;
    if (n < NK) {
      *reinterpret_cast<float2*>(Sb + ilo * SP + n) = make_float2(dBa[t][0], dBa[t][1]);
      *reinterpret_cast<float2*>(Sb + ihi * SP + n) = make_float2(dBa[t][2], dBa[t][3]);
      *reinterpret_cast<float2*>(Sc + ilo * SP + n) = make_float2(dCa[t][0], dCa[t][1]);
      *reinterpret_cast<float2*>(Sc + ihi * SP + n) = make_float2(dCa[t][2], dCa[t][3]);
    }
  }
  __syncthreads();
  const long long part =
      (((long long)b * a.nc + c) * gridDim.y + grp) * Q * N;
  const int n4 = N / 4;
  for (int o = threadIdx.x; o < Q * n4; o += kTBG) {
    const int j = o / n4, n = (o - j * n4) * 4;
    *reinterpret_cast<float4*>(g.dBp + part + j * N + n) =
        *reinterpret_cast<const float4*>(Sb + j * SP + n);
    *reinterpret_cast<float4*>(g.dCp + part + j * N + n) =
        *reinterpret_cast<const float4*>(Sc + j * SP + n);
  }
}

size_t smem_grad_bf16(int N) {
  const int NP = kpad(N) + 8;
  return sizeof(__nv_bfloat16) * ((size_t)2 * kQ * NP + 4 * kPB * NP +
                                  6 * kQ * kXP) +
         sizeof(float) * ((size_t)2 * kPB * kpad(N) + (10 + 4 * kCW) * kQ +
                          kGW);
}

// dB, dC: the groups' partials summed in order and cast (one CTA per
// token); dA: the (b, chunk) partials summed in order (one CTA per head)
template <typename T>
__global__ void __launch_bounds__(128) ssd_bwd_finish(Args a, Grad g) {
  const long long rows = (long long)a.B * a.S, row = blockIdx.x;
  if (row >= rows) {
    if (threadIdx.x == 0) {
      const int h = (int)(row - rows);
      float s = 0.f;
      for (long long k = 0; k < (long long)a.B * a.nc; ++k)
        s += g.dAp[k * a.H + h];
      g.dA[h] = s;
    }
    return;
  }
  const int groups = (a.H + a.hg - 1) / a.hg;
  const int b = (int)(row / a.S), t = (int)(row - (long long)b * a.S);
  const int c = t / kQ, j = t - c * kQ;
  const long long base = (((long long)b * a.nc + c) * groups * kQ + j) * a.N;
  const long long gstride = (long long)kQ * a.N;
  for (int n = threadIdx.x; n < a.N; n += blockDim.x) {
    float sb = 0.f, sc = 0.f;
    for (int gi = 0; gi < groups; ++gi) {
      sb += g.dBp[base + gi * gstride + n];
      sc += g.dCp[base + gi * gstride + n];
    }
    store((T*)g.dB + row * a.N + n, sb);
    store((T*)g.dC + row * a.N + n, sc);
  }
}

// ============================ launch =======================================

template <typename K, typename... Ts>
cudaError_t run(K kern, dim3 grid, int threads, size_t smem, cudaStream_t st,
                const Ts&... args) {
  // dynamic shared memory above 48 KB is granted per kernel and per
  // device: asked before every launch, on the current device (a cheap
  // host call)
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <typename TD>
cudaError_t launch_bf16(Args& a, cudaStream_t st) {
  const int groups = (a.H + a.hg - 1) / a.hg;
  const int steps = a.h_final ? a.nc : a.nc - 1;    // chunk states needed
  cudaError_t e;
  if (steps > 0) {
    e = run(ssd_state_bf16<TD, false>, dim3(steps, groups, a.B), kT,
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
    e = run(ssd_state_f32<TD, false>, dim3(steps, groups, a.B), kT,
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


// The chunk pass of x's dtype T: the forward's (a), or with kGrad the
// backward's (a')
template <typename T, typename TD, bool kGrad>
cudaError_t run_state(const Args& a, int steps, cudaStream_t st) {
  const dim3 grid(steps, (a.H + a.hg - 1) / a.hg, a.B);
  if constexpr (std::is_same<T, float>::value)
    return run(ssd_state_f32<TD, kGrad>, grid, kT, smem_state_f32(a.N), st,
               a);
  else
    return run(ssd_state_bf16<TD, kGrad>, grid, kT, smem_state_bf16(a.N),
               st, a);
}

// The backward (dt f32): the forward's chunk and state passes recomputed
// (h_c as f32 over the chunk states), then (a') on dy and C into gs, (b')
// over gs, (c') and the last sums
template <typename T>
cudaError_t launch_bwd(const Args& a, const Grad& g, cudaStream_t st) {
  using TD = float;
  const int groups = (a.H + a.hg - 1) / a.hg;
  const int steps = a.nc - 1;
  const long long n4 = (long long)a.P * a.N / 4;
  const dim3 pgrid((unsigned)((n4 + 127) / 128), a.H, a.B);
  cudaError_t e;
  if (steps > 0) {
    if ((e = run_state<T, TD, false>(a, steps, st)) != cudaSuccess) return e;
    ssd_pass_kernel<<<pgrid, 128, 0, st>>>(a, steps);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    Args ga = a;                    // (a'): x = dy, B = C, into gs
    ga.x = g.dy;
    ga.sxb = g.sdyb; ga.sxs = g.sdys; ga.sxh = g.sdyh;
    ga.Bm = a.Cm;
    ga.sbb = a.scb; ga.sbs = a.scs;
    ga.states = g.gs;
    ga.decay = g.gdecay;
    if ((e = run_state<T, TD, true>(ga, steps, st)) != cudaSuccess) return e;
  }
  ssd_rpass_kernel<<<pgrid, 128, 0, st>>>(a, g);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const dim3 grid(a.nc, groups, a.B);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    e = run(ssd_grad_bf16<TD>, grid, kTBG, smem_grad_bf16(a.N), st, a, g);
  else
    e = run(ssd_grad_f32<TD>, grid, kTB, smem_grad_f32(a.N, g.pt), st, a, g);
  if (e != cudaSuccess) return e;
  ssd_bwd_finish<T><<<(unsigned)((long long)a.B * a.S + a.H), 128, 0, st>>>(
      a, g);
  return cudaGetLastError();
}

// rows of P a tile of the f32 gradient pass
int grad_pt(int P) { return P % 64 == 0 ? 64 : P % 32 == 0 ? 32 : 16; }

// out = {dynamic shared memory a CTA, CTAs a SM, registers a thread,
// threads a CTA, local (spilled) bytes a thread} of kern on the current
// device
template <typename K>
cudaError_t occupancy(K kern, int threads, size_t smem, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  if ((e = cudaFuncGetAttributes(&fa, kern)) != cudaSuccess) return e;
  out[0] = (int)smem;
  out[1] = ctas;
  out[2] = fa.numRegs;
  out[3] = threads;
  out[4] = (int)fa.localSizeBytes;
  return cudaSuccess;
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


// C entry point of the backward (bound with ctypes): the gradients of
// repro_ssd_scan's y (and h_final) for the cotangents dy [B, S, H, P]
// (x's dtype, read through sdyb/sdys/sdyh, last axis contiguous) and
// dh_final [B, H, P, N] f32 contiguous (or null).  x, A, Bm, Cm, the
// strides, x_dtype, heads_per_cta and vec (which covers dy as well) as
// for repro_ssd_scan; dt is float32 (the wrapper converts a bfloat16 dt:
// exact, and ddt comes back through the same rounding).  Writes dx
// [B, S, H, P] and dB, dC [B, S, N] contiguous in x's dtype, ddt
// [B, S, H] contiguous f32, dA [H] f32.  Scratch, all f32 (the wrapper's one allocation, 16-byte
// aligned): states and decay [B, nc, H, P, N] and [B, nc, H] (null when
// nc == 1), gs [B, nc, H, P, N], gdecay [B, nc, H], dBp and dCp [B, nc,
// groups, 64, N], dAp [B, nc, H].  P a multiple of 16, N a multiple of 4
// up to 128.  Launches up to six kernels; returns the first CUDA error, 0
// when all launched.
extern "C" int repro_ssd_scan_bwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, const void* dy, const void* dh_final, void* dx,
    void* ddt, void* dA, void* dB, void* dC, void* states, void* decay,
    void* gs, void* gdecay, void* dBp, void* dCp, void* dAp, int B, int S,
    int H, int P, int N, long long sxb, long long sxs, long long sxh,
    long long sdb, long long sds, long long sdh, long long sbb, long long sbs,
    long long scb, long long scs, long long sdyb, long long sdys,
    long long sdyh, int x_dtype, int heads_per_cta, int vec, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P % 16 || N <= 0 || N % 4 ||
      N > kMaxNB || B > 65535 || H > 65535 || heads_per_cta <= 0 ||
      (x_dtype != 0 && x_dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x; a.dt = dt; a.A = (const float*)A; a.Bm = Bm; a.Cm = Cm;
  a.y = nullptr;
  a.h_final = nullptr;
  a.states = (float*)states;
  a.decay = (float*)decay;
  a.hsplit = nullptr;               // the recomputed states stay f32
  a.B = B; a.S = S; a.H = H; a.P = P; a.N = N;
  a.nc = (S + kQ - 1) / kQ;
  a.hg = heads_per_cta;
  a.sxb = sxb; a.sxs = sxs; a.sxh = sxh; a.sdb = sdb; a.sds = sds;
  a.sdh = sdh; a.sbb = sbb; a.sbs = sbs; a.scb = scb; a.scs = scs;
  a.vec = vec;
  Grad g;
  g.dy = dy; g.dh = (const float*)dh_final; g.dx = dx; g.ddt = ddt;
  g.dA = (float*)dA; g.dB = dB; g.dC = dC;
  g.gs = (float*)gs; g.gdecay = (float*)gdecay;
  g.dBp = (float*)dBp; g.dCp = (float*)dCp; g.dAp = (float*)dAp;
  g.sdyb = sdyb; g.sdys = sdys; g.sdyh = sdyh;
  g.pt = grad_pt(P);
  if ((a.nc > 1 && (!states || !decay || !gdecay)) || !gs || !dBp || !dCp ||
      !dAp)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(x_dtype == 0 ? launch_bwd<float>(a, g, s)
                             : launch_bwd<__nv_bfloat16>(a, g, s));
}


// C entry point (bound with ctypes): what the gradient pass of
// repro_ssd_scan_bwd asks of the current device at N and P for x_dtype
// (0 = float32, 1 = bfloat16), into out[5]: dynamic shared memory a CTA
// (bytes), CTAs a SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// registers a thread, threads a CTA and local (spilled) bytes a thread.
// Returns the first CUDA error, 0 on success.
extern "C" int repro_ssd_grad_occupancy(int N, int P, int x_dtype,
                                        int* out) {
  if (N <= 0 || N % 4 || N > kMaxNB || P <= 0 || P % 16 || !out)
    return (int)cudaErrorInvalidValue;
  if (x_dtype == 1)
    return (int)occupancy(ssd_grad_bf16<float>, kTBG, smem_grad_bf16(N),
                          out);
  if (x_dtype == 0)
    return (int)occupancy(ssd_grad_f32<float>, kTB,
                          smem_grad_f32(N, grad_pt(P)), out);
  return (int)cudaErrorInvalidValue;
}
