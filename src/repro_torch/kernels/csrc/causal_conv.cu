// Causal depthwise convolution with its SiLU, forward and gradient, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference computes the Mamba-2 block's conv
// with an einsum over K stacked shifted windows
// (src/repro/models/ssm.py), which XLA fuses on the TPU.  On the card the
// same einsum became a [B, S, dc, K] stack (K copies of the input) and
// batched gemvs, and its gradient a batched product (magma's sgemmEx).
// These kernels compute exactly ref_causal_conv / ref_causal_conv_bwd
// (kernels/ref.py) with one rounding:
//
//   ci = cat(window, x) along S      (window [B, K-1, dc], zeros if absent)
//   pre[s] = sum_k ci[s + k] * w[:, k] + b        (f32)
//   y[s]   = silu(pre[s])                          (rounded once to T)
//
// and for dy: g = dy * silu'(pre), dci[r] = sum_k g[r - k] * w[:, k],
// dx = dci[K-1:], dwindow = dci[:K-1], dw[:, k] = sum_s g[s] * ci[s + k],
// db = sum_s g[s].  T is float32 or bfloat16 for x, w, b, window, dy and
// every output; every sum is in f32.
//
// Bound.  A few operations per element (K FMAs, an exp, a divide), so
// bytes bound both: the forward reads x and writes y, the gradient reads x
// and dy and writes dx.  At mamba2-130m's training shape ([16, 2048, 1792]
// bf16, a strided view of the in-projection's output) that is 117.4 MB a
// tensor: 70.1 us forward, 105.2 us gradient at 3.35 TB/s.
//
// Design.  A stencil along S with channels contiguous, bound by how many
// bytes are in flight.  A CTA of 256 threads takes a tile of 512 bytes of
// channels (256 bf16, 128 f32) by 64 rows: it first copies the tile's
// rows with the K-1 rows before them (the halo) into shared memory with
// cp.async (16 bytes a thread, the whole tile in flight at once, no
// registers held), then each thread computes 4 channels over a run of the
// tile's rows from shared memory, with its taps and bias and the last K-1
// input rows in registers, summing in f32 and writing y once.  A first
// form staged the rows in registers (8 channels by 16 rows a thread,
// loads issued 4 rows ahead): 0.16 ms forward and 0.36 ms gradient at the
// training shape, 2.3x and 3.4x the bound, and no choice of its tile
// shape moved it much (chip_smoke.py, phase conv).  Views that are not
// 16-byte aligned (a ragged width) get the scalar instantiation (kVec
// false): the same tiles, filled by element loads.  The gradient CTA
// walks 4 tiles of 64 rows: it stages x with K-1 rows before and after
// the tile and dy with K-1 rows after it, computes g = dy * silu'(pre) of
// its run and the K-1 rows after it (to form dx of its last rows), writes
// dx (and, on the first rows, dwindow), and sums g * ci and g over its
// own rows in registers; the CTA adds its threads' sums through shared
// memory into one partial per (row range, channel), and
// causal_conv_bwd_sum adds the partials in a fixed order: no atomics, so
// two calls agree to the bit.  The training shape runs 3584 forward CTAs
// and 896 gradient CTAs; granite's B = 1 prefill at dc 8448, 6720 rows,
// 3498 and 891.  There: 0.0932 ms forward, 1.33x the bound, and 0.1834
// ms gradient, 1.74x (the partials' sum included); 70 and 104 registers,
// no spills (chip_smoke.py, phase conv; NVIDIA H100 80GB HBM3, 700 W).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // a CTA
constexpr int kPacks = 32;      // 16-byte packs a tile row (512 bytes)
constexpr int kRows = 64;       // rows a tile
constexpr int kBwdTiles = 4;    // tiles a gradient CTA walks (one partial)
constexpr int kVecC = 4;        // channels a computing thread
constexpr int kFwdCtas = 3;     // CTAs a SM the registers must leave room for
constexpr int kBwdCtas = 2;

// channels a 16-byte pack and a tile
template <typename T>
__host__ __device__ constexpr int pack_n() { return 16 / sizeof(T); }
template <typename T>
__host__ __device__ constexpr int tile_c() { return kPacks * pack_n<T>(); }

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);           // round to nearest even
}

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };

// the card's fast exp (ex2.approx) and reciprocal: a few ulp, against
// IEEE expf and division's tens of instructions an element; exp(-x)
// overflowing to inf gives sigmoid 0 and silu -0
__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.f, 1.f + __expf(-x));
}
__device__ __forceinline__ float silu(float x) {
  return __fdividef(x, 1.f + __expf(-x));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// rows [0, rows) of a tile [rows][tile_c] in shared memory: row j from
// row(j) (the tile's first channel c0 of a source row; null: zeros),
// channels past dc zeros; the copies land by cp_async_wait
template <typename T, bool kVec, typename Row>
__device__ __forceinline__ void load_tile(T* tile, int rows, int c0, int dc,
                                          Row row) {
  constexpr int TC = tile_c<T>(), PN = pack_n<T>();
  if constexpr (kVec) {
    for (int i = threadIdx.x; i < rows * kPacks; i += kThreads) {
      const int j = i / kPacks, p = i % kPacks;
      T* dst = tile + j * TC + p * PN;
      const T* src = row(j);
      if (src != nullptr && c0 + p * PN < dc)
        cp_async16(dst, src + p * PN);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * TC; i += kThreads) {
      const int j = i / TC, c = i % TC;
      const T* src = row(j);
      tile[j * TC + c] =
          (src != nullptr && c0 + c < dc) ? src[c] : from_f32<T>(0.f);
    }
  }
}

// kVecC channels of a tile row in shared memory as f32
template <typename T>
__device__ __forceinline__ void read_c(const T* p, float (&o)[kVecC]) {
  using R = typename Raw<kVecC * sizeof(T)>::type;
  const R raw = *reinterpret_cast<const R*>(p);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVecC; ++i) o[i] = to_f32(e[i]);
}

// kVecC channels of one output row; past the last channel (nv < kVecC)
// nothing
template <typename T, bool kVec>
__device__ __forceinline__ void store_c(T* __restrict__ p, int nv,
                                        const float (&v)[kVecC]) {
  if constexpr (kVec) {
    if (nv == kVecC) {
      using R = typename Raw<kVecC * sizeof(T)>::type;
      R raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < kVecC; ++i) e[i] = from_f32<T>(v[i]);
      *reinterpret_cast<R*>(p) = raw;
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < kVecC; ++i)
    if (i < nv) p[i] = from_f32<T>(v[i]);
}

template <typename T, int K>
__device__ __forceinline__ void load_taps(const T* __restrict__ w,
                                          const T* __restrict__ bias, int c,
                                          int nv, float (&tap)[K][kVecC],
                                          float (&bv)[kVecC]) {
#pragma unroll
  for (int v = 0; v < kVecC; ++v) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      tap[k][v] = v < nv ? to_f32(w[(long long)(c + v) * K + k]) : 0.f;
    bv[v] = (bias != nullptr && v < nv) ? to_f32(bias[c + v]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward: y = silu(conv + b)
// ---------------------------------------------------------------------------

template <typename T, int K, bool kVec>
__global__ void __launch_bounds__(kThreads, kFwdCtas)
causal_conv_fwd(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, const T* __restrict__ win,
                T* __restrict__ y, int S, int dc, long long sxb,
                long long sxs, long long swb, long long sws) {
  constexpr int TC = tile_c<T>(), H = K - 1;
  constexpr int kLanes = TC / kVecC, R = kRows / (kThreads / kLanes);
  __shared__ __align__(16) T tile[(kRows + H) * TC];
  const int c0 = blockIdx.x * TC, s_base = blockIdx.y * kRows;
  const long long b = blockIdx.z;
  const T* xb = x + b * sxb + c0;
  const T* wb = win != nullptr ? win + b * swb + c0 : nullptr;
  // tile row j is ci row s_base + j: the window's (zeros without one)
  // before row K-1, x's after, zeros past S
  load_tile<T, kVec>(tile, kRows + H, c0, dc, [&](int j) -> const T* {
    const int r = s_base + j, t = r - H;
    if (t >= S) return nullptr;
    if (t >= 0) return xb + t * sxs;
    return wb != nullptr ? wb + r * sws : nullptr;
  });
  cp_async_wait();
  __syncthreads();
  const int lane = threadIdx.x % kLanes, r0 = threadIdx.x / kLanes * R;
  const int c = c0 + lane * kVecC, nv = min(kVecC, dc - c);
  if (nv <= 0) return;
  float tap[K][kVecC], bv[kVecC];
  load_taps<T, K>(w, bias, c, nv, tap, bv);
  const T* col = tile + lane * kVecC;
  float ring[K][kVecC];         // ci rows i .. i+K-2 (the first K-1 used)
#pragma unroll
  for (int j = 0; j < H; ++j) read_c(col + (r0 + j) * TC, ring[j]);
  T* yb = y + b * S * dc + c;
  const int n = min(R, S - s_base - r0);
#pragma unroll 4
  for (int i = 0; i < n; ++i) {
    float cur[kVecC], o[kVecC];
    read_c(col + (r0 + i + H) * TC, cur);
#pragma unroll
    for (int v = 0; v < kVecC; ++v) {
      float acc = bv[v];
#pragma unroll
      for (int k = 0; k < H; ++k) acc = fmaf(ring[k][v], tap[k][v], acc);
      o[v] = silu(fmaf(cur[v], tap[H][v], acc));
    }
    store_c<T, kVec>(yb + (long long)(s_base + r0 + i) * dc, nv, o);
    if constexpr (K > 1) {
#pragma unroll
      for (int k = 0; k + 1 < H; ++k)
#pragma unroll
        for (int v = 0; v < kVecC; ++v) ring[k][v] = ring[k + 1][v];
#pragma unroll
      for (int v = 0; v < kVecC; ++v) ring[H - 1][v] = cur[v];
    }
  }
}

// ---------------------------------------------------------------------------
// gradient: dx (and dwindow), and one partial of dw, db per CTA
// ---------------------------------------------------------------------------

template <typename T, int K>
__host__ __device__ constexpr size_t bwd_smem() {
  return (size_t)(2 * kRows + 3 * (K - 1)) * tile_c<T>() * sizeof(T);
}

template <typename T, int K, bool kVec>
__global__ void __launch_bounds__(kThreads, kBwdCtas)
causal_conv_bwd(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, const T* __restrict__ win,
                const T* __restrict__ dy, T* __restrict__ dx,
                T* __restrict__ dwin, float* __restrict__ part, int S, int dc,
                long long sxb, long long sxs, long long swb, long long sws,
                long long sdb, long long sds) {
  constexpr int TC = tile_c<T>(), H = K - 1;
  constexpr int kLanes = TC / kVecC, kGroups = kThreads / kLanes;
  constexpr int R = kRows / kGroups;
  constexpr int XR = kRows + 2 * H;             // ci rows of a tile
  constexpr int NP = kVecC * (K + 1);           // a thread's sums
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* ds = xs + XR * TC;                         // dy rows of a tile
  const int c0 = blockIdx.x * TC;
  const long long b = blockIdx.z;
  const int lane = threadIdx.x % kLanes, grp = threadIdx.x / kLanes;
  const int c = c0 + lane * kVecC, nv = min(kVecC, dc - c), r0 = grp * R;
  float tap[K][kVecC], bv[kVecC];
  load_taps<T, K>(w, bias, c, nv, tap, bv);
  float acc[K + 1][kVecC];
#pragma unroll
  for (int k = 0; k <= K; ++k)
#pragma unroll
    for (int v = 0; v < kVecC; ++v) acc[k][v] = 0.f;
  const T* xb = x + b * sxb + c0;
  const T* wb = win != nullptr ? win + b * swb + c0 : nullptr;
  const T* yb = dy + b * sdb + c0;
  T* dxb = dx + b * S * dc + c;
  T* dwb = dwin != nullptr ? dwin + b * H * dc + c : nullptr;
  const T* xcol = xs + lane * kVecC;
  const T* dcol = ds + lane * kVecC;

  for (int tile = 0; tile < kBwdTiles; ++tile) {
    const int s_base = (blockIdx.y * kBwdTiles + tile) * kRows;
    if (s_base >= S) break;
    __syncthreads();            // the previous tile's reads are done
    // xs row j is ci row s_base + j; ds row j is dy row s_base + j
    load_tile<T, kVec>(xs, XR, c0, dc, [&](int j) -> const T* {
      const int r = s_base + j, t = r - H;
      if (t >= S) return nullptr;
      if (t >= 0) return xb + t * sxs;
      return wb != nullptr ? wb + r * sws : nullptr;
    });
    load_tile<T, kVec>(ds, kRows + H, c0, dc, [&](int j) -> const T* {
      const int t = s_base + j;
      return t < S ? yb + t * sds : nullptr;
    });
    cp_async_wait();
    __syncthreads();
    if (nv <= 0) continue;
    float ring[K][kVecC];       // ci rows i .. i+K-2
#pragma unroll
    for (int j = 0; j < H; ++j) read_c(xcol + (r0 + j) * TC, ring[j]);
    float gr[K][kVecC];         // g rows i-K+1 .. i (gr[K-1] newest)
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int v = 0; v < kVecC; ++v) gr[k][v] = 0.f;
    const int own = min(R, S - s_base - r0);     // rows summed here
    const int last = min(R + H, S + H - s_base - r0);
    for (int i = 0; i < last; ++i) {
      float cur[kVecC], d[kVecC], g[kVecC];
      read_c(xcol + (r0 + i + H) * TC, cur);
      read_c(dcol + (r0 + i) * TC, d);           // zeros past S: g = 0
#pragma unroll
      for (int v = 0; v < kVecC; ++v) {
        float p = bv[v];
#pragma unroll
        for (int k = 0; k < H; ++k) p = fmaf(ring[k][v], tap[k][v], p);
        p = fmaf(cur[v], tap[H][v], p);
        const float sg = sigmoid(p);
        g[v] = d[v] * (sg * (1.f + p * (1.f - sg)));
      }
      if (i < own) {
#pragma unroll
        for (int v = 0; v < kVecC; ++v) {
#pragma unroll
          for (int k = 0; k < H; ++k)
            acc[k][v] = fmaf(g[v], ring[k][v], acc[k][v]);
          acc[H][v] = fmaf(g[v], cur[v], acc[H][v]);
          acc[K][v] += g[v];
        }
      }
#pragma unroll
      for (int k = 0; k + 1 < K; ++k)
#pragma unroll
        for (int v = 0; v < kVecC; ++v) gr[k][v] = gr[k + 1][v];
#pragma unroll
      for (int v = 0; v < kVecC; ++v) gr[H][v] = g[v];
      // dci[r] = sum_k g[r - k] * w[:, k] at r = s_base + r0 + i: complete
      // once the thread holds g from r - K + 1 on (its own rows, or row 0)
      float o[kVecC];
#pragma unroll
      for (int v = 0; v < kVecC; ++v) {
        float t = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) t = fmaf(gr[H - k][v], tap[k][v], t);
        o[v] = t;
      }
      const int r = s_base + r0 + i;
      if (i >= H)
        store_c<T, kVec>(dxb + (long long)(r - H) * dc, nv, o);
      else if (r == i && dwb != nullptr)
        store_c<T, kVec>(dwb + (long long)r * dc, nv, o);
      if constexpr (K > 1) {
#pragma unroll
        for (int k = 0; k + 1 < H; ++k)
#pragma unroll
          for (int v = 0; v < kVecC; ++v) ring[k][v] = ring[k + 1][v];
#pragma unroll
        for (int v = 0; v < kVecC; ++v) ring[H - 1][v] = cur[v];
      }
    }
  }

  // the CTA's row groups summed in order into one partial a channel
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [kGroups][kLanes * NP]
  float* mine = red + (grp * kLanes + lane) * NP;
#pragma unroll
  for (int v = 0; v < kVecC; ++v)
#pragma unroll
    for (int k = 0; k <= K; ++k) mine[v * (K + 1) + k] = acc[k][v];
  __syncthreads();
  const int n = min(TC, dc - c0) * (K + 1);
  float* out = part + (b * gridDim.y + blockIdx.y) * (long long)dc * (K + 1) +
               (long long)c0 * (K + 1);
  for (int o = threadIdx.x; o < n; o += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kGroups; ++q) t += red[q * kLanes * NP + o];
    out[o] = t;
  }
}

// dw [dc, K] and db [dc] from the partials [P, dc * (K+1)], each summed over
// P in a fixed order (thread y takes partials y, y + 8, ...; then y 0..7)
template <typename T>
__global__ void __launch_bounds__(kThreads)
causal_conv_bwd_sum(const float* __restrict__ part, int P, int dc, int K,
                    T* __restrict__ dw, T* __restrict__ db) {
  __shared__ float red[8][32];
  const int n = dc * (K + 1);
  const int o = blockIdx.x * 32 + threadIdx.x;
  float t = 0.f;
  if (o < n)
    for (int p = threadIdx.y; p < P; p += 8) t += part[(long long)p * n + o];
  red[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && o < n) {
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) sum += red[r][threadIdx.x];
    const int c = o / (K + 1), k = o - c * (K + 1);
    if (k < K)
      dw[(long long)c * K + k] = from_f32<T>(sum);
    else if (db != nullptr)
      db[c] = from_f32<T>(sum);
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <typename T, int K, bool kVec>
cudaError_t fwd_launch(const void* x, const void* w, const void* b,
                       const void* win, void* y, int B, int S, int dc,
                       long long sxb, long long sxs, long long swb,
                       long long sws, cudaStream_t st) {
  const dim3 grid(ceil_div(dc, tile_c<T>()), ceil_div(S, kRows), B);
  causal_conv_fwd<T, K, kVec><<<grid, kThreads, 0, st>>>(
      (const T*)x, (const T*)w, (const T*)b, (const T*)win, (T*)y, S, dc, sxb,
      sxs, swb, sws);
  return cudaGetLastError();
}

template <typename T, int K, bool kVec>
cudaError_t bwd_launch(const void* x, const void* w, const void* b,
                       const void* win, const void* dy, void* dx, void* dwin,
                       void* part, void* dw, void* db, int B, int S, int dc,
                       long long sxb, long long sxs, long long swb,
                       long long sws, long long sdb, long long sds,
                       cudaStream_t st) {
  constexpr size_t smem = bwd_smem<T, K>();
  static bool sized = false;    // once an instantiation, before any capture
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        causal_conv_bwd<T, K, kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const dim3 grid(ceil_div(dc, tile_c<T>()), ceil_div(S, kRows * kBwdTiles),
                  B);
  causal_conv_bwd<T, K, kVec><<<grid, kThreads, smem, st>>>(
      (const T*)x, (const T*)w, (const T*)b, (const T*)win, (const T*)dy,
      (T*)dx, (T*)dwin, (float*)part, S, dc, sxb, sxs, swb, sws, sdb, sds);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int P = B * (int)grid.y;
  causal_conv_bwd_sum<T><<<ceil_div(dc * (K + 1), 32), dim3(32, 8), 0, st>>>(
      (const float*)part, P, dc, K, (T*)dw, (T*)db);
  return cudaGetLastError();
}

#define REPRO_CONV_K(LAUNCH, T, VEC, ...)                   \
  switch (K) {                                              \
    case 1: return LAUNCH<T, 1, VEC>(__VA_ARGS__);          \
    case 2: return LAUNCH<T, 2, VEC>(__VA_ARGS__);          \
    case 3: return LAUNCH<T, 3, VEC>(__VA_ARGS__);          \
    case 4: return LAUNCH<T, 4, VEC>(__VA_ARGS__);          \
    default: return cudaErrorInvalidValue;                  \
  }

template <typename T, bool kVec>
cudaError_t fwd_k(int K, const void* x, const void* w, const void* b,
                  const void* win, void* y, int B, int S, int dc,
                  long long sxb, long long sxs, long long swb, long long sws,
                  cudaStream_t st) {
  REPRO_CONV_K(fwd_launch, T, kVec, x, w, b, win, y, B, S, dc, sxb, sxs, swb,
               sws, st)
}

template <typename T, bool kVec>
cudaError_t bwd_k(int K, const void* x, const void* w, const void* b,
                  const void* win, const void* dy, void* dx, void* dwin,
                  void* part, void* dw, void* db, int B, int S, int dc,
                  long long sxb, long long sxs, long long swb, long long sws,
                  long long sdb, long long sds, cudaStream_t st) {
  REPRO_CONV_K(bwd_launch, T, kVec, x, w, b, win, dy, dx, dwin, part, dw, db,
               B, S, dc, sxb, sxs, swb, sws, sdb, sds, st)
}

#undef REPRO_CONV_K

}  // namespace

// y [B, S, dc] (contiguous) = silu(conv(cat(win, x)) + b).  x [B, S, dc]
// and win [B, K-1, dc] (or null: zeros) with unit channel stride and the
// given batch / row strides in elements; w [dc, K], b [dc] (or null)
// contiguous; all of dtype (0 f32, 1 bf16).  vec: every pointer and row
// stride 16-byte aligned and dc a multiple of the 16-byte width.
extern "C" int repro_causal_conv(const void* x, const void* w, const void* b,
                                 const void* win, void* y, int B, int S,
                                 int dc, int K, long long sxb, long long sxs,
                                 long long swb, long long sws, int dtype,
                                 int vec, void* stream) {
  if (B <= 0 || S <= 0 || dc <= 0 || B > 65535 ||
      ceil_div(S, kRows) > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_FWD_ARGS K, x, w, b, win, y, B, S, dc, sxb, sxs, swb, sws, st
  if (dtype == 0)
    return (int)(vec ? fwd_k<float, true>(REPRO_FWD_ARGS)
                     : fwd_k<float, false>(REPRO_FWD_ARGS));
  if (dtype == 1)
    return (int)(vec ? fwd_k<__nv_bfloat16, true>(REPRO_FWD_ARGS)
                     : fwd_k<__nv_bfloat16, false>(REPRO_FWD_ARGS));
#undef REPRO_FWD_ARGS
  return (int)cudaErrorInvalidValue;
}

// The gradient of repro_causal_conv for dy [B, S, dc] (unit channel
// stride, strides sdb / sds): dx [B, S, dc] and dwin [B, K-1, dc] (null:
// not wanted) contiguous; dw [dc, K] and db [dc] (null without a bias)
// through part, f32 scratch of parts x dc x (K+1), parts = B x
// ceil(S / 256) (a gradient CTA's rows).
extern "C" int repro_causal_conv_bwd(
    const void* x, const void* w, const void* b, const void* win,
    const void* dy, void* dx, void* dwin, void* part, void* dw, void* db,
    int B, int S, int dc, int K, long long sxb, long long sxs, long long swb,
    long long sws, long long sdb, long long sds, int parts, int dtype,
    int vec, void* stream) {
  if (B <= 0 || S <= 0 || dc <= 0 || B > 65535 ||
      ceil_div(S, kRows * kBwdTiles) > 65535 ||
      parts != B * ceil_div(S, kRows * kBwdTiles))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define REPRO_BWD_ARGS K, x, w, b, win, dy, dx, dwin, part, dw, db, B, S, dc, \
                       sxb, sxs, swb, sws, sdb, sds, st
  if (dtype == 0)
    return (int)(vec ? bwd_k<float, true>(REPRO_BWD_ARGS)
                     : bwd_k<float, false>(REPRO_BWD_ARGS));
  if (dtype == 1)
    return (int)(vec ? bwd_k<__nv_bfloat16, true>(REPRO_BWD_ARGS)
                     : bwd_k<__nv_bfloat16, false>(REPRO_BWD_ARGS));
#undef REPRO_BWD_ARGS
  return (int)cudaErrorInvalidValue;
}
