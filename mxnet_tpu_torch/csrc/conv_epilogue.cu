// Conv epilogue for Hopper (sm_90a), plain C interface: training-mode
// BatchNorm (+ residual add) (+ ReLU) over a channels-last activation seen
// as rows, x (R = N*H*W, C), C contiguous.
//
// Four kernels, each replacing one TPU kernel of
// mxnet_tpu/ops/pallas_kernels.py (reached through conv_epilogue :1086):
//
//   epi_stats       <- _epi_stats_kernel (:769, pallas_call :903)
//       per-channel sum(d), sum(d^2), d = x - proxy, then mean, var,
//       inv = 1/sqrt(var + eps), scale = gamma * inv, shift = beta - mean *
//       scale. The proxy is the mean of the first min(R, 8) rows.
//   epi_apply       <- _epi_apply_kernel (:790, pallas_call :920)
//       out = relu?(x * scale + shift (+ res))
//   epi_bwd_reduce  <- _epi_bwd_reduce_kernel (:807, pallas_call :936)
//       per-channel sum(g), sum(g * xhat), g = ct * [out > 0] when relu,
//       xhat = (x - mean) * inv; then dgamma, dbeta and the dx
//       coefficients coef = gamma * inv, cb = sum(g) / R, cg = sum(g*xhat)/R
//   epi_bwd_dx      <- _epi_bwd_dx_kernel (:840, pallas_call :954)
//       dx = coef * (g - cb - xhat * cg), dres = g
//
// Element types: float and __nv_bfloat16 for the (R, C) tensors; gamma,
// beta, dgamma and dbeta in float or bfloat16 (the trainer casts them to
// the compute type); every per-channel vector and every sum in float.
//
// Bound on the card: bytes. Each kernel does a few FLOPs per element it
// reads (at most ~10), far below the ~20 FLOP/byte (f32, outside the
// tensor cores) where an H100 stops being memory-bound. What the design
// does about it:
//   * Each (R, C) tensor is read once and each output written once, with
//     16-byte vector loads and stores (8 bf16 or 4 f32 channels a thread)
//     when C is a multiple of the vector width and the rows are 16-byte
//     aligned. The two reductions fold any other C: they read the tensor
//     as (R / L, L C) rows, L the fewest rows that make L C elements whole
//     16-byte packs (C = 3: L = 8 in bf16, 4 in f32), column j standing for
//     channel j % C; the finishing thread adds a channel's L columns in
//     order and then the R % L tail rows. Past 32 packs a folded row, and
//     for a tensor that is not 16-byte aligned, one element a thread. Any
//     C >= 1 is taken.
//   * The TPU kernels ran the row grid in order and added every block's sum
//     into one output block that step 0 zeroed. Blocks here run in
//     parallel in no order. Each reduction has two routes, chosen from the
//     shape before the launch (`epi_layout`):
//       - small R, the cluster route: one launch, no workspace. A
//         thread-block cluster of K blocks (16 where the card holds it,
//         else the portable 8) covers each tile of channels; each block
//         streams a contiguous share of the rows, reduces it in shared
//         memory in a fixed tree order, and after a cluster barrier block
//         0 adds the K blocks' sums in rank order over distributed shared
//         memory, does the per-channel finishing math and writes each
//         output; a second barrier keeps the blocks' shared memory alive
//         until it has been read. Narrow tiles (8 packs) make the
//         clusters fill the SMs: at (8192, 448) bf16, 7 tiles x 16 blocks.
//       - the streamed route, two passes: pass 1 is a 2-D grid of (row
//         chunk, channel tile) blocks, neighbouring threads on neighbouring
//         channels, each block's column sums reduced in shared memory and
//         written to a float workspace (2, n_chunks, C); pass 2 sums the
//         chunks of each column in a fixed order and finishes.
//     No atomics and fixed orders: the result is the same bits on every
//     run.
//   * The elementwise kernels read the per-channel float vectors by
//     channel index (element index mod C), 16 bytes at a time, from L1.
// Numerics kept from the TPU kernels: float accumulation for bf16 inputs,
// the proxy-shifted one-pass moments, var = max(E[d^2] - E[d]^2, 0), and
// the ReLU mask taken from the saved output (out > 0).
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise. Each entry point returns cudaGetLastError() after its
// launches (cudaErrorInvalidValue for arguments it does not take).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kProxyRows = 8;     // rows averaged into the stats proxy
constexpr int kThreads = 256;     // threads of a pass-1 or elementwise block
constexpr int kFinishLanes = 32;  // chunk lanes of a pass-2 block
constexpr int kMaxGrid = 132 * 32;  // elementwise grid cap (grid-stride)
constexpr int kMaxFold = 8;         // the most rows a fold takes (bf16, odd C)
constexpr int kClusterMinK = 8;     // the portable cluster size
constexpr int kClusterMaxK = 16;    // with the non-portable attribute

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// V consecutive elements moved as one load or store
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  const Pack<T, V> r = *reinterpret_cast<const Pack<T, V>*>(p);
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = to_f32(r.v[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const float (&in)[V]) {
  Pack<T, V> r;
#pragma unroll
  for (int k = 0; k < V; ++k) r.v[k] = from_f32<T>(in[k]);
  *reinterpret_cast<Pack<T, V>*>(p) = r;
}

// the same through the read-only data path: the reductions take their
// row tensors from a struct, whose pointers the compiler cannot prove
// unaliased
template <typename T, int V>
__device__ __forceinline__ void load_ro(const T* p, float (&out)[V]) {
  if constexpr (sizeof(T) * V == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const Pack<T, V> r = *reinterpret_cast<const Pack<T, V>*>(&u);
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = to_f32(r.v[k]);
  } else {
    static_assert(V == 1, "V elements are one 16-byte pack or one element");
    out[0] = to_f32(__ldg(p));
  }
}

// V consecutive per-channel floats; 16-byte loads when V is a multiple of
// 4 (the host then guarantees the vector and c are 16-byte aligned), so a
// warp reads its channels' values in few wide transactions
template <int V>
__device__ __forceinline__ void load_channels(const float* __restrict__ p,
                                              float (&out)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int k = 0; k < V; k += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + k));
      out[k] = q.x;
      out[k + 1] = q.y;
      out[k + 2] = q.z;
      out[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) out[k] = __ldg(p + k);
  }
}

// gamma / beta / dgamma / dbeta come in float or bfloat16
__device__ __forceinline__ float param_at(const void* p, int bf16, int c) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[c])
              : static_cast<const float*>(p)[c];
}

__device__ __forceinline__ void param_put(void* p, int bf16, int c,
                                          float v) {
  if (bf16)
    static_cast<__nv_bfloat16*>(p)[c] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[c] = v;
}

// mean of rows [0, min(R, kProxyRows)) of channel c, summed in row order:
// every block and the finishing thread get the same bits. The loads are
// all issued before the sum, one memory latency and not kProxyRows.
template <typename T>
__device__ __forceinline__ float proxy_of(const T* x, long long R, int C,
                                          int c) {
  const int n = R < kProxyRows ? static_cast<int>(R) : kProxyRows;
  float v[kProxyRows];
#pragma unroll
  for (int i = 0; i < kProxyRows; ++i)
    v[i] = i < n ? to_f32(__ldg(x + static_cast<long long>(i) * C + c)) : 0.f;
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kProxyRows; ++i)
    if (i < n) s += v[i];
  return s / static_cast<float>(n);
}

// ---------------------------------------------------------------------------
// The two reductions, epi_stats and epi_bwd_reduce
// ---------------------------------------------------------------------------

enum RedMode { kStats = 0, kBwd = 1, kBwdRelu = 2 };

// One reduction's arguments. The (R, C) row tensors are read as Rf = R / L
// folded rows of W = L * C columns (L = 1 unless the fold is on); column j
// of a folded row is channel j % C. The R - Rf * L tail rows are added by
// the thread that finishes the channel.
struct Red {
  const void* x;
  const void* ct;   // bwd: the cotangent
  const void* out;  // bwd with relu: the saved output, whose sign masks ct
  long long R, Rf;
  int C, L, W;
  const float* mean;  // bwd
  const float* inv;   // bwd
  const void* gamma;
  const void* beta;  // stats
  int params_bf16, fix_gamma;
  float eps;  // stats
  float* o[5];  // stats: mean var inv scale shift; bwd: coef cb cg
  void* dgamma;  // bwd
  void* dbeta;   // bwd
};

// One folded row's terms added into this thread's sums of its V columns.
// Stats: sum(d), sum(d^2) with d = x - p; bwd: sum(g), sum(g * (x - p) *
// iv), g = ct masked by out > 0 (x, g and o as loaded).
template <int V, int M>
__device__ __forceinline__ void add_row(const float (&xv)[V],
                                        const float (&g)[V],
                                        const float (&o)[V],
                                        const float (&p)[V],
                                        const float (&iv)[V], float (&s1)[V],
                                        float (&s2)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if constexpr (M == kStats) {
      const float d = xv[k] - p[k];
      s1[k] += d;
      s2[k] += d * d;
    } else {
      const float gk = M == kBwdRelu ? (o[k] > 0.f ? g[k] : 0.f) : g[k];
      s1[k] += gk;
      s2[k] += gk * ((xv[k] - p[k]) * iv[k]);
    }
  }
}

// rows loaded together before they are added (16-byte loads in flight a
// thread against the memory latency): the cluster route's few blocks a tile
// take more than the streamed route's many (measured, chip_smoke.py)
template <int M, bool CLUSTER>
constexpr int kBatchRows = M == kStats ? (CLUSTER ? 8 : 4) : (CLUSTER ? 4 : 2);

template <typename T, int V, int M>
__device__ __forceinline__ void load_row(const Red& a, long long e,
                                         float (&xv)[V], float (&g)[V],
                                         float (&o)[V]) {
  load_ro<T, V>(static_cast<const T*>(a.x) + e, xv);
  if constexpr (M != kStats) load_ro<T, V>(static_cast<const T*>(a.ct) + e, g);
  if constexpr (M == kBwdRelu)
    load_ro<T, V>(static_cast<const T*>(a.out) + e, o);
}

// This thread's sums over its V columns [j0, j0 + V) of folded rows r0 +
// ty, r0 + ty + blockDim.y, ... below r1, added in row order. Rows are
// loaded B at a time, every load of a batch issued before the first add.
template <typename T, int V, int M, int B>
__device__ __forceinline__ void accumulate(const Red& a, int j0, long long r0,
                                           long long r1, const float (&p)[V],
                                           const float (&iv)[V],
                                           float (&s1)[V], float (&s2)[V]) {
  const long long step = blockDim.y;
  long long r = r0 + threadIdx.y;
  for (; r + (B - 1) * step < r1; r += B * step) {
    float xv[B][V], g[B][V], o[B][V];
#pragma unroll
    for (int u = 0; u < B; ++u)
      load_row<T, V, M>(a, (r + u * step) * a.W + j0, xv[u], g[u], o[u]);
#pragma unroll
    for (int u = 0; u < B; ++u) add_row<V, M>(xv[u], g[u], o[u], p, iv, s1, s2);
  }
  for (; r < r1; r += step) {
    float xv[V], g[V], o[V];
    load_row<T, V, M>(a, r * a.W + j0, xv, g, o);
    add_row<V, M>(xv, g, o, p, iv, s1, s2);
  }
}

// The per-column constants of this thread's columns. Stats: the proxy of
// the column's channel, also left in shared memory `prox` (w columns) for
// the block's finishing threads: unfolded, each thread sums its own V
// channels' first rows with 16-byte loads; else the block's w columns are
// computed one a thread. Bwd: the channel's mean and inv.
template <typename T, int V, int M>
__device__ __forceinline__ void column_constants(const Red& a, float* prox,
                                                 int j0, bool live,
                                                 float (&p)[V],
                                                 float (&iv)[V]) {
  const int tx = threadIdx.x;
#pragma unroll
  for (int k = 0; k < V; ++k) iv[k] = 1.f;
  if constexpr (M == kStats) {
    const T* x = static_cast<const T*>(a.x);
    if (V > 1 && a.L == 1) {
      const int n = a.R < kProxyRows ? static_cast<int>(a.R) : kProxyRows;
      float v[kProxyRows][V];
#pragma unroll
      for (int i = 0; i < kProxyRows; ++i) {
        if (live && i < n) {
          load_ro<T, V>(x + static_cast<long long>(i) * a.C + j0, v[i]);
        } else {
#pragma unroll
          for (int k = 0; k < V; ++k) v[i][k] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < kProxyRows; ++i)
          if (i < n) t += v[i][k];
        p[k] = t / static_cast<float>(n);
        if (threadIdx.y == 0) prox[tx * V + k] = p[k];
      }
      return;
    }
    const int w = blockDim.x * V;
    const int c0 = blockIdx.y * w;
    for (int j = threadIdx.y * blockDim.x + tx; j < w;
         j += blockDim.x * blockDim.y)
      prox[j] = c0 + j < a.W ? proxy_of(x, a.R, a.C, (c0 + j) % a.C) : 0.f;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = prox[tx * V + k];
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = (j0 + k) % a.C;
      p[k] = live ? a.mean[c] : 0.f;
      iv[k] = live ? a.inv[c] : 0.f;
    }
  }
}

// The block's (blockDim.y) partial sums of each of its w = blockDim.x * V
// columns added in a fixed tree order in shared memory; after it sa[0, w)
// and sb[0, w) hold the block's column sums.
template <int V>
__device__ __forceinline__ void block_column_sums(float* sa, float* sb,
                                                  const float (&s1)[V],
                                                  const float (&s2)[V]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int w = blockDim.x * V;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    sa[ty * w + tx * V + k] = s1[k];
    sb[ty * w + tx * V + k] = s2[k];
  }
  __syncthreads();
  for (int s = blockDim.y / 2; s > 0; s >>= 1) {
    if (ty < s) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        sa[ty * w + tx * V + k] += sa[(ty + s) * w + tx * V + k];
        sb[ty * w + tx * V + k] += sb[(ty + s) * w + tx * V + k];
      }
    }
    __syncthreads();
  }
}

// The block's channel sums, from its column sums in sa[0, w), sb[0, w):
// channel t of the block takes its L columns t, C + t, ... in order (L > 1
// only when the whole folded row is one tile, so the block has them all).
// After it sa[0, w / L) and sb[0, w / L) hold them.
__device__ __forceinline__ void fold_columns(float* sa, float* sb, int w,
                                             int L, int C) {
  if (L == 1) return;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  float u1 = 0.f, u2 = 0.f;
  if (tid < w / L) {
    for (int l = 0; l < L; ++l) {
      u1 += sa[l * C + tid];
      u2 += sb[l * C + tid];
    }
  }
  __syncthreads();
  if (tid < w / L) {
    sa[tid] = u1;
    sb[tid] = u2;
  }
  __syncthreads();
}

// The finishing math of channel c from s1, s2, its sums over the folded
// rows, and (stats) its proxy p: the tail rows [Rf L, R) added in row
// order, then the outputs, each written once.
template <typename T, int M>
__device__ __forceinline__ void finish_channel(const Red& a, int c, float s1,
                                               float s2, float p) {
  const T* x = static_cast<const T*>(a.x);
  const long long C = a.C;
  const float rows = static_cast<float>(a.R);
  const float g1 = a.fix_gamma ? 1.f : param_at(a.gamma, a.params_bf16, c);
  // the tail is under L <= kMaxFold rows: its loads are issued together
  const long long r0 = a.Rf * a.L;
  const int tail = static_cast<int>(a.R - r0);
  if constexpr (M == kStats) {
    float xt[kMaxFold];
#pragma unroll
    for (int i = 0; i < kMaxFold; ++i)
      xt[i] = i < tail ? to_f32(__ldg(x + (r0 + i) * C + c)) : 0.f;
#pragma unroll
    for (int i = 0; i < kMaxFold; ++i) {
      if (i < tail) {
        const float d = xt[i] - p;
        s1 += d;
        s2 += d * d;
      }
    }
    s1 /= rows;
    s2 /= rows;
    const float m = p + s1;
    const float v = fmaxf(s2 - s1 * s1, 0.f);
    const float iv = 1.f / sqrtf(v + a.eps);
    const float sc = g1 * iv;
    a.o[0][c] = m;
    a.o[1][c] = v;
    a.o[2][c] = iv;
    a.o[3][c] = sc;
    a.o[4][c] = param_at(a.beta, a.params_bf16, c) - m * sc;
  } else {
    const T* ct = static_cast<const T*>(a.ct);
    const T* out = static_cast<const T*>(a.out);
    const float m = a.mean[c], iv = a.inv[c];
    float gv[kMaxFold], xv[kMaxFold];
#pragma unroll
    for (int i = 0; i < kMaxFold; ++i) {
      gv[i] = 0.f;
      xv[i] = 0.f;
      if (i < tail) {
        const long long e = (r0 + i) * C + c;
        gv[i] = to_f32(__ldg(ct + e));
        if (M == kBwdRelu && !(to_f32(__ldg(out + e)) > 0.f)) gv[i] = 0.f;
        xv[i] = to_f32(__ldg(x + e));
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxFold; ++i) {
      if (i < tail) {
        s1 += gv[i];
        s2 += gv[i] * ((xv[i] - m) * iv);
      }
    }
    a.o[0][c] = g1 * iv;
    a.o[1][c] = s1 / rows;
    a.o[2][c] = s2 / rows;
    param_put(a.dgamma, a.params_bf16, c, a.fix_gamma ? 0.f : s2);
    param_put(a.dbeta, a.params_bf16, c, s1);
  }
}

// Streamed route, pass 1: a 2-D grid of (chunk of folded rows, tile of
// columns) blocks; each block's channel sums go to the float workspace
// part (2, n_chunks, C).
template <typename T, int V, int M>
__global__ void __launch_bounds__(kThreads)
reduce_partial(Red a, long long rows_per_chunk, float* __restrict__ part,
               int n_chunks) {
  extern __shared__ float sm[];  // 2 * blockDim.y * w sums, then w proxies
  const int w = blockDim.x * V;
  float* sa = sm;
  float* sb = sa + blockDim.y * w;
  float* prox = sb + blockDim.y * w;
  const int tx = threadIdx.x;
  const int j0 = (blockIdx.y * blockDim.x + tx) * V;
  // with V > 1 the host guarantees W % V == 0: the thread's V columns are
  // all live or all past the edge
  const bool live = j0 < a.W;
  float p[V], iv[V], s1[V] = {}, s2[V] = {};
  column_constants<T, V, M>(a, prox, j0, live, p, iv);
  const long long r0 = blockIdx.x * rows_per_chunk;
  const long long r1 = r0 + rows_per_chunk < a.Rf ? r0 + rows_per_chunk : a.Rf;
  if (live)
    accumulate<T, V, M, kBatchRows<M, false>>(a, j0, r0, r1, p, iv, s1, s2);
  block_column_sums<V>(sa, sb, s1, s2);
  fold_columns(sa, sb, w, a.L, a.C);
  const long long chunk = blockIdx.x;
  const int c0 = blockIdx.y * w;
  for (int t = threadIdx.y * blockDim.x + tx; t < w / a.L && c0 + t < a.C;
       t += blockDim.x * blockDim.y) {
    part[chunk * a.C + c0 + t] = sa[t];
    part[(n_chunks + chunk) * a.C + c0 + t] = sb[t];
  }
}

// Streamed route, pass 2: one thread column per channel, kFinishLanes
// lanes over the chunks, lanes added in order; then the finishing math.
template <typename T, int M>
__global__ void reduce_finish(Red a, const float* __restrict__ part,
                              int n_chunks) {
  __shared__ float sa[kFinishLanes][33];
  __shared__ float sb[kFinishLanes][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float u1 = 0.f, u2 = 0.f;
  if (c < a.C) {
#pragma unroll 8
    for (int k = ty; k < n_chunks; k += kFinishLanes) {
      u1 += part[static_cast<long long>(k) * a.C + c];
      u2 += part[static_cast<long long>(n_chunks + k) * a.C + c];
    }
  }
  sa[ty][tx] = u1;
  sb[ty][tx] = u2;
  __syncthreads();
  float s1 = 0.f, s2 = 0.f;
  if (ty == 0) {
    for (int q = 0; q < kFinishLanes; ++q) {
      s1 += sa[q][tx];
      s2 += sb[q][tx];
    }
  }
  if (ty == 0 && c < a.C)
    finish_channel<T, M>(
        a, c, s1, s2,
        M == kStats ? proxy_of(static_cast<const T*>(a.x), a.R, a.C, c) : 0.f);
}

// Cluster route (small R), one launch and no workspace: a cluster of K
// blocks (blockIdx.x, its rank) covers each tile of columns (blockIdx.y).
// Block k streams the contiguous share [k s, (k + 1) s) of the folded
// rows, s = ceil(Rf / K), reduces it in shared memory in the tree order
// above to the tile's channel sums, and after a cluster barrier block 0
// adds the K blocks' sums in rank order over DSMEM and finishes the tile's
// channels. A second barrier keeps every block's shared memory alive until
// block 0 has read it.
template <typename T, int V, int M>
__global__ void __launch_bounds__(kThreads) reduce_cluster(Red a) {
  extern __shared__ float sm[];  // sums (2 * blockDim.y * w), w proxies,
                                 // the cluster's two channel sums (2 * w)
  cg::cluster_group cluster = cg::this_cluster();
  const int K = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int w = blockDim.x * V;
  float* sa = sm;
  float* sb = sa + blockDim.y * w;
  float* prox = sb + blockDim.y * w;
  float* t1 = prox + w;
  float* t2 = t1 + w;
  const int j0 = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  const bool live = j0 < a.W;
  float p[V], iv[V], s1[V] = {}, s2[V] = {};
  column_constants<T, V, M>(a, prox, j0, live, p, iv);
  const long long share = (a.Rf + K - 1) / K;
  long long r0 = rank * share;
  if (r0 > a.Rf) r0 = a.Rf;
  const long long r1 = r0 + share < a.Rf ? r0 + share : a.Rf;
  if (live)
    accumulate<T, V, M, kBatchRows<M, true>>(a, j0, r0, r1, p, iv, s1, s2);
  block_column_sums<V>(sa, sb, s1, s2);
  fold_columns(sa, sb, w, a.L, a.C);
  cluster.sync();
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const int nch = w / a.L;  // the tile's channels
  if (rank == 0) {
    for (int j = tid; j < nch; j += nthreads) {
      // every block's two sums fetched first, then added in rank order
      float v1[kClusterMaxK], v2[kClusterMaxK];
#pragma unroll
      for (int q = 0; q < kClusterMaxK; ++q) {
        v1[q] = q < K ? cluster.map_shared_rank(sa, q)[j] : 0.f;
        v2[q] = q < K ? cluster.map_shared_rank(sb, q)[j] : 0.f;
      }
      float u1 = 0.f, u2 = 0.f;
#pragma unroll
      for (int q = 0; q < kClusterMaxK; ++q) {
        if (q < K) {
          u1 += v1[q];
          u2 += v2[q];
        }
      }
      t1[j] = u1;
      t2[j] = u2;
    }
  }
  cluster.sync();  // every block's sums are read: the blocks may exit
  if (rank != 0) return;
  // prox[t] is channel c0 + t's proxy: column t of the tile, folded or not
  const int c0 = blockIdx.y * w;
  for (int t = tid; t < nch && c0 + t < a.C; t += nthreads)
    finish_channel<T, M>(a, c0 + t, t1[t], t2[t], M == kStats ? prox[t] : 0.f);
}

// ---------------------------------------------------------------------------
// epi_apply: out = relu?(x * scale + shift (+ res)), elementwise
// ---------------------------------------------------------------------------
template <typename T, int V, bool RELU, bool RES>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const T* __restrict__ res,
             const float* __restrict__ scale, const float* __restrict__ shift,
             T* __restrict__ out, long long n_packs, int C) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_packs; i += stride) {
    const long long e = i * V;
    const int c = static_cast<int>(e % C);
    float v[V], r[V], sc[V], sh[V];
    load<T, V>(x + e, v);
    if (RES) load<T, V>(res + e, r);
    load_channels<V>(scale + c, sc);
    load_channels<V>(shift + c, sh);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float y = v[k] * sc[k] + sh[k];
      if (RES) y += r[k];
      if (RELU) y = y < 0.f ? 0.f : y;  // NaN stays NaN, as jnp.maximum
      v[k] = y;
    }
    store<T, V>(out + e, v);
  }
}

// ---------------------------------------------------------------------------
// epi_bwd_dx: dx = coef * (g - cb - xhat * cg), dres = g, elementwise
// ---------------------------------------------------------------------------
template <typename T, int V, bool RELU, bool RES>
__global__ void __launch_bounds__(kThreads)
bwd_dx_kernel(const T* __restrict__ ct, const T* __restrict__ x,
              const T* __restrict__ out, const float* __restrict__ mean,
              const float* __restrict__ inv, const float* __restrict__ coef,
              const float* __restrict__ cb, const float* __restrict__ cg,
              T* __restrict__ dx, T* __restrict__ dres, long long n_packs,
              int C) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n_packs; i += stride) {
    const long long e = i * V;
    const int c = static_cast<int>(e % C);
    float g[V], xv[V];
    load<T, V>(ct + e, g);
    load<T, V>(x + e, xv);
    if (RELU) {
      float o[V];
      load<T, V>(out + e, o);
#pragma unroll
      for (int k = 0; k < V; ++k) g[k] = o[k] > 0.f ? g[k] : 0.f;
    }
    float m[V], iv[V], cf[V], b[V], gx[V], d[V];
    load_channels<V>(mean + c, m);
    load_channels<V>(inv + c, iv);
    load_channels<V>(coef + c, cf);
    load_channels<V>(cb + c, b);
    load_channels<V>(cg + c, gx);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xhat = (xv[k] - m[k]) * iv[k];
      d[k] = cf[k] * (g[k] - b[k] - xhat * gx[k]);
    }
    store<T, V>(dx + e, d);
    if (RES) store<T, V>(dres + e, g);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// vector width for rows of C elements of T: 16 bytes when C divides into
// whole packs and every row tensor is 16-byte aligned, else 1
template <typename T>
inline int pack_width(int C, const void* a, const void* b, const void* c,
                      const void* d) {
  constexpr int kV = 16 / sizeof(T);
  return (C % kV == 0 && aligned16(a) && aligned16(b) && aligned16(c) &&
          aligned16(d))
             ? kV
             : 1;
}

inline int elementwise_grid(long long n_packs) {
  const long long blocks = (n_packs + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxGrid ? blocks : kMaxGrid);
}

// The layout of a reduction over (R, C) rows of T whose row tensors are
// all 16-byte aligned or not (`aligned`); ops/pallas_kernels.py
// `_epi_layout` mirrors it, and the wrapper allocates the workspace only
// for the streamed route.
//   * V: elements a load (16 bytes, or 1 on the scalar path); L: the fold.
//     C a multiple of 16 / sizeof(T) takes the vector path unfolded. Any
//     other C of an aligned tensor with R >= L0 rows folds L0 = 16 /
//     gcd(C sizeof(T), 16) rows into one of W = L0 C columns, whole 16-byte
//     packs, when such a row is at most kFoldMaxBytes (32 packs, so one
//     tile holds it); else the scalar path, L = 1.
//   * The cluster route when the tensor's bytes are at most
//     kClusterBytesPerBlock for each block of kClusterMinK a tile; its tiles
//     are kClusterTilePacks packs, doubled up to 32 while that leaves at
//     least kClusterMinTiles tiles (32 elements on the scalar path; the
//     whole row when folded). Else the streamed route, pass 1 on tiles of tx
//     packs (a power of two up to 32; the whole row when folded), over
//     n_chunks chunks of folded rows: one a kChunkRows rows, at most
//     kMaxChunks (a function of the shape alone, so a shape always reduces
//     in the same order).
//   * ty: rows in flight, the largest power of two with tx ty <= kThreads.
constexpr long long kClusterBytesPerBlock = 400 * 1024;
constexpr int kClusterTilePacks = 8;
constexpr int kClusterMinTiles = 8;
constexpr int kFoldMaxBytes = 512;
constexpr int kChunkRows = 128;
constexpr int kMaxChunks = 1024;
// shared memory of a cluster block at most: 2 ty w + 3 w floats, tx ty <=
// kThreads, w = 8 tx
constexpr int kClusterSmemMax = (2 * kThreads * 8 + 3 * 32 * 8) * 4;

struct Layout {
  int V, L, W;
  long long Rf;
  bool cluster;
  int tx, ty, tiles;
  int n_chunks;  // streamed route
  long long rows_per_chunk;
};

inline int gcd_int(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

template <typename T>
inline Layout epi_layout(long long R, int C, bool aligned) {
  constexpr int kV = 16 / sizeof(T);
  constexpr int kE = sizeof(T);
  Layout y = {};
  y.V = 1;
  y.L = 1;
  if (aligned && C % kV == 0) {
    y.V = kV;
  } else if (aligned) {
    const int l0 = 16 / gcd_int((C % 16) * kE % 16, 16);
    if (static_cast<long long>(l0) * C * kE <= kFoldMaxBytes && R >= l0) {
      y.V = kV;
      y.L = l0;
    }
  }
  y.W = y.L * C;
  y.Rf = R / y.L;
  const int P = y.W / y.V;  // packs of a folded row
  int twc = P;  // the cluster route's tile
  if (y.L == 1 && y.V == 1) {
    twc = std::min(P, 32);
  } else if (y.L == 1) {
    twc = kClusterTilePacks;
    while (twc < 32 && (P + 2 * twc - 1) / (2 * twc) >= kClusterMinTiles)
      twc *= 2;
    twc = std::min(twc, P);
  }
  const long long tiles_c = (P + twc - 1) / twc;
  const long long bytes = y.Rf * y.W * kE;
  y.cluster = bytes <= kClusterBytesPerBlock * kClusterMinK * tiles_c;
  if (y.cluster) {
    y.tx = twc;
  } else if (y.L > 1) {
    y.tx = P;
  } else {
    y.tx = 1;
    while (y.tx < P && y.tx < 32) y.tx <<= 1;
  }
  y.tiles = (P + y.tx - 1) / y.tx;
  y.ty = 1;
  while (y.tx * y.ty * 2 <= kThreads) y.ty <<= 1;
  if (!y.cluster) {
    const long long n = (y.Rf + kChunkRows - 1) / kChunkRows;
    y.n_chunks = static_cast<int>(n < 1 ? 1 : (n > kMaxChunks ? kMaxChunks
                                                               : n));
    y.rows_per_chunk = (y.Rf + y.n_chunks - 1) / y.n_chunks;
  }
  return y;
}

// The cluster size of reduce_cluster<T, V, M> on the current device:
// kClusterMaxK when the card holds such a cluster of kThreads-thread blocks
// with the most shared memory a cluster block takes, else kClusterMinK.
// Asked once a device, before the kernel's first launch.
template <typename T, int V, int M>
int cluster_size() {
  constexpr int kDevices = 64;
  static int cache[kDevices] = {};
  auto kernel = reduce_cluster<T, V, M>;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = -1;
  if (dev >= 0 && dev < kDevices && cache[dev]) return cache[dev];
  int k = kClusterMinK;
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeNonPortableClusterSizeAllowed,
                           1) == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kClusterMaxK);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kClusterSmemMax;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kClusterMaxK;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    if (cudaOccupancyMaxActiveClusters(
            &n, reinterpret_cast<const void*>(kernel), &cfg) == cudaSuccess &&
        n >= 1)
      k = kClusterMaxK;
  }
  cudaGetLastError();  // a refused probe leaves no error behind
  if (dev >= 0 && dev < kDevices) cache[dev] = k;
  return k;
}

// The cluster size for `tiles` tiles: the most the card holds when the
// tiles are few (at most kClusterWideTiles), else the portable size
// (measured on an H100: 32 tiles in clusters of 16 run ~1.7x slower than
// in clusters of 8; 7 tiles faster in 16).
constexpr int kClusterWideTiles = 8;

template <typename T, int V, int M>
int cluster_k(int tiles) {
  return tiles <= kClusterWideTiles ? cluster_size<T, V, M>() : kClusterMinK;
}

// Launch a reduction of mode M: the cluster route's one kernel, or the
// streamed route's two over `part` (2, n_chunks, C), which must be given
// (with the layout's n_chunks) exactly on that route.
template <typename T, int V, int M>
int launch_reduce(const Red& a, const Layout& y, float* part, int n_chunks,
                  cudaStream_t s) {
  const dim3 block(y.tx, y.ty);
  const int w = y.tx * V;
  if (y.cluster) {
    if (part != nullptr) return cudaErrorInvalidValue;
    const int K = cluster_k<T, V, M>(y.tiles);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(K, y.tiles);
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = (2 * y.ty * w + 3 * w) * sizeof(float);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, reduce_cluster<T, V, M>, a);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
  }
  if (part == nullptr || n_chunks != y.n_chunks) return cudaErrorInvalidValue;
  const size_t smem = (2 * y.ty * w + w) * sizeof(float);
  reduce_partial<T, V, M><<<dim3(y.n_chunks, y.tiles), block, smem, s>>>(
      a, y.rows_per_chunk, part, y.n_chunks);
  reduce_finish<T, M><<<dim3((a.C + 31) / 32), dim3(32, kFinishLanes), 0,
                        s>>>(a, part, y.n_chunks);
  return cudaGetLastError();
}

template <typename T, int M>
int launch_reduction(Red a, bool aligned, float* part, int n_chunks,
                     cudaStream_t s) {
  if (a.R < 1 || a.C < 1) return cudaErrorInvalidValue;
  constexpr int kV = 16 / sizeof(T);
  const Layout y = epi_layout<T>(a.R, a.C, aligned);
  if (y.tiles > 65535) return cudaErrorInvalidValue;
  a.L = y.L;
  a.W = y.W;
  a.Rf = y.Rf;
  if (y.V == kV) return launch_reduce<T, kV, M>(a, y, part, n_chunks, s);
  return launch_reduce<T, 1, M>(a, y, part, n_chunks, s);
}

template <typename T>
int launch_stats(const void* x, long long R, int C, const void* gamma,
                 const void* beta, int params_bf16, float eps, int fix_gamma,
                 float* part, int n_chunks, float* mean, float* var,
                 float* inv, float* scale, float* shift, cudaStream_t s) {
  Red a = {};
  a.x = x;
  a.R = R;
  a.C = C;
  a.gamma = gamma;
  a.beta = beta;
  a.params_bf16 = params_bf16;
  a.fix_gamma = fix_gamma;
  a.eps = eps;
  a.o[0] = mean;
  a.o[1] = var;
  a.o[2] = inv;
  a.o[3] = scale;
  a.o[4] = shift;
  return launch_reduction<T, kStats>(a, aligned16(x), part, n_chunks, s);
}

template <typename T>
int launch_bwd_reduce(const void* ct, const void* x, const void* out,
                      const float* mean, const float* inv, long long R, int C,
                      const void* gamma, int params_bf16, int fix_gamma,
                      float* part, int n_chunks, void* dgamma, void* dbeta,
                      float* coef, float* cb, float* cg, cudaStream_t s) {
  Red a = {};
  a.x = x;
  a.ct = ct;
  a.out = out;
  a.R = R;
  a.C = C;
  a.mean = mean;
  a.inv = inv;
  a.gamma = gamma;
  a.params_bf16 = params_bf16;
  a.fix_gamma = fix_gamma;
  a.o[0] = coef;
  a.o[1] = cb;
  a.o[2] = cg;
  a.dgamma = dgamma;
  a.dbeta = dbeta;
  const bool aligned = aligned16(ct) && aligned16(x) && aligned16(out);
  if (out)
    return launch_reduction<T, kBwdRelu>(a, aligned, part, n_chunks, s);
  return launch_reduction<T, kBwd>(a, aligned, part, n_chunks, s);
}

template <typename T, int V>
void apply_variant(const T* x, const T* res, const float* scale,
                   const float* shift, T* out, long long n_packs, int C,
                   int relu, cudaStream_t s) {
  const int grid = elementwise_grid(n_packs);
  if (relu && res)
    apply_kernel<T, V, true, true><<<grid, kThreads, 0, s>>>(
        x, res, scale, shift, out, n_packs, C);
  else if (relu)
    apply_kernel<T, V, true, false><<<grid, kThreads, 0, s>>>(
        x, res, scale, shift, out, n_packs, C);
  else if (res)
    apply_kernel<T, V, false, true><<<grid, kThreads, 0, s>>>(
        x, res, scale, shift, out, n_packs, C);
  else
    apply_kernel<T, V, false, false><<<grid, kThreads, 0, s>>>(
        x, res, scale, shift, out, n_packs, C);
}

template <typename T>
int launch_apply(const void* x_, const void* res_, const float* scale,
                 const float* shift, void* out_, long long R, int C, int relu,
                 cudaStream_t s) {
  if (R < 1 || C < 1) return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(x_);
  const T* res = static_cast<const T*>(res_);
  T* out = static_cast<T*>(out_);
  constexpr int kV = 16 / sizeof(T);
  const int v = pack_width<T>(C, x, res, out, nullptr) == kV &&
                        aligned16(scale) && aligned16(shift)
                    ? kV
                    : 1;
  const long long n = R * static_cast<long long>(C);
  if (v == kV)
    apply_variant<T, kV>(x, res, scale, shift, out, n / kV, C, relu, s);
  else
    apply_variant<T, 1>(x, res, scale, shift, out, n, C, relu, s);
  return cudaGetLastError();
}

template <typename T, int V>
void dx_variant(const T* ct, const T* x, const T* out, const float* mean,
                const float* inv, const float* coef, const float* cb,
                const float* cg, T* dx, T* dres, long long n_packs, int C,
                cudaStream_t s) {
  const int grid = elementwise_grid(n_packs);
  if (out && dres)
    bwd_dx_kernel<T, V, true, true><<<grid, kThreads, 0, s>>>(
        ct, x, out, mean, inv, coef, cb, cg, dx, dres, n_packs, C);
  else if (out)
    bwd_dx_kernel<T, V, true, false><<<grid, kThreads, 0, s>>>(
        ct, x, out, mean, inv, coef, cb, cg, dx, dres, n_packs, C);
  else if (dres)
    bwd_dx_kernel<T, V, false, true><<<grid, kThreads, 0, s>>>(
        ct, x, out, mean, inv, coef, cb, cg, dx, dres, n_packs, C);
  else
    bwd_dx_kernel<T, V, false, false><<<grid, kThreads, 0, s>>>(
        ct, x, out, mean, inv, coef, cb, cg, dx, dres, n_packs, C);
}

template <typename T>
int launch_bwd_dx(const void* ct_, const void* x_, const void* out_,
                  const float* mean, const float* inv, const float* coef,
                  const float* cb, const float* cg, void* dx_, void* dres_,
                  long long R, int C, cudaStream_t s) {
  if (R < 1 || C < 1) return cudaErrorInvalidValue;
  const T* ct = static_cast<const T*>(ct_);
  const T* x = static_cast<const T*>(x_);
  const T* out = static_cast<const T*>(out_);
  T* dx = static_cast<T*>(dx_);
  T* dres = static_cast<T*>(dres_);
  constexpr int kV = 16 / sizeof(T);
  const int v = pack_width<T>(C, ct, x, out, dx) == kV &&
                        pack_width<T>(C, dres, mean, inv, coef) == kV &&
                        aligned16(cb) && aligned16(cg)
                    ? kV
                    : 1;
  const long long n = R * static_cast<long long>(C);
  if (v == kV)
    dx_variant<T, kV>(ct, x, out, mean, inv, coef, cb, cg, dx, dres, n / kV,
                      C, s);
  else
    dx_variant<T, 1>(ct, x, out, mean, inv, coef, cb, cg, dx, dres, n, C, s);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of the (R, C) tensors); params_bf16:
// gamma / beta (and dgamma / dbeta) are bfloat16 instead of float32.
// A null `res`, `out` or `dres` pointer switches that input or output off.
// The reductions take `part` (2, n_chunks, C floats, with the layout's
// n_chunks) on the streamed route and a null `part` on the cluster route.

extern "C" int epi_stats(const void* x, int dtype, long long R, int C,
                         const void* gamma, const void* beta, int params_bf16,
                         float eps, int fix_gamma, void* part, int n_chunks,
                         void* mean, void* var, void* inv, void* scale,
                         void* shift, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return launch_stats<float>(x, R, C, gamma, beta, params_bf16, eps,
                               fix_gamma, f(part), n_chunks, f(mean), f(var),
                               f(inv), f(scale), f(shift), s);
  if (dtype == 1)
    return launch_stats<__nv_bfloat16>(x, R, C, gamma, beta, params_bf16, eps,
                                       fix_gamma, f(part), n_chunks, f(mean),
                                       f(var), f(inv), f(scale), f(shift), s);
  return cudaErrorInvalidValue;
}

// The reduction layout of (R, C) rows of dtype (`epi_layout`, with the
// cluster size K the cluster route launches with on the current device):
// out[0..8] = V, L, W, route (1: cluster), tx, ty, tiles, n_chunks, K.
extern "C" int epi_layout_query(int dtype, long long R, int C, int aligned,
                                int* out) {
  Layout y;
  int K;
  if (dtype == 0) {
    y = epi_layout<float>(R, C, aligned != 0);
    K = y.V == 4 ? cluster_k<float, 4, kStats>(y.tiles)
                 : cluster_k<float, 1, kStats>(y.tiles);
  } else if (dtype == 1) {
    y = epi_layout<__nv_bfloat16>(R, C, aligned != 0);
    K = y.V == 8 ? cluster_k<__nv_bfloat16, 8, kStats>(y.tiles)
                 : cluster_k<__nv_bfloat16, 1, kStats>(y.tiles);
  } else {
    return cudaErrorInvalidValue;
  }
  const int v[9] = {y.V, y.L, y.W, y.cluster ? 1 : 0, y.tx, y.ty, y.tiles,
                    y.n_chunks, K};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return cudaSuccess;
}

extern "C" int epi_apply(const void* x, const void* res, int dtype,
                         long long R, int C, const void* scale,
                         const void* shift, int relu, void* out,
                         void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto sc = static_cast<const float*>(scale);
  auto sh = static_cast<const float*>(shift);
  if (dtype == 0) return launch_apply<float>(x, res, sc, sh, out, R, C, relu, s);
  if (dtype == 1)
    return launch_apply<__nv_bfloat16>(x, res, sc, sh, out, R, C, relu, s);
  return cudaErrorInvalidValue;
}

extern "C" int epi_bwd_reduce(const void* ct, const void* x, const void* out,
                              int dtype, long long R, int C, const void* mean,
                              const void* inv, const void* gamma,
                              int params_bf16, int fix_gamma, void* part,
                              int n_chunks, void* dgamma, void* dbeta,
                              void* coef, void* cb, void* cg, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  auto f = [](void* p) { return static_cast<float*>(p); };
  if (dtype == 0)
    return launch_bwd_reduce<float>(ct, x, out, cf(mean), cf(inv), R, C, gamma,
                                    params_bf16, fix_gamma, f(part), n_chunks,
                                    dgamma, dbeta, f(coef), f(cb), f(cg), s);
  if (dtype == 1)
    return launch_bwd_reduce<__nv_bfloat16>(
        ct, x, out, cf(mean), cf(inv), R, C, gamma, params_bf16, fix_gamma,
        f(part), n_chunks, dgamma, dbeta, f(coef), f(cb), f(cg), s);
  return cudaErrorInvalidValue;
}

extern "C" int epi_bwd_dx(const void* ct, const void* x, const void* out,
                          int dtype, long long R, int C, const void* mean,
                          const void* inv, const void* coef, const void* cb,
                          const void* cg, void* dx, void* dres, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto cf = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == 0)
    return launch_bwd_dx<float>(ct, x, out, cf(mean), cf(inv), cf(coef),
                                cf(cb), cf(cg), dx, dres, R, C, s);
  if (dtype == 1)
    return launch_bwd_dx<__nv_bfloat16>(ct, x, out, cf(mean), cf(inv),
                                        cf(coef), cf(cb), cf(cg), dx, dres, R,
                                        C, s);
  return cudaErrorInvalidValue;
}
