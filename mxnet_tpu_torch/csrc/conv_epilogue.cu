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
//     aligned; otherwise one element a thread. Any C >= 1 is taken.
//   * The TPU kernels ran the row grid in order and added every block's sum
//     into one output block that step 0 zeroed. Blocks here run in
//     parallel in no order, so the two reductions are two passes: pass 1
//     is a 2-D grid of (row chunk, channel tile) blocks, neighbouring
//     threads on neighbouring channels, each block's column sums reduced
//     in shared memory and written to a float workspace (2, n_chunks, C);
//     pass 2 sums the chunks of each channel in a fixed order and does the
//     per-channel finishing math. No atomics: the result is the same bits
//     on every run.
//   * The elementwise kernels read the per-channel float vectors by
//     channel index (element index mod C), 16 bytes at a time, from L1.
// Numerics kept from the TPU kernels: float accumulation for bf16 inputs,
// the proxy-shifted one-pass moments, var = max(E[d^2] - E[d]^2, 0), and
// the ReLU mask taken from the saved output (out > 0).
//
// The kernels launch on the caller's stream, allocate nothing and do not
// synchronise. Each entry point returns cudaGetLastError() after its
// launches (cudaErrorInvalidValue for arguments it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kProxyRows = 8;     // rows averaged into the stats proxy
constexpr int kThreads = 256;     // threads of a pass-1 or elementwise block
constexpr int kFinishLanes = 32;  // chunk lanes of a pass-2 block
constexpr int kMaxGrid = 132 * 32;  // elementwise grid cap (grid-stride)

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
// every block and the finishing pass get the same bits
template <typename T>
__device__ __forceinline__ float proxy_of(const T* x, long long R, int C,
                                          int c) {
  const int n = R < kProxyRows ? static_cast<int>(R) : kProxyRows;
  float s = 0.f;
  for (int i = 0; i < n; ++i) s += to_f32(x[static_cast<long long>(i) * C + c]);
  return s / static_cast<float>(n);
}

// Pass-1 tail shared by both reductions: the block's (blockDim.y) partial
// sums of each of its channels are added in a fixed tree order in shared
// memory, and row ty = 0 writes the block's two column sums to
// part[0 or 1][chunk][c].
template <int V>
__device__ __forceinline__ void block_column_sums(float* sm, const float (&s1)[V],
                                                  const float (&s2)[V],
                                                  bool live, int c0, int C,
                                                  float* part, int n_chunks) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int w = blockDim.x * V;  // channels of this block
  float* a = sm;
  float* b = sm + blockDim.y * w;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    a[ty * w + tx * V + k] = s1[k];
    b[ty * w + tx * V + k] = s2[k];
  }
  __syncthreads();
  for (int s = blockDim.y / 2; s > 0; s >>= 1) {
    if (ty < s) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a[ty * w + tx * V + k] += a[(ty + s) * w + tx * V + k];
        b[ty * w + tx * V + k] += b[(ty + s) * w + tx * V + k];
      }
    }
    __syncthreads();
  }
  if (ty == 0 && live) {
    const long long chunk = blockIdx.x;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      part[chunk * C + c0 + k] = a[tx * V + k];
      part[(n_chunks + chunk) * C + c0 + k] = b[tx * V + k];
    }
  }
}

// ---------------------------------------------------------------------------
// epi_stats, pass 1: per chunk of rows, per channel, sum(d) and sum(d^2)
// ---------------------------------------------------------------------------
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
stats_partial(const T* __restrict__ x, long long R, int C,
              long long rows_per_chunk, float* __restrict__ part,
              int n_chunks) {
  extern __shared__ float sm[];  // 2 * blockDim.y * w sums, then w proxies
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int w = blockDim.x * V;
  const int c0 = (blockIdx.y * blockDim.x + tx) * V;
  // with V > 1 the host guarantees C % V == 0, so the thread's V channels
  // are all live or all past the edge
  const bool live = c0 < C;
  float* prox = sm + 2 * blockDim.y * w;
  if (ty == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k)
      prox[tx * V + k] = live ? proxy_of(x, R, C, c0 + k) : 0.f;
  }
  __syncthreads();
  float p[V], s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    p[k] = prox[tx * V + k];
    s1[k] = 0.f;
    s2[k] = 0.f;
  }
  const long long r0 = blockIdx.x * rows_per_chunk;
  const long long r1 = r0 + rows_per_chunk < R ? r0 + rows_per_chunk : R;
  if (live) {
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += blockDim.y) {
      float v[V];
      load<T, V>(x + r * C + c0, v);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float d = v[k] - p[k];
        s1[k] += d;
        s2[k] += d * d;
      }
    }
  }
  block_column_sums<V>(sm, s1, s2, live, c0, C, part, n_chunks);
}

// epi_stats, pass 2: one thread column per channel, kFinishLanes lanes
// over the chunks, lanes added in order; then the finishing math
template <typename T>
__global__ void stats_finish(const float* __restrict__ part, int n_chunks,
                             const T* __restrict__ x, long long R, int C,
                             const void* gamma, const void* beta,
                             int params_bf16, float eps, int fix_gamma,
                             float* __restrict__ mean, float* __restrict__ var,
                             float* __restrict__ inv,
                             float* __restrict__ scale,
                             float* __restrict__ shift) {
  __shared__ float sa[kFinishLanes][33];
  __shared__ float sb[kFinishLanes][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int k = ty; k < n_chunks; k += kFinishLanes) {
      a += part[static_cast<long long>(k) * C + c];
      b += part[static_cast<long long>(n_chunks + k) * C + c];
    }
  }
  sa[ty][tx] = a;
  sb[ty][tx] = b;
  __syncthreads();
  if (ty != 0 || c >= C) return;
  float s1 = 0.f, s2 = 0.f;
  for (int j = 0; j < kFinishLanes; ++j) {
    s1 += sa[j][tx];
    s2 += sb[j][tx];
  }
  const float rows = static_cast<float>(R);
  s1 /= rows;
  s2 /= rows;
  const float m = proxy_of(x, R, C, c) + s1;
  const float v = fmaxf(s2 - s1 * s1, 0.f);
  const float iv = 1.f / sqrtf(v + eps);
  const float g = fix_gamma ? 1.f : param_at(gamma, params_bf16, c);
  const float sc = g * iv;
  mean[c] = m;
  var[c] = v;
  inv[c] = iv;
  scale[c] = sc;
  shift[c] = param_at(beta, params_bf16, c) - m * sc;
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
// epi_bwd_reduce, pass 1: per chunk, per channel, sum(g), sum(g * xhat)
// ---------------------------------------------------------------------------
template <typename T, int V, bool RELU>
__global__ void __launch_bounds__(kThreads)
bwd_reduce_partial(const T* __restrict__ ct, const T* __restrict__ x,
                   const T* __restrict__ out, const float* __restrict__ mean,
                   const float* __restrict__ inv, long long R, int C,
                   long long rows_per_chunk, float* __restrict__ part,
                   int n_chunks) {
  extern __shared__ float sm[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c0 = (blockIdx.y * blockDim.x + tx) * V;
  const bool live = c0 < C;
  float m[V], iv[V], s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    m[k] = live ? mean[c0 + k] : 0.f;
    iv[k] = live ? inv[c0 + k] : 0.f;
    s1[k] = 0.f;
    s2[k] = 0.f;
  }
  const long long r0 = blockIdx.x * rows_per_chunk;
  const long long r1 = r0 + rows_per_chunk < R ? r0 + rows_per_chunk : R;
  if (live) {
#pragma unroll 4
    for (long long r = r0 + ty; r < r1; r += blockDim.y) {
      const long long e = r * C + c0;
      float g[V], xv[V];
      load<T, V>(ct + e, g);
      load<T, V>(x + e, xv);
      if (RELU) {
        float o[V];
        load<T, V>(out + e, o);
#pragma unroll
        for (int k = 0; k < V; ++k) g[k] = o[k] > 0.f ? g[k] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < V; ++k) {
        s1[k] += g[k];
        s2[k] += g[k] * ((xv[k] - m[k]) * iv[k]);
      }
    }
  }
  block_column_sums<V>(sm, s1, s2, live, c0, C, part, n_chunks);
}

// epi_bwd_reduce, pass 2: fixed-order sums, then dgamma, dbeta and the dx
// coefficients
__global__ void bwd_reduce_finish(const float* __restrict__ part,
                                  int n_chunks, long long R, int C,
                                  const float* __restrict__ inv,
                                  const void* gamma, int params_bf16,
                                  int fix_gamma, void* dgamma, void* dbeta,
                                  float* __restrict__ coef,
                                  float* __restrict__ cb,
                                  float* __restrict__ cg) {
  __shared__ float sa[kFinishLanes][33];
  __shared__ float sb[kFinishLanes][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int k = ty; k < n_chunks; k += kFinishLanes) {
      a += part[static_cast<long long>(k) * C + c];
      b += part[static_cast<long long>(n_chunks + k) * C + c];
    }
  }
  sa[ty][tx] = a;
  sb[ty][tx] = b;
  __syncthreads();
  if (ty != 0 || c >= C) return;
  float db = 0.f, dg = 0.f;
  for (int j = 0; j < kFinishLanes; ++j) {
    db += sa[j][tx];
    dg += sb[j][tx];
  }
  const float rows = static_cast<float>(R);
  const float g = fix_gamma ? 1.f : param_at(gamma, params_bf16, c);
  coef[c] = g * inv[c];
  cb[c] = db / rows;
  cg[c] = dg / rows;
  param_put(dgamma, params_bf16, c, fix_gamma ? 0.f : dg);
  param_put(dbeta, params_bf16, c, db);
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

// pass-1 geometry: tx threads across channel packs (a power of two up to
// 32), kThreads / tx rows in flight
struct ReduceGeom {
  dim3 grid, block;
  size_t smem;
  long long rows_per_chunk;
};

inline bool reduce_geom(long long R, int C, int v, int n_chunks,
                        int extra_floats_per_col, ReduceGeom* g) {
  const int packs = (C + v - 1) / v;
  int tx = 1;
  while (tx < packs && tx < 32) tx <<= 1;
  const int ty = kThreads / tx;
  const int tiles = (packs + tx - 1) / tx;
  if (tiles > 65535) return false;
  g->block = dim3(tx, ty);
  g->grid = dim3(n_chunks, tiles);
  g->smem = (2 * ty + extra_floats_per_col) * tx * v * sizeof(float);
  g->rows_per_chunk = (R + n_chunks - 1) / n_chunks;
  return true;
}

inline int elementwise_grid(long long n_packs) {
  const long long blocks = (n_packs + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxGrid ? blocks : kMaxGrid);
}

inline dim3 finish_grid(int C) { return dim3((C + 31) / 32); }

template <typename T>
int launch_stats(const void* x_, long long R, int C, const void* gamma,
                 const void* beta, int params_bf16, float eps, int fix_gamma,
                 float* part, int n_chunks, float* mean, float* var,
                 float* inv, float* scale, float* shift, cudaStream_t s) {
  if (R < 1 || C < 1 || n_chunks < 1) return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(x_);
  constexpr int kV = 16 / sizeof(T);
  const int v = pack_width<T>(C, x, nullptr, nullptr, nullptr);
  ReduceGeom g;
  if (!reduce_geom(R, C, v, n_chunks, 1, &g)) return cudaErrorInvalidValue;
  if (v == kV)
    stats_partial<T, kV><<<g.grid, g.block, g.smem, s>>>(
        x, R, C, g.rows_per_chunk, part, n_chunks);
  else
    stats_partial<T, 1><<<g.grid, g.block, g.smem, s>>>(
        x, R, C, g.rows_per_chunk, part, n_chunks);
  stats_finish<T><<<finish_grid(C), dim3(32, kFinishLanes), 0, s>>>(
      part, n_chunks, x, R, C, gamma, beta, params_bf16, eps, fix_gamma, mean,
      var, inv, scale, shift);
  return cudaGetLastError();
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

template <typename T>
int launch_bwd_reduce(const void* ct_, const void* x_, const void* out_,
                      const float* mean, const float* inv, long long R, int C,
                      const void* gamma, int params_bf16, int fix_gamma,
                      float* part, int n_chunks, void* dgamma, void* dbeta,
                      float* coef, float* cb, float* cg, cudaStream_t s) {
  if (R < 1 || C < 1 || n_chunks < 1) return cudaErrorInvalidValue;
  const T* ct = static_cast<const T*>(ct_);
  const T* x = static_cast<const T*>(x_);
  const T* out = static_cast<const T*>(out_);
  constexpr int kV = 16 / sizeof(T);
  const int v = pack_width<T>(C, ct, x, out, nullptr);
  ReduceGeom g;
  if (!reduce_geom(R, C, v, n_chunks, 0, &g)) return cudaErrorInvalidValue;
  const long long rpc = g.rows_per_chunk;
  if (v == kV && out)
    bwd_reduce_partial<T, kV, true><<<g.grid, g.block, g.smem, s>>>(
        ct, x, out, mean, inv, R, C, rpc, part, n_chunks);
  else if (v == kV)
    bwd_reduce_partial<T, kV, false><<<g.grid, g.block, g.smem, s>>>(
        ct, x, out, mean, inv, R, C, rpc, part, n_chunks);
  else if (out)
    bwd_reduce_partial<T, 1, true><<<g.grid, g.block, g.smem, s>>>(
        ct, x, out, mean, inv, R, C, rpc, part, n_chunks);
  else
    bwd_reduce_partial<T, 1, false><<<g.grid, g.block, g.smem, s>>>(
        ct, x, out, mean, inv, R, C, rpc, part, n_chunks);
  bwd_reduce_finish<<<finish_grid(C), dim3(32, kFinishLanes), 0, s>>>(
      part, n_chunks, R, C, inv, gamma, params_bf16, fix_gamma, dgamma, dbeta,
      coef, cb, cg);
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
