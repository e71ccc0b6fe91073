// Flash attention for Hopper (sm_90a), plain C interface: the forward, and
// the two backward kernels (dQ; dK and dV).
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas_kernels.py, reached
// through flash_attention (:334):
//   _fwd_kernel      (:57,  pl.pallas_call at :125)  -> flash_fwd
//   _bwd_dq_kernel   (:163, pl.pallas_call at :261)  -> flash_bwd_dq
//   _bwd_dkv_kernel  (:201, pl.pallas_call at :286)  -> flash_bwd_dkv
//
//   q, dout        (BH, Lq, D)  float32 or bfloat16, contiguous
//   k, v           (BH, Lk, D)  the same dtype
//   lse, delta     (BH, Lq)     float32: the forward's per-row logsumexp,
//                               and sum(dout * out) over D (computed by the
//                               caller, as the JAX package did outside its
//                               kernels)
//   out, dq        (BH, Lq, D)  the input dtype
//   dk, dv         (BH, Lk, D)  the input dtype
//
// Any Lq >= 1, Lk >= 1 and 1 <= D <= 128. Causal keeps the top-left
// diagonal (key col <= query row), as the TPU kernel. Scores, softmax state
// and every accumulator are f32 for both input dtypes.
//
// Bound on the card. At BERT-base's shape (BH = 96, L = 512, D = 64, bf16)
// the forward is bound by its bytes (q, k, v and out read or written once,
// 25 MB), the two backward kernels by their FLOPs (4 and 5 products of
// L x L x D per head) at the tensor cores' rate. These kernels do their
// products on the f32 FMA units (67 TFLOP/s), not the tensor cores, so
// they stay well above that bound: a right, simple kernel first; mma.sync
// or wgmma tiles are later work. What the design does:
//   * Blocks run in no order on 132 SMs, so nothing carries between them.
//     The TPU grid walked k-blocks (or q-blocks) as a sequential grid
//     dimension; here that walk is a loop INSIDE the block. The forward
//     and dQ blocks each own one 64-row q tile and loop over 64-row k
//     tiles; a dK/dV block owns one 64-row k tile and loops over q tiles.
//     No block writes another's output: no atomics, and two runs give the
//     same bits.
//   * The streamed tiles are staged in shared memory as f32 with a row
//     pitch of D + 1 words, so the 8 lanes that read 8 different rows at
//     one column hit 8 different banks. The 64 x 64 score tile goes through
//     shared memory too (pitch 65) between the two products.
//   * 128 threads a block; thread t owns rows 4 * (t / 8) .. + 3 of the
//     tile, score columns (t % 8) + 8 j, and output columns (t % 8) + 8 e.
//     The 8 lanes of one row group reduce a row's max and sum with three
//     warp shuffles.
//   * Ragged tails are handled by loop bounds and masks: a tile row past
//     the end is staged as zeros and masked, never read from device
//     memory. The TPU's padding of L to a multiple of 128 and its
//     (BH, 8, Lq) lse layout (a sublane-tiling need) are gone.
//   * Causal: a q tile stops at the last k tile its rows can see; a k tile
//     starts at the first q tile that can see it.
// Numerics kept from the TPU kernel: the finite -1e30 mask, l clamped at
// 1e-30 (a fully masked row gives no NaN), p recomputed from lse in the
// backward.
//
// Shared memory: up to 166 KB a block (dK/dV at D = 128), set with
// cudaFuncSetAttribute before each launch. Kernels launch on the caller's
// stream, allocate nothing and do not synchronise; each entry point
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;          // rows of a q tile and of a k tile
constexpr int kPitchS = kTile + 1;  // row pitch of a score tile in smem
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// max / sum over the 8 lanes of one row group (lanes 8g .. 8g + 7)
__device__ __forceinline__ float group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  return x;
}

// Stage rows [0, 64) of a tile that starts at `src` (row length D) into
// `dst` as f32 times `scale`, row pitch D + 1. Rows at or past `avail` are
// zeros and are not read.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst,
                                          const T* __restrict__ src,
                                          int avail, int D, float scale) {
  const int pitch = D + 1;
  const int n = kTile * D;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    dst[r * pitch + d] =
        r < avail ? to_f32(src[static_cast<size_t>(r) * D + d]) * scale
                  : 0.f;
  }
}

// s[i][j] = sum_d A[4 rg + i][d] * B[8 j + cg][d] over two staged tiles
__device__ __forceinline__ void tile_dot(float (&s)[4][8],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B, int D,
                                         int rg, int cg) {
  const int pitch = D + 1;
  const float* a0 = A + rg * 4 * pitch;
  const float* b0 = B + cg * pitch;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = a0[i * pitch + d];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = b0[j * 8 * pitch + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

// acc[i][e] += sum_k S[4 rg + i][k] * M[k][8 e + cg] over the 64 rows of a
// staged (64, D) tile M and a staged 64 x 64 score tile S
template <int NE>
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][NE],
                                                const float* __restrict__ S,
                                                const float* __restrict__ M,
                                                int D, int rg, int cg) {
  const int pitch = D + 1;
  const float* s0 = S + rg * 4 * kPitchS;
#pragma unroll 4
  for (int k = 0; k < kTile; ++k) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = s0[i * kPitchS + k];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = e * 8 + cg;
      const float m = d < D ? M[k * pitch + d] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][e] = fmaf(p[i], m, acc[i][e]);
    }
  }
}

// rows 4 rg + i of acc into the (rows, D) output starting at `dst`, for
// rows below `avail`
template <typename T, int NE>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const float (&acc)[4][NE],
                                           int avail, int D, int rg,
                                           int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (r >= avail) continue;
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      const int d = e * 8 + cg;
      if (d < D) store(dst + static_cast<size_t>(r) * D + d, acc[i][e]);
    }
  }
}

// number of k tiles a q tile starting at q0 reads
__device__ __forceinline__ int k_tiles(int q0, int Lq, int Lk, int causal) {
  int n = (Lk + kTile - 1) / kTile;
  if (causal) n = min(n, (min(Lq, q0 + kTile) - 1) / kTile + 1);
  return n;
}

// ---------------------------------------------------------------------------
// forward: out = softmax(q k^T * scale) v per head, and lse per row
// ---------------------------------------------------------------------------
template <typename T, int NE>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Lq, int Lk, int D, float scale,
                 int causal) {
  extern __shared__ float smem[];
  const int pitch = D + 1;
  float* sQ = smem;
  float* sK = sQ + kTile * pitch;
  float* sV = sK + kTile * pitch;
  float* sP = sV + kTile * pitch;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int rg = threadIdx.x >> 3;
  const int cg = threadIdx.x & 7;
  const size_t qoff = static_cast<size_t>(bh) * Lq * D;
  const size_t koff = static_cast<size_t>(bh) * Lk * D;

  // q is scaled as it is staged, as the TPU kernel scales it (:64)
  load_tile(sQ, q + qoff + static_cast<size_t>(q0) * D, Lq - q0, D, scale);
  float m[4], l[4], acc[4][NE];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = 0.f;
  }

  const int n_k = k_tiles(q0, Lq, Lk, causal);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();  // the last tile's readers are done
    load_tile(sK, k + koff + static_cast<size_t>(k0) * D, Lk - k0, D, 1.f);
    load_tile(sV, v + koff + static_cast<size_t>(k0) * D, Lk - k0, D, 1.f);
    __syncthreads();
    float s[4][8];
    tile_dot(s, sQ, sK, D, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + j * 8 + cg;
        const bool ok = col < Lk && (!causal || col <= row);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        sP[(rg * 4 + i) * kPitchS + j * 8 + cg] = p;
      }
      sum = group_sum(sum);
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[i][e] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();
    tile_accumulate(acc, sP, sV, D, rg, cg);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = acc[i][e] / lc;
    const int row = q0 + rg * 4 + i;
    if (cg == 0 && row < Lq)
      lse[static_cast<size_t>(bh) * Lq + row] = m[i] + logf(lc);
  }
  store_rows(out + qoff + static_cast<size_t>(q0) * D, acc, Lq - q0, D, rg,
             cg);
}

// ---------------------------------------------------------------------------
// dQ: dq = sum over k tiles of dS k, dS = p * (dO v^T - delta) * scale,
// p = exp(q k^T * scale - lse)
// ---------------------------------------------------------------------------
template <typename T, int NE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int Lq, int Lk, int D, float scale, int causal) {
  extern __shared__ float smem[];
  const int pitch = D + 1;
  float* sQ = smem;
  float* sO = sQ + kTile * pitch;  // dout
  float* sK = sO + kTile * pitch;
  float* sV = sK + kTile * pitch;
  float* sS = sV + kTile * pitch;
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int rg = threadIdx.x >> 3;
  const int cg = threadIdx.x & 7;
  const size_t qoff = static_cast<size_t>(bh) * Lq * D;
  const size_t koff = static_cast<size_t>(bh) * Lk * D;

  load_tile(sQ, q + qoff + static_cast<size_t>(q0) * D, Lq - q0, D, 1.f);
  load_tile(sO, dout + qoff + static_cast<size_t>(q0) * D, Lq - q0, D, 1.f);
  float lse_r[4], delta_r[4], acc[4][NE];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + rg * 4 + i;
    const size_t at = static_cast<size_t>(bh) * Lq + row;
    lse_r[i] = row < Lq ? lse[at] : 0.f;
    delta_r[i] = row < Lq ? delta[at] : 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[i][e] = 0.f;
  }

  const int n_k = k_tiles(q0, Lq, Lk, causal);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile(sK, k + koff + static_cast<size_t>(k0) * D, Lk - k0, D, 1.f);
    load_tile(sV, v + koff + static_cast<size_t>(k0) * D, Lk - k0, D, 1.f);
    __syncthreads();
    float s[4][8], dp[4][8];
    tile_dot(s, sQ, sK, D, rg, cg);
    tile_dot(dp, sO, sV, D, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = k0 + j * 8 + cg;
        const bool ok = row < Lq && col < Lk && (!causal || col <= row);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sS[(rg * 4 + i) * kPitchS + j * 8 + cg] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    tile_accumulate(acc, sS, sK, D, rg, cg);
  }
  store_rows(dq + qoff + static_cast<size_t>(q0) * D, acc, Lq - q0, D, rg,
             cg);
}

// ---------------------------------------------------------------------------
// dK, dV: over q tiles, dv += p^T dO and dk += dS^T q, with p and dS as in
// the dQ kernel, computed transposed (rows are keys, columns queries)
// ---------------------------------------------------------------------------
template <typename T, int NE>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int Lq, int Lk, int D, float scale,
                     int causal) {
  extern __shared__ float smem[];
  const int pitch = D + 1;
  float* sK = smem;
  float* sV = sK + kTile * pitch;
  float* sQ = sV + kTile * pitch;
  float* sO = sQ + kTile * pitch;  // dout
  float* sP = sO + kTile * pitch;
  float* sS = sP + kTile * kPitchS;
  float* sL = sS + kTile * kPitchS;  // lse of the q tile's rows
  float* sD = sL + kTile;            // delta of the q tile's rows
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int rg = threadIdx.x >> 3;
  const int cg = threadIdx.x & 7;
  const size_t qoff = static_cast<size_t>(bh) * Lq * D;
  const size_t koff = static_cast<size_t>(bh) * Lk * D;

  load_tile(sK, k + koff + static_cast<size_t>(k0) * D, Lk - k0, D, 1.f);
  load_tile(sV, v + koff + static_cast<size_t>(k0) * D, Lk - k0, D, 1.f);
  float acc_k[4][NE], acc_v[4][NE];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      acc_k[i][e] = 0.f;
      acc_v[i][e] = 0.f;
    }

  const int n_q = (Lq + kTile - 1) / kTile;
  // causal: q rows below k0 see none of this tile's keys
  for (int qt = causal ? blockIdx.y : 0; qt < n_q; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile(sQ, q + qoff + static_cast<size_t>(q0) * D, Lq - q0, D, 1.f);
    load_tile(sO, dout + qoff + static_cast<size_t>(q0) * D, Lq - q0, D,
              1.f);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const size_t at = static_cast<size_t>(bh) * Lq + row;
      sL[threadIdx.x] = row < Lq ? lse[at] : 0.f;
      sD[threadIdx.x] = row < Lq ? delta[at] : 0.f;
    }
    __syncthreads();
    float s[4][8];
    tile_dot(s, sK, sQ, D, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = q0 + j * 8 + cg;
        const bool ok = key < Lk && row < Lq && (!causal || key <= row);
        sP[(rg * 4 + i) * kPitchS + j * 8 + cg] =
            ok ? expf(s[i][j] * scale - sL[j * 8 + cg]) : 0.f;
      }
    }
    tile_dot(s, sV, sO, D, rg, cg);  // dP^T
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int at = (rg * 4 + i) * kPitchS + j * 8 + cg;
        sS[at] = sP[at] * (s[i][j] - sD[j * 8 + cg]) * scale;
      }
    __syncthreads();
    tile_accumulate(acc_v, sP, sO, D, rg, cg);
    tile_accumulate(acc_k, sS, sQ, D, rg, cg);
  }
  store_rows(dk + koff + static_cast<size_t>(k0) * D, acc_k, Lk - k0, D, rg,
             cg);
  store_rows(dv + koff + static_cast<size_t>(k0) * D, acc_v, Lk - k0, D, rg,
             cg);
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

bool shape_ok(int BH, int Lq, int Lk, int D) {
  return BH >= 1 && Lq >= 1 && Lk >= 1 && D >= 1 && D <= 128 &&
         (Lq + kTile - 1) / kTile <= 65535 &&
         (Lk + kTile - 1) / kTile <= 65535;
}

size_t tile_bytes(int D) {
  return sizeof(float) * static_cast<size_t>(kTile) * (D + 1);
}
constexpr size_t kScoreBytes = sizeof(float) * kTile * kPitchS;

// allow `smem` bytes of dynamic shared memory (above 48 KB a kernel needs
// the attribute set)
template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// NE (output columns a thread owns, 8 apart) from D
#define FLASH_DISPATCH(D, ...)  \
  do {                           \
    if ((D) <= 16) {             \
      constexpr int NE = 2;      \
      __VA_ARGS__                \
    } else if ((D) <= 32) {      \
      constexpr int NE = 4;      \
      __VA_ARGS__                \
    } else if ((D) <= 64) {      \
      constexpr int NE = 8;      \
      __VA_ARGS__                \
    } else {                     \
      constexpr int NE = 16;     \
      __VA_ARGS__                \
    }                            \
  } while (0)

template <typename T>
int fwd(const T* q, const T* k, const T* v, T* out, float* lse, int BH,
        int Lq, int Lk, int D, float scale, int causal,
        cudaStream_t stream) {
  if (!shape_ok(BH, Lq, Lk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH, (Lq + kTile - 1) / kTile);
  const size_t smem = 3 * tile_bytes(D) + kScoreBytes;
  FLASH_DISPATCH(D, {
    auto kernel = flash_fwd_kernel<T, NE>;
    const int rc = set_smem(kernel, smem);
    if (rc != 0) return rc;
    kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, lse, Lq, Lk, D,
                                             scale, causal);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dq(const T* q, const T* k, const T* v, const T* dout,
           const float* lse, const float* delta, T* dq, int BH, int Lq,
           int Lk, int D, float scale, int causal, cudaStream_t stream) {
  if (!shape_ok(BH, Lq, Lk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH, (Lq + kTile - 1) / kTile);
  const size_t smem = 4 * tile_bytes(D) + kScoreBytes;
  FLASH_DISPATCH(D, {
    auto kernel = flash_bwd_dq_kernel<T, NE>;
    const int rc = set_smem(kernel, smem);
    if (rc != 0) return rc;
    kernel<<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dq,
                                             Lq, Lk, D, scale, causal);
  });
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd_dkv(const T* q, const T* k, const T* v, const T* dout,
            const float* lse, const float* delta, T* dk, T* dv, int BH,
            int Lq, int Lk, int D, float scale, int causal,
            cudaStream_t stream) {
  if (!shape_ok(BH, Lq, Lk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH, (Lk + kTile - 1) / kTile);
  const size_t smem =
      4 * tile_bytes(D) + 2 * kScoreBytes + 2 * sizeof(float) * kTile;
  FLASH_DISPATCH(D, {
    auto kernel = flash_bwd_dkv_kernel<T, NE>;
    const int rc = set_smem(kernel, smem);
    if (rc != 0) return rc;
    kernel<<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dk,
                                             dv, Lq, Lk, D, scale, causal);
  });
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* out, void* lse, int dtype, int BH, int Lq,
                         int Lk, int D, float scale, int causal,
                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return fwd(static_cast<const float*>(q), static_cast<const float*>(k),
               static_cast<const float*>(v), static_cast<float*>(out), l, BH,
               Lq, Lk, D, scale, causal, s);
  if (dtype == 1)
    return fwd(static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<__nv_bfloat16*>(out), l, BH, Lq, Lk, D, scale,
               causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int dtype, int BH,
                            int Lq, int Lk, int D, float scale, int causal,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return bwd_dq(static_cast<const float*>(q), static_cast<const float*>(k),
                  static_cast<const float*>(v),
                  static_cast<const float*>(dout), l, dl,
                  static_cast<float*>(dq), BH, Lq, Lk, D, scale, causal, s);
  if (dtype == 1)
    return bwd_dq(static_cast<const __nv_bfloat16*>(q),
                  static_cast<const __nv_bfloat16*>(k),
                  static_cast<const __nv_bfloat16*>(v),
                  static_cast<const __nv_bfloat16*>(dout), l, dl,
                  static_cast<__nv_bfloat16*>(dq), BH, Lq, Lk, D, scale,
                  causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv,
                             int dtype, int BH, int Lq, int Lk, int D,
                             float scale, int causal, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  if (dtype == 0)
    return bwd_dkv(static_cast<const float*>(q),
                   static_cast<const float*>(k), static_cast<const float*>(v),
                   static_cast<const float*>(dout), l, dl,
                   static_cast<float*>(dk), static_cast<float*>(dv), BH, Lq,
                   Lk, D, scale, causal, s);
  if (dtype == 1)
    return bwd_dkv(static_cast<const __nv_bfloat16*>(q),
                   static_cast<const __nv_bfloat16*>(k),
                   static_cast<const __nv_bfloat16*>(v),
                   static_cast<const __nv_bfloat16*>(dout), l, dl,
                   static_cast<__nv_bfloat16*>(dk),
                   static_cast<__nv_bfloat16*>(dv), BH, Lq, Lk, D, scale,
                   causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
