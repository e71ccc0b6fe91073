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
//   lse, delta     (BH, Lq)     float32: the forward's per-row logsumexp
//                               (natural log), and sum(dout * out) over D
//                               (computed by the caller, as the JAX
//                               package did outside its kernels)
//   out, dq        (BH, Lq, D)  the input dtype
//   dk, dv         (BH, Lk, D)  the input dtype
//
// Any Lq >= 1, Lk >= 1 and 1 <= D <= 128. Causal keeps the top-left
// diagonal (key col <= query row), as the TPU kernel. Scores, softmax state
// and every accumulator are f32 for both input dtypes.
//
// Which kernel serves which call:
//   flash_fwd      bf16: flash_fwd_mma_kernel (tensor cores)
//                  f32:  flash_fwd_kernel (f32 FMA units)
//   flash_bwd_dq   bf16: flash_bwd_dq_mma_kernel (tensor cores)
//                  f32:  flash_bwd_dq_kernel (f32 FMA units)
//   flash_bwd_dkv  bf16: flash_bwd_dkv_mma_kernel (tensor cores)
//                  f32:  flash_bwd_dkv_kernel (f32 FMA units)
//
// Bound on the card. At BERT-base's shape (BH = 96, L = 512, D = 64, bf16)
// the forward is bound by its bytes (q, k, v and out read or written once,
// 25 MB, 0.0076 ms at 3.35 TB/s), the two backward kernels by their FLOPs
// (3 and 4 products of L x L x D per head) at the tensor cores' 989 TFLOP/s.
// Every one of them does 2 L^2 D FLOPs per product, so on the f32 FMA units
// (67 TFLOP/s) the products, not the bytes, set the time; only the tensor
// cores bring the kernels near their bounds.
//
// The tensor-core kernels (bf16). Each block owns one 64-row tile (q rows in
// the forward and dQ, keys in dK/dV) and loops over the other side's
// 64-row tiles; 4 warps, each owning 16 rows of the tile.
//   * Tiles stay bf16 in shared memory, row pitch DP + 8 elements (DP = D
//     rounded up to 16, the padded columns zero, so the k-dimension of
//     every product is whole k16 steps). The +8-element pad makes the row
//     pitch an odd number of 16-byte units, so the 8 row addresses of one
//     ldmatrix phase fall in 8 different bank groups: no conflicts, and no
//     swizzle to compute.
//   * The streamed tiles (K and V in the forward and dQ; q, dO, lse and
//     delta in dK/dV) go through a two-stage ring: the next tile's loads
//     are issued as 16-byte cp.async copies right after the barrier that
//     opens this tile, so they run under this tile's products; one
//     __syncthreads a tile. Rows past Lq or Lk are zero-filled (src-size
//     0, address clamped to the tile's first row). When D * 2 bytes is not
//     a multiple of 16 (or a pointer is not 16-byte aligned) the rows are
//     not 16-byte aligned, and the same tiles are staged with element
//     loads instead.
//   * Both products of a tile are mma.sync.aligned.m16n8k16 (bf16 in, f32
//     accumulate). q k^T reads B from k's rows with ldmatrix (no transpose);
//     P v reads v with ldmatrix.trans. The score tile stays in registers as
//     accumulator fragments: masking, the online-softmax max (two quad
//     shuffles) and the rescale happen there, and P is rounded to bf16 in
//     registers, since the C layout of two adjacent n8 tiles is the A layout
//     of one k16 step. Nothing goes through shared memory between the two
//     products.
//   * dQ computes S = q k^T and dP = dO v^T (k and v rows as B, no
//     transpose), forms P = exp2(S scale log2e - lse log2e) and
//     dS = P (dP - delta) in registers, and takes dQ += dS k with k through
//     ldmatrix.trans, the path of the forward's P v; sm_scale multiplies
//     the f32 sum once, at the store. Up to D = 64 the warp's q and dO
//     fragments are loaded once and held in registers; above, they are
//     re-read through ldmatrix every k tile (holding them would spill).
//     Each dQ row belongs to one warp: no atomics, no split over keys.
//   * dK/dV computes the transposed scores directly, S^T = k q^T and
//     dP^T = v dO^T (q and dO rows as B, no transpose), so P^T and
//     dS^T = P^T (dP^T - delta) are A fragments in registers for
//     dV += P^T dO and dK += dS^T q (dO and q through ldmatrix.trans). dK
//     and dV stay in registers for the block's 64 keys across all q tiles
//     and are written once: no atomics and no cross-block sum. The k and v
//     fragments are re-read from shared memory for every q tile rather
//     than held; at D > 112 (2 x 64 accumulators a thread) the q tile is
//     also taken in two passes of 32 rows, which halves the live score
//     fragments, so no instantiation spills.
//   * Softmax in base 2: the scores are scaled by sm_scale * log2(e) in one
//     multiply and exponentiated with exp2f. lse is still written and read
//     in natural-log units (the dQ kernel reads it).
//   * Rounding: P is rounded to bf16 before P v and P^T dO, and dS before
//     dS^T q and dS k (the sums stay f32; l sums the unrounded P).
//   * mma.sync and cp.async, not wgmma and TMA: at L = 512 and D <= 128 the
//     products are 64 x 64 x D per tile, which warp-level m16n8k16 tiles
//     cover with register-resident softmax state, as the FA2-class kernels
//     behind PyTorch's sdpa do at this size. wgmma wants 64-row warpgroup
//     tiles fed from swizzled shared memory and an asynchronous pipeline
//     with a producer warp; that is the next step, not this one.
//
// The FMA kernels (f32). f32 keeps them because the f32 BERT step on the
// card is held to the CPU's at rtol 1e-4, which TF32 or bf16 products
// would not meet. The tiles are staged as f32 with a row pitch of D + 1
// words, so the 8 lanes that read 8 different rows at one column hit 8
// different banks; the 64 x 64 score tile goes through shared memory
// (pitch 65) between the two products. Thread t owns rows
// 4 * (t / 8) .. + 3 of the tile, score columns (t % 8) + 8 j, and output
// columns (t % 8) + 8 e; the 8 lanes of one row group reduce a row's max
// and sum with three warp shuffles.
//
// Common to both: blocks run in no order on 132 SMs, so the TPU grid's
// sequential walk over k (or q) blocks is a loop inside the block, and no
// block writes another's output: two runs give the same bits. Ragged tails
// are handled by loop bounds and masks, never read from device memory; the
// TPU's padding of L to a multiple of 128 and its (BH, 8, Lq) lse layout
// are gone. Causal: a q tile stops at the last k tile its rows can see; a
// k tile starts at the first q tile that can see it. Numerics kept from the
// TPU kernel: the finite -1e30 mask, l clamped at 1e-30 (a fully masked
// row gives no NaN), p recomputed from lse in the backward.
//
// Shared memory: up to 166 KB a block (the f32 dK/dV at D = 128), set with
// cudaFuncSetAttribute before each launch. Kernels launch on the caller's
// stream, allocate nothing and do not synchronise; each entry point
// returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a
// shape it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 64;          // rows of a q tile and of a k tile
constexpr int kPitchS = kTile + 1;  // row pitch of a score tile in smem
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
// tensor-core kernels (bf16): mma.sync m16n8k16, ldmatrix, cp.async
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; with `valid` false nothing is read and
// the 16 bytes are zero-filled (src-size 0)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a b over one m16n8k16 step (bf16 in, f32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 in one register, `lo` in the low half (the
// lower column of a fragment pair)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment of one k16 step from the accumulators of two adjacent n8
// tiles (columns 16 kk .. 16 kk + 15 of a 16-row score tile), rounded
template <int N>
__device__ __forceinline__ void score_as_a(uint32_t (&a)[4],
                                           const float (&s)[N][4], int kk) {
  a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

template <int DP>
struct MmaTile {
  static constexpr int kPitch = DP + 8;  // elements; an odd count of 16 B
  static constexpr int kElems = kTile * kPitch;
  static constexpr int kBytes = kElems * 2;
  static constexpr int kSteps = DP / 16;  // k16 steps over D
  static constexpr int kOut = DP / 8;     // n8 tiles over D
};

// Stage rows [0, 64) of a (rows, D) bf16 tile starting at `src` into `dst`
// (pitch DP + 8); columns D .. DP - 1 and rows at or past `avail` are
// zeros. `vec`: D % 8 == 0 and 16-byte aligned rows, so cp.async copies;
// otherwise element loads (synchronous).
template <int DP>
__device__ __forceinline__ void stage_tile(bf16* dst,
                                           const bf16* __restrict__ src,
                                           int avail, int D, bool vec) {
  constexpr int kPitch = MmaTile<DP>::kPitch;
  if (vec) {
    constexpr int kChunks = DP / 8;
    const int chunks = D / 8;
    for (int idx = threadIdx.x; idx < kTile * kChunks; idx += kThreads) {
      const int r = idx / kChunks;
      const int c = idx - r * kChunks;
      const bool ok = r < avail && c < chunks;
      cp_async16(smem_addr(dst + r * kPitch + c * 8),
                 ok ? src + static_cast<size_t>(r) * D + c * 8 : src, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kTile * DP; idx += kThreads) {
      const int r = idx / DP;
      const int c = idx - r * DP;
      dst[r * kPitch + c] = r < avail && c < D
                                ? src[static_cast<size_t>(r) * D + c]
                                : __float2bfloat16(0.f);
    }
  }
}

// one k16 step of s[nt] += a B^T: NT n8 tiles of B rows through ldmatrix
// (no transpose) from `b_base`, the lane's row address in B
template <int DP, int NT>
__device__ __forceinline__ void abt_step(float (&s)[NT][4],
                                         const uint32_t (&a)[4],
                                         uint32_t b_base, int ks) {
  constexpr int kPitch = MmaTile<DP>::kPitch;
#pragma unroll
  for (int np = 0; np < NT / 2; ++np) {
    uint32_t b[4];
    ldsm_x4(b, b_base + (np * 16 * kPitch) * 2 + ks * 32);
    mma_bf16(s[2 * np], a, b[0], b[1]);
    mma_bf16(s[2 * np + 1], a, b[2], b[3]);
  }
}

// lane's ldmatrix row address in A (rows a_row0 .. + 15) and in B (NT * 8
// rows from its first), both (rows, DP) in shared memory
template <int DP>
__device__ __forceinline__ uint32_t a_rows(const bf16* A, int a_row0,
                                           int lane) {
  return smem_addr(A + (a_row0 + (lane & 15)) * MmaTile<DP>::kPitch +
                   (lane >> 4) * 8);
}
template <int DP>
__device__ __forceinline__ uint32_t b_rows(const bf16* B, int lane) {
  return smem_addr(B + ((lane >> 4) * 8 + (lane & 7)) * MmaTile<DP>::kPitch +
                   ((lane >> 3) & 1) * 8);
}

template <int NT>
__device__ __forceinline__ void zero(float (&s)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
}

// s[nt] = A B^T over one 16-row A slice (rows a_row0 .., of tile `A`) and
// NT * 8 rows of `B` (from its first row), both (rows, DP) in shared
// memory: NT n8 tiles of 8 B rows each. ldmatrix without a transpose gives
// both operands.
template <int DP, int NT>
__device__ __forceinline__ void tile_mma_abt(float (&s)[NT][4], const bf16* A,
                                             int a_row0, const bf16* B,
                                             int lane) {
  zero(s);
  const uint32_t a_base = a_rows<DP>(A, a_row0, lane);
  const uint32_t b_base = b_rows<DP>(B, lane);
#pragma unroll
  for (int ks = 0; ks < MmaTile<DP>::kSteps; ++ks) {
    uint32_t a[4];
    ldsm_x4(a, a_base + ks * 32);
    abt_step<DP, NT>(s, a, b_base, ks);
  }
}

// the same product with the A slice's fragments already in registers
// (`a`, one per k16 step over D)
template <int DP, int NT>
__device__ __forceinline__ void tile_mma_abt(
    float (&s)[NT][4], const uint32_t (&a)[MmaTile<DP>::kSteps][4],
    const bf16* B, int lane) {
  zero(s);
  const uint32_t b_base = b_rows<DP>(B, lane);
#pragma unroll
  for (int ks = 0; ks < MmaTile<DP>::kSteps; ++ks)
    abt_step<DP, NT>(s, a[ks], b_base, ks);
}

// the A fragments of rows a_row0 .. + 15 of tile `A` over every k16 step
template <int DP>
__device__ __forceinline__ void a_frags(
    uint32_t (&a)[MmaTile<DP>::kSteps][4], const bf16* A, int a_row0,
    int lane) {
  const uint32_t a_base = a_rows<DP>(A, a_row0, lane);
#pragma unroll
  for (int ks = 0; ks < MmaTile<DP>::kSteps; ++ks)
    ldsm_x4(a[ks], a_base + ks * 32);
}

// acc += S M over a 16-row score slice in registers (16 x NT * 8, rounded
// to bf16 as A) and NT * 8 rows of `M` (from its first row; (rows, DP) in
// shared memory), read through ldmatrix.trans as B
template <int DP, int NT>
__device__ __forceinline__ void tile_mma_sm(
    float (&acc)[MmaTile<DP>::kOut][4], const float (&s)[NT][4], const bf16* M,
    int lane) {
  constexpr int kPitch = MmaTile<DP>::kPitch;
  const uint32_t m_base = smem_addr(
      M + (((lane >> 3) & 1) * 8 + (lane & 7)) * kPitch + (lane >> 4) * 8);
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t a[4];
    score_as_a(a, s, kk);
#pragma unroll
    for (int dp = 0; dp < MmaTile<DP>::kOut / 2; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, m_base + (kk * 16 * kPitch + dp * 16) * 2);
      mma_bf16(acc[2 * dp], a, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// rows r0 + g and r0 + g + 8 of a 16-row accumulator slice (columns
// 8 nt + 2 t, + 1) times `mul[half]` into the (rows, D) bf16 output at
// `dst`, rows below `avail`, columns below D; pairs as one 4-byte store
// when `vec` (D even and `dst` aligned)
template <int NO>
__device__ __forceinline__ void store_slice(bf16* __restrict__ dst,
                                            const float (&acc)[NO][4],
                                            const float (&mul)[2], int r0,
                                            int avail, int D, bool vec,
                                            int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    if (r >= avail) continue;
    bf16* row = dst + static_cast<size_t>(r) * D;
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      const int c = nt * 8 + 2 * t;
      const float x0 = acc[nt][2 * half] * mul[half];
      const float x1 = acc[nt][2 * half + 1] * mul[half];
      if (vec && c + 1 < D) {
        *reinterpret_cast<__nv_bfloat162*>(row + c) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (c < D) row[c] = __float2bfloat16(x0);
        if (c + 1 < D) row[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// forward on the tensor cores: a block owns 64 q rows (16 a warp) and
// walks the k tiles it can see through a two-stage ring of K and V tiles
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     float* __restrict__ lse, int Lq, int Lk, int D,
                     float scale_log2, int causal, int vec) {
  using Tile = MmaTile<DP>;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_mma);
  bf16* sK = sQ + Tile::kElems;      // two stages
  bf16* sV = sK + 2 * Tile::kElems;  // two stages
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t qoff = static_cast<size_t>(bh) * Lq * D;
  const size_t koff = static_cast<size_t>(bh) * Lk * D;

  stage_tile<DP>(sQ, q + qoff + static_cast<size_t>(q0) * D, Lq - q0, D, vec);
  stage_tile<DP>(sK, k + koff, Lk, D, vec);
  stage_tile<DP>(sV, v + koff, Lk, D, vec);
  cp_async_commit();

  // this warp's rows q0 + 16 warp + g (+ 8): running max (base 2) and the
  // thread's part of the row sum (its quad's four parts are summed at the
  // end; the rescales are uniform over the quad)
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[Tile::kOut][4];
#pragma unroll
  for (int nt = 0; nt < Tile::kOut; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const int row0 = q0 + warp * 16 + g;

  const int n_k = k_tiles(q0, Lq, Lk, causal);
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + 1 < n_k) {
      const int k1 = (kt + 1) * kTile;
      const int st = (kt + 1) & 1;
      stage_tile<DP>(sK + st * Tile::kElems,
                     k + koff + static_cast<size_t>(k1) * D, Lk - k1, D, vec);
      stage_tile<DP>(sV + st * Tile::kElems,
                     v + koff + static_cast<size_t>(k1) * D, Lk - k1, D, vec);
      cp_async_commit();
    }
    const int k0 = kt * kTile;
    float s[8][4];
    tile_mma_abt<DP, 8>(s, sQ, warp * 16, sK + (kt & 1) * Tile::kElems,
                        lane);

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        const bool ok = col < Lk && (!causal || col <= row);
        s[nt][e] = ok ? s[nt][e] * scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < Tile::kOut; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
        l[e >> 1] += s[nt][e];
      }
    tile_mma_sm<DP, 8>(acc, s, sV + (kt & 1) * Tile::kElems, lane);
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const float lc = fmaxf(l[h], 1e-30f);
    inv[h] = 1.f / lc;
    const int row = row0 + 8 * h;
    if (t == 0 && row < Lq)
      lse[static_cast<size_t>(bh) * Lq + row] = m[h] * kLn2 + logf(lc);
  }
  store_slice(out + qoff + static_cast<size_t>(q0) * D, acc, inv, warp * 16,
              Lq - q0, D, vec, lane);
}

// dQ on the tensor cores: a block owns 64 q rows (16 a warp) and walks the
// k tiles its rows can see through a two-stage ring of K and V tiles. S
// and dP are accumulator fragments; P and dS = P (dP - delta) stay in
// registers, and dS, rounded to bf16, is the A operand of dQ += dS K.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16* __restrict__ dq, int Lq, int Lk, int D,
                        float scale, float scale_log2, int causal, int vec) {
  using Tile = MmaTile<DP>;
  // up to D = 64 the warp's q and dO fragments (2 x 4 x kSteps registers)
  // are loaded once and held; above, holding them would spill, and they
  // are re-read from shared memory for every k tile
  constexpr bool kHold = DP <= 64;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_mma);
  bf16* sO = sQ + Tile::kElems;      // dout
  bf16* sK = sO + Tile::kElems;      // two stages
  bf16* sV = sK + 2 * Tile::kElems;  // two stages
  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t qoff = static_cast<size_t>(bh) * Lq * D;
  const size_t koff = static_cast<size_t>(bh) * Lk * D;

  stage_tile<DP>(sQ, q + qoff + static_cast<size_t>(q0) * D, Lq - q0, D, vec);
  stage_tile<DP>(sO, dout + qoff + static_cast<size_t>(q0) * D, Lq - q0, D,
                 vec);
  stage_tile<DP>(sK, k + koff, Lk, D, vec);
  stage_tile<DP>(sV, v + koff, Lk, D, vec);
  cp_async_commit();

  // this thread's rows row0 and row0 + 8: lse in base 2, and delta (rows
  // past Lq read neither; their dO is zero, and they are not stored)
  const int row0 = q0 + warp * 16 + g;
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const size_t at = static_cast<size_t>(bh) * Lq + row;
    lse2[h] = row < Lq ? lse[at] * kLog2e : 0.f;
    dlt[h] = row < Lq ? delta[at] : 0.f;
  }
  float acc[Tile::kOut][4];
  zero(acc);

  uint32_t qa[kHold ? Tile::kSteps : 1][4], oa[kHold ? Tile::kSteps : 1][4];
  if constexpr (kHold) {
    cp_async_wait_all();
    __syncthreads();
    a_frags<DP>(qa, sQ, warp * 16, lane);
    a_frags<DP>(oa, sO, warp * 16, lane);
  }

  const int n_k = k_tiles(q0, Lq, Lk, causal);
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait_all();
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    if (kt + 1 < n_k) {
      const int k1 = (kt + 1) * kTile;
      const int st = (kt + 1) & 1;
      stage_tile<DP>(sK + st * Tile::kElems,
                     k + koff + static_cast<size_t>(k1) * D, Lk - k1, D, vec);
      stage_tile<DP>(sV + st * Tile::kElems,
                     v + koff + static_cast<size_t>(k1) * D, Lk - k1, D, vec);
      cp_async_commit();
    }
    const int k0 = kt * kTile;
    const bf16* cK = sK + (kt & 1) * Tile::kElems;
    const bf16* cV = sV + (kt & 1) * Tile::kElems;
    float s[8][4], dp[8][4];
    if constexpr (kHold) {
      tile_mma_abt<DP, 8>(s, qa, cK, lane);   // S = q k^T
      tile_mma_abt<DP, 8>(dp, oa, cV, lane);  // dP = dO v^T
    } else {
      tile_mma_abt<DP, 8>(s, sQ, warp * 16, cK, lane);
      tile_mma_abt<DP, 8>(dp, sO, warp * 16, cV, lane);
    }
    // dS = P (dP - delta), P = exp2(S scale log2e - lse log2e), masked to 0
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * t + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        const bool ok = col < Lk && (!causal || col <= row);
        const float p =
            ok ? exp2f(s[nt][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dlt[e >> 1]);
      }
    tile_mma_sm<DP, 8>(acc, s, cK, lane);  // dQ += dS k, unscaled
  }

  const float sc[2] = {scale, scale};
  store_slice(dq + qoff + static_cast<size_t>(q0) * D, acc, sc, warp * 16,
              Lq - q0, D, vec, lane);
}

// dK and dV on the tensor cores: a block owns 64 keys (16 a warp) and walks
// the q tiles that can see them through a two-stage ring of q, dO, lse and
// delta; S^T, P^T, dP^T and dS^T are (key, query) tiles in registers
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Lq,
                         int Lk, int D, float scale, float scale_log2,
                         int causal, int vec) {
  using Tile = MmaTile<DP>;
  // the q tile in passes of NT * 8 rows: two passes at D > 112, where one
  // pass's score fragments on top of the 2 x 64 dK, dV accumulators would
  // spill
  constexpr int kSplit = DP > 112 ? 2 : 1;
  constexpr int NT = 8 / kSplit;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  bf16* sK = reinterpret_cast<bf16*>(smem_mma);
  bf16* sV = sK + Tile::kElems;
  bf16* sQ = sV + Tile::kElems;      // two stages
  bf16* sO = sQ + 2 * Tile::kElems;  // dout, two stages
  float* sL = reinterpret_cast<float*>(sO + 2 * Tile::kElems);  // lse log2e
  float* sD = sL + 2 * kTile;                                   // delta
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t qoff = static_cast<size_t>(bh) * Lq * D;
  const size_t koff = static_cast<size_t>(bh) * Lk * D;
  const int n_q = (Lq + kTile - 1) / kTile;
  // causal: q rows below k0 see none of this tile's keys
  const int qt0 = causal ? blockIdx.y : 0;

  // the q-side tiles of q tile `qt` into ring stage `st`
  auto stage_q = [&](int qt, int st) {
    const int q0 = qt * kTile;
    stage_tile<DP>(sQ + st * Tile::kElems,
                   q + qoff + static_cast<size_t>(q0) * D, Lq - q0, D, vec);
    stage_tile<DP>(sO + st * Tile::kElems,
                   dout + qoff + static_cast<size_t>(q0) * D, Lq - q0, D,
                   vec);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      const size_t at = static_cast<size_t>(bh) * Lq + row;
      sL[st * kTile + threadIdx.x] = row < Lq ? lse[at] * kLog2e : 0.f;
      sD[st * kTile + threadIdx.x] = row < Lq ? delta[at] : 0.f;
    }
  };

  stage_tile<DP>(sK, k + koff + static_cast<size_t>(k0) * D, Lk - k0, D,
                 vec);
  stage_tile<DP>(sV, v + koff + static_cast<size_t>(k0) * D, Lk - k0, D,
                 vec);
  if (qt0 < n_q) stage_q(qt0, 0);
  cp_async_commit();

  float acc_k[Tile::kOut][4], acc_v[Tile::kOut][4];
#pragma unroll
  for (int nt = 0; nt < Tile::kOut; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc_k[nt][e] = 0.f;
      acc_v[nt][e] = 0.f;
    }
  const int key0 = k0 + warp * 16 + g;  // this thread's keys: key0, + 8

  for (int qt = qt0; qt < n_q; ++qt) {
    const int st = (qt - qt0) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile qt is in; every warp is done with tile qt - 1
    if (qt + 1 < n_q) {
      stage_q(qt + 1, st ^ 1);
      cp_async_commit();
    }
    const int q0 = qt * kTile;
    const bf16* cQ = sQ + st * Tile::kElems;
    const bf16* cO = sO + st * Tile::kElems;
    const float* cL = sL + st * kTile;
    const float* cD = sD + st * kTile;

    // in kSplit passes of NT * 8 q rows each, one after the other (not
    // unrolled, so the passes' fragments are not live together)
#pragma unroll 1
    for (int h = 0; h < kSplit; ++h) {
      const int c0 = h * NT * 8;  // first q row of the pass, in the tile
      const bf16* hQ = cQ + c0 * Tile::kPitch;
      const bf16* hO = cO + c0 * Tile::kPitch;
      // P^T = exp2(S^T scale log2e - lse log2e), masked to 0
      float p[NT][4];
      tile_mma_abt<DP, NT>(p, sK, warp * 16, hQ, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + nt * 8 + 2 * t + (e & 1);
          const int row = q0 + c;
          const int key = key0 + 8 * (e >> 1);
          const bool ok = key < Lk && row < Lq && (!causal || key <= row);
          p[nt][e] = ok ? exp2f(p[nt][e] * scale_log2 - cL[c]) : 0.f;
        }
      tile_mma_sm<DP, NT>(acc_v, p, hO, lane);  // dV += P^T dO

      // dS^T = P^T (dP^T - delta), dP^T = v dO^T
      float ds[NT][4];
      tile_mma_abt<DP, NT>(ds, sV, warp * 16, hO, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[nt][e] =
              p[nt][e] * (ds[nt][e] - cD[c0 + nt * 8 + 2 * t + (e & 1)]);
      tile_mma_sm<DP, NT>(acc_k, ds, hQ, lane);  // dK += dS^T q, unscaled
    }
  }

  const float one[2] = {1.f, 1.f};
  const float sc[2] = {scale, scale};
  store_slice(dk + koff + static_cast<size_t>(k0) * D, acc_k, sc, warp * 16,
              Lk - k0, D, vec, lane);
  store_slice(dv + koff + static_cast<size_t>(k0) * D, acc_v, one, warp * 16,
              Lk - k0, D, vec, lane);
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

// DP, D rounded up to 16: the tensor-core kernels' padded head dim
#define MMA_DISPATCH(D, ...)                   \
  switch (((D) + 15) / 16) {                   \
    case 1: {                                  \
      constexpr int DP = 16;                   \
      __VA_ARGS__                              \
    } break;                                   \
    case 2: {                                  \
      constexpr int DP = 32;                   \
      __VA_ARGS__                              \
    } break;                                   \
    case 3: {                                  \
      constexpr int DP = 48;                   \
      __VA_ARGS__                              \
    } break;                                   \
    case 4: {                                  \
      constexpr int DP = 64;                   \
      __VA_ARGS__                              \
    } break;                                   \
    case 5: {                                  \
      constexpr int DP = 80;                   \
      __VA_ARGS__                              \
    } break;                                   \
    case 6: {                                  \
      constexpr int DP = 96;                   \
      __VA_ARGS__                              \
    } break;                                   \
    case 7: {                                  \
      constexpr int DP = 112;                  \
      __VA_ARGS__                              \
    } break;                                   \
    default: {                                 \
      constexpr int DP = 128;                  \
      __VA_ARGS__                              \
    } break;                                   \
  }

// rows of D bf16 values at these pointers are 16-byte aligned (cp.async and
// paired stores), else the kernels take element loads and stores
template <typename... P>
int rows16(int D, P... ptrs) {
  bool ok = D % 8 == 0;
  for (const void* p : {static_cast<const void*>(ptrs)...})
    ok = ok && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  return ok ? 1 : 0;
}

int fwd_mma(const bf16* q, const bf16* k, const bf16* v, bf16* out,
            float* lse, int BH, int Lq, int Lk, int D, float scale,
            int causal, cudaStream_t stream) {
  if (!shape_ok(BH, Lq, Lk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH, (Lq + kTile - 1) / kTile);
  const int vec = rows16(D, q, k, v, out);
  MMA_DISPATCH(D, {
    auto kernel = flash_fwd_mma_kernel<DP>;
    const size_t smem = 5 * MmaTile<DP>::kBytes;
    const int rc = set_smem(kernel, smem);
    if (rc != 0) return rc;
    kernel<<<grid, kThreads, smem, stream>>>(q, k, v, out, lse, Lq, Lk, D,
                                             scale * kLog2e, causal, vec);
  });
  return static_cast<int>(cudaGetLastError());
}

int bwd_dkv_mma(const bf16* q, const bf16* k, const bf16* v,
                const bf16* dout, const float* lse, const float* delta,
                bf16* dk, bf16* dv, int BH, int Lq, int Lk, int D,
                float scale, int causal, cudaStream_t stream) {
  if (!shape_ok(BH, Lq, Lk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH, (Lk + kTile - 1) / kTile);
  const int vec = rows16(D, q, k, v, dout, dk, dv);
  MMA_DISPATCH(D, {
    auto kernel = flash_bwd_dkv_mma_kernel<DP>;
    const size_t smem =
        6 * MmaTile<DP>::kBytes + 4 * sizeof(float) * kTile;
    const int rc = set_smem(kernel, smem);
    if (rc != 0) return rc;
    kernel<<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dk,
                                             dv, Lq, Lk, D, scale,
                                             scale * kLog2e, causal, vec);
  });
  return static_cast<int>(cudaGetLastError());
}

int bwd_dq_mma(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
               const float* lse, const float* delta, bf16* dq, int BH,
               int Lq, int Lk, int D, float scale, int causal,
               cudaStream_t stream) {
  if (!shape_ok(BH, Lq, Lk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BH, (Lq + kTile - 1) / kTile);
  const int vec = rows16(D, q, k, v, dout, dq);
  MMA_DISPATCH(D, {
    auto kernel = flash_bwd_dq_mma_kernel<DP>;
    const size_t smem = 6 * MmaTile<DP>::kBytes;
    const int rc = set_smem(kernel, smem);
    if (rc != 0) return rc;
    kernel<<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dq,
                                             Lq, Lk, D, scale,
                                             scale * kLog2e, causal, vec);
  });
  return static_cast<int>(cudaGetLastError());
}

// the FMA kernels serve float32 only (bf16 takes fwd_mma, bwd_dq_mma and
// bwd_dkv_mma)
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

// dtype: 0 float32 (the FMA kernels), 1 bfloat16 (the tensor-core kernels)
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
    return fwd_mma(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                   static_cast<const bf16*>(v), static_cast<bf16*>(out), l,
                   BH, Lq, Lk, D, scale, causal, s);
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
    return bwd_dq_mma(static_cast<const bf16*>(q),
                      static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v),
                      static_cast<const bf16*>(dout), l, dl,
                      static_cast<bf16*>(dq), BH, Lq, Lk, D, scale, causal,
                      s);
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
    return bwd_dkv_mma(static_cast<const bf16*>(q),
                       static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v),
                       static_cast<const bf16*>(dout), l, dl,
                       static_cast<bf16*>(dk), static_cast<bf16*>(dv), BH,
                       Lq, Lk, D, scale, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
