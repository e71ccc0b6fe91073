// Fused LSTM layer for Hopper (sm_90a), plain C interface: the residual-free
// inference forward, the training forward, and the backward.
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas_kernels.py, reached
// through lstm_layer (:662):
//   _lstm_infer_kernel (:506, pl.pallas_call at :548) -> lstm_infer
//   _lstm_fwd_kernel   (:429, pl.pallas_call at :585) -> lstm_fwd
//   _lstm_bwd_kernel   (:463, pl.pallas_call at :626) -> lstm_bwd
//
//   gx       (T, B, 4H)  x . w_ih^T + b_ih + b_hh, gate order i, f, g, o;
//                        float32 or bfloat16 ("the dtype"), contiguous
//   wh       (4H, H)     the recurrent weight in the reference's layout
//   h0, c0   (B, H)      the dtype
//   ys       (T, B, H)   the dtype; hT is ys[T - 1]
//   cT       (B, H)      the dtype (inference)
//   c_all    (T, B, H)   float32: c_t of every step (training residual)
//   gates    (T, B, 4H)  the dtype: post-activation i, f, g, o
//   dy       (T, B, H)   the dtype (the caller casts the cotangent)
//   dcT      (B, H)      the dtype
//   dgx      (T, B, 4H)  the dtype: pre-activation gate gradients
//   dh0, dc0 (B, H)      the dtype
//
// Any T >= 1, B >= 1, H >= 1: no padding of B, H or the gate blocks.
//
// Numerics kept from the TPU kernels: the recurrent product takes h in the
// dtype with f32 accumulation; the h / c carries (and dh / dc) are f32; ys
// and gates are stored in the dtype, c_all in f32; in the backward dgates
// is rounded to the dtype before it is stored and multiplied back through
// w_hh, and c_prev at t = 0 is c0.
//
// Design: one persistent, cooperative launch per layer. The recurrence is
// sequential in t and every step needs all of h_{t-1}, so the whole grid
// waits at cooperative_groups' grid barrier once a step. On the TPU w_hh^T
// stayed in VMEM for the whole loop; at the word LM's H = 650 it is 3.4 MB
// in bf16, more than one SM's 227 KB of shared memory, so here it is cut:
//   * block k owns hidden units j0 .. j0 + U - 1 (U = ceil(H / #SMs), one
//     block an SM), with all four gate rows of each unit, so the cell update
//     stays inside the block. It stages its slice of w_hh in shared memory
//     once: the 4U gate rows in the forward (the output side), the U
//     columns in the backward (the input side of dh = dgx . w_hh);
//   * each step it streams the product's left operand (h_{t-1}, which is
//     ys[t - 1] or h0; in the backward dgx[t]) through shared memory in
//     chunks of KC columns and computes its outputs as 4 x 4 register tiles:
//     a warp takes a tile, its 32 lanes split the contraction (k = lane,
//     lane + 32, ...) and a fixed shuffle butterfly sums them;
//   * c (and the backward's dh, dc) never leave the block; the carries stay
//     in shared memory as f32. ys[t] (forward) and dgx[t] (backward) are
//     the only values exchanged between blocks, and they are outputs anyway:
//     ys[t - 1] in its dtype IS the h the product takes, so no separate
//     exchange buffer exists and none is overwritten while still read;
//   * every output element is written by one thread in a fixed order: no
//     atomics, and two runs give the same bits. The "last step wins"
//     outputs of the TPU grid (cT; dh0 and dc0) are one write by the owning
//     block after its loop.
//
// Traps, and what the code does about them:
//   * Stale reads: ys and dgx are written inside the kernel and read by
//     other blocks after the barrier. They are never read through the
//     read-only path (no const __restrict__, no __ldg): load_cg reads them
//     from L2 (ld.global.cg), which every SM sees coherently.
//   * Refused launches: a cooperative launch larger than what can be
//     co-resident is refused (cudaErrorCooperativeLaunchTooLarge). The grid
//     is at most one block an SM, the occupancy is checked first, and every
//     entry point returns the launch's error (0 on success) to the wrapper,
//     which raises.
//   * Shared memory above 48 KB: set with cudaFuncSetAttribute before each
//     launch. At B = 32, H = 650: 118 KB (f32) or 91 KB (bf16) a block.
//     mxnet_tpu_torch/ops/pallas_kernels.py:lstm_layer_fits mirrors the
//     layout below to route a shape that does not fit to the step loop.
//
// Bound on the card at the word LM's shape (T = 35, B = 32, H = 650, bf16):
// the infer kernel's 3.79 GFLOP of products against 10.8 MB of tensors is
// bound by its operations at the tensor cores' rate (3.8 us), the forward
// and backward by their bytes (about 19.5 MB each, 5.8 us). These kernels
// do their products on the f32 FMA units, from shared memory, and pay one
// grid barrier a step, so they stay far above that bound: a right, simple
// kernel first. Thread-block clusters with DSMEM instead of the grid
// barrier, tensor-core tiles and h kept on chip are later work.
//
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiles = 3;             // 4 x 4 tiles a warp holds at once
constexpr int kChunkBytes = 64 * 1024;  // budget of one streamed chunk
constexpr int kStage = 8;                // staging loads in flight a thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// a value another block wrote during this launch: read from L2
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 load_cg(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 16);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// out[r * ldo + c] = sum_k A[r * lda + k] * W[c * ldw + k] for r < R,
// c < C, k < K, with f32 accumulation. A lies in device memory (read
// through load_cg, chunk by chunk into a_s: R rows of KC columns); W lies
// in shared memory. Warps take 4 x 4 tiles (rows r0.., columns c0..),
// kMaxTiles at a time; a tile's rows or columns past the end read the last
// row or column again and are not stored. Ends with the block synchronised
// and out complete.
template <typename T>
__device__ void block_gemm(const T* A, int lda, int R, int K, int KC,
                           T* a_s, const T* w_s, int ldw, int C, float* out,
                           int ldo) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_c = (C + 3) / 4;
  const int tiles = ((R + 3) / 4) * tiles_c;
  for (int base = 0; base < tiles; base += kWarps * kMaxTiles) {
    float acc[kMaxTiles][4][4];
#pragma unroll
    for (int s = 0; s < kMaxTiles; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[s][i][j] = 0.0f;
    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kc = min(KC, K - k0);
      __syncthreads();  // the previous chunk's readers are done with a_s
      // warp w copies rows w, w + kWarps, ..., its lanes the columns, with
      // kStage independent loads in flight a thread before their stores
      for (int r = warp; r < R; r += kWarps) {
        const T* src = A + static_cast<size_t>(r) * lda + k0;
        T* dst = a_s + r * KC;
        for (int k = lane; k < kc; k += 32 * kStage) {
          T v[kStage];
#pragma unroll
          for (int s = 0; s < kStage; ++s)
            v[s] = load_cg(src + min(k + 32 * s, kc - 1));
#pragma unroll
          for (int s = 0; s < kStage; ++s)
            if (k + 32 * s < kc) dst[k + 32 * s] = v[s];
        }
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kMaxTiles; ++s) {
        const int tile = base + warp + s * kWarps;
        if (tile < tiles) {
          const int r0 = (tile / tiles_c) * 4, c0 = (tile % tiles_c) * 4;
          const T* ar[4];
          const T* wr[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ar[i] = a_s + min(r0 + i, R - 1) * KC;
            wr[i] = w_s + static_cast<size_t>(min(c0 + i, C - 1)) * ldw + k0;
          }
          for (int k = lane; k < kc; k += 32) {
            float a[4], w[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              a[i] = to_f32(ar[i][k]);
              w[i] = to_f32(wr[i][k]);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[s][i][j] = fmaf(a[i], w[j], acc[s][i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int s = 0; s < kMaxTiles; ++s) {
      const int tile = base + warp + s * kWarps;
      if (tile < tiles) {
        const int r0 = (tile / tiles_c) * 4, c0 = (tile % tiles_c) * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v = warp_sum(acc[s][i][j]);
            if (lane == 0 && r0 + i < R && c0 + j < C)
              out[(r0 + i) * ldo + c0 + j] = v;
          }
      }
    }
  }
  __syncthreads();
}

// columns of one streamed chunk: a multiple of 32 within kChunkBytes (at
// least 32), or all of K
__host__ __device__ inline int chunk_cols(int B, int K, int elem) {
  int kc = kChunkBytes / (B * elem) / 32 * 32;
  kc = kc < 32 ? 32 : kc;
  return kc < K ? kc : K;
}

// shared memory of a block (pallas_kernels.py:_lstm_smem mirrors these):
// forward  out_s [B][4U] f32 | c_s [B][U] f32 | w_s [4U][H] | a_s [B][KC]
// backward dh_s [B][U] f32 | dc_s [B][U] f32 | wc_s [U][4H] | a_s [B][KC]
inline size_t fwd_smem(int B, int H, int U, int elem) {
  return sizeof(float) * 5 * static_cast<size_t>(B) * U +
         static_cast<size_t>(elem) *
             (4 * static_cast<size_t>(U) * H +
              static_cast<size_t>(B) * chunk_cols(B, H, elem));
}
inline size_t bwd_smem(int B, int H, int U, int elem) {
  return sizeof(float) * 2 * static_cast<size_t>(B) * U +
         static_cast<size_t>(elem) *
             (4 * static_cast<size_t>(U) * H +
              static_cast<size_t>(B) * chunk_cols(B, 4 * H, elem));
}

// forward over T steps. kSave: the training forward (c_all and gates
// saved, cT left to the caller as c_all[T - 1]); otherwise the inference
// forward (cT written, no residuals).
template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads)
    lstm_forward_kernel(const T* gx, const T* wh, const T* h0, const T* c0,
                        T* ys, float* c_all, T* gates, T* cT, int nt, int B,
                        int H, int U) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int j0 = blockIdx.x * U;
  const int nu = min(U, H - j0);
  const int KC = chunk_cols(B, H, sizeof(T));
  float* out_s = reinterpret_cast<float*>(smem);
  float* c_s = out_s + B * 4 * U;
  T* w_s = reinterpret_cast<T*>(c_s + B * U);
  T* a_s = w_s + 4 * U * H;
  // w_s row u * 4 + g = w_hh row g * H + j0 + u: one unit's 4 gates are
  // one column tile of the product
  for (int i = threadIdx.x; i < 4 * nu * H; i += kThreads) {
    const int r = i / H, k = i - r * H;
    w_s[i] = wh[(static_cast<size_t>(r % 4) * H + j0 + r / 4) * H + k];
  }
  for (int p = threadIdx.x; p < B * nu; p += kThreads) {
    const int b = p / nu, u = p - b * nu;
    c_s[b * U + u] = to_f32(c0[b * H + j0 + u]);
  }
  for (int t = 0; t < nt; ++t) {
    // h_{t-1} in the dtype: h0, or the ys[t - 1] every block wrote
    const T* h_prev = t == 0 ? h0 : ys + static_cast<size_t>(t - 1) * B * H;
    block_gemm(h_prev, H, B, H, KC, a_s, w_s, H, 4 * nu, out_s, 4 * U);
    for (int p = threadIdx.x; p < B * nu; p += kThreads) {
      const int b = p / nu, u = p - b * nu, j = j0 + u;
      const size_t row = static_cast<size_t>(t) * B + b;
      const T* g_in = gx + row * 4 * H + j;
      const float* acc = out_s + b * 4 * U + u * 4;
      const float ig = sigmoid(to_f32(g_in[0]) + acc[0]);
      const float fg = sigmoid(to_f32(g_in[H]) + acc[1]);
      const float gg = tanhf(to_f32(g_in[2 * H]) + acc[2]);
      const float og = sigmoid(to_f32(g_in[3 * H]) + acc[3]);
      const float c = fg * c_s[b * U + u] + ig * gg;
      c_s[b * U + u] = c;
      store(ys + row * H + j, og * tanhf(c));
      if (kSave) {
        c_all[row * H + j] = c;
        T* g_out = gates + row * 4 * H + j;
        store(g_out, ig);
        store(g_out + H, fg);
        store(g_out + 2 * H, gg);
        store(g_out + 3 * H, og);
      }
    }
    if (t + 1 < nt) grid.sync();  // ys[t] complete for every block
  }
  if (!kSave) {
    // each pair's c_s entry was written by this same thread
    for (int p = threadIdx.x; p < B * nu; p += kThreads) {
      const int b = p / nu, u = p - b * nu;
      store(cT + b * H + j0 + u, c_s[b * U + u]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_backward_kernel(const T* dy, const T* gates, const float* c_all,
                         const T* c0, const T* dcT, const T* wh, T* dgx,
                         T* dh0, T* dc0, int nt, int B, int H, int U) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int j0 = blockIdx.x * U;
  const int nu = min(U, H - j0);
  const int G = 4 * H;
  const int KC = chunk_cols(B, G, sizeof(T));
  float* dh_s = reinterpret_cast<float*>(smem);
  float* dc_s = dh_s + B * U;
  T* wc_s = reinterpret_cast<T*>(dc_s + B * U);
  T* a_s = wc_s + U * G;
  // wc_s row u = w_hh column j0 + u over all 4H rows
  for (int i = threadIdx.x; i < nu * G; i += kThreads) {
    const int m = i / nu, u = i - m * nu;
    wc_s[u * G + m] = wh[static_cast<size_t>(m) * H + j0 + u];
  }
  for (int p = threadIdx.x; p < B * nu; p += kThreads) {
    const int b = p / nu, u = p - b * nu;
    dh_s[b * U + u] = 0.0f;
    dc_s[b * U + u] = to_f32(dcT[b * H + j0 + u]);
  }
  for (int t = nt - 1; t >= 0; --t) {
    // dh_s: written by block_gemm of step t + 1, which ends synchronised
    for (int p = threadIdx.x; p < B * nu; p += kThreads) {
      const int b = p / nu, u = p - b * nu, j = j0 + u;
      const size_t row = static_cast<size_t>(t) * B + b;
      const T* ga = gates + row * G + j;
      const float ig = to_f32(ga[0]), fg = to_f32(ga[H]);
      const float gg = to_f32(ga[2 * H]), og = to_f32(ga[3 * H]);
      const float c_t = c_all[row * H + j];
      const float c_prev = t > 0 ? c_all[(row - B) * H + j]
                                 : to_f32(c0[b * H + j]);
      const float dh = to_f32(dy[row * H + j]) + dh_s[b * U + u];
      const float tc = tanhf(c_t);
      const float d_o = dh * tc;
      const float dc = dc_s[b * U + u] + dh * og * (1.0f - tc * tc);
      T* dg = dgx + row * G + j;
      store(dg, (dc * gg) * ig * (1.0f - ig));
      store(dg + H, (dc * c_prev) * fg * (1.0f - fg));
      store(dg + 2 * H, (dc * ig) * (1.0f - gg * gg));
      store(dg + 3 * H, d_o * og * (1.0f - og));
      dc_s[b * U + u] = dc * fg;
    }
    grid.sync();  // dgx[t] complete for every block
    // dh_{t-1}[:, j] = dgx[t] (in the dtype) . w_hh[:, j], f32 sums
    block_gemm(dgx + static_cast<size_t>(t) * B * G, G, B, G, KC, a_s, wc_s,
               G, nu, dh_s, U);
  }
  for (int p = threadIdx.x; p < B * nu; p += kThreads) {
    const int b = p / nu, u = p - b * nu;
    store(dh0 + b * H + j0 + u, dh_s[b * U + u]);
    store(dc0 + b * H + j0 + u, dc_s[b * U + u]);
  }
}

__global__ void barrier_probe_kernel(int iters) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < iters; ++i) grid.sync();
}

// units a block owns: one block an SM
int units_per_block(int H) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (sms < 1) sms = 1;
  return (H + sms - 1) / sms;
}

// a refused launch leaves its error as the last error; clear it, so the
// next launch's check does not report it again
int fail(cudaError_t e) {
  cudaGetLastError();
  return static_cast<int>(e);
}

template <typename Kernel>
int launch(Kernel kernel, int blocks, size_t smem, void** args,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return fail(e);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem);
  if (e != cudaSuccess) return fail(e);
  if (per_sm * sms < blocks) return fail(cudaErrorCooperativeLaunchTooLarge);
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                  dim3(blocks), dim3(kThreads), args, smem,
                                  stream);
  if (e != cudaSuccess) return fail(e);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int nt, int B, int H) { return nt >= 1 && B >= 1 && H >= 1; }

template <typename T, bool kSave>
int forward(const T* gx, const T* wh, const T* h0, const T* c0, T* ys,
            float* c_all, T* gates, T* cT, int nt, int B, int H,
            cudaStream_t stream) {
  if (!shape_ok(nt, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  int U = units_per_block(H);
  const int blocks = (H + U - 1) / U;
  void* args[] = {&gx, &wh, &h0, &c0, &ys, &c_all, &gates, &cT,
                  &nt, &B, &H, &U};
  return launch(lstm_forward_kernel<T, kSave>, blocks,
                fwd_smem(B, H, U, sizeof(T)), args, stream);
}

template <typename T>
int backward(const T* dy, const T* gates, const float* c_all, const T* c0,
             const T* dcT, const T* wh, T* dgx, T* dh0, T* dc0, int nt, int B,
             int H, cudaStream_t stream) {
  if (!shape_ok(nt, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  int U = units_per_block(H);
  const int blocks = (H + U - 1) / U;
  void* args[] = {&dy, &gates, &c_all, &c0, &dcT, &wh, &dgx, &dh0, &dc0,
                  &nt, &B, &H, &U};
  return launch(lstm_backward_kernel<T>, blocks,
                bwd_smem(B, H, U, sizeof(T)), args, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16
extern "C" int lstm_infer(const void* gx, const void* wh, const void* h0,
                          const void* c0, void* ys, void* cT, int dtype,
                          int nt, int B, int H, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float, false>(
        static_cast<const float*>(gx), static_cast<const float*>(wh),
        static_cast<const float*>(h0), static_cast<const float*>(c0),
        static_cast<float*>(ys), nullptr, nullptr, static_cast<float*>(cT),
        nt, B, H, s);
  if (dtype == 1)
    return forward<__nv_bfloat16, false>(
        static_cast<const __nv_bfloat16*>(gx),
        static_cast<const __nv_bfloat16*>(wh),
        static_cast<const __nv_bfloat16*>(h0),
        static_cast<const __nv_bfloat16*>(c0),
        static_cast<__nv_bfloat16*>(ys), nullptr, nullptr,
        static_cast<__nv_bfloat16*>(cT), nt, B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int lstm_fwd(const void* gx, const void* wh, const void* h0,
                        const void* c0, void* ys, void* c_all, void* gates,
                        int dtype, int nt, int B, int H, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ca = static_cast<float*>(c_all);
  if (dtype == 0)
    return forward<float, true>(
        static_cast<const float*>(gx), static_cast<const float*>(wh),
        static_cast<const float*>(h0), static_cast<const float*>(c0),
        static_cast<float*>(ys), ca, static_cast<float*>(gates), nullptr, nt,
        B, H, s);
  if (dtype == 1)
    return forward<__nv_bfloat16, true>(
        static_cast<const __nv_bfloat16*>(gx),
        static_cast<const __nv_bfloat16*>(wh),
        static_cast<const __nv_bfloat16*>(h0),
        static_cast<const __nv_bfloat16*>(c0),
        static_cast<__nv_bfloat16*>(ys), ca,
        static_cast<__nv_bfloat16*>(gates), nullptr, nt, B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int lstm_bwd(const void* dy, const void* gates, const void* c_all,
                        const void* c0, const void* dcT, const void* wh,
                        void* dgx, void* dh0, void* dc0, int dtype, int nt,
                        int B, int H, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ca = static_cast<const float*>(c_all);
  if (dtype == 0)
    return backward<float>(
        static_cast<const float*>(dy), static_cast<const float*>(gates), ca,
        static_cast<const float*>(c0), static_cast<const float*>(dcT),
        static_cast<const float*>(wh), static_cast<float*>(dgx),
        static_cast<float*>(dh0), static_cast<float*>(dc0), nt, B, H, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(gates), ca,
        static_cast<const __nv_bfloat16*>(c0),
        static_cast<const __nv_bfloat16*>(dcT),
        static_cast<const __nv_bfloat16*>(wh),
        static_cast<__nv_bfloat16*>(dgx), static_cast<__nv_bfloat16*>(dh0),
        static_cast<__nv_bfloat16*>(dc0), nt, B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// A measurement aid, not on any path: `iters` grid barriers of a
// cooperative launch of `blocks` blocks of the LSTM kernels' width, so a
// caller can time one barrier (the recurrence's sequential floor is T of
// them).
extern "C" int lstm_barrier_probe(int blocks, int iters, void* stream) {
  void* args[] = {&iters};
  return launch(barrier_probe_kernel, blocks, 0, args,
                static_cast<cudaStream_t>(stream));
}
