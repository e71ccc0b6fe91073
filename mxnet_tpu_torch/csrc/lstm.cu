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
//   hx       (2, B, HP)  the dtype: the forward's h exchange buffer, HP = H
//                        rounded up to 16 bytes; scratch, any contents
//   ys       (T, B, H)   the dtype; hT is ys[T - 1]
//   cT       (B, H)      the dtype (inference)
//   c_all    (T, B, H)   float32: c_t of every step (training residual)
//   gates    (T, B, 4H)  the dtype: post-activation i, f, g, o
//   dy       (T, B, H)   the dtype (the caller casts the cotangent)
//   dcT      (B, H)      the dtype
//   dgx      (T, B, 4H)  the dtype: pre-activation gate gradients
//   dh0, dc0 (B, H)      the dtype
//
// Any T >= 1, B >= 1, H >= 1: no padding of B, H or the gate blocks is
// visible to the caller.
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
// block k owns hidden units j0 .. j0 + U - 1 (U = ceil(H / #SMs) in the
// forward, one block an SM), with all four gate rows of each unit, so the
// cell update stays inside the block. It stages its slice of w_hh in
// shared memory once: the 4U gate rows in the forward (the output side);
// in the backward a cluster's share of w_hh's rows for the cluster's
// units (below). c (and the backward's dc) never leave the block; the
// carries stay in shared memory as f32.
//
// The forward's step (lstm_forward_kernel), built to keep staging, the
// reduction and the gate inputs' latency short and off the critical path:
//   * h exchange: each block writes its units of h_t into hx[t % 2] (and
//     ys[t]); step t + 1 stages all of hx[t % 2] into shared memory with
//     16-byte cp.async.cg copies, all issued at once. ys rows (1300 bytes
//     at H = 650 in bf16) are not 16-byte aligned, hence the padded
//     buffer; its padding columns are never written and stay zero. Two
//     buffers, because step t + 1 writes hx[(t + 1) % 2] only after the
//     barrier that ends step t, and the last reads of that buffer were in
//     step t - 1; one buffer would be overwritten while other blocks still
//     read it. The kernel's prologue copies h0 into hx[1] (each block
//     its units; the last block zeroes the padding) and waits at one grid
//     barrier more before step 0.
//   * bf16: the product h_{t-1} (B x HP) . w_s^T on the tensor cores,
//     mma.sync m16n8k16 with both operands through ldmatrix: M = B in m16
//     tiles (rows past B zero), N = the block's 4U gate rows in n8 tiles
//     (unit-major, row u * 4 + g, which is the col operand as it lies), K
//     in k16 steps over H padded with zeros. The K steps are cut into
//     slices, one warp an (m16 tile, K slice); each warp stores its f32
//     partial sums, and the cell update adds the slices in a fixed order.
//     The staging is two commit groups split at a slice boundary: the
//     warps of the first slices compute while the second group lands.
//     Rows of both operands are an odd count of 16 bytes apart, so
//     ldmatrix meets no bank conflict.
//   * f32 keeps its products on the FMA units (4 x 4 register tiles, the
//     32 lanes of a warp split the contraction, a fixed shuffle butterfly
//     sums them), from the same staged h.
//   * off the barrier's path: the gate inputs gx[t] are loaded into
//     registers right after step t's copies are issued, by volatile loads
//     the compiler cannot move down to their use, so they arrive while h
//     lands (loaded before the barrier that ends step t - 1 instead, a
//     step took 0.1 us more: PERF.md); the step's other outputs (ys,
//     c_all, gates) stay in registers and are stored in step t + 1,
//     behind its copies, so the barrier's fence waits only for hx.
//   * every output element is written by one thread in a fixed order: no
//     atomics, and two runs give the same bits. The "last step wins"
//     outputs of the TPU grid (cT; dh0 and dc0) are one write by the owning
//     block after its loop.
// The backward's step (lstm_backward_kernel). Its product, dh_{t-1}[:, j]
// = sum over m < 4H of dgx[t][:, m] w_hh[m, j], needs all of dgx[t] for
// each unit; a block that owns U units and reads all of dgx[t] takes in
// B x 4H elements (166 KB at B 32, H 650 in bf16) to compute B x U sums,
// and every SM reads the same lines at once. So the contraction is split
// across a thread-block cluster:
//   * a cooperative launch of clusters of Q blocks (8, else 4 or 2: the
//     largest of which the card holds a cluster at one block an SM), as
//     many as cover H with U = ceil(H / (co-resident clusters x Q)) units
//     a block (an H100 holds 15 clusters of 8: 112 blocks of 6 units at
//     H 650). Block q of a cluster takes the q-th share of the 16-byte
//     chunks of a dgx row (328 columns at H 650) and holds w_hh[share, the
//     cluster's QU units] (the same U x 4H elements a block held before);
//   * each step it stages only its share of dgx[t] (21 KB) by 16-byte
//     cp.async.cg copies, and computes a partial dh (B, QU): bf16 on the
//     tensor cores (mma.sync m16n8k16 through ldmatrix, mma_slice; a
//     warp an (m16 tile, pair of n8 tiles, K slice)), f32
//     on the FMA units (fma_product);
//   * each (owner block, batch row) of the partial sums, its K slices
//     added in order, goes to the owner's shared memory by st.async (16
//     bytes a store), counted on the owner's mbarrier; the owner waits for
//     its bytes (no cluster barrier a step) and adds the Q slots in block
//     order in its cell update;
//   * the next step's gates, c_t, c_{t-1} and dy are loaded into registers
//     right after the share's copies are issued (volatile loads), so they
//     arrive while it lands; only dgx[t], the exchange, is waited for at
//     the grid barrier. A bf16 row of 4H that is not a whole number of 16
//     bytes (odd H) is exchanged through the padded buffer xb (2, B, GP),
//     double-buffered as the forward's hx.
// A shape whose backward layout does not fit a block (B past 160 at H 650
// in bf16, 94 in f32; H 1500 at B 32) runs lstm_backward_streamed_kernel:
// one block an SM, all of dgx[t] streamed through shared memory in chunks
// of KC columns (block_gemm: 4 x 4 register tiles, the lanes of a warp
// split the contraction, a shuffle butterfly sums them).
//
// Traps, and what the code does about them:
//   * Stale reads: hx and dgx are written inside the kernel and read by
//     other blocks after the barrier. They are never read through the
//     read-only path (no const __restrict__, no __ldg): cp.async.cg and
//     load_cg read them from L2, which every SM sees coherently. gx, an
//     input nobody writes, is read through the read-only path
//     (ld.global.nc).
//   * Refused launches: a cooperative launch larger than what can be
//     co-resident is refused (cudaErrorCooperativeLaunchTooLarge). The grid
//     is at most one block an SM (the backward: at most the clusters
//     cudaOccupancyMaxActiveClusters admits), the occupancy is checked
//     first, and every entry point returns the launch's error (0 on
//     success) to the wrapper, which raises. The runtime takes a
//     cooperative launch with clusters (cudaLaunchKernelEx with both
//     attributes), so the backward keeps cooperative groups' grid barrier
//     (1.15 us at its 112 blocks; a barrier written with atomics took
//     1.87 us: PERF.md).
//   * The backward's DSMEM sends: a block's mbarrier is initialised before
//     a cluster barrier, so no peer sends to it earlier; recv is reused
//     every step only after the grid barrier that follows every owner's
//     reads; a cluster barrier after the last wait keeps every block alive
//     until no peer can still send to it.
//   * Shared memory above 48 KB: set with cudaFuncSetAttribute before each
//     launch. At B = 32, H = 650 the forward takes 136 KB (f32) or 108 KB
//     (bf16) a block, the backward 117 KB or 75 KB. A forward whose block
//     cannot hold all of h_{t-1} (B past 112 at H = 650 in bf16, 66 in
//     f32; H = 1500 at B = 32) runs lstm_forward_streamed_kernel, which
//     streams h through shared memory in chunks.
//     mxnet_tpu_torch/ops/pallas_kernels.py:lstm_layer_fits mirrors the
//     layouts below to route a shape that fits neither to the step loop.
//
// Bound on the card at the word LM's shape (T = 35, B = 32, H = 650, bf16):
// the infer kernel's 3.79 GFLOP of products against 10.8 MB of tensors is
// bound by its operations at the tensor cores' rate (3.8 us), the forward
// and backward by their bytes (about 19.5 MB each, 5.8 us). The recurrence
// pays one grid barrier a step (about 1.1 us, lstm_barrier_probe), T - 1
// of them in the forward, T in the backward: that sequential floor, not
// the bound, is what these kernels can approach. The backward's step adds
// to its barrier the staging of its share, the product, the DSMEM sends
// and the cell update; the cluster split cuts what each SM takes in from
// 166 KB to 21 KB a step and what the card reads from L2 from 21.6 MB to
// 2.4 MB, each line read by one block of each cluster (14), not by all.
//
// Kernels launch on the caller's stream, allocate nothing and do not
// synchronise.

#include <cooperative_groups.h>
#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiles = 3;             // 4 x 4 tiles a warp holds at once
constexpr int kChunkBytes = 64 * 1024;  // budget of one streamed chunk
constexpr int kStage = 8;                // staging loads in flight a thread
constexpr int kKSlices = 8;  // most K slices of the forward's bf16 product
constexpr int kMaxNT = 8;    // n8 tiles a warp accumulates at once (even)
constexpr int kMaxQ = 8;     // blocks a cluster of the backward (portable)

// A measurement aid, compiled only with -DLSTM_TRACE (tools/
// lstm_step_probe.py --trace builds it so; the library the port loads has
// none of it): thread 0 of block 0 of the forward and backward kernels
// records the SM clock and the global timer at fixed points of each step.
// Forward: (t, 0) the kernel's start (t = 0) and end (t = T), (t, 1) step
// t begins, (t, 2) its copies are issued, (t, 3) and (t, 4) the first and
// second commit group have landed, (t, 5) the product is complete, (t, 6)
// the cell update is done (the grid barrier follows). Backward (steps
// run from t = T - 1 down): (0, 0) and (T, 0) the start and end, (t, 1)
// step t begins (the cell update), (t, 2) the cell update is done, (t, 3)
// the grid barrier is passed, (t, 4) the share's copies and the next
// step's input loads are issued, (t, 5) the share has landed, (t, 6) the
// product is complete, (t, 7) the partial sums are sent (the wait for the
// peers' sums falls between (t - 1, 1) and (t - 1, 2)).
#ifdef LSTM_TRACE
constexpr int kTraceSteps = 128, kTracePoints = 8;
__device__ long long trace_clock[kTraceSteps + 1][kTracePoints];
__device__ long long trace_ns[kTraceSteps + 1][kTracePoints];
#define LSTM_TRACE_POINT(t, k)                                          \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0 && (t) <= kTraceSteps) {    \
      long long ns;                                                     \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));            \
      trace_clock[t][k] = clock64();                                    \
      trace_ns[t][k] = ns;                                              \
    }                                                                   \
  } while (0)
#else
#define LSTM_TRACE_POINT(t, k) \
  do {                         \
  } while (0)
#endif

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared through L2 (.cg: never a stale L1 line)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; lane l gives the row address of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// distributed shared memory: the address of `addr` (this block's shared
// memory) in the block of cluster rank `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into another block's shared memory (`addr`, from mapa), counted
// as 16 bytes of the transaction that mbarrier `bar` (in that block) waits
// for; the store is asynchronous, the waiter sees the data once its phase
// completes
__device__ __forceinline__ void st_async16(uint32_t addr, float4 v,
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr),
      "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// this thread's arrival on `bar`, which then expects `bytes` more of
// transactions in the current phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{ .reg .b64 st; mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], "
      "%1; }" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait until the phase of `bar` with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\tLAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\tbra LAB_WAIT;\n\tDONE:\n\t}" ::"r"(bar),
      "r"(parity)
      : "memory");
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

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) / 16 * 16;
}

// Shared memory of a forward block (pallas_kernels.py:_lstm_fwd_layout
// mirrors it), regions 16-byte aligned, in this order:
//   c_s   [B][U]                    f32   the c carry
//   red_s [kslices][mpad][np]       f32   partial products, one slice a
//                                         K slice (f32: one)
//   w_s   [w_rows][pitch]           dtype w_hh's 4U gate rows, unit-major
//   a_s   [mpad][pitch]             dtype h_{t-1}, staged from hx
// bf16 pads for the tensor cores: mpad = B and w_rows = 4U rounded up to
// 16, K to steps * 16 zero columns, and pitch = steps * 16 + 8 (an odd
// count of 16 bytes); f32 pads nothing (pitch = hp).
struct FwdLayout {
  int hp;       // pitch of hx: H rounded up to 16 bytes
  int steps;    // k16 steps: H rounded up to 16, over 16
  int pitch;    // of a_s and w_s, in elements
  int mpad;     // rows of a_s and red_s
  int w_rows;   // rows of w_s
  int np;       // pitch of red_s: 4U rounded up to 8
  int kslices;  // K slices of the product
  size_t red_off, w_off, a_off, bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int B, int H, int U,
                                                int elem) {
  const bool mma = elem == 2;
  FwdLayout L;
  L.hp = round_up(H, 16 / elem);
  L.steps = round_up(H, 16) / 16;
  L.pitch = mma ? L.steps * 16 + 8 : L.hp;
  L.mpad = mma ? round_up(B, 16) : B;
  L.w_rows = mma ? round_up(4 * U, 16) : 4 * U;
  L.np = round_up(4 * U, 8);
  int ks = 1;
  if (mma) {  // a warp an (m16 tile, K slice)
    ks = kWarps / (L.mpad / 16);
    ks = ks < 1 ? 1 : ks;
    ks = ks < kKSlices ? ks : kKSlices;
    ks = ks < L.steps ? ks : L.steps;
  }
  L.kslices = ks;
  L.red_off = align16(sizeof(float) * static_cast<size_t>(B) * U);
  L.w_off = L.red_off +
            align16(sizeof(float) * static_cast<size_t>(ks) * L.mpad * L.np);
  L.a_off = L.w_off + align16(static_cast<size_t>(elem) * L.w_rows * L.pitch);
  L.bytes = L.a_off + align16(static_cast<size_t>(elem) * L.mpad * L.pitch);
  return L;
}

// Shared memory of a backward block (pallas_kernels.py:_lstm_bwd_layout
// mirrors it) for clusters of Q blocks, U units a block; regions 16-byte
// aligned, in this order:
//   bar   16 bytes                      the mbarrier the peers' partial
//                                       sums arrive on
//   recv  [Q][B][up]              f32   the cluster's partial dh sums for
//                                       this block's units, one slice a
//                                       block of the cluster (up = U
//                                       rounded up to 4: 16-byte rows)
//   dc_s  [B][U]                  f32   the dc carry
//   red_s [kslices][mpad][np]     f32   partial products, one slice a K
//                                       slice (f32: one)
//   w_s   [w_rows][pitch]         dtype w_hh[share, the cluster's QU units]
//                                       transposed: row c, column m - m_lo
//   a_s   [mpad][pitch]           dtype the block's share of dgx[t]
// The share: 16-byte chunks [q nch / Q, (q + 1) nch / Q) of an exchange row
// of gp elements (4H rounded up to 16 bytes), at most kmax elements. bf16
// pads for the tensor cores as the forward does (mpad = B and w_rows = QU
// rounded up to 16, K to steps * 16 zero columns, pitch = steps * 16 + 8)
// and gives each warp an (m16 tile, pair of n8 tiles, K slice); f32 pads
// nothing (pitch = kmax), one K slice.
struct BwdLayout {
  int gp;       // pitch of an exchange row: 4H rounded up to 16 bytes
  int nch;      // 16-byte chunks of an exchange row
  int kmax;     // elements of the largest share
  int steps;    // k16 steps of the largest share
  int pitch;    // of a_s and w_s, in elements
  int mpad;     // rows of a_s and red_s
  int qu;       // units a cluster
  int up;       // pitch of recv's rows: U rounded up to 4
  int w_rows;   // rows of w_s
  int np;       // pitch of red_s: QU rounded up to 8, plus one (an odd
                // pitch: a warp reading one column of 32 rows meets no bank
                // conflict)
  int npairs;   // pairs of n8 tiles
  int kslices;  // K slices of the product
  size_t recv_off, dc_off, red_off, w_off, a_off, bytes;
};

__host__ __device__ inline BwdLayout bwd_layout(int B, int H, int Q, int U,
                                                int elem) {
  const bool mma = elem == 2;
  BwdLayout L;
  L.gp = round_up(4 * H, 16 / elem);
  L.nch = L.gp * elem / 16;
  L.kmax = (L.nch + Q - 1) / Q * (16 / elem);
  L.steps = round_up(L.kmax, 16) / 16;
  L.pitch = mma ? L.steps * 16 + 8 : L.kmax;
  L.mpad = mma ? round_up(B, 16) : B;
  L.qu = Q * U;
  L.up = round_up(U, 4);
  L.w_rows = mma ? round_up(L.qu, 16) : L.qu;
  L.np = round_up(L.qu, 8) + 1;
  L.npairs = (L.np / 8 + 1) / 2;
  int ks = 1;
  if (mma) {  // the K slices that give each warp one item, if there are
    ks = kWarps / (L.mpad / 16 * L.npairs);
    ks = ks < 1 ? 1 : ks;
    ks = ks < kKSlices ? ks : kKSlices;
    ks = ks < L.steps ? ks : L.steps;
  }
  L.kslices = ks;
  L.recv_off = 16;
  L.dc_off =
      L.recv_off + align16(sizeof(float) * static_cast<size_t>(Q) * B * L.up);
  L.red_off = L.dc_off + align16(sizeof(float) * static_cast<size_t>(B) * U);
  L.w_off = L.red_off +
            align16(sizeof(float) * static_cast<size_t>(ks) * L.mpad * L.np);
  L.a_off = L.w_off + align16(static_cast<size_t>(elem) * L.w_rows * L.pitch);
  L.bytes = L.a_off + align16(static_cast<size_t>(elem) * L.mpad * L.pitch);
  return L;
}

// shared memory of a streamed forward block and of a streamed backward
// block (pallas_kernels.py:_lstm_smem mirrors them):
// streamed forward out_s [B][4U] f32 | c_s [B][U] f32 | w_s [4U][H] |
//                  a_s [B][KC]
// streamed backward dh_s [B][U] f32 | dc_s [B][U] f32 | wc_s [U][4H] |
//                   a_s [B][KC]
inline size_t fwd_streamed_smem(int B, int H, int U, int elem) {
  return sizeof(float) * 5 * static_cast<size_t>(B) * U +
         static_cast<size_t>(elem) *
             (4 * static_cast<size_t>(U) * H +
              static_cast<size_t>(B) * chunk_cols(B, H, elem));
}
inline size_t bwd_streamed_smem(int B, int H, int U, int elem) {
  return sizeof(float) * 2 * static_cast<size_t>(B) * U +
         static_cast<size_t>(elem) *
             (4 * static_cast<size_t>(U) * H +
              static_cast<size_t>(B) * chunk_cols(B, 4 * H, elem));
}

// rows [0, B) x 16-byte chunks [lo, hi) of h (pitch hp) into a_s (pitch
// `pitch`), one cp.async a chunk, as one commit group: a warp a row, its
// lanes over the chunks
template <typename T>
__device__ __forceinline__ void stage_h(const T* h, int hp, T* a_s,
                                        int pitch, int B, int lo, int hi) {
  constexpr int kPer = 16 / sizeof(T);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < B; r += kWarps)
    for (int c = (lo + lane) * kPer; c < hi * kPer; c += 32 * kPer)
      cp_async16(smem_addr(a_s + r * pitch + c),
                 h + static_cast<size_t>(r) * hp + c);
  cp_async_commit();
}

// red[r][c] = sum over k16 steps s0 .. s1 - 1 of a_s[r][k] w_s[c][k] for
// the 16 rows of m16 tile mt and the first `ntiles` n8 tiles of w_s, NT at
// a time (NT even; the backward's warps take 2): one warp's K slice, f32
// partial sums, on the tensor cores. a_s, w_s: bf16 (rows, pitch) in
// shared memory; red: (rows, np) f32.
template <int NT = kMaxNT>
__device__ __forceinline__ void mma_slice(const __nv_bfloat16* a_s,
                                          const __nv_bfloat16* w_s, int pitch,
                                          int mt, int s0, int s1, int ntiles,
                                          float* red, int np) {
  const int lane = threadIdx.x % 32;
  // the lane's ldmatrix row: A x4 = (rows 0-7 | 8-15) x (k 0-7 | 8-15);
  // B x4 = (n tile j, k 0-7), (j, k 8-15), (j + 1, k 0-7), (j + 1, k 8-15)
  const uint32_t a_base =
      smem_addr(a_s + (mt * 16 + lane % 16) * pitch + (lane / 16) * 8);
  const uint32_t w_base = smem_addr(
      w_s + ((lane / 16) * 8 + lane % 8) * pitch + ((lane / 8) % 2) * 8);
  for (int n0 = 0; n0 < ntiles; n0 += NT) {
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    for (int s = s0; s < s1; ++s) {
      uint32_t a[4];
      ldsm_x4(a, a_base + s * 32);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        if (n0 + j < ntiles) {
          uint32_t b[4];
          ldsm_x4(b, w_base + (n0 + j) * 8 * pitch * 2 + s * 32);
          mma_bf16(acc[j], a, b[0], b[1]);
          if (n0 + j + 1 < ntiles) mma_bf16(acc[j + 1], a, b[2], b[3]);
        }
      }
    }
    // accumulator e of tile j: row lane / 4 (+ 8 for e >= 2), column
    // 2 (lane % 4) + e % 2
    const int r = mt * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (n0 + j < ntiles) {
        const int c = (n0 + j) * 8 + 2 * (lane % 4);
        red[r * np + c] = acc[j][0];
        red[r * np + c + 1] = acc[j][1];
        red[(r + 8) * np + c] = acc[j][2];
        red[(r + 8) * np + c + 1] = acc[j][3];
      }
    }
  }
}

// out[r * ldo + c] = sum_k a_s[r * pitch + k] w_s[c * pitch + k] for r < R,
// c < C, k < K, f32 on the FMA units, both operands in shared memory:
// block_gemm's tiles and butterfly over an operand already staged
__device__ void fma_product(const float* a_s, const float* w_s, int pitch,
                            int R, int K, int C, float* out, int ldo) {
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
#pragma unroll
    for (int s = 0; s < kMaxTiles; ++s) {
      const int tile = base + warp + s * kWarps;
      if (tile < tiles) {
        const int r0 = (tile / tiles_c) * 4, c0 = (tile % tiles_c) * 4;
        const float* ar[4];
        const float* wr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ar[i] = a_s + min(r0 + i, R - 1) * pitch;
          wr[i] = w_s + min(c0 + i, C - 1) * pitch;
        }
        for (int k = lane; k < K; k += 32) {
          float a[4], w[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = ar[i][k];
            w[i] = wr[i][k];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[s][i][j] = fmaf(a[i], w[j], acc[s][i][j]);
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
}

// gate inputs loaded early: the dtype's raw bits, converted where used. The
// load is volatile asm, so the compiler issues it where it stands and
// cannot move it down to its use; the use waits for it
__device__ __forceinline__ void load_early(float& v, const float* p) {
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
}
__device__ __forceinline__ void load_early(unsigned short& v,
                                           const __nv_bfloat16* p) {
  asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(v) : "l"(p));
}
__device__ __forceinline__ float raw_f32(float v) { return v; }
__device__ __forceinline__ float raw_f32(unsigned short v) {
  return __bfloat162float(__ushort_as_bfloat16(v));
}

// the four gate inputs of pair p (batch row b = p / nu, unit j0 + p % nu)
// at one step: gx_t = gx[t]
template <typename T, typename R>
__device__ __forceinline__ void load_gates(R (&g)[4], const T* gx_t, int p,
                                           int nu, int j0, int H) {
  const int b = p / nu;
  const T* src = gx_t + static_cast<size_t>(b) * 4 * H + j0 + p - b * nu;
#pragma unroll
  for (int e = 0; e < 4; ++e) load_early(g[e], src + e * H);
}

struct FwdStep {  // what the cell update of one step needs
  const float* red_s;
  float* c_s;
  int kslices, mpad, np, nu, U, j0, H, B, hp;
};

struct CellOut {  // one pair's step outputs: h, c and the four gates
  float h, c, i, f, g, o;
};

// the cell update of pair p: the product's K slices summed in their fixed
// order, plus the gate inputs g_in; writes the new c into c_s and h into
// the exchange buffer h_out, and returns the step's outputs
template <typename T, typename R>
__device__ __forceinline__ CellOut cell_update(const FwdStep& st, int p,
                                               const R (&g_in)[4], T* h_out) {
  const int b = p / st.nu, u = p - b * st.nu;
  // the unit's four gate sums of every slice, 16 bytes a slice, all loads
  // issued before the first add
  float4 part[kKSlices];
#pragma unroll
  for (int ks = 0; ks < kKSlices; ++ks)
    part[ks] = ks < st.kslices
                   ? *reinterpret_cast<const float4*>(
                         st.red_s +
                         (static_cast<size_t>(ks) * st.mpad + b) * st.np +
                         u * 4)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int ks = 0; ks < kKSlices; ++ks) {
    acc[0] += part[ks].x;
    acc[1] += part[ks].y;
    acc[2] += part[ks].z;
    acc[3] += part[ks].w;
  }
  CellOut o;
  o.i = sigmoid(raw_f32(g_in[0]) + acc[0]);
  o.f = sigmoid(raw_f32(g_in[1]) + acc[1]);
  o.g = tanhf(raw_f32(g_in[2]) + acc[2]);
  o.o = sigmoid(raw_f32(g_in[3]) + acc[3]);
  o.c = o.f * st.c_s[b * st.U + u] + o.i * o.g;
  st.c_s[b * st.U + u] = o.c;
  o.h = o.o * tanhf(o.c);
  store(h_out + b * st.hp + st.j0 + u, o.h);
  return o;
}

// pair p's outputs of step t: ys (and, training, c_all and the gates)
template <typename T, bool kSave>
__device__ __forceinline__ void store_outputs(const FwdStep& st, int t, int p,
                                              const CellOut& o, T* ys,
                                              float* c_all, T* gates) {
  const int b = p / st.nu, j = st.j0 + p - b * st.nu, H = st.H;
  const size_t row = static_cast<size_t>(t) * st.B + b;
  store(ys + row * H + j, o.h);
  if (kSave) {
    c_all[row * H + j] = o.c;
    T* g_out = gates + row * 4 * H + j;
    store(g_out, o.i);
    store(g_out + H, o.f);
    store(g_out + 2 * H, o.g);
    store(g_out + 3 * H, o.o);
  }
}

// forward over T steps. kSave: the training forward (c_all and gates
// saved, cT left to the caller as c_all[T - 1]); otherwise the inference
// forward (cT written, no residuals). bf16 runs its product on the tensor
// cores, f32 on the FMA units.
template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads)
    lstm_forward_kernel(const T* gx, const T* wh, const T* h0, const T* c0,
                        T* hx, T* ys, float* c_all, T* gates, T* cT, int nt,
                        int B, int H, int U) {
  constexpr bool kMma = sizeof(T) == 2;
  using R = typename std::conditional<kMma, unsigned short, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const FwdLayout L = fwd_layout(B, H, U, sizeof(T));
  const int warp = threadIdx.x / 32;
  const int j0 = blockIdx.x * U;
  const int nu = min(U, H - j0);
  const int pairs = B * nu;
  float* c_s = reinterpret_cast<float*>(smem);
  float* red_s = reinterpret_cast<float*>(smem + L.red_off);
  T* w_s = reinterpret_cast<T*>(smem + L.w_off);
  T* a_s = reinterpret_cast<T*>(smem + L.a_off);
  LSTM_TRACE_POINT(0, 0);
  // w_s row u * 4 + g = w_hh row g * H + j0 + u; rows past 4 nu and columns
  // past H are zero, and so is a_s: cp.async fills only rows < B and
  // columns < hp, and hx's columns past H are zero. kStage loads in flight
  // a thread before their stores (w_hh comes from device memory).
  const int nw = L.w_rows * L.pitch;
  for (int i0 = threadIdx.x; i0 < nw; i0 += kThreads * kStage) {
    float v[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int i = i0 + s * kThreads, r = i / L.pitch, k = i - r * L.pitch;
      v[s] = i < nw && r < 4 * nu && k < H
                 ? to_f32(wh[(static_cast<size_t>(r % 4) * H + j0 + r / 4) *
                                 H + k])
                 : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s)
      if (i0 + s * kThreads < nw) store(w_s + i0 + s * kThreads, v[s]);
  }
  for (int i = threadIdx.x; i < L.mpad * L.pitch; i += kThreads)
    store(a_s + i, 0.0f);
  // hx[1] = h0 (this block's units), and the last block zeroes both
  // buffers' padding columns, which nothing writes afterwards
  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const int b = p / nu, u = p - b * nu;
    c_s[b * U + u] = to_f32(c0[b * H + j0 + u]);
    hx[static_cast<size_t>(B + b) * L.hp + j0 + u] = h0[b * H + j0 + u];
  }
  if (blockIdx.x == gridDim.x - 1) {
    const int pad = L.hp - H;
    for (int i = threadIdx.x; i < 2 * B * pad; i += kThreads)
      store(hx + static_cast<size_t>(i / pad) * L.hp + H + i % pad, 0.0f);
  }
  grid.sync();  // hx[1] complete; a_s zeroed before the copies land in it
  const FwdStep st{red_s, c_s, L.kslices, L.mpad, L.np, nu, U, j0, H, B,
                   L.hp};
  // thread p updates pair p (and p + kThreads, ... where a block has more
  // pairs than threads); pair p's outputs other than hx stay in registers
  // across the barrier and are stored in the next step, behind its copies
  const int p0 = threadIdx.x;
  CellOut out;
  for (int t = 0; t < nt; ++t) {
    LSTM_TRACE_POINT(t, 1);
    // h_{t-1}: hx[1] holds h0 for step 0; step t reads what t - 1 wrote
    const T* h_prev = hx + static_cast<size_t>((t + 1) & 1) * B * L.hp;
    const int nch = L.hp * sizeof(T) / 16;
    // K slice ks takes steps ks S / KS .. (ks + 1) S / KS - 1; with the
    // tensor cores slices ks < ceil(KS / 2) form the first commit group
    const int KS = L.kslices, S = L.steps;
    const int split = kMma ? min(2 * ((KS + 1) / 2 * S / KS), nch) : nch;
    stage_h(h_prev, L.hp, a_s, L.pitch, B, 0, split);
    stage_h(h_prev, L.hp, a_s, L.pitch, B, split, nch);
    LSTM_TRACE_POINT(t, 2);
    // this step's gate inputs, in flight while h lands; then step t - 1's
    // outputs
    const T* gx_t = gx + static_cast<size_t>(t) * B * 4 * H;
    R g_in[4];
    if (p0 < pairs) {
      load_gates(g_in, gx_t, p0, nu, j0, H);
      if (t > 0)
        store_outputs<T, kSave>(st, t - 1, p0, out, ys, c_all, gates);
    }
    if constexpr (kMma) {
      const int ntiles = (4 * nu + 7) / 8;
      const int items = (L.mpad / 16) * KS;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        if (g == 0)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        __syncthreads();  // every thread's copies of group g have landed
        LSTM_TRACE_POINT(t, 3 + g);
        for (int item = warp; item < items; item += kWarps) {
          const int mt = item / KS, ks = item - mt * KS;
          if (ks * 2 / KS == g)
            mma_slice(a_s, w_s, L.pitch, mt, ks * S / KS, (ks + 1) * S / KS,
                      ntiles, red_s + static_cast<size_t>(ks) * L.mpad * L.np,
                      L.np);
        }
      }
    } else {
      cp_async_wait<0>();
      __syncthreads();
      LSTM_TRACE_POINT(t, 3);
      LSTM_TRACE_POINT(t, 4);
      fma_product(a_s, w_s, L.pitch, B, H, 4 * nu, red_s, L.np);
    }
    __syncthreads();  // red_s complete; a_s free for the next staging
    LSTM_TRACE_POINT(t, 5);
    T* h_out = hx + static_cast<size_t>(t & 1) * B * L.hp;
    if (p0 < pairs) out = cell_update(st, p0, g_in, h_out);
    for (int p = p0 + kThreads; p < pairs; p += kThreads) {
      R g[4];
      load_gates(g, gx_t, p, nu, j0, H);
      store_outputs<T, kSave>(st, t, p, cell_update(st, p, g, h_out), ys,
                              c_all, gates);
    }
    LSTM_TRACE_POINT(t, 6);
    if (t + 1 < nt) grid.sync();  // hx[t % 2] complete for every block
  }
  if (p0 < pairs)
    store_outputs<T, kSave>(st, nt - 1, p0, out, ys, c_all, gates);
  LSTM_TRACE_POINT(nt, 0);
  if (!kSave) {
    // each pair's c_s entry was written by this same thread
    for (int p = threadIdx.x; p < pairs; p += kThreads) {
      const int b = p / nu, u = p - b * nu;
      store(cT + b * H + j0 + u, c_s[b * U + u]);
    }
  }
}

// The forward for a shape whose block cannot hold all of h_{t-1} beside
// its slice of w_hh (fwd_layout's bytes above the card's limit, as at H
// 1500 with B 32, or B past 112 at H 650 in bf16): the same step loop, but
// h_{t-1} (ys[t - 1] or h0) streamed through shared memory in chunks of KC
// columns by block_gemm, on the FMA units in both dtypes, and no exchange
// buffer. Outputs and numerics as lstm_forward_kernel.
template <typename T, bool kSave>
__global__ void __launch_bounds__(kThreads)
    lstm_forward_streamed_kernel(const T* gx, const T* wh, const T* h0,
                                 const T* c0, T* ys, float* c_all, T* gates,
                                 T* cT, int nt, int B, int H, int U) {
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

// what the backward's cell update of one pair needs at one step, loaded
// early (raw bits, as load_early gives them)
template <typename R>
struct BwdIn {
  R g[4];     // the post-activation gates i, f, g, o
  R dy;       // the cotangent of h_t
  float c;    // c_t
  float cp;   // c_{t-1}, or c0 at t = 0
};

// the inputs of pair p (batch row b = p / nu, unit j0 + p % nu) at step t
template <typename T, typename R>
__device__ __forceinline__ void load_bwd_inputs(BwdIn<R>& in, const T* dy,
                                                const T* gates,
                                                const float* c_all,
                                                const T* c0, int t, int p,
                                                int nu, int j0, int B,
                                                int H) {
  const int b = p / nu, j = j0 + p - b * nu;
  const size_t row = static_cast<size_t>(t) * B + b;
  const T* ga = gates + row * 4 * H + j;
#pragma unroll
  for (int e = 0; e < 4; ++e) load_early(in.g[e], ga + e * H);
  load_early(in.dy, dy + row * H + j);
  load_early(in.c, c_all + row * H + j);
  if (t > 0)
    load_early(in.cp, c_all + (row - B) * H + j);
  else
    in.cp = to_f32(c0[b * H + j]);
}

struct BwdStep {  // what the backward's cell update needs
  const float* recv;
  float* dc_s;
  int Q, B, U, up, nu, j0, H, gp;
};

// the reverse cell update of pair p at step t: dh = dy + the carry (the
// cluster's partial sums for the pair's unit, added in block order q = 0
// .. Q - 1; none at t = T - 1), dc carried in dc_s; stores the pair's four
// dgates, rounded to the dtype, into dgx (and into the padded exchange
// row ex, where there is one)
template <typename T, typename R>
__device__ __forceinline__ void cell_backward(const BwdStep& st, int t,
                                              int p, const BwdIn<R>& in,
                                              bool carry, T* dgx, T* ex) {
  const int b = p / st.nu, u = p - b * st.nu, j = st.j0 + u, H = st.H;
  float part[kMaxQ];
#pragma unroll
  for (int r = 0; r < kMaxQ; ++r)
    part[r] = carry && r < st.Q ? st.recv[(r * st.B + b) * st.up + u] : 0.0f;
  float dhc = 0.0f;
#pragma unroll
  for (int r = 0; r < kMaxQ; ++r) dhc += part[r];
  const float dh = raw_f32(in.dy) + dhc;
  const float ig = raw_f32(in.g[0]), fg = raw_f32(in.g[1]);
  const float gg = raw_f32(in.g[2]), og = raw_f32(in.g[3]);
  const float tc = tanhf(in.c);
  const float d_o = dh * tc;
  const float dc = st.dc_s[b * st.U + u] + dh * og * (1.0f - tc * tc);
  const float v[4] = {(dc * gg) * ig * (1.0f - ig),
                      (dc * in.cp) * fg * (1.0f - fg),
                      (dc * ig) * (1.0f - gg * gg), d_o * og * (1.0f - og)};
  T* dg = dgx + (static_cast<size_t>(t) * st.B + b) * 4 * H + j;
#pragma unroll
  for (int e = 0; e < 4; ++e) store(dg + e * H, v[e]);
  if (ex != nullptr) {
#pragma unroll
    for (int e = 0; e < 4; ++e) store(ex + b * st.gp + j + e * H, v[e]);
  }
  st.dc_s[b * st.U + u] = dc * fg;
}

// The backward over T steps, t = T - 1 down to 0, on a cooperative launch
// of clusters of Q blocks (cluster rank q = blockIdx.x % Q); block k owns
// units j0 = k U .. j0 + U - 1 for the cell update, its cluster the Q U
// units from jc = (k - q) U. A step:
//   1. the cell update of the block's pairs (after its mbarrier says the
//      peers' partial sums have arrived) writes dgx[t]: the exchange is
//      dgx[t] itself, or, for a bf16 row of 4H that is not a whole number
//      of 16 bytes, the padded buffer xb[t % 2];
//   2. the grid barrier;
//   3. the block stages only its share of the contraction, columns
//      [m_lo, m_hi) of every row of dgx[t], by cp.async, and issues the
//      next step's input loads;
//   4. the product of that share with w_hh[share, the cluster's units]:
//      a partial dh_{t-1} (B, QU) in f32 (bf16 on the tensor cores, f32
//      on the FMA units);
//   5. one thread a (unit owner, batch row) adds the K slices of its U
//      sums in order and sends them, 16 bytes a store, into the owner's
//      recv slot for this block with st.async, counted on the owner's
//      mbarrier; no cluster barrier: each owner waits for its own bytes.
// The cell update adds its unit's Q slots in block order. Every output
// element has one writer and a fixed order of sums: two runs give the same
// bits. recv is reused every step: the pushes of step t - 1 come after the
// grid barrier that follows every owner's reads of step t's sums.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_backward_kernel(const T* dy, const T* gates, const float* c_all,
                         const T* c0, const T* dcT, const T* wh, T* dgx,
                         T* xb, T* dh0, T* dc0, int nt, int B, int H, int Q,
                         int U) {
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int kPer = 16 / sizeof(T);
  using R = typename std::conditional<kMma, unsigned short, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const BwdLayout L = bwd_layout(B, H, Q, U, sizeof(T));
  const int warp = threadIdx.x / 32;
  const int q = static_cast<int>(cluster.block_rank());
  const int j0 = blockIdx.x * U, jc = j0 - q * U;
  const int nu = max(0, min(U, H - j0));
  const int pairs = B * nu;
  const int G = 4 * H;
  // the share: chunks [c_lo, c_hi) of an exchange row, elements from m_lo
  const int c_lo = q * L.nch / Q, c_hi = (q + 1) * L.nch / Q;
  const int m_lo = c_lo * kPer, klen = (c_hi - c_lo) * kPer;
  const uint32_t bar = smem_addr(smem);
  float* recv = reinterpret_cast<float*>(smem + L.recv_off);
  float* dc_s = reinterpret_cast<float*>(smem + L.dc_off);
  float* red_s = reinterpret_cast<float*>(smem + L.red_off);
  T* w_s = reinterpret_cast<T*>(smem + L.w_off);
  T* a_s = reinterpret_cast<T*>(smem + L.a_off);
  LSTM_TRACE_POINT(0, 0);
  // w_s[c][k] = w_hh[m_lo + k][jc + c]; zero past the share, past 4H and
  // past H (neighbouring threads read neighbouring units of one w_hh row);
  // a_s is zero where cp.async never writes (rows past B, columns past the
  // share)
  const int nw = L.w_rows * L.pitch;
  for (int i0 = threadIdx.x; i0 < nw; i0 += kThreads * kStage) {
    float v[kStage];
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int i = i0 + s * kThreads, k = i / L.w_rows,
                c = i - k * L.w_rows;
      v[s] = i < nw && k < klen && m_lo + k < G && c < L.qu && jc + c < H
                 ? to_f32(wh[static_cast<size_t>(m_lo + k) * H + jc + c])
                 : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kStage; ++s) {
      const int i = i0 + s * kThreads, k = i / L.w_rows,
                c = i - k * L.w_rows;
      if (i < nw) store(w_s + c * L.pitch + k, v[s]);
    }
  }
  for (int i = threadIdx.x; i < L.mpad * L.pitch; i += kThreads)
    store(a_s + i, 0.0f);
  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const int b = p / nu, u = p - b * nu;
    dc_s[b * U + u] = to_f32(dcT[b * H + j0 + u]);
  }
  // the padded exchange's columns past 4H, never written afterwards, are
  // zero before any block stages them (after the first grid barrier)
  if (xb != nullptr && blockIdx.x == gridDim.x - 1) {
    const int pad = L.gp - G;
    for (int i = threadIdx.x; i < 2 * B * pad; i += kThreads)
      store(xb + static_cast<size_t>(i / pad) * L.gp + G + i % pad, 0.0f);
  }
  // the mbarrier: one arrival a phase (thread 0's, which sets the bytes the
  // phase waits for: a row of up floats for each batch row from each of
  // the Q blocks); initialised before any peer can send (cluster barrier)
  const uint32_t recv_bytes = 4u * Q * B * L.up;
  if (threadIdx.x == 0 && pairs > 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster.sync();
  if (threadIdx.x == 0 && pairs > 0) mbar_expect(bar, recv_bytes);
  const BwdStep st{recv, dc_s, Q, B, U, L.up, nu, j0, H, L.gp};
  const int p0 = threadIdx.x;
  BwdIn<R> in;
  // thread p0 < pairs updates pair p0, and loads its next inputs early
  if (p0 < pairs) load_bwd_inputs(in, dy, gates, c_all, c0, nt - 1, p0, nu,
                                  j0, B, H);
  for (int t = nt - 1; t >= 0; --t) {
    LSTM_TRACE_POINT(t, 1);
    T* ex = xb != nullptr ? xb + static_cast<size_t>(t & 1) * B * L.gp
                          : nullptr;
    // the sums of step t + 1's product (phase nt - 2 - t) have arrived;
    // then thread 0 opens the phase of this step's
    const bool carry = t + 1 < nt;
    if (carry && p0 < pairs) mbar_wait(bar, (nt - 2 - t) & 1);
    if (p0 < pairs) cell_backward(st, t, p0, in, carry, dgx, ex);
    if (carry && threadIdx.x == 0 && pairs > 0) mbar_expect(bar, recv_bytes);
    for (int p = p0 + kThreads; p < pairs; p += kThreads) {
      BwdIn<R> x;
      load_bwd_inputs(x, dy, gates, c_all, c0, t, p, nu, j0, B, H);
      cell_backward(st, t, p, x, carry, dgx, ex);
    }
    LSTM_TRACE_POINT(t, 2);
    grid.sync();  // dgx[t] complete for every block
    LSTM_TRACE_POINT(t, 3);
    const T* src = ex != nullptr
                       ? ex
                       : dgx + static_cast<size_t>(t) * B * G;
    stage_h(src + m_lo, L.gp, a_s, L.pitch, B, 0, c_hi - c_lo);
    // the next step's inputs, in flight while the share lands
    if (t > 0 && p0 < pairs)
      load_bwd_inputs(in, dy, gates, c_all, c0, t - 1, p0, nu, j0, B, H);
    LSTM_TRACE_POINT(t, 4);
    cp_async_wait<0>();
    __syncthreads();
    LSTM_TRACE_POINT(t, 5);
    if constexpr (kMma) {
      const int KS = L.kslices, S = L.steps, NP = L.npairs;
      const int items = L.mpad / 16 * NP * KS;
      for (int item = warp; item < items; item += kWarps) {
        const int ks = item % KS, n2 = item / KS % NP, mt = item / KS / NP;
        mma_slice<2>(a_s, w_s + n2 * 16 * L.pitch, L.pitch, mt,
                     ks * S / KS, (ks + 1) * S / KS,
                     min(2, L.np / 8 - 2 * n2),
                     red_s + static_cast<size_t>(ks) * L.mpad * L.np +
                         n2 * 16,
                     L.np);
      }
    } else {
      fma_product(a_s, w_s, L.pitch, B, klen, L.qu, red_s, L.np);
    }
    __syncthreads();  // red_s complete; a_s free for the next staging
    LSTM_TRACE_POINT(t, 6);
    // thread i sends batch row b of owner o's U sums (its K slices added
    // in order), padded to up floats, 16 bytes a store
    for (int i = threadIdx.x; i < Q * B; i += kThreads) {
      const int o = i / B, b = i - o * B;
      if (jc + o * U >= H) continue;  // the owner has no units
      const float* sums = red_s + static_cast<size_t>(b) * L.np + o * U;
      const uint32_t dst = mapa(smem_addr(recv + (q * B + b) * L.up), o);
      const uint32_t obar = mapa(bar, o);
      for (int u0 = 0; u0 < L.up; u0 += 4) {
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int ks = 0; ks < L.kslices; ++ks) {
          const float* slice = sums + static_cast<size_t>(ks) * L.mpad * L.np;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (u0 + e < U) v[e] += slice[u0 + e];
        }
        st_async16(dst + 16 * (u0 / 4), make_float4(v[0], v[1], v[2], v[3]),
                   obar);
      }
    }
    LSTM_TRACE_POINT(t, 7);
  }
  // dh0: the sums of step 0's product; no block leaves while a peer may
  // still send to it
  if (pairs > 0) mbar_wait(bar, (nt - 1) & 1);
  cluster.sync();
  LSTM_TRACE_POINT(nt, 0);
  for (int p = threadIdx.x; p < pairs; p += kThreads) {
    const int b = p / nu, u = p - b * nu;
    float dhc = 0.0f;
    for (int r = 0; r < Q; ++r) dhc += recv[(r * B + b) * L.up + u];
    store(dh0 + b * H + j0 + u, dhc);
    store(dc0 + b * H + j0 + u, dc_s[b * U + u]);
  }
}

// The backward for a shape whose block cannot hold its layout (bwd_layout's
// bytes above the card's limit, as at H 1500 with B 32 in bf16, or B past
// 112 at H 650 in f32): one block an SM with U = ceil(H / #SMs) units, a
// cooperative launch, and the whole of dgx[t] streamed through shared
// memory in chunks of KC columns by block_gemm, on the FMA units in both
// dtypes. Outputs and numerics as lstm_backward_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    lstm_backward_streamed_kernel(const T* dy, const T* gates,
                                  const float* c_all, const T* c0,
                                  const T* dcT, const T* wh, T* dgx, T* dh0,
                                  T* dc0, int nt, int B, int H, int U) {
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

// the barriers of the backward's launch (cooperative, with clusters), for
// lstm_cluster_probe: kind 0 the grid barrier, 1 the cluster barrier
__global__ void cluster_probe_kernel(int kind, int iters) {
  for (int i = 0; i < iters; ++i) {
    if (kind == 0)
      cg::this_grid().sync();
    else
      cg::this_cluster().sync();
  }
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
int forward(const T* gx, const T* wh, const T* h0, const T* c0, T* hx,
            T* ys, float* c_all, T* gates, T* cT, int nt, int B, int H,
            cudaStream_t stream) {
  if (!shape_ok(nt, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  int U = units_per_block(H);
  const int blocks = (H + U - 1) / U;
  const size_t smem = fwd_layout(B, H, U, sizeof(T)).bytes;
  int dev = 0, most = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > static_cast<size_t>(most)) {
    void* args[] = {&gx, &wh, &h0, &c0, &ys, &c_all, &gates, &cT,
                    &nt, &B, &H, &U};
    return launch(lstm_forward_streamed_kernel<T, kSave>, blocks,
                  fwd_streamed_smem(B, H, U, sizeof(T)), args, stream);
  }
  void* args[] = {&gx, &wh, &h0, &c0, &hx, &ys, &c_all, &gates, &cT,
                  &nt, &B, &H, &U};
  return launch(lstm_forward_kernel<T, kSave>, blocks, smem, args, stream);
}

// Co-resident clusters of Q blocks of `kernel` at one block an SM (the
// query asks with the block's most dynamic shared memory), cached per
// device and cluster size (the kernels of a backward launch take the same
// 512 threads and one block an SM, so one kernel's count holds for all).
template <typename Kernel>
cudaError_t cluster_capacity(Kernel kernel, int Q, int dev, int most,
                             int* n) {
  constexpr int kDevices = 64;
  static int cache[kDevices][kMaxQ + 1] = {};  // count + 1; 0: not asked
  if (dev >= 0 && dev < kDevices && cache[dev][Q] > 0) {
    *n = cache[dev][Q] - 1;
    return cudaSuccess;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Q);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = most;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(n, reinterpret_cast<const void*>(kernel),
                                     &cfg);
  if (e == cudaSuccess && dev >= 0 && dev < kDevices) cache[dev][Q] = *n + 1;
  return e;
}

// The backward's clusters at hidden size H: Q, the largest of 8, 4 and 2
// of which the card holds a cluster at one block an SM; U = ceil(H / (n
// Q)) units a block for the n co-resident clusters of that size; and the
// clusters that cover H. Returns the CUDA error
// (cudaErrorInvalidConfiguration if no cluster size is admitted).
template <typename Kernel>
cudaError_t bwd_grid(Kernel kernel, int H, int dev, int most, int* Q,
                     int* U, int* clusters) {
  for (int q = kMaxQ; q >= 2; q /= 2) {
    int n = 0;
    cudaError_t e = cluster_capacity(kernel, q, dev, most, &n);
    if (e != cudaSuccess) return e;
    if (n < 1) continue;
    *Q = q;
    *U = (H + n * q - 1) / (n * q);
    *clusters = (H + q * *U - 1) / (q * *U);
    return cudaSuccess;
  }
  return cudaErrorInvalidConfiguration;
}

// a cooperative launch (its blocks co-resident, so cooperative groups'
// grid barrier holds) of clusters of Q blocks
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, int clusters, int Q, size_t smem,
                    cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * Q);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return fail(e);
  return static_cast<int>(cudaGetLastError());
}

// xb: the padded exchange (2, B, gp), given exactly when a bf16 row of 4H
// is not a whole number of 16 bytes (odd H)
template <typename T>
int backward(const T* dy, const T* gates, const float* c_all, const T* c0,
             const T* dcT, const T* wh, T* dgx, T* xb, T* dh0, T* dc0, int nt,
             int B, int H, cudaStream_t stream) {
  if (!shape_ok(nt, B, H)) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, most = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  auto kernel = lstm_backward_kernel<T>;
  int Q = 0, U = 0, clusters = 0;
  cudaError_t e = bwd_grid(kernel, H, dev, most, &Q, &U, &clusters);
  if (e != cudaSuccess) return fail(e);
  const BwdLayout L = bwd_layout(B, H, Q, U, sizeof(T));
  if (L.bytes <= static_cast<size_t>(most)) {
    if ((L.gp != 4 * H) != (xb != nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L.bytes));
    if (e != cudaSuccess) return fail(e);
    return launch_clusters(kernel, clusters, Q, L.bytes, stream, dy, gates,
                           c_all, c0, dcT, wh, dgx, xb, dh0, dc0, nt, B, H, Q,
                           U);
  }
  U = units_per_block(H);
  const int blocks = (H + U - 1) / U;
  void* args[] = {&dy, &gates, &c_all, &c0, &dcT, &wh, &dgx, &dh0, &dc0,
                  &nt, &B, &H, &U};
  return launch(lstm_backward_streamed_kernel<T>, blocks,
                bwd_streamed_smem(B, H, U, sizeof(T)), args, stream);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. hx: (2, B, HP), HP = H rounded up to 16
// bytes: scratch for the h exchange, any contents
extern "C" int lstm_infer(const void* gx, const void* wh, const void* h0,
                          const void* c0, void* hx, void* ys, void* cT,
                          int dtype, int nt, int B, int H, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return forward<float, false>(
        static_cast<const float*>(gx), static_cast<const float*>(wh),
        static_cast<const float*>(h0), static_cast<const float*>(c0),
        static_cast<float*>(hx), static_cast<float*>(ys), nullptr, nullptr,
        static_cast<float*>(cT), nt, B, H, s);
  if (dtype == 1)
    return forward<__nv_bfloat16, false>(
        static_cast<const __nv_bfloat16*>(gx),
        static_cast<const __nv_bfloat16*>(wh),
        static_cast<const __nv_bfloat16*>(h0),
        static_cast<const __nv_bfloat16*>(c0),
        static_cast<__nv_bfloat16*>(hx), static_cast<__nv_bfloat16*>(ys),
        nullptr, nullptr, static_cast<__nv_bfloat16*>(cT), nt, B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int lstm_fwd(const void* gx, const void* wh, const void* h0,
                        const void* c0, void* hx, void* ys, void* c_all,
                        void* gates, int dtype, int nt, int B, int H,
                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ca = static_cast<float*>(c_all);
  if (dtype == 0)
    return forward<float, true>(
        static_cast<const float*>(gx), static_cast<const float*>(wh),
        static_cast<const float*>(h0), static_cast<const float*>(c0),
        static_cast<float*>(hx), static_cast<float*>(ys), ca,
        static_cast<float*>(gates), nullptr, nt, B, H, s);
  if (dtype == 1)
    return forward<__nv_bfloat16, true>(
        static_cast<const __nv_bfloat16*>(gx),
        static_cast<const __nv_bfloat16*>(wh),
        static_cast<const __nv_bfloat16*>(h0),
        static_cast<const __nv_bfloat16*>(c0),
        static_cast<__nv_bfloat16*>(hx), static_cast<__nv_bfloat16*>(ys), ca,
        static_cast<__nv_bfloat16*>(gates), nullptr, nt, B, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// xb: (2, B, GP) scratch, GP = 4H rounded up to 16 bytes, when that is
// not 4H (bfloat16 with odd H), else null
extern "C" int lstm_bwd(const void* dy, const void* gates, const void* c_all,
                        const void* c0, const void* dcT, const void* wh,
                        void* dgx, void* xb, void* dh0, void* dc0, int dtype,
                        int nt, int B, int H, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ca = static_cast<const float*>(c_all);
  if (dtype == 0)
    return backward<float>(
        static_cast<const float*>(dy), static_cast<const float*>(gates), ca,
        static_cast<const float*>(c0), static_cast<const float*>(dcT),
        static_cast<const float*>(wh), static_cast<float*>(dgx),
        static_cast<float*>(xb), static_cast<float*>(dh0),
        static_cast<float*>(dc0), nt, B, H, s);
  if (dtype == 1)
    return backward<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(gates), ca,
        static_cast<const __nv_bfloat16*>(c0),
        static_cast<const __nv_bfloat16*>(dcT),
        static_cast<const __nv_bfloat16*>(wh),
        static_cast<__nv_bfloat16*>(dgx), static_cast<__nv_bfloat16*>(xb),
        static_cast<__nv_bfloat16*>(dh0), static_cast<__nv_bfloat16*>(dc0),
        nt, B, H, s);
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

// A measurement aid, not on any path: `iters` barriers of a launch as the
// backward's at hidden size H (cooperative, its clusters, one block an
// SM): kind 0 the grid barrier, 1 the cluster barrier. grid[0..2]
// receives the blocks, Q and U.
extern "C" int lstm_cluster_probe(int kind, int H, int iters, int* grid,
                                  void* stream) {
  if (H < 1 || kind < 0 || kind > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, most = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int Q = 0, U = 0, clusters = 0;
  cudaError_t e = bwd_grid(lstm_backward_kernel<__nv_bfloat16>, H, dev, most,
                           &Q, &U, &clusters);
  if (e != cudaSuccess) return fail(e);
  grid[0] = clusters * Q;
  grid[1] = Q;
  grid[2] = U;
  e = cudaFuncSetAttribute(cluster_probe_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e != cudaSuccess) return fail(e);
  return launch_clusters(cluster_probe_kernel, clusters, Q, most,
                         static_cast<cudaStream_t>(stream), kind, iters);
}

#ifdef LSTM_TRACE
// the trace points (see LSTM_TRACE_POINT) of the last traced launch:
// clock[kTraceSteps + 1][kTracePoints] SM cycles, then as many global-timer
// ns; returns the CUDA error
extern "C" int lstm_trace_read(long long* clock, long long* ns) {
  cudaError_t e =
      cudaMemcpyFromSymbol(clock, trace_clock, sizeof(trace_clock));
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(ns, trace_ns, sizeof(trace_ns));
  return static_cast<int>(e);
}
#endif
