// Paged decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas_kernels.py:_paged_kernel
// (pl.pallas_call at :1243, reached through paged_attention :1271): one
// query token per sequence attends over that sequence's keys and values,
// which live scattered across fixed-size pages of a pool and are named by
// a per-sequence page table.
//
//   q        (B, H, D)        float32
//   k, v     (P, H, ps, D)    float32 or bfloat16 (one page pool per layer)
//   tables   (B, maxp)        int32, page of token t is tables[b, t / ps]
//   lengths  (B,)             int32, tokens [0, lengths[b]) are live
//   out      (B, H, D)        float32
//
// Bound on the card: bytes. Each step reads the live K/V rows once
// (2 * sum_b lengths[b] * H * D * sizeof(T)) plus q and out; the arithmetic
// is about 2 FLOPs per K/V element (0.5 FLOP/byte in f32, 1 in bf16), far
// below the ~20 FLOP/byte where an H100 (3.35 TB/s, 67 TFLOP/s f32 outside
// the tensor cores) stops being memory-bound. Tensor cores do not help a
// one-row product, so the design is about bytes in flight:
//   * Blocks over (b, h) and a split of the sequence's pages. When B * H
//     gives fewer than two blocks an SM, a (b, h) is split across up to 8
//     blocks of one thread-block cluster (cudaLaunchKernelEx with a
//     cluster dimension); the split count comes from B * H and the pages a
//     sequence can hold, and each block takes its share of the pages that
//     are live (ceil(lengths[b] / ps)), so a short sequence's blocks find
//     little or nothing to read. The blocks' (m, l, acc) are merged by the
//     cluster's first block through distributed shared memory, after a
//     cluster barrier, in split order. B = 32 at H = 12 needs no split.
//   * The TPU ran a sequential (b, page) grid and carried the softmax state
//     in VMEM scratch; here the block walks its pages in chunks of 16
//     tokens with one online-softmax state. A chunk's K and V rows are
//     copied into a four-stage shared-memory ring with 16-byte cp.async,
//     three chunks ahead of their use, so each block keeps up to 48 rows of
//     K and V in flight instead of one dependent row at a time. The length,
//     the query and the page-table row are loaded together when the block
//     starts (the row into shared memory, once), so the first K/V copy
//     waits on one round trip, not a chain of three. Each row's address
//     comes from the staged row (rows of one page are contiguous per head,
//     and any page size works): one page lookup a thread a chunk. A row of
//     more than 4096 pages is not staged and is read from device memory.
//     K/V rows past the live length, or on a page index outside [0, P),
//     are zero-filled and masked: never read.
//   * Lanes over tokens: the 8 lanes that stage a row also score it, each
//     dotting its share of the row as 16-byte vectors with the query held
//     in registers, then three shuffles. The chunk's 16 scores meet in
//     shared memory: one max and one rescale a chunk, not a serial chain a
//     token. P v with lanes over D: each thread owns one 16-byte column
//     vector of the row and a set of the chunk's tokens, and the block's
//     token groups are summed once, in a fixed order, at the end.
//   * When D * sizeof(T) is not a multiple of 16 bytes (bf16 D = 20) or a
//     pool is not 16-byte aligned, the same layout (rows padded with zeros
//     to whole 16-byte vectors) is filled by element loads instead; no
//     vector load reaches past a row.
// Numerics kept from the TPU kernel: f32 accumulation for f32 and bf16
// pages, the finite -1e30 initial max, l clamped at 1e-30. The softmax runs
// in base 2 (scores scaled by sm_scale * log2(e), exp2f). A row with
// lengths[b] <= 0 (the scheduler's inert padding) writes zeros. No atomics:
// every sum has a fixed order, so two runs give the same bits.
//
// The kernel launches on the caller's stream, allocates nothing and does
// not synchronise. Each entry point returns the launch's error, then
// cudaGetLastError() (cudaErrorInvalidValue for a shape it does not take).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 16;                 // tokens a block scores at once
constexpr int kGroup = kThreads / kChunk;  // lanes that score one token
constexpr int kStages = 4;                 // ring of chunks in shared memory
constexpr int kMaxSplit = 8;               // portable cluster size
constexpr int kMaxD = 128;
constexpr int kTableMax = 4096;  // longest page-table row staged
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;

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
// wait until at most N of this thread's copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one 16-byte vector of shared memory as floats
__device__ __forceinline__ void vec_f32(float (&x)[4], const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void vec_f32(float (&x)[8], const bf16* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void set_zero(float& x) { x = 0.f; }
__device__ __forceinline__ void set_zero(bf16& x) { x = __float2bfloat16(0.f); }

// A block: sequence b = blockIdx.x / H, head h, split blockIdx.y of
// `splits` (the cluster's blocks, when splits > 1). Dynamic shared memory:
// the ring (kStages x {K, V} x kChunk rows of `pitch` elements), then the
// page-table row (`table_smem` = maxp entries staged, or 0: the row is
// read from device memory).
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ tables,
                    const int* __restrict__ lengths, float* __restrict__ out,
                    int H, int D, int P, int ps, int maxp, float scale_log2,
                    int splits, int table_smem, int vec) {
  constexpr int VE = 16 / sizeof(T);         // elements a 16-byte vector
  constexpr int kQVecs = kMaxD / VE / kGroup;  // row vectors a lane owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(16) float sS[kChunk];  // the chunk's scores
  __shared__ int sLive[kStages][kChunk];      // a staged row is live
  __shared__ float sAcc[kThreads * 8];        // token groups' acc
  __shared__ float sLg[kThreads];             // token groups' l
  __shared__ float sOut[kMaxD];               // the block's acc
  __shared__ float sMl[2];                    // the block's m, l

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int split = blockIdx.y;
  const int DV = (D + VE - 1) / VE;  // 16-byte vectors a staged row
  const int pitch = DV * VE;
  T* ring = reinterpret_cast<T*>(smem_raw);
  int* sTable = reinterpret_cast<int*>(ring + kStages * 2 * kChunk * pitch);

  // the length, the query and the page-table row are independent loads,
  // issued together before anything waits on one of them. Staging and
  // scoring: lanes kGroup * tok .. + kGroup - 1 own row tok of a chunk,
  // lane `part` of them its 16-byte vectors part, part + kGroup, ...
  const int len = lengths[b];
  const int tok = tid / kGroup;
  const int part = tid - tok * kGroup;
  float qv[kQVecs][VE];
  const float* qp = q + static_cast<size_t>(bh) * D;
#pragma unroll
  for (int i = 0; i < kQVecs; ++i)
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const int d = (part + kGroup * i) * VE + e;
      qv[i][e] = d < D ? qp[d] * scale_log2 : 0.f;
    }
  const int* row = tables + static_cast<size_t>(b) * maxp;
  if (table_smem)
    for (int j = tid; j < maxp; j += kThreads) sTable[j] = row[j];
  float* o = out + static_cast<size_t>(bh) * D;
  if (len <= 0) {  // uniform across the cluster: no block reaches a barrier
    if (split == 0)
      for (int d = tid; d < D; d += kThreads) o[d] = 0.f;
    return;
  }
  __syncthreads();

  // this split's pages [p0, p1) of the live ones, and its tokens [t0, t1)
  const long long cap = static_cast<long long>(maxp) * ps;
  const int end = len < cap ? len : static_cast<int>(cap);
  const int n_pages = (end + ps - 1) / ps;
  const int per = (n_pages + splits - 1) / splits;
  const int p0 = min(split * per, n_pages);
  const int p1 = min(p0 + per, n_pages);
  const int t0 = p0 * ps;
  const int t1 = min(p1 * ps, end);
  const int n_chunks = (t1 - t0 + kChunk - 1) / kChunk;
  const size_t page_stride = static_cast<size_t>(H) * ps * D;
  const size_t head_off = static_cast<size_t>(h) * ps * D;

  // row tok of chunk c into ring stage c % kStages: one page lookup a
  // thread; a row past t1 or on a page outside [0, P) is zeros, not read
  auto stage = [&](int c) {
    const int st = c % kStages;
    T* sk = ring + st * 2 * kChunk * pitch + tok * pitch;
    T* sv = sk + kChunk * pitch;
    const int t = t0 + c * kChunk + tok;
    int page = -1;
    size_t off = 0;
    if (t < t1) {
      const int j = t / ps;
      page = table_smem ? sTable[j] : row[j];
      if (page < 0 || page >= P) page = -1;
      else off = page * page_stride + head_off +
                 static_cast<size_t>(t - j * ps) * D;
    }
    if (part == 0) sLive[st][tok] = page >= 0;
    if (vec) {
#pragma unroll
      for (int i = 0; i < kQVecs; ++i) {
        const int vi = part + kGroup * i;
        if (vi < DV) {
          cp_async16(smem_addr(sk + vi * VE), k + off + vi * VE, page >= 0);
          cp_async16(smem_addr(sv + vi * VE), v + off + vi * VE, page >= 0);
        }
      }
    } else {
      for (int e = part; e < pitch; e += kGroup) {
        const bool ok = page >= 0 && e < D;
        if (ok) {
          sk[e] = k[off + e];
          sv[e] = v[off + e];
        } else {
          set_zero(sk[e]);
          set_zero(sv[e]);
        }
      }
    }
  };

  // P v: thread owns column vector `col` of the row for tokens grp,
  // grp + groups, ... of each chunk
  const int groups = kThreads / DV;
  const int grp = tid / DV;
  const int col = tid - grp * DV;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) stage(c);
    cp_async_commit();
  }
  float m = kNegInf;  // the block's running max (base 2), uniform
  float l = 0.f;      // this thread's part of the row sum
  float acc[VE];
#pragma unroll
  for (int e = 0; e < VE; ++e) acc[e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk c is in; every thread is done with chunk c - 1
    if (c + kStages - 1 < n_chunks) stage(c + kStages - 1);
    cp_async_commit();  // possibly empty: one group a chunk keeps the count
    const int st = c % kStages;
    const T* sk = ring + st * 2 * kChunk * pitch;
    const T* sv = sk + kChunk * pitch;

    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kQVecs; ++i) {
      const int vi = part + kGroup * i;
      if (vi < DV) {
        float x[VE];
        vec_f32(x, sk + tok * pitch + vi * VE);
#pragma unroll
        for (int e = 0; e < VE; ++e) s = fmaf(qv[i][e], x[e], s);
      }
    }
#pragma unroll
    for (int lane_bit = 1; lane_bit < kGroup; lane_bit <<= 1)
      s += __shfl_xor_sync(0xffffffffu, s, lane_bit);
    if (part == 0) sS[tok] = sLive[st][tok] ? s : kNegInf;
    __syncthreads();

    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kChunk; j += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(sS + j);
      mx = fmaxf(fmaxf(mx, s4.x), fmaxf(s4.y, fmaxf(s4.z, s4.w)));
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[e] *= alpha;
    if (grp < groups) {
      for (int j = grp; j < kChunk; j += groups) {
        const float p = exp2f(sS[j] - m);
        float x[VE];
        vec_f32(x, sv + j * pitch + col * VE);
        l += p;
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[e] = fmaf(p, x[e], acc[e]);
      }
    }
  }
  cp_async_wait<0>();

  // the block's token groups, summed in group order
  if (grp < groups) {
#pragma unroll
    for (int e = 0; e < VE; ++e) sAcc[grp * pitch + col * VE + e] = acc[e];
    if (col == 0) sLg[grp] = l;
  }
  __syncthreads();
  float res = 0.f;
  if (tid < D)
    for (int g = 0; g < groups; ++g) res += sAcc[g * pitch + tid];
  float lsum = 0.f;
  for (int g = 0; g < groups; ++g) lsum += sLg[g];

  if (splits == 1) {
    if (tid < D) o[tid] = res / fmaxf(lsum, 1e-30f);
    return;
  }
  // merge the cluster's splits in split order; a split that saw no live
  // token holds (m = -1e30, l = 0, acc = 0) and its weight is zero
  if (tid < D) sOut[tid] = res;
  if (tid == 0) {
    sMl[0] = m;
    sMl[1] = lsum;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's state is in its shared memory
  if (split == 0 && tid < D) {
    float mx = kNegInf;
    for (int r = 0; r < splits; ++r)
      mx = fmaxf(mx, cluster.map_shared_rank(sMl, r)[0]);
    float total = 0.f, sum = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* ml = cluster.map_shared_rank(sMl, r);
      const float w = exp2f(ml[0] - mx);
      total += ml[1] * w;
      sum += cluster.map_shared_rank(sOut, r)[tid] * w;
    }
    o[tid] = sum / fmaxf(total, 1e-30f);
  }
  cluster.sync();  // no block leaves while the first reads its memory
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 132;
  return count[dev];
}

template <typename T>
int launch(const float* q, const T* k, const T* v, const int* tables,
           const int* lengths, float* out, int B, int H, int D, int P, int ps,
           int maxp, float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || D <= 0 || D > kMaxD || P <= 0 || ps <= 0 ||
      maxp <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int VE = 16 / sizeof(T);
  const long long bh = static_cast<long long>(B) * H;
  if (bh > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // split a (b, h) over a cluster when B * H gives fewer than two blocks an
  // SM; never more splits than pages a sequence can hold
  const long long want = 2LL * sm_count();
  int splits = 1;
  if (bh < want) {
    const long long n = (want + bh - 1) / bh;
    const int most = maxp < kMaxSplit ? maxp : kMaxSplit;
    splits = n < most ? static_cast<int>(n) : most;
  }
  const int table_smem = maxp <= kTableMax ? maxp : 0;
  const int pitch = (D + VE - 1) / VE * VE;
  const size_t smem = sizeof(T) * kStages * 2 * kChunk * pitch +
                      sizeof(int) * static_cast<size_t>(table_smem);
  const bool vec = D % VE == 0 &&
                   (reinterpret_cast<uintptr_t>(k) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  auto kernel = paged_decode_kernel<T>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc != cudaSuccess) return static_cast<int>(rc);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(bh), splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  rc = cudaLaunchKernelEx(&cfg, kernel, q, k, v, tables, lengths, out, H, D,
                          P, ps, maxp, scale * kLog2e, splits, table_smem,
                          vec ? 1 : 0);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int paged_attention_f32(const void* q, const void* k,
                                   const void* v, const void* tables,
                                   const void* lengths, void* out, int B,
                                   int H, int D, int P, int ps, int maxp,
                                   float scale, void* stream) {
  return launch<float>(static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v),
                       static_cast<const int*>(tables),
                       static_cast<const int*>(lengths),
                       static_cast<float*>(out), B, H, D, P, ps, maxp, scale,
                       static_cast<cudaStream_t>(stream));
}

extern "C" int paged_attention_bf16(const void* q, const void* k,
                                    const void* v, const void* tables,
                                    const void* lengths, void* out, int B,
                                    int H, int D, int P, int ps, int maxp,
                                    float scale, void* stream) {
  return launch<bf16>(static_cast<const float*>(q),
                      static_cast<const bf16*>(k),
                      static_cast<const bf16*>(v),
                      static_cast<const int*>(tables),
                      static_cast<const int*>(lengths),
                      static_cast<float*>(out), B, H, D, P, ps, maxp, scale,
                      static_cast<cudaStream_t>(stream));
}
