// GCN aggregation out = diag(r) . A . diag(c) . H for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/gcn_spmm/kernel.py:
// scaled_spmm_blocked (body _scaled_spmm_kernel) and, with r = c = null,
// spmm_blocked (body _spmm_kernel). It computes what they compute, not how
// they tile it:
//   * c scales the adjacency's columns (the reference's `a * c` on each
//     adjacency tile); here it scales H's rows instead: each thread
//     multiplies the H elements it staged by their c (read into registers
//     while the copy is in flight) once its own copies have landed, before
//     the block barrier that publishes the stage. So a * (h * c) is rounded
//     where the reference rounds (a * c) * h: they differ by about an ulp;
//   * the product accumulates in fp32 registers with plain IEEE FMA (no TF32,
//     no split-TF32 emulation), in a loop over K inside the block;
//   * r multiplies the fp32 sum once, in the epilogue, and the result is
//     converted to the input type;
//   * ragged edges are zero-filled here, so the caller pads nothing.
// A, H and out share one type (fp32, bf16 or fp16); r and c are of that type
// too. The 2-byte types are widened to fp32 as they are staged, so all three
// run the same fp32 FMAs and round once, at the output. (An adjacency of
// another type than H's is promoted by the wrapper to fp32 with H, which is
// what the plain version computes: fp32 products, then a cast to H's type.)
//
// What bounds it on an H100: fp32 FMA throughput. The planner's largest
// bucket is M = N = 1024 with D = 213 (the GNN hidden width): 2 * 1024 * 1024 * 213
// = 4.47e8 flops over ~6.0 MB (A 4.19 MB, H and out 0.87 MB each), i.e.
// ~6.7 us at the 67 TFLOP/s fp32 peak against ~1.8 us at 3.35 TB/s.
//
// Design:
//   * Register tile: a block of 128 threads owns a 128-row x 32-column
//     output tile (7 column tiles cover D 213 with 5% waste); each thread
//     owns 8 rows (ty + 16 i) x 4 columns (4 tx ..). Per 4 K steps it reads 8
//     float4 of A (one per row, 4 K values each) and 4 float4 of H for 128
//     FMAs. A's tile rows are padded to 20 floats so a warp's 4 row reads hit 4
//     different bank groups. Shared memory is dynamic (40 KB: two stages
//     and the split-K receive buffer).
//   * Fill the card with split-K over a thread-block cluster: while the
//     output tiles and their K ranges are fewer than two blocks per SM, K is
//     cut into 2, 4 or 8 ranges (never below 64 K values each), one block of
//     a cluster per range (bucket 1024: 56 tiles x 8 = 448 blocks). Rank z
//     of the cluster owns rows [z, z + 1) * 128 / split of the tile; every
//     rank stores its partial rows into the owner's shared memory through
//     distributed shared memory, and after one cluster barrier the owner
//     sums them locally in rank order, applies r and stores. No atomics and
//     no scratch buffer: two calls on the same inputs give the same bits.
//     The stores are pushed, not pulled: remote loads would stall the owner
//     on their latency. Small buckets (bucket 64 is launch-bound) stay one
//     block per tile, with no cluster.
//   * Overlap: the A and H tiles of K step t + 1 are in flight by cp.async
//     while step t is multiplied (two stages). H rows of D 213 floats are
//     not 16-byte aligned, so H (and A when N % 4 != 0) moves by 4-byte
//     cp.async; A moves by 16-byte cp.async when its rows are aligned
//     (N % 4 == 0). bf16 inputs are widened to fp32 by plain loads and
//     stores into the same stages.
// What holds it back now: an SM retires a block's K step at about a third
// of the FMA peak whether it holds one block or four, so the limit lies
// inside the step (12 shared-memory loads and their operand traffic per 128
// FMAs), not in load latency; at bucket 1024 each block has only 8 K steps,
// so the pipeline's fill and the cluster barrier add to it. Gaps left for the next redesign: the fp32 FMA pipe is the
// ceiling without tensor cores (a 3xTF32 split would change the bound);
// persistent blocks that walk several tiles; a CUDA graph per planner
// bucket for the launch-bound small buckets.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBM = 128;  // output rows per block
constexpr int kBN = 32;   // output feature columns per block
constexpr int kBK = 16;   // reduction depth per shared-memory stage
constexpr int kTM = 8;    // output rows per thread
constexpr int kTN = 4;    // output columns per thread (float4s of H)
constexpr int kTX = kBN / kTN;
constexpr int kTY = kBM / kTM;
constexpr int kThreads = kTX * kTY;
constexpr int kAStride = kBK + 4;  // A tile row stride in floats
constexpr int kHPerThread = (kBK * kBN + kThreads - 1) / kThreads;
constexpr int kMaxSplit = 8;       // portable cluster size
constexpr int kFillBlocks = 264;   // two blocks on each of an H100 SXM's 132 SMs
constexpr int kMinSplitK = 64;     // least K range worth a cluster rank

struct Stage {
  float a[kBM][kAStride];  // a[i][k] = A[row0 + i, k0 + k]
  float h[kBK][kBN];       // h[k][j] = H[k0 + k, col0 + j] * c[k0 + k]
};
struct __align__(16) Smem {
  Stage stage[2];
  // split-K: the partial sums of this block's output rows from every rank
  // of the cluster, written there by each rank: recv[rank][row][col]
  float recv[kBM * kBN];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One element into a stage: 4-byte cp.async for fp32 (zero-filled when
// !valid), a widening load and store for bf16 and fp16.
__device__ __forceinline__ void stage_elem(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void stage_elem(float* dst, const __nv_bfloat16* src, bool valid) {
  *dst = valid ? __bfloat162float(*src) : 0.0f;
}
__device__ __forceinline__ void stage_elem(float* dst, const __half* src, bool valid) {
  *dst = valid ? __half2float(*src) : 0.0f;
}
__device__ __forceinline__ void stage_vec4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float lane_of(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// kVecA: A moves by 16-byte cp.async (fp32, N % 4 == 0, aligned base).
// kScaleC: c is given (scaled_spmm); without it the product is plain A . H.
template <typename T, bool kVecA, bool kScaleC>
__global__ void __launch_bounds__(kThreads)
scaled_spmm_kernel(const T* __restrict__ a, const T* __restrict__ h,
                   const T* __restrict__ r, const T* __restrict__ c,
                   T* __restrict__ out, int m, int n, int d, int split, int k_chunk) {
  extern __shared__ __align__(16) unsigned char spmm_smem[];
  Smem& sm = *reinterpret_cast<Smem*>(spmm_smem);

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int k_lo = blockIdx.z * k_chunk;
  const int k_hi = min(n, k_lo + k_chunk);
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  // c of the H elements this thread stages, for the stage in flight: once
  // its own copies have landed the thread scales them in place, so the
  // block barrier that follows publishes scaled H (no extra pass or barrier)
  float c_next[kHPerThread];
  auto load = [&](int t) {
    Stage& st = sm.stage[t & 1];
    const int k0 = k_lo + t * kBK;
    if constexpr (kVecA) {
      constexpr int kTotal = kBM * kBK / 4;
#pragma unroll
      for (int l = 0; l < (kTotal + kThreads - 1) / kThreads; ++l) {
        const int idx = tid + l * kThreads;
        if (kTotal % kThreads != 0 && idx >= kTotal) break;
        const int i = idx / (kBK / 4), q4 = (idx % (kBK / 4)) * 4;
        const bool ok = row0 + i < m && k0 + q4 < k_hi;
        stage_vec4(&st.a[i][q4], a + (ok ? (size_t)(row0 + i) * n + k0 + q4 : 0), ok);
      }
    } else {
      constexpr int kTotal = kBM * kBK;
#pragma unroll
      for (int l = 0; l < (kTotal + kThreads - 1) / kThreads; ++l) {
        const int idx = tid + l * kThreads;
        if (kTotal % kThreads != 0 && idx >= kTotal) break;
        const int i = idx / kBK, kk = idx % kBK;
        const bool ok = row0 + i < m && k0 + kk < k_hi;
        stage_elem(&st.a[i][kk], a + (ok ? (size_t)(row0 + i) * n + k0 + kk : 0), ok);
      }
    }
#pragma unroll
    for (int l = 0; l < kHPerThread; ++l) {
      const int idx = tid + l * kThreads;
      if ((kBK * kBN) % kThreads != 0 && idx >= kBK * kBN) break;
      const int kk = idx / kBN, j = idx % kBN;
      const bool ok = k0 + kk < k_hi && col0 + j < d;
      stage_elem(&st.h[kk][j], h + (ok ? (size_t)(k0 + kk) * d + col0 + j : 0), ok);
      if constexpr (kScaleC) c_next[l] = k0 + kk < k_hi ? to_f32(c[k0 + kk]) : 0.0f;
    }
  };
  auto scale_own_h = [&](int t, const float (&cv)[kHPerThread]) {
    Stage& st = sm.stage[t & 1];
#pragma unroll
    for (int l = 0; l < kHPerThread; ++l) {
      const int idx = tid + l * kThreads;
      if ((kBK * kBN) % kThreads != 0 && idx >= kBK * kBN) break;
      st.h[idx / kBN][idx % kBN] *= cv[l];
    }
  };

  // thread (ty, tx) owns rows ty + kTY i and columns tx * 4 + kTX * 4 q + (0..3)
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  if (n_tiles > 0) {
    load(0);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    float c_cur[kHPerThread];
    if constexpr (kScaleC) {
#pragma unroll
      for (int l = 0; l < kHPerThread; ++l) c_cur[l] = c_next[l];
    }
    if (t + 1 < n_tiles) {
      load(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (kScaleC) scale_own_h(t, c_cur);
    __syncthreads();
    const Stage& st = sm.stage[t & 1];
#pragma unroll
    for (int kq = 0; kq < kBK; kq += 4) {
      float4 av[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
        av[i] = *reinterpret_cast<const float4*>(&st.a[ty + kTY * i][kq]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float hv[kTN];
#pragma unroll
        for (int q = 0; q < kTN / 4; ++q) {
          const float4 h4 = *reinterpret_cast<const float4*>(&st.h[kq + kk][tx * 4 + kTX * 4 * q]);
          hv[4 * q + 0] = h4.x;
          hv[4 * q + 1] = h4.y;
          hv[4 * q + 2] = h4.z;
          hv[4 * q + 3] = h4.w;
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          const float av_k = lane_of(av[i], kk);
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av_k, hv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  auto col_of = [&](int j) { return tx * 4 + kTX * 4 * (j / 4) + j % 4; };
  if (split == 1) {
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int row = row0 + ty + kTY * i;
      if (row >= m) continue;
      const float rs = (r != nullptr) ? to_f32(r[row]) : 1.0f;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int col = col0 + col_of(j);
        if (col < d) out[(size_t)row * d + col] = from_f32<T>(acc[i][j] * rs);
      }
    }
    return;
  }

  // split-K: rank z owns rows [z, z + 1) * rows_per of the tile. Every rank
  // stores its partial rows into their owner's recv (distributed shared
  // memory, no wait on the stores); after one cluster barrier each owner
  // sums its rows locally in rank order.
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int rows_per = kBM / split;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = ty + kTY * i;
    float* dst = cluster.map_shared_rank(sm.recv, row / rows_per) +
                 (rank * rows_per + row % rows_per) * kBN;
#pragma unroll
    for (int q = 0; q < kTN / 4; ++q)
      *reinterpret_cast<float4*>(dst + col_of(4 * q)) =
          make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2], acc[i][4 * q + 3]);
  }
  cluster.sync();
  for (int idx = tid; idx < rows_per * kBN; idx += kThreads) {
    const int row = row0 + rank * rows_per + idx / kBN, col = col0 + idx % kBN;
    float sum = 0.0f;
    for (int z = 0; z < split; ++z) sum += sm.recv[z * rows_per * kBN + idx];
    if (row < m && col < d) {
      const float rs = (r != nullptr) ? to_f32(r[row]) : 1.0f;
      out[(size_t)row * d + col] = from_f32<T>(sum * rs);
    }
  }
}

template <typename T, bool kVecA, bool kScaleC>
int launch_cfg(const void* a, const void* h, const void* r, const void* c, void* out,
               int m, int n, int d, cudaStream_t stream) {
  auto kernel = scaled_spmm_kernel<T, kVecA, kScaleC>;
  constexpr size_t smem = sizeof(Smem);
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const int gx = (d + kBN - 1) / kBN;
  const int gy = (m + kBM - 1) / kBM;
  int split = 1;  // cut K only where the output tiles leave SMs idle
  while (split < kMaxSplit && gx * gy * split < kFillBlocks && n >= 2 * split * kMinSplitK)
    split *= 2;
  const int k_chunk = ((n + split - 1) / split + kBK - 1) / kBK * kBK;
  const T* a_t = static_cast<const T*>(a);
  const T* h_t = static_cast<const T*>(h);
  const T* r_t = static_cast<const T*>(r);
  const T* c_t = static_cast<const T*>(c);
  T* out_t = static_cast<T*>(out);
  if (split == 1) {
    kernel<<<dim3(gx, gy, 1), kThreads, smem, stream>>>(a_t, h_t, r_t, c_t, out_t, m, n, d, 1,
                                                       k_chunk);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, split);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, a_t, h_t, r_t, c_t, out_t, m, n, d, split, k_chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* a, const void* h, const void* r, const void* c, void* out,
           int m, int n, int d, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 4) {
    if (n % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0)
      return c != nullptr ? launch_cfg<T, true, true>(a, h, r, c, out, m, n, d, s)
                          : launch_cfg<T, true, false>(a, h, r, c, out, m, n, d, s);
  }
  return c != nullptr ? launch_cfg<T, false, true>(a, h, r, c, out, m, n, d, s)
                      : launch_cfg<T, false, false>(a, h, r, c, out, m, n, d, s);
}

}  // namespace

// Plain C entry points for ctypes. A (m, n), H (n, d), out (m, d) are
// row-major and contiguous; r (m,) and c (n,) may be null (no scaling).
// Each launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int gcn_scaled_spmm_f32(const void* a, const void* h, const void* r,
                                   const void* c, void* out, int m, int n, int d,
                                   void* stream) {
  return launch<float>(a, h, r, c, out, m, n, d, stream);
}

extern "C" int gcn_scaled_spmm_bf16(const void* a, const void* h, const void* r,
                                    const void* c, void* out, int m, int n, int d,
                                    void* stream) {
  return launch<__nv_bfloat16>(a, h, r, c, out, m, n, d, stream);
}

extern "C" int gcn_scaled_spmm_f16(const void* a, const void* h, const void* r,
                                   const void* c, void* out, int m, int n, int d,
                                   void* stream) {
  return launch<__half>(a, h, r, c, out, m, n, d, stream);
}
