// GCN aggregation out = diag(r) . A . diag(c) . H for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels in src/repro/kernels/gcn_spmm/kernel.py:
// scaled_spmm_blocked (body _scaled_spmm_kernel) and, with r = c = null,
// spmm_blocked (body _spmm_kernel). It computes what they compute, not how
// they tile it:
//   * c scales each element of A as it is staged into shared memory (the
//     reference's `a * c` on each adjacency tile);
//   * the product accumulates in fp32 registers with plain FMA, in a loop
//     over K inside the block (the TPU's sequential K grid axis);
//   * r multiplies the fp32 accumulator once, in the epilogue, and the result
//     is converted to the input type;
//   * ragged edges are zero-filled here, so the caller pads nothing.
// A, H and out share one type (fp32 or bf16); r and c are of that type too.
//
// What bounds it on an H100: fp32 FMA throughput. The planner's largest
// bucket is M = N = 1024 with D = 213 (the GNN hidden width): 2 * 1024 * 1024 * 213
// = 4.47e8 flops over ~6.0 MB (A 4.19 MB, H and out 0.87 MB each), i.e.
// ~6.7 us at the 67 TFLOP/s fp32 peak against ~1.8 us at 3.35 TB/s. There
// is no TF32 and no tensor core here, which keeps the reference's fp32
// tolerance of 2e-5 honest.
//
// Design: one block of 256 threads owns a 64-row x 64-column output tile and
// each thread 4 x 4 outputs (rows ty + 16 i, columns tx + 16 j, so a warp's
// shared-memory reads of H are contiguous and those of A are broadcasts).
// Each K step stages a 64 x 32 tile of c-scaled A (transposed, one float of
// padding per row against bank conflicts) and a 32 x 64 tile of H, both
// widened to fp32. Known gaps, left for the work that makes it fast: at
// bucket 1024, 64 x 64 tiles give only 16 x 4 = 64 blocks for 132 SMs; each
// K step reads shared memory with 8 scalar loads per 16 FMAs; and nothing
// overlaps the global loads with the FMAs (no cp.async / TMA pipeline).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;       // output rows per block
constexpr int kBN = 64;       // output feature columns per block
constexpr int kBK = 32;       // reduction depth per shared-memory stage
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scaled_spmm_kernel(const T* __restrict__ a, const T* __restrict__ h,
                   const T* __restrict__ r, const T* __restrict__ c,
                   T* __restrict__ out, int m, int n, int d) {
  __shared__ float a_s[kBK][kBM + 1];  // a_s[k][i] = A[row0 + i, k0 + k] * c[k0 + k]
  __shared__ float h_s[kBK][kBN];      // h_s[k][j] = H[k0 + k, col0 + j]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < n; k0 += kBK) {
    // A tile: consecutive threads walk along k (a row of A) for coalescing.
#pragma unroll
    for (int l = 0; l < (kBM * kBK) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int kk = idx % kBK;
      const int ii = idx / kBK;
      const int row = row0 + ii;
      const int k = k0 + kk;
      float v = 0.0f;
      if (row < m && k < n) {
        v = to_f32(a[(size_t)row * n + k]);
        if (c != nullptr) v *= to_f32(c[k]);
      }
      a_s[kk][ii] = v;
    }
    // H tile: consecutive threads walk along the feature columns.
#pragma unroll
    for (int l = 0; l < (kBK * kBN) / kThreads; ++l) {
      const int idx = tid + l * kThreads;
      const int jj = idx % kBN;
      const int kk = idx / kBN;
      const int k = k0 + kk;
      const int col = col0 + jj;
      h_s[kk][jj] = (k < n && col < d) ? to_f32(h[(size_t)k * d + col]) : 0.0f;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], hv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) hv[j] = h_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], hv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= m) continue;
    const float rs = (r != nullptr) ? to_f32(r[row]) : 1.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < d) out[(size_t)row * d + col] = from_f32<T>(acc[i][j] * rs);
    }
  }
}

template <typename T>
int launch(const void* a, const void* h, const void* r, const void* c, void* out,
           int m, int n, int d, void* stream) {
  const dim3 grid((d + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  scaled_spmm_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(h), static_cast<const T*>(r),
      static_cast<const T*>(c), static_cast<T*>(out), m, n, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. A (m, n), H (n, d), out (m, d) are
// row-major and contiguous; r (m,) and c (n,) may be null (no scaling).
// Each launches on `stream` and returns cudaGetLastError() (0 on success).
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
