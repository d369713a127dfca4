// Causal / sliding-window GQA attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention_bhsd (body _flash_kernel)
// in src/repro/kernels/flash_attention/kernel.py. It computes what that
// kernel computes, not how it tiles it:
//   * scores s = (q . k) * D^-0.5 in fp32 from inputs of either type;
//   * mask: key position < T (the ragged edge), kpos <= qpos if causal,
//     kpos > qpos - window if a window is set; positions count from 0 for
//     queries and keys alike;
//   * online softmax over kv tiles with the reference's sentinel: masked
//     scores are -1e30 (not -inf), so a tile seen before any visible key
//     adds p = 1 terms that a later alpha = exp(-1e30 - m) = 0 cancels
//     exactly; the final division clamps l at 1e-30;
//   * query head h reads kv head h / (H / KV): GQA without repeating K/V.
// The kernel reads the model layout q (B, S, H, D), k/v (B, T, KV, D) and
// writes o (B, S, H, D) directly, masking its own ragged edges, so the
// caller transposes and pads nothing. Keys past T are left out of the sum
// (p = 0), as the plain version does. With a causal mask the kernel skips
// kv tiles that no row of the query tile can see: every causal row sees its
// own key (the wrapper requires S <= T when a window is set, and window >=
// 1), so a skipped tile's terms would have been cancelled exactly.
//
// What bounds it on an H100: at gemma3-1b's prefill (B 4, S 1024, H 4,
// KV 1, D 256, causal) the work is ~8.6e9 flops over ~21 MB of bf16
// q/k/v/o, i.e. ~8.7 us at the 989 TFLOP/s bf16 tensor-core peak against
// ~6.3 us at 3.35 TB/s: operations. This first kernel does its math as fp32
// FMAs outside the tensor cores (peak 67 TFLOP/s, ~128 us for that work),
// which keeps the reference's fp32 tolerance for fp32 inputs.
//
// Design: one block of 4 warps owns 32 query rows of one (batch, head); each
// warp owns 8 rows. Per kv tile of 32 keys, Q, K transposed (one float of
// padding per row against bank conflicts) and V, all widened to fp32, sit
// in dynamic shared memory (99 KB at D = 256, past the 48 KB static
// limit, hence cudaFuncSetAttribute). For the scores each lane owns one key
// column and reads Q rows as broadcast float4s; for P.V each lane owns the
// output columns lane + 32 c and takes p from its neighbours by shuffle.
// Known gaps, for the work that makes it fast: no tensor cores (wgmma /
// mma.sync), no cp.async or TMA pipeline, scalar global loads of bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF sentinel
constexpr int kBQ = 32;            // query rows per block
constexpr int kBK = 32;            // keys per kv tile (one per lane)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBQ / kWarps;  // query rows per warp

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBQ * D + D * (kBK + 1) + kBK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int T_len,
                 int H, int KV, int causal, int window, float scale) {
  constexpr int kCols = (D + 31) / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;                    // [kBQ][D]
  float* kt_s = q_s + kBQ * D;          // [D][kBK + 1], K transposed
  float* v_s = kt_s + D * (kBK + 1);    // [kBK][D]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int s = q0 + r;
    q_s[idx] = s < S ? to_f32(q[((size_t)b * S + s) * H * D + (size_t)h * D + d]) : 0.0f;
  }

  int k_begin = 0, k_end = T_len;
  if (causal) {  // tiles no row of [q0, q0 + kBQ) can see
    k_end = min(T_len, q0 + kBQ);
    if (window > 0) k_begin = (max(0, q0 - window + 1) / kBK) * kBK;
  }

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }
  const float* q_rows = q_s + warp * kRows * D;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and Q is loaded)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int t = k0 + j;
      const bool in = t < T_len;
      const size_t off = ((size_t)b * T_len + t) * KV * D + (size_t)kvh * D + d;
      kt_s[d * (kBK + 1) + j] = in ? to_f32(k[off]) : 0.0f;
      v_s[j * D + d] = in ? to_f32(v[off]) : 0.0f;
    }
    __syncthreads();

    // scores of this warp's rows against key k0 + lane
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      const float k_a = kt_s[(d + 0) * (kBK + 1) + lane];
      const float k_b = kt_s[(d + 1) * (kBK + 1) + lane];
      const float k_c = kt_s[(d + 2) * (kBK + 1) + lane];
      const float k_d = kt_s[(d + 3) * (kBK + 1) + lane];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_rows + r * D + d);
        s[r] = fmaf(qv.x, k_a, s[r]);
        s[r] = fmaf(qv.y, k_b, s[r]);
        s[r] = fmaf(qv.z, k_c, s[r]);
        s[r] = fmaf(qv.w, k_d, s[r]);
      }
    }

    const int kpos = k0 + lane;
    const bool exists = kpos < T_len;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r;
      bool vis = exists;
      if (causal) vis = vis && kpos <= qpos;
      if (window > 0) vis = vis && kpos > qpos - window;
      const float sc = vis ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float alpha = expf(m[r] - m_new);
      p[r] = exists ? expf(sc - m_new) : 0.0f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }

    // acc += P . V, lane owns columns lane + 32 c
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        vv[c] = (D % 32 == 0 || col < D) ? v_s[j * D + col] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* out_row = o + ((size_t)b * S + qpos) * H * D + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (D % 32 == 0 || col < D) out_row[col] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int B, int S,
             int T_len, int H, int KV, int causal, int window, void* stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, T_len, H, KV, causal, window, 1.0f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
           int H, int KV, int D, int causal, int window, void* stream) {
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, o, B, S, T_len, H, KV, causal, window, stream);
    case 32: return launch_d<T, 32>(q, k, v, o, B, S, T_len, H, KV, causal, window, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, B, S, T_len, H, KV, causal, window, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, B, S, T_len, H, KV, causal, window, stream);
    case 256: return launch_d<T, 256>(q, k, v, o, B, S, T_len, H, KV, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points for ctypes. q (B, S, H, D), k/v (B, T, KV, D) and
// o (B, S, H, D) are contiguous; H % KV == 0; D in {16, 32, 64, 128, 256};
// causal is 0/1, window <= 0 means none. Each launches on `stream` and
// returns the CUDA error code (0 on success).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                       void* o, int B, int S, int T, int H, int KV,
                                       int D, int causal, int window, void* stream) {
  return launch<float>(q, k, v, o, B, S, T, H, KV, D, causal, window, stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        void* o, int B, int S, int T, int H, int KV,
                                        int D, int causal, int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, S, T, H, KV, D, causal, window, stream);
}
