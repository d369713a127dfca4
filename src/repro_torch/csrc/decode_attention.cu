// One-token GQA decode attention against a KV cache for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention_grouped (body
// _decode_kernel) in src/repro/kernels/decode_attention/kernel.py. It
// computes what that kernel computes: for each (batch, kv head), the G query
// heads of the group against the cache slots, scores (q . k) * D^-0.5 in
// fp32, slots with valid[t] == 0 set to the -1e30 sentinel, online softmax,
// l clamped at 1e-30. `valid` is one (T,) int32 mask shared by the batch; for
// a ring cache it is not a prefix. Slots past T do not exist and add nothing.
//
// What bounds it on an H100: bytes. Each step reads the whole cache once:
// at gemma3-1b's global layer (B 4, T 1088, KV 1, D 256, bf16) that is
// 4.5 MB of K/V, ~1.3 us at 3.35 TB/s, against ~9e6 flops.
//
// Design: split-T flash-decoding, because one block per (batch, kv head) is
// only B * KV = 4 blocks for 132 SMs. Pass 1 gives each 32-slot chunk of the
// cache its own block (34 chunks x 4 = 136 blocks at T 1088): K (one float
// of padding per row against bank conflicts), V and the group's queries are
// staged in shared memory as fp32; warp w takes query heads w, w + 4, ...;
// each lane scores one slot, and the chunk's max m, sum l and unnormalized
// P.V go to fp32 scratch. Pass 2 combines the chunks per (row, column):
// out = sum_c e^(m_c - M) acc_c / max(sum_c e^(m_c - M) l_c, 1e-30), M the
// largest m_c. The sentinel arithmetic carries over: a chunk with no valid
// slot has m_c = -1e30 and weight e^(-1e30 - M) = 0 once any chunk has a
// valid slot. Known gaps, for the work that makes it fast: scalar bf16
// loads, a second launch, and chunks too short to hide the load latency.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF sentinel
constexpr int kChunk = 32;         // cache slots per pass-1 block (one per lane)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSmem = 227 * 1024;

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

// grid (B * KV, n_chunks); partials indexed ((bk * n_chunks + chunk) * G + g)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ valid,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int T_len, int H, int KV, float scale) {
  constexpr int kCols = (D + 31) / 32;  // output columns per lane
  extern __shared__ float smem[];
  const int G = H / KV;
  float* q_s = smem;                     // [G][D]
  float* k_s = q_s + G * D;              // [kChunk][D + 1]
  float* v_s = k_s + kChunk * (D + 1);   // [kChunk][D]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int bk = blockIdx.x;
  const int chunk = blockIdx.y;
  const int n_chunks = gridDim.y;
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int t0 = chunk * kChunk;

  // q (B, 1, H, D): the group's heads kvh * G .. kvh * G + G - 1 are adjacent
  const T* q_grp = q + ((size_t)b * H + (size_t)kvh * G) * D;
  for (int idx = tid; idx < G * D; idx += kThreads) q_s[idx] = to_f32(q_grp[idx]);
  for (int idx = tid; idx < kChunk * D; idx += kThreads) {
    const int j = idx / D, d = idx % D;
    const int t = t0 + j;
    const bool in = t < T_len;
    const size_t off = ((size_t)b * T_len + t) * KV * D + (size_t)kvh * D + d;
    k_s[j * (D + 1) + d] = in ? to_f32(k[off]) : 0.0f;
    v_s[j * D + d] = in ? to_f32(v[off]) : 0.0f;
  }
  __syncthreads();

  const int t = t0 + lane;
  const bool exists = t < T_len;
  const bool ok = exists && valid[t] != 0;
  const float* k_row = k_s + lane * (D + 1);
  for (int g = warp; g < G; g += kWarps) {
    const float* q_row = q_s + g * D;
    float s = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = fmaf(q_row[d], k_row[d], s);
    const float sc = ok ? s * scale : kNegInf;
    const float m = warp_max(sc);
    const float p = exists ? expf(sc - m) : 0.0f;
    const float l = warp_sum(p);

    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.0f;
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        if (D % 32 == 0 || col < D) acc[c] = fmaf(pj, v_s[j * D + col], acc[c]);
      }
    }
    const size_t part = ((size_t)bk * n_chunks + chunk) * G + g;
    if (lane == 0) {
      part_m[part] = m;
      part_l[part] = l;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (D % 32 == 0 || col < D) part_acc[part * D + col] = acc[c];
    }
  }
}

// grid (B * H): row b * H + h == (b * KV + kvh) * G + g
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int n_chunks, int G, int D) {
  const int row = blockIdx.x;
  const size_t base = (size_t)(row / G) * n_chunks * G + row % G;
  float m_max = kNegInf;
  for (int c = 0; c < n_chunks; ++c) m_max = fmaxf(m_max, part_m[base + (size_t)c * G]);
  for (int col = threadIdx.x; col < D; col += blockDim.x) {
    float num = 0.0f, den = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const size_t part = base + (size_t)c * G;
      const float w = expf(part_m[part] - m_max);
      den = fmaf(w, part_l[part], den);
      num = fmaf(w, part_acc[part * D + col], num);
    }
    out[(size_t)row * D + col] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* valid, void* part_m,
             void* part_l, void* part_acc, void* out, int B, int T_len, int H, int KV,
             void* stream) {
  const int G = H / KV;
  const size_t smem = sizeof(float) * ((size_t)G * D + kChunk * (D + 1) + kChunk * D);
  if (smem > (size_t)kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static size_t configured = 48 * 1024;  // raise the limit once per size
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  decode_split_kernel<T, D><<<dim3(B * KV, n_chunks), kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(valid), static_cast<float*>(part_m),
      static_cast<float*>(part_l), static_cast<float*>(part_acc), T_len, H, KV,
      1.0f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = D < 32 ? 32 : D;
  decode_combine_kernel<T><<<B * H, threads, 0, s>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_l),
      static_cast<const float*>(part_acc), static_cast<T*>(out), n_chunks, G, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* part_m,
           void* part_l, void* part_acc, void* out, int B, int T_len, int H, int KV, int D,
           void* stream) {
#define DECODE_CASE(DIM)                                                                   \
  case DIM:                                                                                \
    return launch_d<T, DIM>(q, k, v, valid, part_m, part_l, part_acc, out, B, T_len, H, KV, \
                            stream);
  switch (D) {
    DECODE_CASE(16)
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(128)
    DECODE_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DECODE_CASE
}

}  // namespace

// Slots per pass-1 block: the wrapper sizes the scratch with it, as
// n_chunks = ceil(T / chunk) partials of (m, l, acc[D]) per query head.
extern "C" int decode_attention_chunk(void) { return kChunk; }

// Plain C entry points for ctypes. q (B, 1, H, D), k/v (B, T, KV, D) and
// out (B, 1, H, D) are contiguous; valid (T,) int32; part_m / part_l
// (B * KV * n_chunks * G) and part_acc (... * D) fp32 scratch; H % KV == 0;
// D in {16, 32, 64, 128, 256}. Each launches both passes on `stream` and
// returns the CUDA error code (0 on success).
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* valid, void* part_m, void* part_l,
                                    void* part_acc, void* out, int B, int T, int H, int KV,
                                    int D, void* stream) {
  return launch<float>(q, k, v, valid, part_m, part_l, part_acc, out, B, T, H, KV, D, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* valid, void* part_m, void* part_l,
                                     void* part_acc, void* out, int B, int T, int H, int KV,
                                     int D, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, valid, part_m, part_l, part_acc, out, B, T, H, KV, D,
                               stream);
}
