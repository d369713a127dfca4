// Causal / sliding-window GQA attention for Hopper (sm_90a): the forward,
// then its backward (the "backward" section below).
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
// ~6.3 us at 3.35 TB/s: operations, and only on the tensor cores.
//
// Two bodies, chosen by the input type:
//
// bf16 (flash_tc_kernel): both products on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), fed by ldmatrix from
// shared memory that 16-byte cp.async fills.
//   * GQA packing: the G = H / KV query heads of one kv head are packed
//     into the rows of one block (packed row p is query position p / G,
//     head kvh * G + p % G), so each K/V tile in shared memory serves all G
//     heads and is read from device memory once per 64 packed rows, not
//     once per head. A warp group of 4 warps owns 64 packed rows of one
//     (batch, kv head); each warp owns 16 rows and walks the kv tiles.
//   * Head dim 256: a warp's O accumulator (16 x 256 fp32) is 128 registers
//     a thread, so Q stays in shared memory and is re-read by ldmatrix at
//     every k-step instead of living in registers.
//   * Shared memory rows of D bf16 are cut into 16-byte chunks stored at
//     chunk ^ (row % 8): the 8 row addresses of an ldmatrix phase land in 8
//     different bank groups (D >= 64; smaller D keep a partial swizzle).
//     V is read with ldmatrix.trans for the P . V operand.
//   * K/V tiles are double-buffered: the cp.async of tile j + 1 is in flight
//     while tile j is multiplied. 32 keys per tile at D 256 (96 KB of
//     shared memory per group), 64 keys for D <= 128.
//   * The S accumulator fragment becomes the bf16 A fragment of P . V in
//     registers (no trip through shared memory), which rounds P to bf16 as
//     the plain bf16 einsum path does; l sums the unrounded fp32 p.
//   * The softmax runs in base 2 (scale folded with log2 e into one
//     multiply before the mask); the sentinel is written after the scaling,
//     so it is -1e30 exactly and exp2(-1e30 - m) cancels as above.
//   * The mask is evaluated only on tiles that need it: the diagonal tile,
//     the window's lower edge and the ragged end of T.
//   * Causal load balance: a block holds two warp groups, each with its own
//     shared memory and named barrier; group 0 takes query tile n - 1 - x
//     (the most kv tiles), group 1 its mirror x, so every block carries
//     about the same work. With one tile per block (2 blocks per SM) the
//     gemma3-1b prefill's 256 tiles ran in one wave, and the SMs that drew
//     two heavy tiles set the time.
//   * The epilogue stages each warp's output rows through its own Q rows in
//     shared memory and writes 16-byte chunks.
// What holds it back now: per warp and kv tile, 80 ldmatrix.x4 (Q re-read
// at every k-step, K and V) feed 128 mma.sync, and the 252 registers of D
// 256 leave 8 warps per SM to hide their latency. Gaps left for the next
// redesign: wgmma on 64-row warpgroup tiles, which reads K and V from
// shared memory without ldmatrix, with a TMA producer warp and mbarriers;
// softmax of one group overlapped with the other's products; persistent
// blocks over the causal triangle.
//
// Both bodies can also write the per-row log-sum-exp of the scaled scores,
// lse = m + log l (natural log, fp32, layout (B, H, S)), which the backward
// (the section after the forward's launches) reads to rebuild P without a
// second softmax. The
// serving call passes a null pointer and writes none.
//
// fp32 (flash_fwd_kernel): fp32 FMAs outside the tensor cores, which keeps
// the reference's 2e-5 fp32 tolerance (TF32 would not). One block of 4
// warps owns 32 query rows of one (batch, head); each warp owns 8 rows. Per
// kv tile of 32 keys, Q, K transposed (one float of padding per row) and V
// sit in 99 KB of dynamic shared memory. For the scores each lane owns one
// key column and reads Q rows as broadcast float4s; for P.V each lane owns
// the output columns lane + 32 c and takes p from its neighbours by shuffle.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 int S, int T_len, int H, int KV, int causal, int window, float scale) {
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
    if (lse != nullptr && lane == 0) lse[((size_t)b * H + h) * S + qpos] = m[r] + logf(denom);
    T* out_row = o + ((size_t)b * S + qpos) * H * D + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (D % 32 == 0 || col < D) out_row[col] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B,
             int S, int T_len, int H, int KV, int causal, int window, void* stream) {
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
      static_cast<T*>(o), lse, S, T_len, H, KV, causal, window, 1.0f / sqrtf((float)D));
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 body on the tensor cores -----------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kTcRows = 64;      // packed query rows per warp group, 16 per warp
constexpr int kTcGroupThreads = 128;
constexpr int kTcThreads = 2 * kTcGroupThreads;  // two groups: a tile and its mirror

template <int D>
struct TcShape {
  static constexpr int kKeys = D <= 128 ? 64 : 32;  // keys per kv tile
  static constexpr int kChunks = D / 8;             // 16-byte chunks per row
  static constexpr int kSwz = kChunks < 8 ? kChunks - 1 : 7;
  // per warp group: Q, then two stages of K and two of V, all bf16
  static constexpr size_t kGroupSmem = sizeof(bf16) * (kTcRows * D + 4 * kKeys * D);
};

// element offset of (row, 16-byte chunk) in a swizzled [rows][D] bf16 tile
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & TcShape<D>::kSwz)) << 3);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills the destination when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// barrier of one warp group (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(kTcGroupThreads));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                int S, int T_len, int H, int KV, int causal, int window, float scale_log2) {
  constexpr int kKeys = TcShape<D>::kKeys;
  constexpr int kChunks = TcShape<D>::kChunks;
  constexpr int kNB = kKeys / 8;  // score n-blocks of 8 keys
  constexpr int kDB = D / 8;      // output n-blocks of 8 columns
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int group = threadIdx.x / kTcGroupThreads;
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem + group * TcShape<D>::kGroupSmem);  // [kTcRows][D]
  bf16* k_s = q_s + kTcRows * D;    // [2][kKeys][D]
  bf16* v_s = k_s + 2 * kKeys * D;  // [2][kKeys][D]

  const int tid = threadIdx.x % kTcGroupThreads;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = H / KV;
  const int rows = S * G;  // packed rows of one (batch, kv head)
  // Group 0 takes query tile n - 1 - x (the most kv tiles under a causal
  // mask), group 1 its mirror x, so every block carries about the same work.
  const int n_q = (rows + kTcRows - 1) / kTcRows;
  const int tile = group == 0 ? n_q - 1 - blockIdx.x : blockIdx.x;
  if (group == 1 && tile >= n_q - 1 - blockIdx.x) return;  // odd n_q: no mirror
  const int p0 = tile * kTcRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  // element offset of packed row p (query position p / G, head kvh * G + p % G)
  auto q_off = [&](int p) {
    return ((size_t)b * S + p / G) * H * D + (size_t)(kvh * G + p % G) * D;
  };

  for (int idx = tid; idx < kTcRows * kChunks; idx += kTcGroupThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool in = p0 + r < rows;
    cp_async16(q_s + swz<D>(r, c), q + (in ? q_off(p0 + r) + c * 8 : 0), in);
  }

  int k_begin = 0, k_end = T_len;
  if (causal) {  // tiles no row of the block can see
    const int qpos_lo = p0 / G;
    const int qpos_hi = min(S - 1, (p0 + kTcRows - 1) / G);
    k_end = min(T_len, qpos_hi + 1);
    if (window > 0) k_begin = (max(0, qpos_lo - window + 1) / kKeys) * kKeys;
  }
  const int n_tiles = (k_end - k_begin + kKeys - 1) / kKeys;

  auto load_kv = [&](int j) {
    const int k0 = k_begin + j * kKeys;
    bf16* ks = k_s + (j & 1) * kKeys * D;
    bf16* vs = v_s + (j & 1) * kKeys * D;
    for (int idx = tid; idx < kKeys * kChunks; idx += kTcGroupThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const bool in = k0 + r < T_len;
      const size_t off = in ? ((size_t)b * T_len + k0 + r) * KV * D + (size_t)kvh * D + c * 8 : 0;
      cp_async16(ks + swz<D>(r, c), k + off, in);
      cp_async16(vs + swz<D>(r, c), v + off, in);
    }
  };
  load_kv(0);
  cp_async_commit();  // Q and the first kv tile

  // this thread's accumulator rows: wrow0 + lane / 4 and wrow0 + lane / 4 + 8
  const int wrow0 = warp * 16;
  const int pw = p0 + wrow0;
  const int wq_lo = pw / G, wq_hi = (pw + 15) / G;
  const int qpos[2] = {(pw + lane / 4) / G, (pw + lane / 4 + 8) / G};
  const int kcol = (lane % 4) * 2;  // key / column offset of this thread in an n-block

  float acc[kDB][4];
#pragma unroll
  for (int db = 0; db < kDB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};  // this thread's partial row sums

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_kv(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    group_sync(group);
    const bf16* ks = k_s + (j & 1) * kKeys * D;
    const bf16* vs = v_s + (j & 1) * kKeys * D;
    const int k0 = k_begin + j * kKeys;

    // S = Q . K^T for this warp's 16 rows
    float s[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, q_s + swz<D>(wrow0 + lane % 16, kk * 2 + lane / 16));
#pragma unroll
      for (int nb = 0; nb < kNB / 2; ++nb) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + swz<D>(nb * 16 + lane % 8 + (lane / 16) * 8, kk * 2 + (lane / 8) % 2));
        mma_bf16(s[2 * nb], qa, kb[0], kb[1]);
        mma_bf16(s[2 * nb + 1], qa, kb[2], kb[3]);
      }
    }

    // scale into base 2, mask where a row of the warp can miss a key
    const bool edge = k0 + kKeys > T_len;
    const bool need_mask = edge || (causal && k0 + kKeys - 1 > wq_lo) ||
                           (window > 0 && k0 <= wq_hi - window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale_log2;
        if (need_mask) {
          const int kpos = k0 + nb * 8 + kcol + (e & 1);
          const int qp = qpos[e >> 1];
          bool vis = kpos < T_len;
          if (causal) vis = vis && kpos <= qp;
          if (window > 0) vis = vis && kpos > qp - window;
          x = vis ? x : kNegInf;
        }
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // the 4 threads of a row share its max
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = exp2f(s[nb][e] - m[e >> 1]);
        if (edge && k0 + nb * 8 + kcol + (e & 1) >= T_len) p = 0.0f;
        s[nb][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int db = 0; db < kDB; ++db) {
      acc[db][0] *= alpha[0];
      acc[db][1] *= alpha[0];
      acc[db][2] *= alpha[1];
      acc[db][3] *= alpha[1];
    }

    // O += P . V, P taken from the score fragment as bf16
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int db = 0; db < kDB / 2; ++db) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs + swz<D>(kk * 16 + lane % 8 + ((lane / 8) % 2) * 8,
                                      db * 2 + lane / 16));
        mma_bf16(acc[2 * db], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * db + 1], pa, vb[2], vb[3]);
      }
    }
    group_sync(group);  // this buffer is refilled by the next iteration's load
  }

  // epilogue: divide, stage through this warp's own Q rows, 16-byte stores
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.0f / fmaxf(l[i], 1e-30f);
    const int p = pw + lane / 4 + 8 * i;  // m is in base 2: lse = (m + log2 l) ln 2
    if (lse != nullptr && lane % 4 == 0 && p < rows)
      lse[((size_t)b * H + kvh * G + p % G) * S + p / G] =
          (m[i] + log2f(fmaxf(l[i], 1e-30f))) * 0.6931471805599453f;
  }
  const int r0 = wrow0 + lane / 4;
#pragma unroll
  for (int db = 0; db < kDB; ++db) {
    *reinterpret_cast<uint32_t*>(q_s + swz<D>(r0, db) + kcol) =
        pack_bf16(acc[db][0] * inv[0], acc[db][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(q_s + swz<D>(r0 + 8, db) + kcol) =
        pack_bf16(acc[db][2] * inv[1], acc[db][3] * inv[1]);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = idx / kChunks, c = idx % kChunks;
    if (pw + r < rows)
      *reinterpret_cast<uint4*>(o + q_off(pw + r) + c * 8) =
          *reinterpret_cast<const uint4*>(q_s + swz<D>(wrow0 + r, c));
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
              int T_len, int H, int KV, int causal, int window, void* stream) {
  constexpr size_t smem = 2 * TcShape<D>::kGroupSmem;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long n_q = ((long long)S * (H / KV) + kTcRows - 1) / kTcRows;
  const dim3 grid((unsigned)((n_q + 1) / 2), KV, B);  // a query tile and its mirror
  // 1/sqrt(D) and log2(e) in one multiply: exp(x * scale) = exp2(x * scale_log2)
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)D);
  flash_tc_kernel<D><<<grid, kTcThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, S, T_len, H, KV, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The body is chosen by the input type: bf16 on the tensor cores, fp32 on
// the FMA pipe (see the note at the top).
template <typename T, int D>
int launch_body(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                int S, int T_len, int H, int KV, int causal, int window, void* stream) {
  if constexpr (sizeof(T) == 2)
    return launch_tc<D>(q, k, v, o, lse, B, S, T_len, H, KV, causal, window, stream);
  else
    return launch_d<T, D>(q, k, v, o, lse, B, S, T_len, H, KV, causal, window, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int S,
           int T_len, int H, int KV, int D, int causal, int window, void* stream) {
  switch (D) {
    case 16: return launch_body<T, 16>(q, k, v, o, lse, B, S, T_len, H, KV, causal, window, stream);
    case 32: return launch_body<T, 32>(q, k, v, o, lse, B, S, T_len, H, KV, causal, window, stream);
    case 64: return launch_body<T, 64>(q, k, v, o, lse, B, S, T_len, H, KV, causal, window, stream);
    case 128: return launch_body<T, 128>(q, k, v, o, lse, B, S, T_len, H, KV, causal, window, stream);
    case 256: return launch_body<T, 256>(q, k, v, o, lse, B, S, T_len, H, KV, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- backward --------------------------------------------------------------
//
// The gradient of the forward above, which replaces the
// Pallas TPU kernel flash_attention_bhsd (src/repro/kernels/flash_attention/
// kernel.py). The Pallas kernel has no backward of its own: the reference
// differentiates its function (its plain oracle, ref.py::attention_ref,
// under jax.grad). This is that gradient, FA2 style, from the forward's
// saved per-row log-sum-exp (lse = m + log l, natural log, (B, H, S) fp32):
//   P  = exp(s * scale - lse)          rebuilt, never stored
//   dV = P^T dO                        summed over the G query heads of a kv head
//   dP = dO V^T
//   dS = P o (dP - delta),  delta = rowsum(dO o O)   (pre-pass, fp32)
//   dQ = dS K * scale,  dK = dS^T Q * scale
// The masks are the forward's: key position < T, kpos <= qpos if causal,
// kpos > qpos - window if a window is set, positions from 0. A masked score
// gets P = 0: in a row that sees any key, the forward's p = exp(-1e30 - m)
// was exactly 0 there too. (A row that sees no key has no gradient to give;
// the wrapper refuses inputs with such rows.) Tiles that no row can see are
// skipped, as in the forward.
//
// Three kernels per call, launched in order on one stream:
//   1. delta_kernel: one warp per (b, s, h) row, delta = rowsum(dO o O) in fp32.
//   2. dK/dV: one block per (batch, kv head, tile of keys). It loops over the
//      group's query heads and the query tiles that see the tile, so the
//      sum over the G heads is taken inside the block, in a fixed order:
//      no atomics, no scratch, the same bits on every call.
//   3. dQ: one block per (batch, head(s), tile of query rows), looping over
//      the kv tiles its rows see.
//
// What bounds it on an H100: at gemma3-1b's training shape (B 4, S 1024,
// H 4, KV 1, D 256, causal) the backward's five products over the visible
// pairs are ~2.1e10 flops (~22 us at 989 TFLOP/s bf16) against ~27 MB of
// bf16 q/k/v/o/dO in and dq/dk/dv out (~8 us at 3.35 TB/s): operations, on
// the tensor cores. This first version recomputes S in both kernels and dP
// in both (and, at D 256, S once more), 7 to 8 products instead of 5, and
// keeps one warp group per block: simple and right first.
//
// bf16 (dkv_tc_kernel, dq_tc_kernel): mma.sync.m16n8k16 (bf16 in, fp32
// accumulate) fed by ldmatrix from XOR-swizzled shared memory that 16-byte
// cp.async fills, as the forward's tensor-core body. GQA heads are packed
// into rows as in the forward: packed row p of (batch, kv head) is query
// position p / G of head kvh * G + p % G.
//   * dK/dV: 4 warps own 16 keys each (64 keys a block); K and V of the tile
//     stay in shared memory; Q and dO tiles of 32 packed rows are double
//     buffered. Per tile a warp computes S^T = K Q^T and dP^T = V dO^T as
//     16 x 32 fp32 fragments, turns them into P^T and dS^T in registers and
//     feeds them, rounded to bf16, as the A operand of dV += P^T dO and
//     dK += dS^T Q (dO and Q read by ldmatrix.trans). At D 256 a warp
//     cannot hold both 16 x 256 fp32 accumulators (256 registers), so the
//     grid holds two blocks per key tile: one accumulates dV, the other dK.
//   * dQ: 4 warps own 16 packed rows each (64 rows a block); Q and dO rows
//     stay in shared memory, K/V tiles (64 keys, 32 at D 256) are double
//     buffered. Per tile: S = Q K^T, dP = dO V^T, dS, then dQ += dS K (K
//     read by ldmatrix.trans).
//   * The outputs are staged through the warp's own rows of shared memory
//     and written as 16-byte chunks in the model layout.
//
// fp32 (dkv_f32_kernel, dq_f32_kernel): fp32 FMAs outside the tensor cores,
// which keeps the fp32 tolerance, laid out as the forward's fp32 body: a
// lane owns one key (or query) column for the score-like products and
// output columns lane + 32 c for the accumulations, taking the other
// operand's values from its neighbours by shuffle.

constexpr float kLog2e = 1.4426950408889634f;

// the forward's mask: may query position qpos see key position kpos?
__device__ __forceinline__ bool visible(int qpos, int kpos, int T_len, int causal,
                                        int window) {
  bool vis = kpos < T_len;
  if (causal) vis = vis && kpos <= qpos;
  if (window > 0) vis = vis && kpos > qpos - window;
  return vis;
}

// ---- 1. delta = rowsum(dO o O) ---------------------------------------------
constexpr int kDeltaWarps = 8;

template <typename T>
__global__ void __launch_bounds__(32 * kDeltaWarps)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int S, int H, int D, long long n_rows) {
  const long long row = (long long)blockIdx.x * kDeltaWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const T* o_row = o + row * D;
  const T* d_row = dout + row * D;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(o_row[d]), to_f32(d_row[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {  // row = (b * S + s) * H + h  ->  delta[(b * H + h) * S + s]
    const int h = (int)(row % H);
    const long long bs = row / H;
    delta[(bs / S * H + h) * S + bs % S] = acc;
  }
}

// ---- fp32 bodies on the FMA pipe (kBQ, kBK, kThreads, kRows as the forward's)

template <int D>
constexpr size_t bwd_f32_smem_bytes() {
  return sizeof(float) * (2 * 32 * D + 2 * D * 33);
}

// dQ for 32 query rows of one (batch, head): smem q, dO rows [32][D], K and
// V transposed [D][33]. Lane = key column for S and dP, output columns
// lane + 32 c for dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads)
dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int S, int T_len, int H, int KV, int causal, int window,
              float scale) {
  constexpr int kCols = (D + 31) / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [kBQ][D]
  float* do_s = q_s + kBQ * D;         // [kBQ][D]
  float* kt_s = do_s + kBQ * D;        // [D][kBK + 1]
  float* vt_s = kt_s + D * (kBK + 1);  // [D][kBK + 1]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);

  for (int idx = tid; idx < kBQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D, s = q0 + r;
    const size_t off = ((size_t)b * S + s) * H * D + (size_t)h * D + d;
    q_s[idx] = s < S ? q[off] : 0.0f;
    do_s[idx] = s < S ? dout[off] : 0.0f;
  }
  float lse_r[kRows], dl_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    const size_t off = ((size_t)b * H + h) * S + qpos;
    lse_r[r] = qpos < S ? lse[off] : 0.0f;
    dl_r[r] = qpos < S ? delta[off] : 0.0f;
  }

  int k_begin = 0, k_end = T_len;
  if (causal) {  // the forward's range: tiles no row of the block can see
    k_end = min(T_len, q0 + kBQ);
    if (window > 0) k_begin = (max(0, q0 - window + 1) / kBK) * kBK;
  }

  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  const float* q_rows = q_s + warp * kRows * D;
  const float* do_rows = do_s + warp * kRows * D;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and Q, dO are loaded)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D, t = k0 + j;
      const size_t off = ((size_t)b * T_len + t) * KV * D + (size_t)kvh * D + d;
      kt_s[d * (kBK + 1) + j] = t < T_len ? k[off] : 0.0f;
      vt_s[d * (kBK + 1) + j] = t < T_len ? v[off] : 0.0f;
    }
    __syncthreads();

    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.0f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float kk[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = kt_s[(d + i) * (kBK + 1) + lane];
        vv[i] = vt_s[(d + i) * (kBK + 1) + lane];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(q_rows + r * D + d);
        const float4 gv = *reinterpret_cast<const float4*>(do_rows + r * D + d);
        s[r] = fmaf(qv.x, kk[0], fmaf(qv.y, kk[1], fmaf(qv.z, kk[2], fmaf(qv.w, kk[3], s[r]))));
        dp[r] = fmaf(gv.x, vv[0], fmaf(gv.y, vv[1], fmaf(gv.z, vv[2], fmaf(gv.w, vv[3], dp[r]))));
      }
    }
    const int kpos = k0 + lane;
    float ds[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + warp * kRows + r;
      const float p = visible(qpos, kpos, T_len, causal, window) ? expf(s[r] * scale - lse_r[r])
                                                                 : 0.0f;
      ds[r] = p * (dp[r] - dl_r[r]);
    }
    // acc += dS . K, K[j][col] read from the transposed tile
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float kc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        kc[c] = (D % 32 == 0 || col < D) ? kt_s[col * (kBK + 1) + j] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsj = __shfl_sync(0xffffffffu, ds[r], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(dsj, kc[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    if (qpos >= S) continue;
    float* out = dq + ((size_t)b * S + qpos) * H * D + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (D % 32 == 0 || col < D) out[col] = acc[r][c] * scale;
    }
  }
}

// dK and dV for 32 keys of one (batch, kv head): smem K, V rows [32][D], Q
// and dO transposed [D][33]. Lane = query column for S^T and dP^T, output
// columns lane + 32 c for dV += P^T dO and dK += dS^T Q. Loops over the G
// heads of the kv head, then the query tiles that see the keys.
template <int D>
__global__ void __launch_bounds__(kThreads)
dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, int S, int T_len, int H, int KV,
               int causal, int window, float scale) {
  constexpr int kCols = (D + 31) / 32;
  extern __shared__ float smem[];
  float* k_s = smem;                    // [kBK][D]
  float* v_s = k_s + kBK * D;           // [kBK][D]
  float* qt_s = v_s + kBK * D;          // [D][kBQ + 1]
  float* dot_s = qt_s + D * (kBQ + 1);  // [D][kBQ + 1]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * kBK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;

  for (int idx = tid; idx < kBK * D; idx += kThreads) {
    const int j = idx / D, d = idx % D, t = k0 + j;
    const size_t off = ((size_t)b * T_len + t) * KV * D + (size_t)kvh * D + d;
    k_s[idx] = t < T_len ? k[off] : 0.0f;
    v_s[idx] = t < T_len ? v[off] : 0.0f;
  }
  // query positions that can see a key of [k0, k0 + kBK)
  const int k_last = min(T_len, k0 + kBK) - 1;
  int q_begin = 0, q_end = S;
  if (causal) q_begin = (min(k0, S) / kBQ) * kBQ;
  if (window > 0) q_end = min(S, k_last + window);

  float acc_k[kRows][kCols], acc_v[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_k[r][c] = acc_v[r][c] = 0.0f;
  const float* k_rows = k_s + warp * kRows * D;
  const float* v_rows = v_s + warp * kRows * D;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt0 = q_begin; qt0 < q_end; qt0 += kBQ) {
      __syncthreads();  // the previous tile is consumed (and K, V are loaded)
      for (int idx = tid; idx < kBQ * D; idx += kThreads) {
        const int i = idx / D, d = idx % D, s = qt0 + i;
        const size_t off = ((size_t)b * S + s) * H * D + (size_t)h * D + d;
        qt_s[d * (kBQ + 1) + i] = s < S ? q[off] : 0.0f;
        dot_s[d * (kBQ + 1) + i] = s < S ? dout[off] : 0.0f;
      }
      __syncthreads();
      const int qpos = qt0 + lane;
      const size_t roff = ((size_t)b * H + h) * S + qpos;
      const float lse_q = qpos < S ? lse[roff] : 0.0f;
      const float dl_q = qpos < S ? delta[roff] : 0.0f;

      float s[kRows], dp[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.0f;
#pragma unroll 2
      for (int d = 0; d < D; d += 4) {
        float qq[4], gg[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          qq[i] = qt_s[(d + i) * (kBQ + 1) + lane];
          gg[i] = dot_s[(d + i) * (kBQ + 1) + lane];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float4 kv4 = *reinterpret_cast<const float4*>(k_rows + r * D + d);
          const float4 vv4 = *reinterpret_cast<const float4*>(v_rows + r * D + d);
          s[r] = fmaf(kv4.x, qq[0], fmaf(kv4.y, qq[1], fmaf(kv4.z, qq[2], fmaf(kv4.w, qq[3], s[r]))));
          dp[r] = fmaf(vv4.x, gg[0], fmaf(vv4.y, gg[1], fmaf(vv4.z, gg[2], fmaf(vv4.w, gg[3], dp[r]))));
        }
      }
      float p[kRows], ds[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int kpos = k0 + warp * kRows + r;
        const bool vis = qpos < S && visible(qpos, kpos, T_len, causal, window);
        p[r] = vis ? expf(s[r] * scale - lse_q) : 0.0f;
        ds[r] = p[r] * (dp[r] - dl_q);
      }
#pragma unroll 4
      for (int i = 0; i < kBQ; ++i) {
        float gc[kCols], qc[kCols];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = lane + 32 * c;
          const bool in = D % 32 == 0 || col < D;
          gc[c] = in ? dot_s[col * (kBQ + 1) + i] : 0.0f;
          qc[c] = in ? qt_s[col * (kBQ + 1) + i] : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pi = __shfl_sync(0xffffffffu, p[r], i);
          const float dsi = __shfl_sync(0xffffffffu, ds[r], i);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            acc_v[r][c] = fmaf(pi, gc[c], acc_v[r][c]);
            acc_k[r][c] = fmaf(dsi, qc[c], acc_k[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int kpos = k0 + warp * kRows + r;
    if (kpos >= T_len) continue;
    const size_t off = ((size_t)b * T_len + kpos) * KV * D + (size_t)kvh * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (D % 32 == 0 || col < D) {
        dk[off + col] = acc_k[r][c] * scale;
        dv[off + col] = acc_v[r][c];
      }
    }
  }
}

// ---- bf16 bodies on the tensor cores ---------------------------------------
// one warp group of 4 warps a block, each warp 16 rows: a block owns kTcRows
// = 64 rows (keys in dK/dV, packed query rows in dQ)
constexpr int kBwdThreads = kTcGroupThreads;
constexpr int kKvQ = 32;  // packed query rows per tile in dK/dV

template <int D>
struct BwdSmem {  // dynamic shared memory of the bf16 backward kernels
  // dK/dV: K, V [64][D]; two stages of Q and of dO [32][D]; lse, delta [2][32]
  static constexpr size_t kDkv =
      sizeof(bf16) * (2 * kTcRows * D + 4 * kKvQ * D) + sizeof(float) * 4 * kKvQ;
  // dQ: Q, dO [64][D]; two stages of K and of V [kKeys][D]
  static constexpr size_t kDq = sizeof(bf16) * (2 * kTcRows * D + 4 * TcShape<D>::kKeys * D);
};

// acc (16 x NB*8) += A (the warp's 16 rows of a [rows][D] tile) . B^T, B =
// NB*8 rows of another [rows][D] tile starting at row b0, over all of D
template <int D, int NB>
__device__ __forceinline__ void mma_rows_rows(float (&acc)[NB][4], const bf16* a_s, int a_row0,
                                              const bf16* b_s, int b_row0, int lane) {
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, a_s + swz<D>(a_row0 + lane % 16, kk * 2 + lane / 16));
#pragma unroll
    for (int nb = 0; nb < NB / 2; ++nb) {
      uint32_t bb[4];
      ldsm_x4(bb, b_s + swz<D>(b_row0 + nb * 16 + lane % 8 + (lane / 16) * 8,
                               kk * 2 + (lane / 8) % 2));
      mma_bf16(acc[2 * nb], a, bb[0], bb[1]);
      mma_bf16(acc[2 * nb + 1], a, bb[2], bb[3]);
    }
  }
}

// out (16 x D) += X (16 x NB*8, an fp32 score fragment, rounded to bf16 as
// the A operand) . Y (NB*8 rows of a [rows][D] tile, read transposed)
template <int D, int NB>
__device__ __forceinline__ void mma_frag_rows(float (&out)[D / 8][4], const float (&x)[NB][4],
                                              const bf16* y_s, int lane) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    const uint32_t a[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                           pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                           pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                           pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int db = 0; db < D / 16; ++db) {
      uint32_t yb[4];
      ldsm_x4_trans(yb, y_s + swz<D>(kk * 16 + lane % 8 + ((lane / 8) % 2) * 8,
                                     db * 2 + lane / 16));
      mma_bf16(out[2 * db], a, yb[0], yb[1]);
      mma_bf16(out[2 * db + 1], a, yb[2], yb[3]);
    }
  }
}

// write a warp's 16 x D fp32 accumulator (times mul) as bf16 rows: staged
// through the warp's own 16 rows of a swizzled tile, then 16-byte stores;
// row r goes to dst + offset(r) for r with valid(r)
template <int D, typename Off, typename Valid>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], float mul,
                                           bf16* stage, int row0, bf16* dst, Off offset,
                                           Valid valid, int lane) {
  constexpr int kChunks = D / 8;
  const int r0 = row0 + lane / 4, kcol = (lane % 4) * 2;
  __syncwarp();
#pragma unroll
  for (int db = 0; db < D / 8; ++db) {
    *reinterpret_cast<uint32_t*>(stage + swz<D>(r0, db) + kcol) =
        pack_bf16(acc[db][0] * mul, acc[db][1] * mul);
    *reinterpret_cast<uint32_t*>(stage + swz<D>(r0 + 8, db) + kcol) =
        pack_bf16(acc[db][2] * mul, acc[db][3] * mul);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = idx / kChunks, c = idx % kChunks;
    if (valid(r))
      *reinterpret_cast<uint4*>(dst + offset(r) + c * 8) =
          *reinterpret_cast<const uint4*>(stage + swz<D>(row0 + r, c));
  }
}

// dK / dV for 64 keys of one (batch, kv head). WANT_V / WANT_K pick the
// accumulators (both for D <= 128; one each at D 256, see the top note).
template <int D, bool WANT_V, bool WANT_K>
__device__ __forceinline__ void dkv_tc_body(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                            const bf16* __restrict__ v,
                                            const bf16* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta, bf16* __restrict__ dk,
                                            bf16* __restrict__ dv, int tile, int S, int T_len,
                                            int H, int KV, int causal, int window,
                                            float scale_log2, float scale,
                                            unsigned char* smem) {
  constexpr int kChunks = TcShape<D>::kChunks;
  constexpr int kNB = kKvQ / 8;  // score n-blocks of 8 packed rows
  bf16* k_s = reinterpret_cast<bf16*>(smem);  // [64][D]
  bf16* v_s = k_s + kTcRows * D;              // [64][D]
  bf16* q_s = v_s + kTcRows * D;              // [2][kKvQ][D]
  bf16* do_s = q_s + 2 * kKvQ * D;            // [2][kKvQ][D]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kKvQ * D);  // [2][kKvQ], base 2
  float* dl_s = lse_s + 2 * kKvQ;                                 // [2][kKvQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = tile * kTcRows, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int rows = S * G;  // packed rows of (b, kvh)
  auto q_off = [&](int p) {
    return ((size_t)b * S + p / G) * H * D + (size_t)(kvh * G + p % G) * D;
  };
  auto kv_off = [&](int t) { return ((size_t)b * T_len + t) * KV * D + (size_t)kvh * D; };

  for (int idx = tid; idx < kTcRows * kChunks; idx += kBwdThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool in = k0 + r < T_len;
    const size_t off = in ? kv_off(k0 + r) + c * 8 : 0;
    cp_async16(k_s + swz<D>(r, c), k + off, in);
    cp_async16(v_s + swz<D>(r, c), v + off, in);
  }
  // packed rows whose query position can see a key of the tile
  const int k_last = min(T_len, k0 + kTcRows) - 1;
  int p_begin = 0, p_end = rows;
  if (causal) p_begin = (min(k0, S) * G / kKvQ) * kKvQ;
  if (window > 0) p_end = min(rows, (k_last + window) * G);
  const int n_tiles = p_end > p_begin ? (p_end - p_begin + kKvQ - 1) / kKvQ : 0;

  auto load_q = [&](int j) {
    const int p0 = p_begin + j * kKvQ;
    bf16* qs = q_s + (j & 1) * kKvQ * D;
    bf16* ds = do_s + (j & 1) * kKvQ * D;
    for (int idx = tid; idx < kKvQ * kChunks; idx += kBwdThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const bool in = p0 + r < rows;
      const size_t off = in ? q_off(p0 + r) + c * 8 : 0;
      cp_async16(qs + swz<D>(r, c), q + off, in);
      cp_async16(ds + swz<D>(r, c), dout + off, in);
    }
    if (tid < kKvQ) {
      const int p = p0 + tid;
      const size_t off = ((size_t)b * H + kvh * G + p % G) * S + p / G;
      lse_s[(j & 1) * kKvQ + tid] = p < rows ? lse[off] * kLog2e : 0.0f;
      dl_s[(j & 1) * kKvQ + tid] = p < rows ? delta[off] : 0.0f;
    }
  };
  if (n_tiles > 0) load_q(0);
  cp_async_commit();  // K, V and the first query tile

  constexpr int kDB = D / 8;
  float acc_v[WANT_V ? kDB : 1][4], acc_k[WANT_K ? kDB : 1][4];
#pragma unroll
  for (int db = 0; db < (WANT_V ? kDB : 1); ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_v[db][e] = 0.0f;
#pragma unroll
  for (int db = 0; db < (WANT_K ? kDB : 1); ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[db][e] = 0.0f;
  const int wrow0 = warp * 16;
  // this thread's keys: wrow0 + lane / 4 and + 8; its packed rows in a
  // score n-block: nb * 8 + (lane % 4) * 2 + {0, 1}
  const int kpos[2] = {k0 + wrow0 + lane / 4, k0 + wrow0 + lane / 4 + 8};
  const int qcol = (lane % 4) * 2;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_q(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = q_s + (j & 1) * kKvQ * D;
    const bf16* ds_ = do_s + (j & 1) * kKvQ * D;
    const float* lse2 = lse_s + (j & 1) * kKvQ;
    const float* dl = dl_s + (j & 1) * kKvQ;
    const int p0 = p_begin + j * kKvQ;

    float st[kNB][4];  // S^T = K Q^T, then P^T
    mma_rows_rows<D, kNB>(st, k_s, wrow0, qs, 0, lane);
    float dpt[kNB][4];  // dP^T = V dO^T, then dS^T
    if constexpr (WANT_K) mma_rows_rows<D, kNB>(dpt, v_s, wrow0, ds_, 0, lane);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nb * 8 + qcol + (e & 1);
        const int p = p0 + col;
        const bool vis = p < rows && visible(p / G, kpos[e >> 1], T_len, causal, window);
        const float pv = vis ? exp2f(st[nb][e] * scale_log2 - lse2[col]) : 0.0f;
        st[nb][e] = pv;
        if constexpr (WANT_K) dpt[nb][e] = pv * (dpt[nb][e] - dl[col]);
      }
    if constexpr (WANT_V) mma_frag_rows<D, kNB>(acc_v, st, ds_, lane);
    if constexpr (WANT_K) mma_frag_rows<D, kNB>(acc_k, dpt, qs, lane);
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  if (n_tiles == 0) {  // K and V still in flight: land them before staging
    cp_async_wait<0>();
    __syncthreads();
  }
  auto offset = [&](int r) { return kv_off(k0 + wrow0 + r); };
  auto valid = [&](int r) { return k0 + wrow0 + r < T_len; };
  // stage through the warp's own K / V rows (no other warp reads them)
  if constexpr (WANT_K) store_rows<D>(acc_k, scale, k_s, wrow0, dk, offset, valid, lane);
  if constexpr (WANT_V) store_rows<D>(acc_v, 1.0f, v_s, wrow0, dv, offset, valid, lane);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
              int S, int T_len, int H, int KV, int causal, int window, float scale_log2,
              float scale) {
  extern __shared__ __align__(128) unsigned char tc_smem[];
  if constexpr (D <= 128) {
    dkv_tc_body<D, true, true>(q, k, v, dout, lse, delta, dk, dv, blockIdx.x, S, T_len, H, KV,
                               causal, window, scale_log2, scale, tc_smem);
  } else {  // two blocks per key tile: even ones dV, odd ones dK
    if (blockIdx.x & 1)
      dkv_tc_body<D, false, true>(q, k, v, dout, lse, delta, dk, dv, blockIdx.x / 2, S, T_len,
                                  H, KV, causal, window, scale_log2, scale, tc_smem);
    else
      dkv_tc_body<D, true, false>(q, k, v, dout, lse, delta, dk, dv, blockIdx.x / 2, S, T_len,
                                  H, KV, causal, window, scale_log2, scale, tc_smem);
  }
}

// dQ for 64 packed rows of one (batch, kv head)
template <int D>
__global__ void __launch_bounds__(kBwdThreads)
dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, bf16* __restrict__ dq, int S, int T_len, int H,
             int KV, int causal, int window, float scale_log2, float scale) {
  constexpr int kKeys = TcShape<D>::kKeys;
  constexpr int kChunks = TcShape<D>::kChunks;
  constexpr int kNB = kKeys / 8;
  constexpr int kDB = D / 8;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(tc_smem);  // [64][D]
  bf16* do_s = q_s + kTcRows * D;                // [64][D]
  bf16* k_s = do_s + kTcRows * D;                // [2][kKeys][D]
  bf16* v_s = k_s + 2 * kKeys * D;               // [2][kKeys][D]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p0 = blockIdx.x * kTcRows, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int rows = S * G;
  auto q_off = [&](int p) {
    return ((size_t)b * S + p / G) * H * D + (size_t)(kvh * G + p % G) * D;
  };

  for (int idx = tid; idx < kTcRows * kChunks; idx += kBwdThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    const bool in = p0 + r < rows;
    const size_t off = in ? q_off(p0 + r) + c * 8 : 0;
    cp_async16(q_s + swz<D>(r, c), q + off, in);
    cp_async16(do_s + swz<D>(r, c), dout + off, in);
  }
  int k_begin = 0, k_end = T_len;
  if (causal) {  // the forward's range
    const int qpos_lo = p0 / G;
    const int qpos_hi = min(S - 1, (p0 + kTcRows - 1) / G);
    k_end = min(T_len, qpos_hi + 1);
    if (window > 0) k_begin = (max(0, qpos_lo - window + 1) / kKeys) * kKeys;
  }
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kKeys - 1) / kKeys : 0;
  auto load_kv = [&](int j) {
    const int t0 = k_begin + j * kKeys;
    bf16* ks = k_s + (j & 1) * kKeys * D;
    bf16* vs = v_s + (j & 1) * kKeys * D;
    for (int idx = tid; idx < kKeys * kChunks; idx += kBwdThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const bool in = t0 + r < T_len;
      const size_t off = in ? ((size_t)b * T_len + t0 + r) * KV * D + (size_t)kvh * D + c * 8 : 0;
      cp_async16(ks + swz<D>(r, c), k + off, in);
      cp_async16(vs + swz<D>(r, c), v + off, in);
    }
  };
  if (n_tiles > 0) load_kv(0);
  cp_async_commit();  // Q, dO and the first kv tile

  const int wrow0 = warp * 16;
  const int pw = p0 + wrow0;
  int qpos[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = pw + lane / 4 + 8 * i;
    qpos[i] = p / G;
    const size_t off = ((size_t)b * H + kvh * G + p % G) * S + p / G;
    lse2[i] = p < rows ? lse[off] * kLog2e : 0.0f;
    dl[i] = p < rows ? delta[off] : 0.0f;
  }
  const bool row_in[2] = {pw + lane / 4 < rows, pw + lane / 4 + 8 < rows};
  const int kcol = (lane % 4) * 2;

  float acc[kDB][4];
#pragma unroll
  for (int db = 0; db < kDB; ++db)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[db][e] = 0.0f;

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      load_kv(j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = k_s + (j & 1) * kKeys * D;
    const bf16* vs = v_s + (j & 1) * kKeys * D;
    const int t0 = k_begin + j * kKeys;

    float s[kNB][4], dp[kNB][4];
    mma_rows_rows<D, kNB>(s, q_s, wrow0, ks, 0, lane);
    mma_rows_rows<D, kNB>(dp, do_s, wrow0, vs, 0, lane);
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kp = t0 + nb * 8 + kcol + (e & 1);
        const bool vis = row_in[i] && visible(qpos[i], kp, T_len, causal, window);
        const float pv = vis ? exp2f(s[nb][e] * scale_log2 - lse2[i]) : 0.0f;
        s[nb][e] = pv * (dp[nb][e] - dl[i]);  // dS
      }
    mma_frag_rows<D, kNB>(acc, s, ks, lane);
    __syncthreads();  // this stage is refilled by the next iteration's load
  }

  if (n_tiles == 0) {  // Q and dO still in flight: land them before staging
    cp_async_wait<0>();
    __syncthreads();
  }
  auto offset = [&](int r) { return q_off(pw + r); };
  auto valid = [&](int r) { return pw + r < rows; };
  // stage through the warp's own dO rows (no other warp reads them)
  store_rows<D>(acc, scale, do_s, wrow0, dq, offset, valid, lane);
}

// ---- launches ----------------------------------------------------------------
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured = true;
  return err;
}

template <typename T, int D>
int launch_bwd_body(const void* q, const void* k, const void* v, const void* dout, const float* lse,
                const float* delta, void* dq, void* dk, void* dv, int B, int S, int T_len,
                int H, int KV, int causal, int window, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)D);
  if constexpr (sizeof(T) == 2) {
    static bool cfg_kv = false, cfg_q = false;  // one attribute call per instantiation
    cudaError_t err = set_smem(dkv_tc_kernel<D>, BwdSmem<D>::kDkv, cfg_kv);
    if (err == cudaSuccess) err = set_smem(dq_tc_kernel<D>, BwdSmem<D>::kDq, cfg_q);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int kv_tiles = (T_len + kTcRows - 1) / kTcRows;
    const dim3 grid_kv(kv_tiles * (D <= 128 ? 1 : 2), KV, B);
    dkv_tc_kernel<D><<<grid_kv, kBwdThreads, BwdSmem<D>::kDkv, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), S, T_len, H, KV, causal, window, scale * kLog2e, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long q_tiles = ((long long)S * (H / KV) + kTcRows - 1) / kTcRows;
    dq_tc_kernel<D><<<dim3((unsigned)q_tiles, KV, B), kBwdThreads, BwdSmem<D>::kDq,
                      stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), S, T_len, H, KV,
        causal, window, scale * kLog2e, scale);
    return static_cast<int>(cudaGetLastError());
  } else {
    constexpr size_t smem = bwd_f32_smem_bytes<D>();
    static bool cfg_kv = false, cfg_q = false;
    cudaError_t err = set_smem(dkv_f32_kernel<D>, smem, cfg_kv);
    if (err == cudaSuccess) err = set_smem(dq_f32_kernel<D>, smem, cfg_q);
    if (err != cudaSuccess) return static_cast<int>(err);
    dkv_f32_kernel<D><<<dim3((T_len + kBK - 1) / kBK, KV, B), kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dk), static_cast<float*>(dv), S, T_len, H, KV, causal, window,
        scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    dq_f32_kernel<D><<<dim3((S + kBQ - 1) / kBQ, H, B), kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
        static_cast<float*>(dq), S, T_len, H, KV, causal, window, scale);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
           const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int S, int T_len,
           int H, int KV, int D, int causal, int window, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n_rows = (long long)B * S * H;
  delta_kernel<T><<<(unsigned)((n_rows + kDeltaWarps - 1) / kDeltaWarps), 32 * kDeltaWarps, 0,
                    stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout),
                              static_cast<float*>(delta), S, H, D, n_rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
#define FA_BWD_CASE(DIM)                                                                  \
  case DIM:                                                                               \
    return launch_bwd_body<T, DIM>(q, k, v, dout, l, dl, dq, dk, dv, B, S, T_len, H, KV, causal, \
                               window, stream);
  switch (D) {
    FA_BWD_CASE(16)
    FA_BWD_CASE(32)
    FA_BWD_CASE(64)
    FA_BWD_CASE(128)
    FA_BWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_BWD_CASE
}

}  // namespace

// Plain C entry points for ctypes. q (B, S, H, D), k/v (B, T, KV, D) and
// o (B, S, H, D) are contiguous; lse is null or an fp32 (B, H, S) buffer;
// H % KV == 0; D in {16, 32, 64, 128, 256}; causal is 0/1, window <= 0 means none. The bf16 entry also needs each
// pointer 16-byte aligned (its tiles move by 16-byte cp.async). Each
// launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                       void* o, void* lse, int B, int S, int T, int H, int KV,
                                       int D, int causal, int window, void* stream) {
  return launch<float>(q, k, v, o, static_cast<float*>(lse), B, S, T, H, KV, D, causal,
                       window, stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        void* o, void* lse, int B, int S, int T, int H, int KV,
                                        int D, int causal, int window, void* stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return launch<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), B, S, T, H, KV, D,
                               causal, window, stream);
}

// Plain C entry points for ctypes. q, o, dout, dq (B, S, H, D) and k, v, dk,
// dv (B, T, KV, D) are contiguous and of one type; lse is the forward's
// (B, H, S) fp32 log-sum-exp; delta is an fp32 (B, H, S) scratch buffer the
// call fills. H % KV == 0; D in {16, 32, 64, 128, 256}; causal 0/1, window
// <= 0 means none. The bf16 entry also needs 16-byte aligned q, k, v, dout,
// dq, dk and dv. Each launches its kernels on `stream` and returns the CUDA
// error code (0 on success).
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* delta, void* dq, void* dk, void* dv, int B, int S,
                                       int T, int H, int KV, int D, int causal, int window,
                                       void* stream) {
  return launch_bwd<float>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, T, H, KV, D, causal,
                       window, stream);
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* delta, void* dq, void* dk, void* dv, int B, int S,
                                        int T, int H, int KV, int D, int causal, int window,
                                        void* stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)dout | (uintptr_t)dq |
       (uintptr_t)dk | (uintptr_t)dv) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return launch_bwd<__nv_bfloat16>(q, k, v, o, dout, lse, delta, dq, dk, dv, B, S, T, H, KV, D,
                               causal, window, stream);
}
