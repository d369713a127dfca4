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
                const bf16* __restrict__ v, bf16* __restrict__ o, int S, int T_len, int H,
                int KV, int causal, int window, float scale_log2) {
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
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
              int H, int KV, int causal, int window, void* stream) {
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
      static_cast<bf16*>(o), S, T_len, H, KV, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The body is chosen by the input type: bf16 on the tensor cores, fp32 on
// the FMA pipe (see the note at the top).
template <typename T, int D>
int launch_body(const void* q, const void* k, const void* v, void* o, int B, int S,
                int T_len, int H, int KV, int causal, int window, void* stream) {
  if constexpr (sizeof(T) == 2)
    return launch_tc<D>(q, k, v, o, B, S, T_len, H, KV, causal, window, stream);
  else
    return launch_d<T, D>(q, k, v, o, B, S, T_len, H, KV, causal, window, stream);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T_len,
           int H, int KV, int D, int causal, int window, void* stream) {
  switch (D) {
    case 16: return launch_body<T, 16>(q, k, v, o, B, S, T_len, H, KV, causal, window, stream);
    case 32: return launch_body<T, 32>(q, k, v, o, B, S, T_len, H, KV, causal, window, stream);
    case 64: return launch_body<T, 64>(q, k, v, o, B, S, T_len, H, KV, causal, window, stream);
    case 128: return launch_body<T, 128>(q, k, v, o, B, S, T_len, H, KV, causal, window, stream);
    case 256: return launch_body<T, 256>(q, k, v, o, B, S, T_len, H, KV, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry points for ctypes. q (B, S, H, D), k/v (B, T, KV, D) and
// o (B, S, H, D) are contiguous; H % KV == 0; D in {16, 32, 64, 128, 256};
// causal is 0/1, window <= 0 means none. The bf16 entry also needs each
// pointer 16-byte aligned (its tiles move by 16-byte cp.async). Each
// launches on `stream` and returns the CUDA error code (0 on success).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                       void* o, int B, int S, int T, int H, int KV,
                                       int D, int causal, int window, void* stream) {
  return launch<float>(q, k, v, o, B, S, T, H, KV, D, causal, window, stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        void* o, int B, int S, int T, int H, int KV,
                                        int D, int causal, int window, void* stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return launch<__nv_bfloat16>(q, k, v, o, B, S, T, H, KV, D, causal, window, stream);
}
