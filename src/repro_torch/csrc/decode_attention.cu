// One-token GQA decode attention against a KV cache for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decode_attention_grouped (body
// _decode_kernel) in src/repro/kernels/decode_attention/kernel.py. It
// computes what that kernel computes: for each (batch, kv head), the G query
// heads of the group against the cache slots, scores (q . k) * D^-0.5 in
// fp32, slots with valid[t] == 0 set to the -1e30 sentinel, online softmax,
// l clamped at 1e-30, output in q's type. `valid` is one (T,) byte mask
// (a torch bool) shared by the batch; for a ring cache it is not a prefix.
// Slots past T do not exist and add nothing, so an all-invalid mask gives
// uniform weights over the T slots, as the plain version does.
//
// What bounds it on an H100: bytes. Each step streams the whole cache once:
// at gemma3-1b's global layer (B 4, T 1088 of which 1056 valid, KV 1, G 4,
// D 256, bf16) that is 4.3 MB of valid K/V, ~1.3 us at 3.35 TB/s, against
// ~9e6 flops. At that size latency, not bandwidth, sets the time: on an
// H100 the launch, the first trip for the cache, the math of a few slots
// per warp and the combine each take a comparable share of it.
//
// Design (one launch, no scratch, no atomics):
//   * Fill the card: a unit is one (batch, kv head, group of up to 8 query
//     heads); each unit gets a thread-block cluster of up to 16 blocks (one
//     block per SM), so B * KV = 4 units still spread over 64 SMs. Each of
//     the cluster's W * CS warps (W = 12 a block, 8 for groups of 8 heads)
//     owns a contiguous run of ceil(T / (W CS)) slots and runs its own
//     online softmax over it: no block barrier while the cache streams.
//   * 16-byte loads, overlapped: a warp moves its slots in chunks of 8 rows
//     (16 for D 16) of K and V by 16-byte cp.async into a private ring of up
//     to 4 chunks in shared memory, kept in the cache's type (bf16 stays
//     bf16), with the next chunks in flight while one is multiplied.
//     Out-of-range rows are zero-filled. Only __syncwarp orders the ring.
//   * Scores without a long serial chain: lane j of a row holds 8 elements
//     of the row (one 16-byte shared load in bf16) and the same 8 elements
//     of each query head of the group in registers, widened once. It forms
//     8 products per head and row; a transposing butterfly then sums the
//     partials of a whole chunk over the row's lanes with one shuffle per
//     value pair and step (31 shuffles for 32 partials at D 256, G 4), so
//     each lane ends with the full score of one (row, head).
//   * Softmax in base 2: scores are scaled by D^-0.5 * log2(e); the -1e30
//     sentinel is written after the scaling, so exp2(-1e30 - m) is 0 and
//     exp2(-1e30 + 1e30) is 1 exactly as in the reference's exp. Rows past
//     the warp's run get -inf and weigh 0. Each lane rescales its own
//     accumulator columns by exp2(m_old - m_new) once per chunk and head.
//   * P . V: the lane owns the same 8 columns of the output for every head
//     of the group and accumulates p * v for the rows of its row group; at
//     D < 256 the row groups are summed by shuffles once, at the end.
//   * Combine inside the launch: warps write (m, l, acc) to shared memory
//     and the block combines them in warp order with one weight
//     e^(m_w - M) per (warp, head); each block then pushes its partial
//     columns and its (m, l) into the owning rank's shared memory through
//     distributed shared memory, 16 bytes a store (rank r owns columns
//     [r, r + 1) * D / CS, rounded to 4), and after one cluster barrier
//     every owner combines the ranks in rank order with one weight per
//     (rank, head) and writes its columns. Sums run in a fixed order, so
//     repeated calls give the same bits, and no state survives a call, so
//     the launch can be captured in a CUDA graph.
// fp32 inputs take the same path with two 16-byte loads per 8 elements and
// a ring of half the depth (one chunk at D 256). decode_attention_setup()
// sets every instantiation's shared-memory limit and non-portable cluster
// size once, before any capture, and records the largest cluster the card
// can place.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <limits>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF sentinel
constexpr float kAbsent = -std::numeric_limits<float>::infinity();  // a row past the run
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxCluster = 16;      // non-portable cluster size on Hopper
constexpr int kPortableCluster = 8;
constexpr int kFillBlocks = 264;     // two blocks' worth on each of 132 SMs
constexpr int kMinRowsPerWarp = 4;   // fewer slots per warp are not worth a rank
constexpr int kRingBudget = 192 * 1024;

template <typename T, int D, int GP>
struct Shape {
  // 12 warps a block put one chunk on each warp at T 1088 (6 slots a warp);
  // a group of 8 heads needs more registers than 12 warps leave a thread
  static constexpr int kWarps = GP >= 8 ? 8 : 12;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kElt = sizeof(T);
  static constexpr int kL = D / 8;                  // lanes per cache row
  static constexpr int kR = 32 / kL;                // rows per warp pass
  static constexpr int kRows = kR > 8 ? kR : 8;     // rows per chunk
  static constexpr int kPasses = kRows / kR;
  static constexpr int kNV = kPasses * GP;          // score partials per lane
  static constexpr int kNVL = kNV >= kL ? kNV / kL : 1;  // full scores per lane
  static constexpr int kRowBytes = D * kElt;
  static constexpr int kChunkBytes = 2 * kRows * kRowBytes;  // K then V
  static constexpr int kStagesFit = kRingBudget / (kWarps * kChunkBytes);
  static constexpr int kStages = kStagesFit < 1 ? 1 : (kStagesFit > 4 ? 4 : kStagesFit);
  static constexpr int kRingBytes = kStages * kChunkBytes;   // per warp
  // float offsets past the rings
  static constexpr int kScores = kWarps * kRows * GP;        // [warp][row][head]
  static constexpr int kWm = kScores;                        // [warp][head]
  static constexpr int kWl = kWm + kWarps * GP;
  static constexpr int kWw = kWl + kWarps * GP;              // block weights
  static constexpr int kBm = kWw + kWarps * GP;              // block max [head]
  static constexpr int kCw = kBm + (GP + 3) / 4 * 4;         // cluster weights [rank][head]
  static constexpr int kRecvM = kCw + kMaxCluster * GP;      // [rank][head]
  static constexpr int kRecvL = kRecvM + kMaxCluster * GP;
  static constexpr int kRecvAcc = kRecvL + kMaxCluster * GP; // [rank][head][col]
  static constexpr int kFloats = kRecvAcc + GP * (D + 4 * kMaxCluster);
  static_assert(kRecvAcc % 4 == 0, "float4 receive buffer");
  static constexpr size_t kSmem = (size_t)kWarps * kRingBytes + sizeof(float) * kFloats;
  static_assert(kRingBytes >= GP * D * (int)sizeof(float), "warp partial must fit its ring");
  static_assert(kSmem <= 227 * 1024, "shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The 8 elements of a row that lane j (of the row's kL lanes) owns: in bf16
// one 16-byte piece, elements 8j..8j+7; in fp32 the pieces j and j + kL,
// elements 4j..4j+3 and 4(j + kL)..4(j + kL)+3, so each load instruction
// reads neighbouring pieces across the lanes.
template <typename T, int D> struct Row8;
template <int D> struct Row8<__nv_bfloat16, D> {
  __device__ static __forceinline__ int col(int j, int e) { return 8 * j + e; }
  __device__ static __forceinline__ void load(const __nv_bfloat16* row, int j, float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * j);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <int D> struct Row8<float, D> {
  static constexpr int kL = D / 8;
  __device__ static __forceinline__ int col(int j, int e) {
    return e < 4 ? 4 * j + e : 4 * (j + kL) + e - 4;
  }
  __device__ static __forceinline__ void load(const float* row, int j, float (&f)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(row + 4 * j);
    const float4 b = *reinterpret_cast<const float4*>(row + 4 * (j + kL));
    f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
    f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
  }
};

// Sums N partials per lane over the lanes xor OFF, OFF / 2, .., 1. While
// more than one partial is left, each step sends half of them to the
// partner and keeps the other half (the upper half on the lane whose OFF
// bit is set), so lane bit OFF selects the upper half of the indices.
// Afterwards lane x holds max(1, N / L) full sums, starting at index
// (x % L) * N / L (N >= L) or (x % L) / (L / N) (N < L), L = 2 * OFF at the
// first step. The order of the sums is fixed.
template <int N, int OFF>
struct TransposeSum {
  __device__ static __forceinline__ void run(float* v, int lane) {
    if constexpr (OFF > 0) {
      if constexpr (N > 1) {
        constexpr int H = N / 2;
        const bool upper = (lane & OFF) != 0;
#pragma unroll
        for (int i = 0; i < H; ++i) {
          const float send = upper ? v[i] : v[i + H];
          const float keep = upper ? v[i + H] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
        }
        TransposeSum<H, OFF / 2>::run(v, lane);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
        TransposeSum<1, OFF / 2>::run(v, lane);
      }
    }
  }
};

// grid (CS, units), cluster (CS, 1, 1); unit = (b * KV + kvh) * NHG + hg
template <typename T, int D, int GP>
__global__ void __launch_bounds__(Shape<T, D, GP>::kThreads, 1)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const uint8_t* __restrict__ valid, T* __restrict__ out, int T_len, int H,
              int KV, int G, int NHG, float scale_log2) {
  using S = Shape<T, D, GP>;
  using RowT = Row8<T, D>;
  constexpr int kL = S::kL, kR = S::kR, kRows = S::kRows, kPasses = S::kPasses;
  constexpr int kStages = S::kStages;
  constexpr int kWarps = S::kWarps, kThreads = S::kThreads;
  extern __shared__ __align__(16) unsigned char dec_smem[];
  float* fs = reinterpret_cast<float*>(dec_smem + (size_t)kWarps * S::kRingBytes);

  // every block of the cluster must have started before any writes into
  // its shared memory: arrive now, wait just before the first remote store
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int unit = blockIdx.y;
  const int hg = unit % NHG;
  const int bk = unit / NHG;   // b * KV + kvh
  const int b = bk / KV;
  const int kvh = bk % KV;
  const int head0 = kvh * G + hg * GP;   // first query head of the unit
  const int n_heads = min(GP, G - hg * GP);

  // this warp's run of slots
  const int n_warps = cs * kWarps;
  const int per = (T_len + n_warps - 1) / n_warps;
  const int lo = min(T_len, (rank * kWarps + warp) * per);
  const int hi = min(T_len, lo + per);
  const int n_chunks = (hi - lo + kRows - 1) / kRows;

  const int j = lane % kL;      // the lane's 8 elements of a row
  const int rg = lane / kL;     // the lane's row within a pass

  // the group's queries, 8 elements a head, in registers
  float qf[GP][8];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g < n_heads) {
      RowT::load(q + ((size_t)b * H + head0 + g) * D, j, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[g][e] = 0.0f;
    }
  }

  unsigned char* ring = dec_smem + (size_t)warp * S::kRingBytes;
  float* sc = fs + warp * kRows * GP;   // this warp's scores [row][head]
  const size_t row_stride = (size_t)KV * D;   // elements between cache slots
  const T* k_base = k + ((size_t)b * T_len * KV + kvh) * D;
  const T* v_base = v + ((size_t)b * T_len * KV + kvh) * D;

  auto issue = [&](int c) {
    if (c < n_chunks) {
      constexpr int kPieces = S::kRowBytes / 16;   // 16-byte pieces per row
      unsigned char* kd = ring + (c % kStages) * S::kChunkBytes;
      unsigned char* vd = kd + kRows * S::kRowBytes;
      const int r0 = lo + c * kRows;
#pragma unroll
      for (int i = lane; i < kRows * kPieces; i += 32) {
        const int row = i / kPieces, piece = i % kPieces;
        const bool ok = r0 + row < hi;
        const size_t off = ok ? (size_t)(r0 + row) * row_stride : 0;
        cp_async16(kd + row * S::kRowBytes + piece * 16,
                   reinterpret_cast<const unsigned char*>(k_base + off) + piece * 16, ok);
        cp_async16(vd + row * S::kRowBytes + piece * 16,
                   reinterpret_cast<const unsigned char*>(v_base + off) + piece * 16, ok);
      }
    }
    cp_async_commit();   // an empty group keeps the wait count uniform
  };

  float m_run[GP], l_run[GP], acc[GP][8];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m_run[g] = kNegInf;
    l_run[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.0f;
  }

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  for (int c = 0; c < n_chunks; ++c) {
    issue(c + kStages - 1);
    const int r0 = lo + c * kRows;
    const int nr = min(kRows, hi - r0);
    // the chunk's mask bytes, one row per lane, while the copies fly
    const int vb = lane < nr ? valid[r0 + lane] : 0;
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const T* kc = reinterpret_cast<const T*>(ring + (c % kStages) * S::kChunkBytes);
    const T* vc = kc + kRows * D;

    // scores: 8 products per head and row, then a transposing sum
    float part[S::kNV];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      if (p * kR >= nr) {   // a pass of rows past the run (uniform in the warp)
#pragma unroll
        for (int g = 0; g < GP; ++g) part[p * GP + g] = 0.0f;
        continue;
      }
      float kf[8];
      RowT::load(kc + (p * kR + rg) * D, j, kf);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float s = qf[g][0] * kf[0];
#pragma unroll
        for (int e = 1; e < 8; ++e) s = fmaf(qf[g][e], kf[e], s);
        part[p * GP + g] = s;
      }
    }
    TransposeSum<S::kNV, kL / 2>::run(part, lane);
    const int base = S::kNV >= kL ? j * (S::kNV / kL) : j / (kL / S::kNV);
#pragma unroll
    for (int i = 0; i < S::kNVL; ++i) {
      const int idx = base + i;
      const int row = (idx / GP) * kR + rg, g = idx % GP;
      const int ok = __shfl_sync(0xffffffffu, vb, row);
      sc[row * GP + g] = row >= nr ? kAbsent : (ok ? part[i] * scale_log2 : kNegInf);
    }
    __syncwarp();

    // online softmax over the chunk: max over the lane's rows, then over
    // the row groups
    float m_new[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) m_new[g] = m_run[g];
#pragma unroll
    for (int p = 0; p < kPasses; ++p)
#pragma unroll
      for (int g = 0; g < GP; ++g) m_new[g] = fmaxf(m_new[g], sc[(p * kR + rg) * GP + g]);
#pragma unroll
    for (int off = kL; off < 32; off *= 2)
#pragma unroll
      for (int g = 0; g < GP; ++g)
        m_new[g] = fmaxf(m_new[g], __shfl_xor_sync(0xffffffffu, m_new[g], off));
    float l_add[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float alpha = fast_exp2(m_run[g] - m_new[g]);
      m_run[g] = m_new[g];
      l_run[g] *= alpha;
      l_add[g] = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
    }
    // P . V over the lane's rows
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      if (p * kR >= nr) continue;
      const int row = p * kR + rg;
      float vf[8];
      RowT::load(vc + row * D, j, vf);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float w = fast_exp2(sc[row * GP + g] - m_new[g]);
        l_add[g] += w;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(w, vf[e], acc[g][e]);
      }
    }
#pragma unroll
    for (int off = kL; off < 32; off *= 2)
#pragma unroll
      for (int g = 0; g < GP; ++g) l_add[g] += __shfl_xor_sync(0xffffffffu, l_add[g], off);
#pragma unroll
    for (int g = 0; g < GP; ++g) l_run[g] += l_add[g];
    __syncwarp();   // the ring slot and the scores are refilled next
  }
  cp_async_wait<0>();

  // the row groups' accumulators hold disjoint rows of the same columns
#pragma unroll
  for (int off = kL; off < 32; off *= 2)
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);

  // the warp's partial (m, l, acc) into shared memory; acc in its own ring
  __syncwarp();
  float* wacc = reinterpret_cast<float*>(ring);   // [head][col]
  if (lane < kL) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      *reinterpret_cast<float4*>(wacc + g * D + RowT::col(j, 0)) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      *reinterpret_cast<float4*>(wacc + g * D + RowT::col(j, 4)) =
          make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      fs[S::kWm + warp * GP + g] = m_run[g];
      fs[S::kWl + warp * GP + g] = l_run[g];
    }
  }
  __syncthreads();

  // block combine, warps in order: one weight e^(m_w - M) per (warp, head)
  if (tid < kWarps * GP) {
    const int w = tid / GP, g = tid % GP;
    float mb = kNegInf;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) mb = fmaxf(mb, fs[S::kWm + x * GP + g]);
    fs[S::kWw + tid] = fast_exp2(fs[S::kWm + tid] - mb);
    if (w == 0) fs[S::kBm + g] = mb;
  }
  __syncthreads();
  // each thread pushes 4 columns of one head to the rank that owns them;
  // the first cs * GP threads push the block's (m, l) to every rank
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int cpr = ((D + cs - 1) / cs + 3) / 4 * 4;   // output columns per rank
  for (int quad = tid; quad < GP * D / 4; quad += kThreads) {
    const int g = quad / (D / 4), col = quad % (D / 4) * 4;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float ww = fs[S::kWw + w * GP + g];
      const float4 x = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(dec_smem + (size_t)w * S::kRingBytes) + g * D + col);
      a.x = fmaf(ww, x.x, a.x);
      a.y = fmaf(ww, x.y, a.y);
      a.z = fmaf(ww, x.z, a.z);
      a.w = fmaf(ww, x.w, a.w);
    }
    float* dst = cluster.map_shared_rank(fs + S::kRecvAcc, col / cpr);
    *reinterpret_cast<float4*>(dst + (rank * GP + g) * cpr + col % cpr) = a;
  }
  if (tid < cs * GP) {
    const int owner = tid / GP, g = tid % GP;
    float lb = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      lb = fmaf(fs[S::kWw + w * GP + g], fs[S::kWl + w * GP + g], lb);
    cluster.map_shared_rank(fs + S::kRecvM, owner)[rank * GP + g] = fs[S::kBm + g];
    cluster.map_shared_rank(fs + S::kRecvL, owner)[rank * GP + g] = lb;
  }
  cluster.sync();

  // owner: one weight per (rank, head)
  if (tid < cs * GP) {
    const int g = tid % GP;
    float mc = kNegInf;
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < cs) mc = fmaxf(mc, fs[S::kRecvM + r * GP + g]);
    fs[S::kCw + tid] = fast_exp2(fs[S::kRecvM + tid] - mc);
  }
  __syncthreads();
  // ranks in order, 4 columns a thread
  for (int quad = tid; quad < GP * cpr / 4; quad += kThreads) {
    const int g = quad / (cpr / 4), c = quad % (cpr / 4) * 4;
    const int col = rank * cpr + c;
    if (g >= n_heads || col >= D) continue;
    float lc = 0.0f;
    float4 num = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r) {
      if (r < cs) {
        const float w = fs[S::kCw + r * GP + g];
        const float4 x =
            *reinterpret_cast<const float4*>(fs + S::kRecvAcc + (r * GP + g) * cpr + c);
        lc = fmaf(w, fs[S::kRecvL + r * GP + g], lc);
        num.x = fmaf(w, x.x, num.x);
        num.y = fmaf(w, x.y, num.y);
        num.z = fmaf(w, x.z, num.z);
        num.w = fmaf(w, x.w, num.w);
      }
    }
    lc = fmaxf(lc, 1e-30f);
    T* o = out + ((size_t)b * H + head0 + g) * D + col;
    o[0] = from_f32<T>(num.x / lc);
    o[1] = from_f32<T>(num.y / lc);
    o[2] = from_f32<T>(num.z / lc);
    o[3] = from_f32<T>(num.w / lc);
  }
}

// The largest cluster the card can place for an instantiation: set by
// setup(), read by launch().
template <typename T, int D, int GP>
int& max_cluster() {
  static int n = 0;
  return n;
}

template <typename T, int D, int GP>
int setup_one() {
  using S = Shape<T, D, GP>;
  auto kernel = decode_kernel<T, D, GP>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxCluster, 1, 1);
  cfg.blockDim = dim3(S::kThreads, 1, 1);
  cfg.dynamicSmemBytes = S::kSmem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kMaxCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();   // the query may refuse 16; 8 is portable
    n = 0;
  }
  max_cluster<T, D, GP>() = n > 0 ? kMaxCluster : kPortableCluster;
  return 0;
}

template <typename T, int D, int GP>
int launch_cfg(const void* q, const void* k, const void* v, const void* valid, void* out,
               int B, int T_len, int H, int KV, int G, float scale, cudaStream_t stream) {
  using S = Shape<T, D, GP>;
  const int cap = max_cluster<T, D, GP>();
  if (cap == 0) return static_cast<int>(cudaErrorInitializationError);  // setup() not run
  const int n_hg = (G + GP - 1) / GP;
  const int units = B * KV * n_hg;
  int cs = (T_len + S::kWarps * kMinRowsPerWarp - 1) / (S::kWarps * kMinRowsPerWarp);
  cs = std::min(cs, cap);
  cs = std::min(cs, std::max(1, (kFillBlocks + units - 1) / units));
  cs = std::max(cs, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, units, 1);
  cfg.blockDim = dim3(S::kThreads, 1, 1);
  cfg.dynamicSmemBytes = S::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale_log2 = kLog2e * scale;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_kernel<T, D, GP>, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const uint8_t*>(valid), static_cast<T*>(out),
      T_len, H, KV, G, n_hg, scale_log2);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// heads per unit: the group itself up to 8, rounded up to a power of two
inline int group_pad(int G) { return G > 4 ? 8 : G > 2 ? 4 : G; }

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* valid, void* out, int B,
             int T_len, int H, int KV, float scale, cudaStream_t s) {
  const int G = H / KV;
  switch (group_pad(G)) {
    case 1: return launch_cfg<T, D, 1>(q, k, v, valid, out, B, T_len, H, KV, G, scale, s);
    case 2: return launch_cfg<T, D, 2>(q, k, v, valid, out, B, T_len, H, KV, G, scale, s);
    case 4: return launch_cfg<T, D, 4>(q, k, v, valid, out, B, T_len, H, KV, G, scale, s);
    default: return launch_cfg<T, D, 8>(q, k, v, valid, out, B, T_len, H, KV, G, scale, s);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out, int B,
           int T_len, int H, int KV, int D, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, valid, out, B, T_len, H, KV, scale, s);
    case 32: return launch_d<T, 32>(q, k, v, valid, out, B, T_len, H, KV, scale, s);
    case 64: return launch_d<T, 64>(q, k, v, valid, out, B, T_len, H, KV, scale, s);
    case 128: return launch_d<T, 128>(q, k, v, valid, out, B, T_len, H, KV, scale, s);
    case 256: return launch_d<T, 256>(q, k, v, valid, out, B, T_len, H, KV, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
int setup_d() {
  int err = setup_one<T, D, 1>();
  if (err == 0) err = setup_one<T, D, 2>();
  if (err == 0) err = setup_one<T, D, 4>();
  if (err == 0) err = setup_one<T, D, 8>();
  return err;
}

template <typename T>
int setup_t() {
  int err = setup_d<T, 16>();
  if (err == 0) err = setup_d<T, 32>();
  if (err == 0) err = setup_d<T, 64>();
  if (err == 0) err = setup_d<T, 128>();
  if (err == 0) err = setup_d<T, 256>();
  return err;
}

}  // namespace

// Sets every instantiation's dynamic shared-memory limit and non-portable
// cluster size on the current device and finds the largest cluster it can
// place. Call once, outside any stream capture, before the first launch.
// Returns the CUDA error code (0 on success).
extern "C" int decode_attention_setup(void) {
  const int err = setup_t<float>();
  return err != 0 ? err : setup_t<__nv_bfloat16>();
}

// Plain C entry points for ctypes. q (B, 1, H, D), k/v (B, T, KV, D) and
// out (B, 1, H, D) are contiguous, k and v 16-byte aligned; valid (T,) one
// byte per slot, nonzero = attend; H % KV == 0; D in {16, 32, 64, 128,
// 256}; scores are scaled by `scale` (the wrapper passes the true head
// dim's D^-0.5 when it has padded D). Each is one launch on `stream` and
// returns the CUDA error code (0 on success).
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* valid, void* out, int B, int T, int H, int KV,
                                    int D, float scale, void* stream) {
  return launch<float>(q, k, v, valid, out, B, T, H, KV, D, scale, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* valid, void* out, int B, int T, int H, int KV,
                                     int D, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, valid, out, B, T, H, KV, D, scale, stream);
}
