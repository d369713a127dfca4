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
// a ring of half the depth (one chunk at D 256).
// Head dims: the Pallas kernel's blocks span any D. The kernel is
// instantiated at widths 16, 32, 64, 128 and 256, and a call with head dim
// D <= 256 runs the smallest width W >= D (the wrapper's dispatch picks it
// and hands it over): it reads q and the cache at the caller's strides
// (Axes: a view of a fused or wider tensor is read in place), the ring's
// columns past D are zero-filled (so they add nothing to a score and give
// accumulator columns that stay out of the output),
// the cluster combines and writes only the D columns, and scores are scaled
// by the true D^-0.5. Nothing is copied in device memory. Rows of D not on
// the 16-byte grid (D % 8 in bf16, D % 4 in fp32) are read element by
// element, the choice made once per chunk outside the copy loop. Each
// width has two instantiations: D = W keeps every bound at compile time, as
// the power-of-two head dims always ran (with D a runtime value throughout,
// D 64 decode ran 5-8% slower on an H100), D < W reads dh columns. decode_attention_setup()
// sets every instantiation's shared-memory limit and non-portable cluster
// size once, before any capture, and records the largest cluster the card
// can place.
// Head dims above 256 run in column passes of 256 (kWide, one launch: grid
// y = unit * passes + pass): the cache rows are streamed as pieces of 256
// columns, K pieces 0 .. ceil(D / 256) - 1 of a chunk of rows summed into
// the same score partials (the q piece re-read from L1 each time), then
// the pass's V piece; the ring keeps the width-256 layout (a stage holds a
// K piece and, with the chunk's last K piece, the V piece). Each pass
// combines and writes its own 256 columns, so K is streamed once per pass.
// float16 takes the bf16 path with f16 loads.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <limits>
#include <type_traits>

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
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

constexpr int kPassWidth = 256;  // output columns of one pass when D > 256

// element strides of the batch, row and head axes of a (B, rows, heads, D)
// input whose last axis is unit-stride: the caller's view, read in place
// (every stride a multiple of 16 bytes, so a row on the 16-byte grid stays
// there; the wrapper copies any other view)
struct Axes {
  long long b;  // may pass 2^31 elements
  int s, h;     // the wrapper checks these fit an int
  __host__ __device__ __forceinline__ size_t at(int bi, int si, int hi) const {
    return (size_t)((long long)bi * b + (long long)si * s + (long long)hi * h);
  }
};
// whether strides `a` are those of a dense (B, rows, heads, dh) tensor (an
// axis of size 1 carries stride 0 from the wrapper: never used)
inline bool is_dense(const Axes& a, int B, int rows, int heads, int dh) {
  return (B == 1 || a.b == (long long)rows * heads * dh) &&
         (rows == 1 || a.s == (long long)heads * dh) && (heads == 1 || a.h == dh);
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
template <int D> struct Row8<__half, D> {
  __device__ static __forceinline__ int col(int j, int e) { return 8 * j + e; }
  __device__ static __forceinline__ void load(const __half* row, int j, float (&f)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(row + 8 * j);
    const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __half22float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
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

// The same 8 elements of a row of dh <= D elements in device memory, one at
// a time, zeros past dh.
template <typename T, int D>
__device__ __forceinline__ void load_row8(const T* row, int j, int dh, float (&f)[8]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int c = Row8<T, D>::col(j, e);
    f[e] = c < dh ? to_f32(row[c]) : 0.0f;
  }
}

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

// grid (CS, units * passes), cluster (CS, 1, 1); unit = (b * KV + kvh) * NHG
// + hg, blockIdx.y = unit * passes + pass (passes = 1 unless kWide).
// kPart: the tensors' head dim dh_arg is below the width D; otherwise dh = D
// at compile time and the body is the one the power-of-two head dims
// always ran. kWide (with kPart, D = 256): dh_arg > 256 in column passes.
// kStrided (with kPart): q, k and v are views read at the caller's strides
// (Axes); a dense call keeps the addressing it always had (strides read
// everywhere cost up to 15% at internvl2-1b's decode on an H100).
template <typename T, int D, int GP, bool kPart, bool kWide, bool kStrided>
__global__ void __launch_bounds__(Shape<T, D, GP>::kThreads, 1)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const uint8_t* __restrict__ valid, T* __restrict__ out, const Axes q_ax,
              const Axes k_ax, const Axes v_ax, int T_len, int H, int KV, int dh_arg, int G,
              int NHG, float scale_log2, int passes) {
  using S = Shape<T, D, GP>;
  const int dh = kPart ? dh_arg : D;
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
  const int unit = kWide ? blockIdx.y / passes : blockIdx.y;
  const int c0 = kWide ? (blockIdx.y % passes) * D : 0;  // the pass's first column
  const int n_pc = kWide ? (dh + D - 1) / D : 1;          // K pieces of a cache row
  const int dv = kWide ? min(D, dh - c0) : dh;            // the pass's output columns
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
  const int n_items = n_chunks * n_pc;   // (chunk, K piece) in order: the ring's items

  const int j = lane % kL;      // the lane's 8 elements of a row
  const int rg = lane / kL;     // the lane's row within a pass

  // the group's queries, 8 elements a head, in registers: all of them, or
  // (kWide) K piece pc's columns
  float qf[GP][8];
  auto load_q = [&](int pc) {
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g < n_heads) {
        const T* row = q + pc * D +
                       (kStrided ? q_ax.at(b, 0, head0 + g) : ((size_t)b * H + head0 + g) * dh);
        if (!kPart || (!kWide && dh == D))
          RowT::load(row, j, qf[g]);
        else
          load_row8<T, D>(row, j, dh - pc * D, qf[g]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) qf[g][e] = 0.0f;
      }
    }
  };
  if constexpr (!kWide) load_q(0);

  unsigned char* ring = dec_smem + (size_t)warp * S::kRingBytes;
  float* sc = fs + warp * kRows * GP;   // this warp's scores [row][head]
  // slot t of this batch and kv head at + t * row_stride (kStrided: at the
  // caller's strides, k and v apart; else one offset for both)
  const size_t row_stride = kStrided ? (size_t)k_ax.s : (size_t)KV * dh;
  const T* k_base = k + (kStrided ? k_ax.at(b, 0, kvh) : ((size_t)b * T_len * KV + kvh) * dh);
  const T* v_base = v + (kStrided ? v_ax.at(b, 0, kvh) : ((size_t)b * T_len * KV + kvh) * dh);
  // a row of dh elements on the 16-byte grid moves by cp.async, a piece
  // past dh zero-filled; another dh is read element by element
  constexpr int kPieceElts = 16 / S::kElt;
  const bool vec = dh % kPieceElts == 0;

  // 16 bytes of a row (columns e0 .. of `row`, lim of them real) into dst
  auto piece16 = [&](unsigned char* dst, const T* row, int e0, int lim, bool ok, auto vec_t) {
    if (decltype(vec_t)::value || !ok || e0 >= lim) {
      const bool in = ok && e0 < lim;
      cp_async16(dst, row + (in ? e0 : 0), in);
    } else {
      T* d = reinterpret_cast<T*>(dst);
#pragma unroll
      for (int e = 0; e < kPieceElts; ++e) d[e] = e0 + e < lim ? row[e0 + e] : from_f32<T>(0.0f);
    }
  };
  // item i into the ring: the rows of chunk i / n_pc, K columns
  // [pc D, pc D + D) (pc = i % n_pc) and, with the last piece, V columns
  // [c0, c0 + D)
  auto issue_chunk = [&](int i, auto vec_t) {
    if (i < n_items) {
      constexpr int kPieces = S::kRowBytes / 16;   // 16-byte pieces per row
      const int c = i / n_pc, pc = i % n_pc;
      unsigned char* kd = ring + (i % kStages) * S::kChunkBytes;
      unsigned char* vd = kd + kRows * S::kRowBytes;
      const int r0 = lo + c * kRows;
      const bool with_v = pc == n_pc - 1;
#pragma unroll
      for (int x = lane; x < kRows * kPieces; x += 32) {
        const int row = x / kPieces, piece = x % kPieces;
        const bool ok = r0 + row < hi;
        const size_t off = ok ? (size_t)(r0 + row) * row_stride : 0;
        const size_t v_off = kStrided ? (ok ? (size_t)(r0 + row) * v_ax.s : 0) : off;
        const int e0 = piece * kPieceElts;   // the piece's first column
        piece16(kd + row * S::kRowBytes + piece * 16, k_base + off + pc * D, e0, dh - pc * D, ok,
                vec_t);
        if (with_v)
          piece16(vd + row * S::kRowBytes + piece * 16, v_base + v_off + c0, e0, dh - c0, ok,
                  vec_t);
      }
    }
    cp_async_commit();   // an empty group keeps the wait count uniform
  };
  // the layout is picked once per item, outside the copy loop
  auto issue = [&](int i) {
    if (vec)
      issue_chunk(i, std::true_type{});
    else
      issue_chunk(i, std::false_type{});
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
    const int r0 = lo + c * kRows;
    const int nr = min(kRows, hi - r0);
    // scores: 8 products per head and row (summed over the K pieces if
    // kWide), then a transposing sum
    float part[S::kNV];
    const T* vc;
    int vb;
    if constexpr (!kWide) {
      issue(c + kStages - 1);
      // the chunk's mask bytes, one row per lane, while the copies fly
      vb = lane < nr ? valid[r0 + lane] : 0;
      cp_async_wait<kStages - 1>();
      __syncwarp();
      const T* kc = reinterpret_cast<const T*>(ring + (c % kStages) * S::kChunkBytes);
      vc = kc + kRows * D;
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
    } else {   // item c * n_pc + pc: K piece pc, with the V piece at the last
      vb = lane < nr ? valid[r0 + lane] : 0;
      for (int pc = 0; pc < n_pc; ++pc) {
        const int i = c * n_pc + pc;
        issue(i + kStages - 1);
        load_q(pc);
        cp_async_wait<kStages - 1>();
        __syncwarp();
        const T* kc = reinterpret_cast<const T*>(ring + (i % kStages) * S::kChunkBytes);
        vc = kc + kRows * D;
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
            float s = pc == 0 ? qf[g][0] * kf[0] : fmaf(qf[g][0], kf[0], part[p * GP + g]);
#pragma unroll
            for (int e = 1; e < 8; ++e) s = fmaf(qf[g][e], kf[e], s);
            part[p * GP + g] = s;
          }
        }
        if (pc < n_pc - 1) __syncwarp();   // the ring slot is refilled next
      }
    }
    TransposeSum<S::kNV, kL / 2>::run(part, lane);
    const int base = S::kNV >= kL ? j * (S::kNV / kL) : j / (kL / S::kNV);
#pragma unroll
    for (int x = 0; x < S::kNVL; ++x) {
      const int idx = base + x;
      const int row = (idx / GP) * kR + rg, g = idx % GP;
      const int ok = __shfl_sync(0xffffffffu, vb, row);
      sc[row * GP + g] = row >= nr ? kAbsent : (ok ? part[x] * scale_log2 : kNegInf);
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
  // columns below dv (rounded up to 4) only: the ones past it are zeros
  const int nq = (dv + 3) / 4;                            // 4-column quads per head
  const int cpr = ((4 * nq + cs - 1) / cs + 3) / 4 * 4;   // output columns per rank
  for (int quad = tid; quad < GP * nq; quad += kThreads) {
    const int g = quad / nq, col = quad % nq * 4;
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
    if (g >= n_heads || col >= dv) continue;
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
    T* o = out + ((size_t)b * H + head0 + g) * dh + c0 + col;
    const float r[4] = {num.x / lc, num.y / lc, num.z / lc, num.w / lc};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (col + i < dv) o[i] = from_f32<T>(r[i]);
  }
}

// The largest cluster the card can place for an instantiation: set by
// setup(), read by launch().
template <typename T, int D, int GP, bool kPart, bool kWide, bool kStrided>
int& max_cluster() {
  static int n = 0;
  return n;
}

template <typename T, int D, int GP, bool kPart, bool kWide, bool kStrided>
int setup_one() {
  using S = Shape<T, D, GP>;
  auto kernel = decode_kernel<T, D, GP, kPart, kWide, kStrided>;
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
  max_cluster<T, D, GP, kPart, kWide, kStrided>() = n > 0 ? kMaxCluster : kPortableCluster;
  return 0;
}

template <typename T, int D, int GP, bool kPart, bool kWide, bool kStrided>
int launch_cfg(const void* q, const void* k, const void* v, const void* valid, void* out,
               const Axes* ax, int B, int T_len, int H, int KV, int dh, int G, int passes,
               float scale, cudaStream_t stream) {
  using S = Shape<T, D, GP>;
  const int cap = max_cluster<T, D, GP, kPart, kWide, kStrided>();
  if (cap == 0) return static_cast<int>(cudaErrorInitializationError);  // setup() not run
  const int n_hg = (G + GP - 1) / GP;
  const int units = B * KV * n_hg * passes;
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
      &cfg, decode_kernel<T, D, GP, kPart, kWide, kStrided>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const uint8_t*>(valid),
      static_cast<T*>(out), ax[0], ax[1], ax[2], T_len, H, KV, dh, G, n_hg, scale_log2, passes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// heads per unit: the group itself up to 8, rounded up to a power of two
inline int group_pad(int G) { return G > 4 ? 8 : G > 2 ? 4 : G; }

template <typename T, int D, int GP>
int launch_gp(const void* q, const void* k, const void* v, const void* valid, void* out,
              const Axes* ax, bool strided, int B, int T_len, int H, int KV, int dh, int G,
              int passes, float scale, cudaStream_t s) {
#define DEC_CFG(PART, WIDE, STRIDED, P)                                                       \
  launch_cfg<T, D, GP, PART, WIDE, STRIDED>(q, k, v, valid, out, ax, B, T_len, H, KV, dh, G, \
                                            P, scale, s)
  if constexpr (D == kPassWidth) {
    if (passes > 1)
      return strided ? DEC_CFG(true, true, true, passes) : DEC_CFG(true, true, false, passes);
  }
  if (strided)  // a view: the body with dh at run time, at the caller's strides
    return DEC_CFG(true, false, true, 1);
  return dh == D ? DEC_CFG(false, false, false, 1) : DEC_CFG(true, false, false, 1);
#undef DEC_CFG
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* valid, void* out,
             const Axes* ax, bool strided, int B, int T_len, int H, int KV, int dh, int passes,
             float scale, cudaStream_t s) {
  const int G = H / KV;
#define DEC_GP_CASE(GP)                                                                    \
  return launch_gp<T, D, GP>(q, k, v, valid, out, ax, strided, B, T_len, H, KV, dh, G, passes, \
                             scale, s)
  switch (group_pad(G)) {
    case 1: DEC_GP_CASE(1);
    case 2: DEC_GP_CASE(2);
    case 4: DEC_GP_CASE(4);
    default: DEC_GP_CASE(8);
  }
#undef DEC_GP_CASE
}

// Whether the wrapper's plan fits the head dim: one pass at a width that
// holds dh (the switch below refuses one not instantiated), or passes of
// 256 that cover dh exactly. The wrapper's dispatch chooses the plan.
inline bool plan_fits(int dh, int width, int passes) {
  if (dh < 1 || passes < 1) return false;
  if (passes == 1) return dh <= width;
  return width == kPassWidth && (passes - 1) * kPassWidth < dh && dh <= passes * kPassWidth;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* valid, void* out,
           const long long* strides, int B, int T_len, int H, int KV, int dh, int width,
           int passes, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!plan_fits(dh, width, passes)) return static_cast<int>(cudaErrorInvalidValue);
  Axes ax[3];
  for (int i = 0; i < 3; ++i)
    ax[i] = Axes{strides[3 * i], (int)strides[3 * i + 1], (int)strides[3 * i + 2]};
  // views run an instantiation of their own, so a dense call runs the
  // addressing it always ran
  const bool strided = !is_dense(ax[0], B, 1, H, dh) || !is_dense(ax[1], B, T_len, KV, dh) ||
                       !is_dense(ax[2], B, T_len, KV, dh);
#define DEC_D_CASE(W, P) \
  return launch_d<T, W>(q, k, v, valid, out, ax, strided, B, T_len, H, KV, dh, P, scale, s)
  switch (width) {
    case 16: DEC_D_CASE(16, 1);
    case 32: DEC_D_CASE(32, 1);
    case 64: DEC_D_CASE(64, 1);
    case 128: DEC_D_CASE(128, 1);
    case 256: DEC_D_CASE(256, passes);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DEC_D_CASE
}

template <typename T, int D, bool kPart, bool kWide, bool kStrided>
int setup_p() {
  int err = setup_one<T, D, 1, kPart, kWide, kStrided>();
  if (err == 0) err = setup_one<T, D, 2, kPart, kWide, kStrided>();
  if (err == 0) err = setup_one<T, D, 4, kPart, kWide, kStrided>();
  if (err == 0) err = setup_one<T, D, 8, kPart, kWide, kStrided>();
  return err;
}

template <typename T, int D>
int setup_d() {
  int err = setup_p<T, D, false, false, false>();
  if (err == 0) err = setup_p<T, D, true, false, false>();
  return err != 0 ? err : setup_p<T, D, true, false, true>();   // views
}

template <typename T>
int setup_t() {
  int err = setup_d<T, 16>();
  if (err == 0) err = setup_d<T, 32>();
  if (err == 0) err = setup_d<T, 64>();
  if (err == 0) err = setup_d<T, 128>();
  if (err == 0) err = setup_d<T, 256>();
  // D > 256, in passes, dense and views
  if (err == 0) err = setup_p<T, kPassWidth, true, true, false>();
  if (err == 0) err = setup_p<T, kPassWidth, true, true, true>();
  return err;
}

}  // namespace

// Sets every instantiation's dynamic shared-memory limit and non-portable
// cluster size on the current device and finds the largest cluster it can
// place. Call once, outside any stream capture, before the first launch.
// Returns the CUDA error code (0 on success).
extern "C" int decode_attention_setup(void) {
  int err = setup_t<float>();
  if (err == 0) err = setup_t<__nv_bfloat16>();
  return err != 0 ? err : setup_t<__half>();
}

// Plain C entry points for ctypes. q (B, 1, H, D) and k/v (B, T, KV, D)
// are read at `strides`: 9 element strides, the batch, row and head axes of
// q, k and v in turn (the last axis unit-stride, every stride a multiple of
// 16 bytes), each 16-byte aligned; out (B, 1, H, D) is contiguous; valid
// (T,) one byte per slot, nonzero = attend; H % KV == 0; any D >= 1, at the
// wrapper's `width` and column `passes`: one pass at a width of 16, 32, 64,
// 128 or 256 that holds D, or ceil(D / 256) passes at width 256 (see the
// note at the top; a plan that does not fit D is refused); scores are
// scaled by `scale` (D^-0.5). Each is one launch on `stream` and returns
// the CUDA error code (0 on success).
extern "C" int decode_attention_f32(const void* q, const void* k, const void* v,
                                    const void* valid, void* out, const long long* strides,
                                    int B, int T, int H, int KV, int D, int width, int passes,
                                    float scale, void* stream) {
  return launch<float>(q, k, v, valid, out, strides, B, T, H, KV, D, width, passes, scale,
                       stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k, const void* v,
                                     const void* valid, void* out, const long long* strides,
                                     int B, int T, int H, int KV, int D, int width, int passes,
                                     float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, valid, out, strides, B, T, H, KV, D, width, passes,
                               scale, stream);
}

extern "C" int decode_attention_f16(const void* q, const void* k, const void* v,
                                    const void* valid, void* out, const long long* strides,
                                    int B, int T, int H, int KV, int D, int width, int passes,
                                    float scale, void* stream) {
  return launch<__half>(q, k, v, valid, out, strides, B, T, H, KV, D, width, passes, scale,
                        stream);
}
