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
// caller transposes and pads nothing. Each input is read through the
// caller's strides of its batch, row and head axes (Axes; the last axis
// unit-stride): a transpose, an unbind of a fused tensor or a column slice
// is read in place. The outputs are dense. Keys past T are left out of the sum
// (p = 0), as the plain version does. With a causal mask the kernel skips
// kv tiles that no row of the query tile can see: a row that sees some key
// lies past a skipped tile's keys (or, under a window, after them), so the
// tile's terms would have been cancelled exactly. A row that sees no key at
// all (a causal window with S > T: query positions from T + window - 1 on)
// is the uniform average over the T keys in the plain version (a softmax of
// T equal sentinels), so a query tile that holds such a row walks every kv
// tile: its other rows lose nothing, since a masked tile before a row's
// first visible key is cancelled by alpha = 0 and one after it adds p = 0.
//
// What bounds it on an H100: at gemma3-1b's prefill (B 4, S 1024, H 4,
// KV 1, D 256, causal) the work is ~8.6e9 flops over ~21 MB of bf16
// q/k/v/o, i.e. ~8.7 us at the 989 TFLOP/s bf16 tensor-core peak against
// ~6.3 us at 3.35 TB/s: operations, and only on the tensor cores.
//
// Three bodies, chosen by the wrapper's dispatch from the input type and
// the head widths:
//
// bf16 and fp16 at every other width (flash_tc_kernel): both products on
// the tensor cores with mma.sync.m16n8k16 (bf16 in, fp32 accumulate), fed
// by ldmatrix from shared memory that 16-byte cp.async fills.
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
// What holds this body back: per warp and kv tile, 80 ldmatrix.x4 (Q
// re-read at every k-step, K and V) feed 128 mma.sync, and the 252
// registers of D 256 leave 8 warps per SM to hide their latency; it ran
// near 13% of its roofline at the cells' shapes. It stays for the shapes
// the wgmma body is not instantiated at (below).
//
// bf16 and fp16 at the instantiated (q/k, v) widths (flash_tc_kernel_wgmma,
// the section after the backward's bodies; the wrapper's FWD_WGMMA_WIDTHS:
// 64, phi3-mini's 96, 128, MLA's 192 with v at 128): the Hopper body, one
// template over the 2-byte type and the two widths.
//   * What bounds it: operations. At phi3-mini's training shape (B 2,
//     S 4096, H 32, D 96, window 2047) a visible pair costs 4 D = 384
//     flops and one exp2, so the exponentials alone take ~2/3 of the
//     tensor cores' time (16 a cycle per SM against 2048 bf16 FMAs): the
//     softmax has to run under the products, not between them. At MLA's
//     (192, 128) a pair is 2 (192 + 128) flops, the products' share higher.
//     On an H100 the body reads 54-57% of its bound at MLA's calls and
//     28-32% at phi3-mini's D 96, where the exponentials hold it (the
//     mma.sync body: 12.5-14%).
//   * Both products on wgmma. S = Q K^T (m64n128k16) reads Q and K from
//     shared memory; P stays in registers as the A operand of O += P V,
//     whose B operand V is read MN-major through its descriptor (no
//     ldmatrix, no transpose). Q is read from shared memory by the
//     hardware at every k-step, in registers never.
//   * TMA and warp specialisation. A block is three warp groups: one
//     producer thread issues every copy (setmaxnreg gives its group's
//     registers to the consumers: 24 against 240), two consumer groups own
//     64 packed query rows each of one 128-row tile and share every K/V
//     tile. Q arrives once per tile; K and V in a ring of 2-4 stages (as
//     many as shared memory holds), full and empty mbarriers per stage.
//   * The widths as they are: each operand is stored in panels of 128-byte
//     rows (64 columns) when its width is a multiple of 64, else of 64-byte
//     rows (96 = 3 x 32 columns), swizzled over the row, so no zero column
//     is moved or multiplied: 96 is computed at 96 (not 128), and MLA's v
//     and o at 128 beside q and k at 192 (not both at 256: 1.6x fewer
//     operations than the mma.sync body's padded call).
//   * Overlap. At kv tile j a group issues S_j and then O += P_{j-1}
//     V_{j-1}, and runs tile j's softmax while the second product is in
//     flight; the two groups take turns to issue (named barriers 1 and 2),
//     so one's softmax runs under the other's products.
//   * Persistent and balanced: one block per SM walks items (batch, kv
//     head, 128-row query tile), dealt in a snake (odd rounds take the
//     blocks in reverse). The (batch, kv head) pairs go in groups, each
//     group query tile by query tile over its pairs, heaviest first under
//     a causal mask. A run of many rounds (decode-4k's and serve-8k's
//     prefill calls: ~120 rounds) takes groups of two pairs, so the items
//     at work at once share two heads' K and V in L2: one group of all
//     512 pairs at decode-4k's call streamed every item's window of K/V
//     (786 KB for ~1e8 flops) from device memory and took 11% longer
//     (serve-8k's call 35% longer). A short run (at most 16 rounds, as
//     MLA's B 1 call and phi3-mini's training call) takes all pairs in one
//     group, so the lightest tiles close the run: in groups of two, MLA's
//     B 1 call ended on heavy tiles and took 50% longer. Q of the next item
//     is loaded once the last product of this one has read Q. Tiles no row
//     sees are skipped as in the mma.sync body, and masks are evaluated on
//     the tiles that need them.
//   * GQA packing as above: a group's rows are G (64 / G) packed rows,
//     whole positions of the G heads (one TMA box over (position, head));
//     at G 7 a group takes 63 rows, its 64th a zero row.
//   * The same semantics: the base-2 fold, the -1e30 sentinel, rows that
//     see no key, the log-sum-exp, the caller's strides (the tensor maps
//     take them) and `scale`.
// Shapes that stay on mma.sync: head dims off the 16-column k-step (36,
// 200), widths not instantiated (80, 112, 256, ...: each instantiation
// adds build time; at 256 two stages of 128-key K and V tiles do not fit
// beside Q, and a 64-key variant is not built), D > 256 (column passes),
// and G > 64 (a group's 64 rows would not hold one position).
//
// Every body can also write the per-row log-sum-exp of the scaled scores,
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
//
// Head dims: the Pallas kernel's blocks span any D. The mma.sync and FMA
// bodies take one head dim D for q, k and v (the wrapper widens v, or q
// and k, with zero columns to the wider of two and slices o back); each is
// instantiated at widths 16, 32, 64, 128 and 256, and a call with head dim
// D <= 256 runs the smallest width W >= D (the wrapper's dispatch picks it
// and hands it over). It reads the caller's rows at their strides, fills
// the columns past D with zeros in shared memory (zero q and k columns
// leave the scores as they are, zero v columns give output columns that
// are never written), writes D columns and scales by the true
// D^-0.5; nothing is copied or padded in device memory. The bf16 body has
// two instantiations a width: D = W keeps every bound at
// compile time, as the power-of-two head dims always ran; D < W multiplies
// the zero columns too. (A version that took D at run time everywhere and
// skipped the zero k-steps by a runtime bound ran every head dim at about
// half speed on an H100.) A row of D % 8 != 0 lies off the 16-byte grid
// that cp.async needs, so the bf16 body reads such rows element by element
// (the fp32 body always does); the choice is made once per tile, outside
// the copy loops.
//
// Head dims above 256 run in column passes of 256 (kWide): pass c writes
// output columns [256 c, 256 c + 256) and recomputes the scores over the
// whole of D in k-steps of 256 columns (Q and K chunks reloaded per kv
// tile, zeros past D), so the q . k work is done ceil(D / 256) times. A
// single wider body does not fit: the bf16 warp's 16 x 256 fp32 O
// accumulator is already 128 registers a thread. Every pass sums the score
// chunks in the same order, so its m, l and log-sum-exp are the same bits;
// pass 0 writes the log-sum-exp. The passes are one launch (blockIdx.x =
// query tile * passes + pass).
//
// float16 runs the tensor-core body with f16 operands (mma.sync
// m16n8k16.f32.f16.f16, P rounded to f16), accumulating in fp32 as bf16
// does: one template over the 2-byte type.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF sentinel
constexpr int kBQ = 32;            // query rows per block
constexpr int kBK = 32;            // keys per kv tile (one per lane)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = kBQ / kWarps;  // query rows per warp

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
// input whose last axis is unit-stride: the caller's view, read in place.
// The 2-byte bodies' 16-byte loads need every stride a multiple of 8
// elements (the wrapper copies any other view).
struct Axes {
  long long b;  // may pass 2^31 elements
  int s, h;     // the wrapper checks these fit an int
  __host__ __device__ __forceinline__ size_t at(int bi, int si, int hi) const {
    return (size_t)((long long)bi * b + (long long)si * s + (long long)hi * h);
  }
};
// the inputs' strides as the wrapper hands them over: q, k, v, then (the
// backward) o and dO
struct InputAxes {
  Axes q, k, v, o, dout;
};
inline InputAxes read_axes(const long long* p, int n) {
  InputAxes a{};
  Axes* dst[5] = {&a.q, &a.k, &a.v, &a.o, &a.dout};
  for (int i = 0; i < n; ++i) *dst[i] = Axes{p[3 * i], (int)p[3 * i + 1], (int)p[3 * i + 2]};
  return a;
}
// whether strides `a` are those of a dense (B, rows, heads, dh) tensor (an
// axis of size 1 carries stride 0 from the wrapper: never used)
inline bool is_dense(const Axes& a, int B, int rows, int heads, int dh) {
  return (B == 1 || a.b == (long long)rows * heads * dh) &&
         (rows == 1 || a.s == (long long)heads * dh) && (heads == 1 || a.h == dh);
}

// the tile range [k_begin, k_end) of kv positions a query block of rows
// [qpos_lo, qpos_hi] must walk: under a causal mask the tiles past its last
// row and, with a window, before its first row's window; all of [0, T) if
// some row of the block sees no key (the note at the top)
__device__ __forceinline__ void kv_range(int qpos_lo, int qpos_hi, int T_len, int causal,
                                         int window, int tile, int& k_begin, int& k_end) {
  k_begin = 0;
  k_end = T_len;
  if (!causal || (window > 0 && (long long)qpos_hi >= (long long)T_len + window - 1)) return;
  k_end = min(T_len, qpos_hi + 1);
  if (window > 0) k_begin = (max(0, qpos_lo - window + 1) / tile) * tile;
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

// kWide: D = 256 and dh > 256, in column passes (the note at the top)
template <typename T, int D, bool kWide>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                 const InputAxes ax, int S, int T_len, int H, int KV, int dh, int causal,
                 int window, float scale, int passes) {
  constexpr int kCols = (D + 31) / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* q_s = smem;                    // [kBQ][D]
  float* kt_s = q_s + kBQ * D;          // [D][kBK + 1], K transposed
  float* v_s = kt_s + D * (kBK + 1);    // [kBK][D]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int pass = kWide ? blockIdx.x % passes : 0;
  const int q0 = (kWide ? blockIdx.x / passes : blockIdx.x) * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int c0 = pass * D;                   // the pass's first output column
  const int n_dc = kWide ? (dh + D - 1) / D : 1;  // column chunks of the scores

  // columns [dc D, dc D + D) of the block's Q rows, zeros past dh
  auto load_q = [&](int dc) {
    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int r = idx / D, d = idx % D + dc * D;
      const int s = q0 + r;
      q_s[idx] = s < S && d < dh ? to_f32(q[ax.q.at(b, s, h) + d]) : 0.0f;
    }
  };
  if (!kWide) load_q(0);

  int k_begin, k_end;
  kv_range(q0, min(S, q0 + kBQ) - 1, T_len, causal, window, kBK, k_begin, k_end);

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
    // scores of this warp's rows against key k0 + lane, chunk by chunk of
    // columns (one chunk unless kWide); V's columns of the pass with the last
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
    for (int dc = 0; dc < n_dc; ++dc) {
      __syncthreads();  // the previous tile or chunk is consumed (and Q is loaded)
      if (kWide) load_q(dc);
      for (int idx = tid; idx < kBK * D; idx += kThreads) {
        const int j = idx / D, d = idx % D;
        const int t = k0 + j;
        const bool kin = t < T_len && d + dc * D < dh;
        kt_s[d * (kBK + 1) + j] = kin ? to_f32(k[ax.k.at(b, t, kvh) + dc * D + d]) : 0.0f;
        if (dc == n_dc - 1) {
          const bool vin = t < T_len && d + c0 < dh;
          v_s[j * D + d] = vin ? to_f32(v[ax.v.at(b, t, kvh) + c0 + d]) : 0.0f;
        }
      }
      __syncthreads();
      // the chunk's columns: past dh all zero
      const int d_end = (min(D, dh - dc * D) + 3) & ~3;
#pragma unroll 2
      for (int d = 0; d < d_end; d += 4) {
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
    if (lse != nullptr && lane == 0 && pass == 0)
      lse[((size_t)b * H + h) * S + qpos] = m[r] + logf(denom);
    T* out_row = o + ((size_t)b * S + qpos) * H * dh + (size_t)h * dh + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (c0 + col < dh) out_row[col] = from_f32<T>(acc[r][c] / denom);
    }
  }
}

// Whether a wrapper's plan fits the head dim: one pass at a width that
// holds dh (the switch on the width refuses one not instantiated), or
// passes of 256 that cover dh exactly. The wrapper's dispatch chooses the
// plan; the launches below only refuse one that would read or write out
// of bounds.
inline bool plan_fits(int dh, int width, int passes) {
  if (dh < 1 || passes < 1) return false;
  if (passes == 1) return dh <= width;
  return width == kPassWidth && (passes - 1) * kPassWidth < dh && dh <= passes * kPassWidth;
}

template <typename T, int D, bool kWide>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse,
             const InputAxes& ax, int B, int S, int T_len, int H, int KV, int dh, int causal,
             int window, int passes, float scale, void* stream) {
  constexpr size_t smem = smem_bytes<D>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D, kWide>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((unsigned)(((long long)S + kBQ - 1) / kBQ * passes), H, B);
  flash_fwd_kernel<T, D, kWide><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, ax, S, T_len, H, KV, dh, causal, window, scale, passes);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 / fp16 body on the tensor cores -----------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcRows = 64;      // packed query rows per warp group, 16 per warp
constexpr int kTcGroupThreads = 128;
constexpr int kTcThreads = 2 * kTcGroupThreads;  // two groups: a tile and its mirror

template <int D>
struct TcShape {
  static constexpr int kKeys = D <= 128 ? 64 : 32;  // keys per kv tile
  static constexpr int kChunks = D / 8;             // 16-byte chunks per row
  static constexpr int kSwz = kChunks < 8 ? kChunks - 1 : 7;
  // per warp group: Q, then two stages of K and two of V, all 2-byte
  static constexpr size_t kGroupSmem = sizeof(bf16) * (kTcRows * D + 4 * kKeys * D);
};

// element offset of (row, 16-byte chunk) in a swizzled [rows][D] tile
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

// 16-byte chunk c (columns 8c .. 8c + 7) of a row of dh 2-byte elements
// into shared memory, zeros past dh and for a row that does not exist
// (!in). kVec (dh % 8 == 0): the row moves by cp.async; another dh has rows
// off the 16-byte grid, so its chunks are read element by element and
// stored whole. The callers pick kVec once per tile, outside their copy
// loops.
template <bool kVec, typename E>
__device__ __forceinline__ void load_chunk(E* dst, const E* row, int c, int dh, bool in) {
  if (kVec || !in || c * 8 >= dh) {
    cp_async16(dst, in ? row + c * 8 : row, in && c * 8 < dh);
    return;
  }
  const uint16_t* r16 = reinterpret_cast<const uint16_t*>(row);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c0 = c * 8 + 2 * i;
    const uint32_t lo = c0 < dh ? r16[c0] : 0u;
    const uint32_t hi = c0 + 1 < dh ? r16[c0 + 1] : 0u;
    w[i] = lo | (hi << 16);
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
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

// c (16 x 8 fp32) += a (16 x 16, row) . b (16 x 8, col), operands of type E
template <typename E>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  if constexpr (std::is_same<E, __half>::value)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
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

// two floats rounded to a pair of E (lo in the low half)
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<E, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// kPart: the tensors' head dim dh_arg is below the width D (rows read at
// stride dh_arg, columns past it zero-filled); otherwise dh = D at compile
// time and the body is the one the power-of-two head dims always ran.
// kWide (with kPart, D = 256): dh_arg > 256 in column passes, blockIdx.x =
// (query tile pair) * passes + pass. kStrided (with kPart): q, k and v are
// views read at the caller's strides (ax); otherwise they are dense and
// read as the body always read them.
template <typename E, int D, bool kPart, bool kWide, bool kStrided>
__global__ void __launch_bounds__(kTcThreads)
flash_tc_kernel(const E* __restrict__ q, const E* __restrict__ k,
                const E* __restrict__ v, E* __restrict__ o, float* __restrict__ lse,
                const InputAxes ax, int S, int T_len, int H, int KV, int dh_arg, int causal,
                int window, float scale_log2, int passes) {
  constexpr int kKeys = TcShape<D>::kKeys;
  constexpr int kChunks = TcShape<D>::kChunks;
  constexpr int kNB = kKeys / 8;  // score n-blocks of 8 keys
  constexpr int kDB = D / 8;      // output n-blocks of 8 columns
  const int dh = kPart ? dh_arg : D;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int group = threadIdx.x / kTcGroupThreads;
  E* q_s = reinterpret_cast<E*>(tc_smem + group * TcShape<D>::kGroupSmem);  // [kTcRows][D]
  E* k_s = q_s + kTcRows * D;    // [2][kKeys][D]
  E* v_s = k_s + 2 * kKeys * D;  // [2][kKeys][D]

  const int tid = threadIdx.x % kTcGroupThreads;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int G = H / KV;
  const int rows = S * G;  // packed rows of one (batch, kv head)
  const int pass = kWide ? blockIdx.x % passes : 0;
  const int bx = kWide ? blockIdx.x / passes : blockIdx.x;
  const int c0 = pass * D;                   // the pass's first output column
  const int n_dc = kWide ? (dh + D - 1) / D : 1;  // column chunks of the scores
  // Group 0 takes query tile n - 1 - x (the most kv tiles under a causal
  // mask), group 1 its mirror x, so every block carries about the same work.
  const int n_q = (rows + kTcRows - 1) / kTcRows;
  const int tile = group == 0 ? n_q - 1 - bx : bx;
  if (group == 1 && tile >= n_q - 1 - bx) return;  // odd n_q: no mirror
  const int p0 = tile * kTcRows;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  // element offset of packed row p (query position p / G, head kvh * G +
  // p % G) in a dense tensor (o; q unless kStrided) and in q at the
  // caller's strides
  auto dense_off = [&](int p) {
    return ((size_t)b * S + p / G) * H * dh + (size_t)(kvh * G + p % G) * dh;
  };
  auto q_off = [&](int p) -> size_t {
    if constexpr (kStrided)
      return (long long)b * ax.q.b + (long long)(p / G) * ax.q.s +
             (long long)(kvh * G + p % G) * ax.q.h;
    else
      return dense_off(p);
  };

  // columns [dc D, dc D + D) of the block's Q rows
  auto load_q = [&](int dc, auto vec) {
    for (int idx = tid; idx < kTcRows * kChunks; idx += kTcGroupThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const bool in = p0 + r < rows;
      load_chunk<decltype(vec)::value>(q_s + swz<D>(r, c),
                                       q + (in ? q_off(p0 + r) + dc * D : 0), c, dh - dc * D,
                                       in);
    }
  };
  if constexpr (!kWide) {
    if (dh % 8 == 0)
      load_q(0, std::true_type{});
    else
      load_q(0, std::false_type{});
  }

  int k_begin, k_end;
  kv_range(p0 / G, min(S - 1, (p0 + kTcRows - 1) / G), T_len, causal, window, kKeys, k_begin,
           k_end);
  const int n_tiles = (k_end - k_begin + kKeys - 1) / kKeys;

  // kv tile j into stage j & 1 (stage 0 if kWide): K columns [kc, kc + D)
  // and, with with_v, V columns [c0, c0 + D)
  auto load_kv_tile = [&](int j, int kc, bool with_v, auto vec) {
    constexpr bool kVec = decltype(vec)::value;
    const int k0 = k_begin + j * kKeys;
    E* ks = k_s + (kWide ? 0 : j & 1) * kKeys * D;
    E* vs = v_s + (kWide ? 0 : j & 1) * kKeys * D;
    for (int idx = tid; idx < kKeys * kChunks; idx += kTcGroupThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const bool in = k0 + r < T_len;
      if constexpr (kStrided) {  // key t at its batch and kv head's row + t * s
        const E* krow = in ? k + ax.k.at(b, k0 + r, kvh) + kc : k;
        load_chunk<kVec>(ks + swz<D>(r, c), krow, c, dh - kc, in);
        if (with_v) {
          const E* vrow = in ? v + ax.v.at(b, k0 + r, kvh) + c0 : v;
          load_chunk<kVec>(vs + swz<D>(r, c), vrow, c, dh - c0, in);
        }
      } else {  // dense k and v: one offset for both
        const size_t off = in ? ((size_t)b * T_len + k0 + r) * KV * dh + (size_t)kvh * dh : 0;
        load_chunk<kVec>(ks + swz<D>(r, c), k + off + (in ? kc : 0), c, dh - kc, in);
        if (with_v)
          load_chunk<kVec>(vs + swz<D>(r, c), v + off + (in ? c0 : 0), c, dh - c0, in);
      }
    }
  };
  auto load_kv = [&](int j, int kc, bool with_v) {
    if (dh % 8 == 0)
      load_kv_tile(j, kc, with_v, std::true_type{});
    else
      load_kv_tile(j, kc, with_v, std::false_type{});
  };
  if constexpr (!kWide) {
    load_kv(0, 0, true);
    cp_async_commit();  // Q and the first kv tile
  }

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
    float s[kNB][4];
    const E* vs;
    int k0;
    if constexpr (!kWide) {  // double-buffered: tile j + 1 in flight while j is multiplied
      if (j + 1 < n_tiles) {
        load_kv(j + 1, 0, true);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      group_sync(group);
      const E* ks = k_s + (j & 1) * kKeys * D;
      vs = v_s + (j & 1) * kKeys * D;
      k0 = k_begin + j * kKeys;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
      // S = Q . K^T for this warp's 16 rows
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4];
        ldsm_x4(qa, q_s + swz<D>(wrow0 + lane % 16, kk * 2 + lane / 16));
#pragma unroll
        for (int nb = 0; nb < kNB / 2; ++nb) {
          uint32_t kb[4];
          ldsm_x4(kb, ks + swz<D>(nb * 16 + lane % 8 + (lane / 16) * 8, kk * 2 + (lane / 8) % 2));
          mma16816<E>(s[2 * nb], qa, kb[0], kb[1]);
          mma16816<E>(s[2 * nb + 1], qa, kb[2], kb[3]);
        }
      }
    } else {  // chunk dc of Q and K (stage 0), the pass's V with the last
      vs = v_s;
      k0 = k_begin + j * kKeys;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = 0.0f;
      for (int dc = 0; dc < n_dc; ++dc) {
        group_sync(group);  // the last chunk's operands are consumed
        if (dh % 8 == 0)
          load_q(dc, std::true_type{});
        else
          load_q(dc, std::false_type{});
        load_kv(j, dc * D, dc == n_dc - 1);
        cp_async_commit();
        cp_async_wait<0>();
        group_sync(group);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qa[4];
          ldsm_x4(qa, q_s + swz<D>(wrow0 + lane % 16, kk * 2 + lane / 16));
#pragma unroll
          for (int nb = 0; nb < kNB / 2; ++nb) {
            uint32_t kb[4];
            ldsm_x4(kb,
                    k_s + swz<D>(nb * 16 + lane % 8 + (lane / 16) * 8, kk * 2 + (lane / 8) % 2));
            mma16816<E>(s[2 * nb], qa, kb[0], kb[1]);
            mma16816<E>(s[2 * nb + 1], qa, kb[2], kb[3]);
          }
        }
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

    // O += P . V, P taken from the score fragment in E
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack2<E>(s[2 * kk][0], s[2 * kk][1]),
                              pack2<E>(s[2 * kk][2], s[2 * kk][3]),
                              pack2<E>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2<E>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int db = 0; db < kDB / 2; ++db) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs + swz<D>(kk * 16 + lane % 8 + ((lane / 8) % 2) * 8,
                                      db * 2 + lane / 16));
        mma16816<E>(acc[2 * db], pa, vb[0], vb[1]);
        mma16816<E>(acc[2 * db + 1], pa, vb[2], vb[3]);
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
    if (lse != nullptr && pass == 0 && lane % 4 == 0 && p < rows)
      lse[((size_t)b * H + kvh * G + p % G) * S + p / G] =
          (m[i] + log2f(fmaxf(l[i], 1e-30f))) * 0.6931471805599453f;
  }
  const int r0 = wrow0 + lane / 4;
#pragma unroll
  for (int db = 0; db < kDB; ++db) {
    *reinterpret_cast<uint32_t*>(q_s + swz<D>(r0, db) + kcol) =
        pack2<E>(acc[db][0] * inv[0], acc[db][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(q_s + swz<D>(r0 + 8, db) + kcol) =
        pack2<E>(acc[db][2] * inv[1], acc[db][3] * inv[1]);
  }
  __syncwarp();
  const int dv = min(D, dh - c0);  // the pass's output columns
  for (int idx = lane; idx < 16 * kChunks; idx += 32) {
    const int r = idx / kChunks, c = idx % kChunks;
    if (pw + r >= rows || c * 8 >= dv) continue;
    const E* src = q_s + swz<D>(wrow0 + r, c);
    E* dst = o + dense_off(pw + r) + c0 + c * 8;
    if (dh % 8 == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {  // rows off the 16-byte grid: the columns below dv one by one
      for (int i = 0; i < 8 && c * 8 + i < dv; ++i) dst[i] = src[i];
    }
  }
}

template <typename E, int D, bool kPart, bool kWide, bool kStrided>
int launch_tc_body(const void* q, const void* k, const void* v, void* o, float* lse,
                   const InputAxes& ax, int B, int S, int T_len, int H, int KV, int dh,
                   int causal, int window, int passes, float scale, void* stream) {
  constexpr size_t smem = 2 * TcShape<D>::kGroupSmem;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(flash_tc_kernel<E, D, kPart, kWide, kStrided>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const long long n_q = ((long long)S * (H / KV) + kTcRows - 1) / kTcRows;
  // a query tile and its mirror, in every pass
  const dim3 grid((unsigned)((n_q + 1) / 2 * passes), KV, B);
  // the scale and log2(e) in one multiply: exp(x * scale) = exp2(x * scale_log2)
  const float scale_log2 = 1.4426950408889634f * scale;
  flash_tc_kernel<E, D, kPart, kWide, kStrided>
      <<<grid, kTcThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
          static_cast<E*>(o), lse, ax, S, T_len, H, KV, dh, causal, window, scale_log2, passes);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, float* lse,
              const InputAxes& ax, bool strided, int B, int S, int T_len, int H, int KV, int dh,
              int causal, int window, float scale, void* stream) {
  if (strided)  // a view: the body with dh at run time, at the caller's strides
    return launch_tc_body<E, D, true, false, true>(q, k, v, o, lse, ax, B, S, T_len, H, KV, dh,
                                                   causal, window, 1, scale, stream);
  return dh == D ? launch_tc_body<E, D, false, false, false>(q, k, v, o, lse, ax, B, S, T_len, H,
                                                             KV, dh, causal, window, 1, scale,
                                                             stream)
                 : launch_tc_body<E, D, true, false, false>(q, k, v, o, lse, ax, B, S, T_len, H,
                                                            KV, dh, causal, window, 1, scale,
                                                            stream);
}

// The body is chosen by the input type (2-byte types on the tensor cores,
// fp32 on the FMA pipe; see the note at the top), the width and the column
// passes by the wrapper (plan_fits).
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const long long* strides, int B, int S, int T_len, int H, int KV, int dh, int causal,
           int window, int width, int passes, float scale, void* stream) {
  if (!plan_fits(dh, width, passes)) return static_cast<int>(cudaErrorInvalidValue);
  const InputAxes ax = read_axes(strides, 3);
  // the 2-byte body reads views in an instantiation of its own, so a
  // dense call runs the addressing it always ran (one that read strides
  // everywhere cost 7-12% at the serve shapes on an H100)
  const bool strided = !is_dense(ax.q, B, S, H, dh) || !is_dense(ax.k, B, T_len, KV, dh) ||
                       !is_dense(ax.v, B, T_len, KV, dh);
  if (passes > 1) {
    if constexpr (sizeof(T) == 2)
      return strided ? launch_tc_body<T, kPassWidth, true, true, true>(
                           q, k, v, o, lse, ax, B, S, T_len, H, KV, dh, causal, window, passes,
                           scale, stream)
                     : launch_tc_body<T, kPassWidth, true, true, false>(
                           q, k, v, o, lse, ax, B, S, T_len, H, KV, dh, causal, window, passes,
                           scale, stream);
    else
      return launch_d<T, kPassWidth, true>(q, k, v, o, lse, ax, B, S, T_len, H, KV, dh, causal,
                                           window, passes, scale, stream);
  }
#define FA_FWD_CASE(DIM)                                                                     \
  case DIM:                                                                                  \
    if constexpr (sizeof(T) == 2)                                                            \
      return launch_tc<T, DIM>(q, k, v, o, lse, ax, strided, B, S, T_len, H, KV, dh, causal, \
                               window, scale, stream);                                       \
    else                                                                                     \
      return launch_d<T, DIM, false>(q, k, v, o, lse, ax, B, S, T_len, H, KV, dh, causal,    \
                                     window, 1, scale, stream);
  switch (width) {
    FA_FWD_CASE(16)
    FA_FWD_CASE(32)
    FA_FWD_CASE(64)
    FA_FWD_CASE(128)
    FA_FWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_FWD_CASE
}

// ---- backward --------------------------------------------------------------
//
// The gradient of the forward above. The Pallas TPU kernel this file
// replaces, flash_attention_bhsd (src/repro/kernels/flash_attention/
// kernel.py:71, pallas_call at :89), has no backward of its own: the
// reference differentiates its plain oracle (ref.py::attention_ref) under
// jax.grad. This is that gradient, FA2 style, from the forward's saved
// per-row log-sum-exp (lse = m + log l, natural log, (B, H, S) fp32):
//   P  = exp(s * scale - lse)          rebuilt, never stored
//   dV = P^T dO                        summed over the G query heads of a kv head
//   dP = dO V^T
//   dS = P o (dP - delta),  delta = rowsum(dO o O)
//   dQ = dS K * scale,  dK = dS^T Q * scale
// The masks are the forward's: key position < T, kpos <= qpos if causal,
// kpos > qpos - window if a window is set, positions from 0. A masked pair
// gets P = 0: in a row that sees any key, the forward's p = exp(-1e30 - m)
// was exactly 0 there too. A row that sees no key (a window, query
// positions from T + window - 1 on) is the uniform average over the T keys
// in the forward; its scores are the constant sentinel, so it gives dQ and
// dK nothing (dS = 0) and adds dO / T to every key's dV (P = 1 / T): the
// gradient of the plain version, which the reference differentiates. Tiles
// that no pair of which is visible are skipped, except that a key tile
// takes the query tiles of such rows.
//
// What bounds it on an H100: operations. The function is five products
// over the visible (query, key) pairs, 10 D flops a pair and head: at
// gemma3-1b's training shape (B 4, S 1024, H 4, KV 1, D 256, causal)
// ~2.2e10 flops, ~22 us at 989 TFLOP/s bf16, against ~27 MB of bf16
// q/k/v/o/dO in and dq/dk/dv out (~8 us at 3.35 TB/s).
//
// bf16 and fp16 (bwd_wgmma_kernel, one template over the 2-byte type: wgmma
// .f16 and TMA FLOAT16 for fp16) run at width 128 or 256. A narrower head dim
// (96: phi3-mini; any D % 8 == 0) reads as zero columns past D, which the
// copies fill in shared memory (zero q and k columns leave the scores as
// they are, zero v and dO columns give gradient columns that are not
// written), so nothing is padded in device memory. TMA needs rows on the
// 16-byte grid: the wrapper pads a D % 8 != 0 to the next multiple of 8.
// Three launches:
//   1. bwd_prep_kernel: delta and lse * log2(e) into a scratch padded to
//      whole 64-row tiles (+inf and 0 past S, so a padded row weighs
//      nothing), which the TMA engine can copy.
//   2. bwd_wgmma_kernel: dK/dV items and dQ items in one persistent,
//      warp-specialised launch of three warp groups, one block per SM
//      (223,792 bytes of shared memory at D 256, alignment slack included).
//   3. dkv_reduce_kernel, when G > 1: the G heads' fp32 partial dK and dV
//      summed in head order, dK times the scale, to bf16.
// The design, against what bounds a plain mma.sync body with one warp group a
// block, products recomputed per accumulator and an unbalanced causal grid:
//   * Tensor cores the Hopper way. Every product is wgmma.mma_async
//     m64n64k16 (bf16 in, fp32 accumulate) on 128-byte-swizzled shared
//     memory. Tiles of 64 rows arrive by TMA (4-d tensor maps over the
//     model layout, one 64 x 64 box per 128-byte panel, zero-filled past S
//     and T) into a ring of stages guarded by mbarriers (full: the
//     producer's arrival and expected bytes; empty: 256 consumer
//     arrivals). One producer thread issues every copy; setmaxnreg moves
//     registers from its warp group (24) to the two consumer groups (240).
//     An MN-major B operand (dO, Q, K read along their rows) is read one
//     64-column panel per instruction, so its descriptor never spans
//     swizzle atoms. What bounds this shape: at D 256 the stages leave no
//     room for tiles wider than 64 rows, and a 64 x 64 product from shared
//     memory reads 4 KB in the 32 cycles the tensor cores take for it, the
//     shared memory's whole bandwidth.
//   * Each product once. In dK/dV, group 0 computes S^T = K Q^T, turns it
//     into P^T and accumulates dV += P^T dO; group 1 computes dP^T = V dO^T,
//     takes P^T in fp32 from group 0 through shared memory (named barriers
//     1 and 2), forms dS^T and accumulates dK += dS^T Q. P^T and dS^T stay
//     in registers as the bf16 A operand of their wgmma (the accumulator's
//     layout is the A fragment's). So at D 256 the two 64 x 256 fp32
//     accumulators (128 registers a thread each) live in two groups of one
//     block and nothing is computed twice. dQ is its own kind of item, as
//     in FA2 (7 products in all, no atomics), split the same way: group 0
//     S = Q K^T and P, group 1 dP = dO V^T and dS, whose bf16 A fragments
//     it also leaves in shared memory for group 0 (named barrier 3); each
//     group then accumulates half of dQ's columns with dS from registers.
//   * Fill and balance. A work item is one (batch, query head, 64-row
//     tile), so the G heads of a kv head run apart: 256 dK/dV items and 256
//     dQ items at the training shape, in one list on 132 blocks. Each kind
//     is ordered heaviest first (key tiles ascending; query tiles
//     descending under a causal mask), the two kinds alternate (their
//     weights match), and the list is dealt in a snake (odd rounds take the
//     blocks in reverse), so the block that drew a heavy item draws a light
//     one next. At the training shape the busiest block carries 34 partner
//     tiles against a mean of 33.0 (global) and 27 against 26.2 (window
//     512); two launches, one per kind, would carry 17 + 17 in both.
//   * The same bits every call. Each output element is written by one
//     thread of one item, the G partials are summed in head order, and
//     nothing uses atomics.
//   * No stall between items: the producer issues an item's first tiles
//     while the previous item's last ones are multiplied.
// What still holds it back: shared memory's bandwidth (above) and, with
// two stages, no room to issue a tile's scores before the last tile's
// accumulation is done, so each group waits for its own products before
// the exponentials; at G > 1 the fp32 partials make a round trip through
// device memory (2 x 16.8 MB at the training shape); dQ recomputes S and
// dP; head dims below 128 run at width 128.
//
// Head dims above 256 in bf16 and fp16 run the same three launches, the
// middle one the wgmma body's wide instantiation (kWide) in column passes
// of 256: a 64 x D tile of four tensors no longer fits shared memory, and
// a 64 x D fp32 accumulator no longer fits a group's registers. The design
// note of that body is at bwd_wide below. fp32 runs the FMA bodies at
// every D (column passes of 256 past it, kWide, as the forward's).
//
// fp32 (dkv_f32_kernel, dq_f32_kernel, after delta_kernel): fp32 FMAs
// outside the tensor cores, which keeps the fp32 tolerance, laid out as
// the forward's fp32 body: a lane owns one key (or query) column for the
// score-like products and output columns lane + 32 c for the
// accumulations, taking the other operand's values from its neighbours by
// shuffle. One block per (batch, kv head, 32 keys) for dK/dV, summing the
// G heads in a fixed order, and one per (batch, head, 32 queries) for dQ.

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
             const Axes o_ax, const Axes do_ax, int S, int H, int D, long long n_rows) {
  const long long row = (long long)blockIdx.x * kDeltaWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  // row = (b * S + s) * H + h  ->  delta[(b * H + h) * S + s]
  const int h = (int)(row % H);
  const long long bs = row / H;
  const int b = (int)(bs / S), s = (int)(bs % S);
  const T* o_row = o + o_ax.at(b, s, h);
  const T* d_row = dout + do_ax.at(b, s, h);
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f32(o_row[d]), to_f32(d_row[d]), acc);
  acc = warp_sum(acc);
  if (lane == 0) delta[((long long)b * H + h) * S + s] = acc;
}

// the first query position that sees no key (a window reaches no further
// back than T - 1 from there on), or past every row when there is none
__host__ __device__ __forceinline__ int first_nokey_row(int S, int T_len, int window) {
  const long long first = (long long)T_len + window - 1;
  return window > 0 && first < S ? (int)first : S;
}

// ---- fp32-math bodies on the FMA pipe (kBQ, kBK, kThreads, kRows as the forward's)

template <int D>
constexpr size_t bwd_f32_smem_bytes() {
  return sizeof(float) * (2 * 32 * D + 2 * D * 33);
}

// dQ for 32 query rows of one (batch, head): smem q, dO rows [32][D], K and
// V transposed [D][33]. Lane = key column for S and dP, output columns
// lane + 32 c for dQ += dS K. kWide: D = 256, dh > 256 in column passes
// (blockIdx.x = query tile * passes + pass); Q, dO, K and V come chunk by
// chunk of 256 columns for S and dP, then K's columns of the pass. A row
// that sees no key gets dQ = 0 (its dS is 0).
template <typename E, int D, bool kWide>
__global__ void __launch_bounds__(kThreads)
dq_f32_kernel(const E* __restrict__ q, const E* __restrict__ k,
              const E* __restrict__ v, const E* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              E* __restrict__ dq, const InputAxes ax, int S, int T_len, int H, int KV, int dh,
              int causal, int window, float scale, int passes) {
  constexpr int kCols = (D + 31) / 32;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [kBQ][D]
  float* do_s = q_s + kBQ * D;         // [kBQ][D]
  float* kt_s = do_s + kBQ * D;        // [D][kBK + 1]
  float* vt_s = kt_s + D * (kBK + 1);  // [D][kBK + 1]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pass = kWide ? blockIdx.x % passes : 0;
  const int q0 = (kWide ? blockIdx.x / passes : blockIdx.x) * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int c0 = pass * D;
  const int n_dc = kWide ? (dh + D - 1) / D : 1;

  auto load_rows = [&](int dc) {  // Q and dO, columns [dc D, dc D + D)
    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int r = idx / D, d = idx % D + dc * D, s = q0 + r;
      const bool in = s < S && d < dh;
      q_s[idx] = in ? to_f32(q[ax.q.at(b, s, h) + d]) : 0.0f;
      do_s[idx] = in ? to_f32(dout[ax.dout.at(b, s, h) + d]) : 0.0f;
    }
  };
  auto load_kv = [&](int k0, int col0, bool with_v) {  // K (and V) transposed
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D, t = k0 + j;
      const bool in = t < T_len && d + col0 < dh;
      kt_s[d * (kBK + 1) + j] = in ? to_f32(k[ax.k.at(b, t, kvh) + col0 + d]) : 0.0f;
      if (with_v)
        vt_s[d * (kBK + 1) + j] = in ? to_f32(v[ax.v.at(b, t, kvh) + col0 + d]) : 0.0f;
    }
  };
  if (!kWide) load_rows(0);
  float lse_r[kRows], dl_r[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + warp * kRows + r;
    const size_t off = ((size_t)b * H + h) * S + qpos;
    lse_r[r] = qpos < S ? lse[off] : 0.0f;
    dl_r[r] = qpos < S ? delta[off] : 0.0f;
  }

  // the tiles the rows see (a row that sees no key needs none)
  int k_begin = 0, k_end = T_len;
  if (causal) {
    k_end = min(T_len, min(S, q0 + kBQ));
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
    float s[kRows], dp[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.0f;
    for (int dc = 0; dc < n_dc; ++dc) {
      __syncthreads();  // the previous tile is consumed (and Q, dO are loaded)
      if (kWide) load_rows(dc);
      load_kv(k0, dc * D, true);
      __syncthreads();
      const int d_end = (min(D, dh - dc * D) + 3) & ~3;  // past dh all zero
#pragma unroll 2
      for (int d = 0; d < d_end; d += 4) {
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
    }
    if (kWide) {  // K's columns of the pass
      __syncthreads();
      load_kv(k0, c0, false);
      __syncthreads();
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
    E* out = dq + ((size_t)b * S + qpos) * H * dh + (size_t)h * dh + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (c0 + col < dh) out[col] = from_f32<E>(acc[r][c] * scale);
    }
  }
}

// dK and dV for 32 keys of one (batch, kv head): smem K, V rows [32][D], Q
// and dO transposed [D][33]. Lane = query column for S^T and dP^T, output
// columns lane + 32 c for dV += P^T dO and dK += dS^T Q. Loops over the G
// heads of the kv head, then the query tiles that see the keys, and the
// tiles of rows that see no key (P = 1 / T, dS = 0). kWide as dq's.
template <typename E, int D, bool kWide>
__global__ void __launch_bounds__(kThreads)
dkv_f32_kernel(const E* __restrict__ q, const E* __restrict__ k,
               const E* __restrict__ v, const E* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               E* __restrict__ dk, E* __restrict__ dv, const InputAxes ax, int S, int T_len,
               int H, int KV, int dh, int causal, int window, float scale, int passes) {
  constexpr int kCols = (D + 31) / 32;
  extern __shared__ float smem[];
  float* k_s = smem;                    // [kBK][D]
  float* v_s = k_s + kBK * D;           // [kBK][D]
  float* qt_s = v_s + kBK * D;          // [D][kBQ + 1]
  float* dot_s = qt_s + D * (kBQ + 1);  // [D][kBQ + 1]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pass = kWide ? blockIdx.x % passes : 0;
  const int k0 = (kWide ? blockIdx.x / passes : blockIdx.x) * kBK;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  const int c0 = pass * D;
  const int n_dc = kWide ? (dh + D - 1) / D : 1;
  const int nokey = first_nokey_row(S, T_len, window);
  const float inv_t = 1.0f / (float)T_len;

  auto load_keys = [&](int dc) {  // K and V rows, columns [dc D, dc D + D)
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D + dc * D, t = k0 + j;
      const bool in = t < T_len && d < dh;
      k_s[idx] = in ? to_f32(k[ax.k.at(b, t, kvh) + d]) : 0.0f;
      v_s[idx] = in ? to_f32(v[ax.v.at(b, t, kvh) + d]) : 0.0f;
    }
  };
  auto load_rows = [&](int h, int qt0, int col0) {  // Q and dO transposed
    for (int idx = tid; idx < kBQ * D; idx += kThreads) {
      const int i = idx / D, d = idx % D, s = qt0 + i;
      const bool in = s < S && d + col0 < dh;
      qt_s[d * (kBQ + 1) + i] = in ? to_f32(q[ax.q.at(b, s, h) + col0 + d]) : 0.0f;
      dot_s[d * (kBQ + 1) + i] = in ? to_f32(dout[ax.dout.at(b, s, h) + col0 + d]) : 0.0f;
    }
  };
  if (!kWide) load_keys(0);
  // query positions that can see a key of [k0, k0 + kBK), then those that
  // see no key at all
  const int k_last = min(T_len, k0 + kBK) - 1;
  int q_begin = 0, q_end = S;
  if (causal) q_begin = (min(k0, S) / kBQ) * kBQ;
  if (window > 0) q_end = nokey < S ? S : min(S, k_last + window);

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
      const int qpos = qt0 + lane;
      const size_t roff = ((size_t)b * H + h) * S + qpos;
      const float lse_q = qpos < S ? lse[roff] : 0.0f;
      const float dl_q = qpos < S ? delta[roff] : 0.0f;

      float s[kRows], dp[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = dp[r] = 0.0f;
      for (int dc = 0; dc < n_dc; ++dc) {
        __syncthreads();  // the previous tile is consumed (and K, V are loaded)
        if (kWide) load_keys(dc);
        load_rows(h, qt0, dc * D);
        __syncthreads();
        const int d_end = (min(D, dh - dc * D) + 3) & ~3;  // past dh all zero
#pragma unroll 2
        for (int d = 0; d < d_end; d += 4) {
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
      }
      if (kWide) {  // Q's and dO's columns of the pass
        __syncthreads();
        load_rows(h, qt0, c0);
        __syncthreads();
      }
      float p[kRows], ds[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int kpos = k0 + warp * kRows + r;
        const bool vis = qpos < S && visible(qpos, kpos, T_len, causal, window);
        p[r] = vis ? expf(s[r] * scale - lse_q) : 0.0f;
        ds[r] = p[r] * (dp[r] - dl_q);
        if (qpos >= nokey && qpos < S && kpos < T_len) p[r] = inv_t;  // a row that sees no key
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
    const size_t off = ((size_t)b * T_len + kpos) * KV * dh + (size_t)kvh * dh + c0;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (c0 + col < dh) {
        dk[off + col] = from_f32<E>(acc_k[r][c] * scale);
        dv[off + col] = from_f32<E>(acc_v[r][c]);
      }
    }
  }
}
// ---- bf16 bodies: wgmma on TMA-fed, warp-specialised persistent blocks ------
constexpr int kBwdRows = 64;                 // rows of every tile: keys or queries
constexpr int kBwdThreads = 384;             // consumer groups 0 and 1, producer group 2
constexpr int kPanelBytes = kBwdRows * 128;  // 64 rows of one 128-byte swizzle panel

template <int D>
struct BwdLayout {  // byte offsets into the (1024-aligned) dynamic shared memory
  static constexpr int kPanels = D / 64;                 // 64-column panels of a row
  static constexpr int kTile = kPanels * kPanelBytes;    // a 64 x D bf16 tile
  static constexpr int kStages = D == 256 ? 2 : 4;
  static constexpr int kStat = 2 * kBwdRows * 4;         // lse2, then delta, of 64 rows
  static constexpr int kPbuf = kBwdRows * kBwdRows * 4;  // fp32 P, [register][thread]
  // the item's two tiles (dK/dV: K, V; dQ: Q, dO), at 0; the stages of the
  // streamed pairs (dK/dV: Q, dO; dQ: K, V); P; dS as bf16 A fragments
  // ([register][thread], 8 KB); the dQ item's stats; each stage's stats
  // (dK/dV); barriers
  static constexpr int kStage0 = 2 * kTile;
  static constexpr int kP = kStage0 + kStages * 2 * kTile;
  static constexpr int kDs = kP + kPbuf;
  static constexpr int kItemStat = kDs + kPanelBytes;
  static constexpr int kStageStat = kItemStat + kStat;
  static constexpr int kBar = kStageStat + kStages * kStat;
  static constexpr int kBytes = kBar + 8 * (2 + 2 * kStages) + 1024;
  static_assert(kBytes <= 232448, "shared memory");
};

struct BwdArgs {
  const float* stats;  // [2][B H][S_pad]: lse * log2(e) (+inf past S), then delta (0 past S)
  void* dq;            // of the inputs' 2-byte type, as dk and dv
  void* dk;
  void* dv;
  float* part;  // G > 1: [2][B][H][T][dh] fp32 partial dK (unscaled), then dV; else null
  int B, S, T, H, KV, S_pad, causal, window;
  int dh;  // the tensors' head dim: D, or less (the tiles' columns past dh are zeros)
  float scale_log2, scale;
  int nokey;    // the first query row that sees no key (S: none)
  float inv_t;  // 1 / T: such a row's P on every key
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// -- mbarriers, TMA, named barriers
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}
// a 64-row x D tile of one head of a (B, rows, heads, D) tensor, one TMA
// box (64 x 64, 128-byte swizzled) per panel, completing on `bar`
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                         int head, int row0, int b) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst + p * kPanelBytes)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(p * 64), "r"(head),
        "r"(row0), "r"(b)
        : "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void named_sync(int id) {  // the two consumer groups
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// -- wgmma
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of a wgmma accumulator across the
// fence / wait that bracket the asynchronous product
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// descriptor of a swizzled operand: start address, leading and stride byte
// offsets (in 16-byte units), layout type 1 for rows swizzled over 128
// bytes (every operand of the backward), 2 and 3 over 64 and 32 (the
// forward's widths that are not multiples of 64)
template <int kRowBytes = 128>
__device__ __forceinline__ uint64_t swz_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (kLayout << 62);
}
// K-major: k-step kk (16 elements) of a 64-row tile whose rows run along the
// contraction dimension, in panels of 64 columns: 8-row groups 1024 B apart
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return swz_desc(tile + (kk >> 2) * kPanelBytes + (kk & 3) * 32, 0, 1024);
}
// MN-major: k-step kk (16 rows) of one 64-column panel whose rows are the
// contraction dimension. One panel is exactly one swizzle atom wide, so
// the product's N is 64 and both offsets are the 8-row stride.
__device__ __forceinline__ uint64_t desc_mn(uint32_t panel, int kk) {
  return swz_desc(panel + kk * 2048, 1024, 1024);
}

// The 32 accumulator registers of a m64n64 wgmma, as asm operands 0-31
#define WG_ACC                                                                               \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),             \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),          \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),          \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define WG_REGS                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "

// d (64 x 64 fp32) = A . B (+ d if accumulate), A and B (of type E) read
// K-major from shared memory through their descriptors
template <typename E>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (std::is_same<E, __half>::value)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WG_REGS
                 "%32, %33, p, 1, 1, 0, 0;\n}\n"
                 : WG_ACC
                 : "l"(da), "l"(db), "r"(accumulate));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS
                 "%32, %33, p, 1, 1, 0, 0;\n}\n"
                 : WG_ACC
                 : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) = A . B (+ d if accumulate), A (64 x 16 of E) from
// registers in the mma.m16n8k16 fragment layout (warp w holds rows 16 w ..
// 16 w + 15), B read MN-major from shared memory
template <typename E>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  if constexpr (std::is_same<E, __half>::value)
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " WG_REGS
                 "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : WG_ACC
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  else
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS
                 "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
                 : WG_ACC
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
#undef WG_ACC
#undef WG_REGS

// The accumulator of a 64 x 64 product holds, in thread (warp w, lane l),
// rows 16 w + l / 4 + 8 i and columns 8 j + 2 (l % 4) + e at register
// 4 j + 2 i + e: the A fragment layout, so it feeds the next product as
// E registers (k-step kk: columns 16 kk .. 16 kk + 15).
template <typename E>
__device__ __forceinline__ void to_a_frags(const float (&x)[32], uint32_t (&af)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    af[kk][0] = pack2<E>(x[8 * kk + 0], x[8 * kk + 1]);
    af[kk][1] = pack2<E>(x[8 * kk + 2], x[8 * kk + 3]);
    af[kk][2] = pack2<E>(x[8 * kk + 4], x[8 * kk + 5]);
    af[kk][3] = pack2<E>(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// -- work items: (batch, query head, 64-row tile), heaviest first
struct BwdItem {
  int dq;           // 0: dK, dV of 64 keys; 1: dQ of 64 query rows
  int b, h, row0;   // the item's (batch, query head) and first row
  int begin;        // the first row of its partner tiles
  int n_tiles;      // its partner tiles: query tiles (dK/dV) or key tiles (dQ)
};

// dK/dV item u: key tile u / (B H), ascending (under a causal mask a tile
// is seen by no fewer query tiles than the next), and the query tiles
// that see its keys, then those of rows that see no key
__device__ __forceinline__ BwdItem dkv_item(int u, const BwdArgs& a) {
  const int bh = u % (a.B * a.H);
  BwdItem it;
  it.dq = 0;
  it.b = bh / a.H;
  it.h = bh % a.H;
  it.row0 = (u / (a.B * a.H)) * kBwdRows;
  const int k_last = min(a.T, it.row0 + kBwdRows) - 1;
  it.begin = a.causal ? (min(it.row0, a.S) / kBwdRows) * kBwdRows : 0;
  const int q_end = a.window > 0 && a.nokey >= a.S ? min(a.S, k_last + a.window) : a.S;
  it.n_tiles = q_end > it.begin ? (q_end - it.begin + kBwdRows - 1) / kBwdRows : 0;
  return it;
}

// dQ item u: query tile (descending under a causal mask: the last tile sees
// the most keys) and the key tiles its rows see
__device__ __forceinline__ BwdItem dq_item(int u, const BwdArgs& a) {
  const int bh = u % (a.B * a.H);
  const int n_q = (a.S + kBwdRows - 1) / kBwdRows;
  const int i = u / (a.B * a.H);
  BwdItem it;
  it.dq = 1;
  it.b = bh / a.H;
  it.h = bh % a.H;
  it.row0 = (a.causal ? n_q - 1 - i : i) * kBwdRows;
  const int q_hi = min(a.S, it.row0 + kBwdRows) - 1;
  const int k_end = a.causal ? min(a.T, q_hi + 1) : a.T;
  it.begin = a.window > 0 ? (max(0, it.row0 - a.window + 1) / kBwdRows) * kBwdRows : 0;
  it.n_tiles = k_end > it.begin ? (k_end - it.begin + kBwdRows - 1) / kBwdRows : 0;
  return it;
}

// item c of one list: the u-th dK/dV and the u-th dQ item alternate (the
// two lists are each heaviest first, and their weights match: key tile j
// and query tile n - 1 - j see as many partner tiles under a causal mask),
// then the rest of the longer list
__device__ __forceinline__ BwdItem bwd_item(int c, int n_kv, int n_q, const BwdArgs& a) {
  const int m = min(n_kv, n_q);
  if (c < 2 * m) return (c & 1) ? dq_item(c >> 1, a) : dkv_item(c >> 1, a);
  return n_kv > n_q ? dkv_item(c - m, a) : dq_item(c - m, a);
}

// round r of the snake: blocks in order when r is even, in reverse when odd,
// so a block that drew a heavy item draws a light one next
__device__ __forceinline__ int snake_item(int r) {
  const int g = (int)gridDim.x, x = (int)blockIdx.x;
  return r * g + ((r & 1) ? g - 1 - x : x);
}

// may some pair of query tile q0 and key tile k0 be masked (causal diagonal
// or the window's lower edge)? Pairs past S or T need no mask: their
// rows are zero-filled and their lse is +inf.
__device__ __forceinline__ bool tile_needs_mask(int q0, int k0, const BwdArgs& a) {
  return (a.causal && q0 < k0 + kBwdRows - 1) ||
         (a.window > 0 && q0 + kBwdRows - 1 - k0 >= a.window);
}

// 1. delta = rowsum(dO o O) and lse * log2(e), rows padded to whole tiles:
// one warp a row, 16-byte loads
template <typename E>
__global__ void __launch_bounds__(32 * kDeltaWarps)
bwd_prep_kernel(const E* __restrict__ o, const E* __restrict__ dout,
                const float* __restrict__ lse, float* __restrict__ stats, const Axes o_ax,
                const Axes do_ax, int S, int H, int dh, int S_pad, long long n_rows) {
  const long long row = (long long)blockIdx.x * kDeltaWarps + threadIdx.x / 32;  // (b h, s)
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const long long bh = row / S_pad;
  const int s = (int)(row % S_pad);
  float l2 = __int_as_float(0x7f800000), dl = 0.0f;  // +inf: a padded row weighs nothing
  if (s < S) {
    const int b = (int)(bh / H), h = (int)(bh % H);
    const E* o_row = o + o_ax.at(b, s, h);
    const E* d_row = dout + do_ax.at(b, s, h);
    float acc = 0.0f;
    for (int d = lane * 8; d < dh; d += 256) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o_row + d);
      const uint4 gv = *reinterpret_cast<const uint4*>(d_row + d);
      const E* op = reinterpret_cast<const E*>(&ov);
      const E* gp = reinterpret_cast<const E*>(&gv);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = fmaf(to_f32(op[e]), to_f32(gp[e]), acc);
    }
    dl = warp_sum(acc);
    l2 = lse[bh * S + s] * kLog2e;
  }
  if (lane == 0) {
    stats[row] = l2;
    stats[n_rows + row] = dl;
  }
}

// The shared memory and barriers of one block. Barrier pair 0 guards the
// item's two tiles, pair 1 + s stage s; in each pair the first is "full"
// (the producer's arrival and its bytes), the second "empty" (256
// consumer arrivals).
template <int D>
struct BwdSmem {
  using L = BwdLayout<D>;
  unsigned char* sm;
  __device__ __forceinline__ explicit BwdSmem(unsigned char* base) : sm(base) {}
  __device__ __forceinline__ uint64_t* bar(int i) const {
    return reinterpret_cast<uint64_t*>(sm + L::kBar) + i;
  }
  __device__ __forceinline__ uint64_t* item_full() const { return bar(0); }
  __device__ __forceinline__ uint64_t* item_empty() const { return bar(1); }
  __device__ __forceinline__ uint64_t* stage_full(int s) const { return bar(2 + 2 * s); }
  __device__ __forceinline__ uint64_t* stage_empty(int s) const { return bar(3 + 2 * s); }
  __device__ __forceinline__ unsigned char* stage(int s) const {  // its second tile at + kTile
    return sm + L::kStage0 + s * 2 * L::kTile;
  }
  __device__ __forceinline__ float* stage_stat(int s) const {
    return reinterpret_cast<float*>(sm + L::kStageStat + s * L::kStat);
  }
  __device__ __forceinline__ float* item_stat() const {
    return reinterpret_cast<float*>(sm + L::kItemStat);
  }
  __device__ __forceinline__ float* pbuf() const { return reinterpret_cast<float*>(sm + L::kP); }
};

// The producer thread: for each item, its first streamed tiles (while the
// consumers finish the last item), then the item's own tiles once the last
// item has released them, then the rest of the stream.
template <int D>
__device__ __forceinline__ void bwd_produce(const BwdSmem<D>& m, const CUtensorMap* tm_q,
                                            const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                            const CUtensorMap* tm_do, const BwdArgs& a,
                                            int n_kv, int n_q) {
  using L = BwdLayout<D>;
  constexpr int NS = L::kStages;
  const int G = a.H / a.KV;
  const size_t n_stat = (size_t)a.B * a.H * a.S_pad;
  int sc = 0, ic = 0;  // stage and item uses so far
  for (int r = 0;; ++r) {
    const int c = snake_item(r);
    if (c >= n_kv + n_q) break;
    const BwdItem it = bwd_item(c, n_kv, n_q, a);
    if (it.n_tiles == 0) continue;
    const int kvh = it.h / G;
    auto load_stats = [&](float* dst, int row0, uint64_t* bar) {
      const float* src = a.stats + ((size_t)it.b * a.H + it.h) * a.S_pad + row0;
      bulk_copy(dst, src, 4 * kBwdRows, bar);
      bulk_copy(dst + kBwdRows, src + n_stat, 4 * kBwdRows, bar);
    };
    auto load_stage = [&](int t) {
      const int s = sc % NS;
      mbar_wait(m.stage_empty(s), ((sc / NS) & 1) ^ 1);
      const int r0 = it.begin + t * kBwdRows;
      if (it.dq) {  // K and V
        mbar_expect_tx(m.stage_full(s), 2 * L::kTile);
        tma_tile<D>(m.stage(s), tm_k, m.stage_full(s), kvh, r0, it.b);
        tma_tile<D>(m.stage(s) + L::kTile, tm_v, m.stage_full(s), kvh, r0, it.b);
      } else {  // Q, dO and their rows' stats
        mbar_expect_tx(m.stage_full(s), 2 * L::kTile + L::kStat);
        tma_tile<D>(m.stage(s), tm_q, m.stage_full(s), it.h, r0, it.b);
        tma_tile<D>(m.stage(s) + L::kTile, tm_do, m.stage_full(s), it.h, r0, it.b);
        load_stats(m.stage_stat(s), r0, m.stage_full(s));
      }
      ++sc;
    };
    const int first = min(NS, it.n_tiles);
    for (int t = 0; t < first; ++t) load_stage(t);
    mbar_wait(m.item_empty(), (ic & 1) ^ 1);
    if (it.dq) {  // Q, dO and their rows' stats
      mbar_expect_tx(m.item_full(), 2 * L::kTile + L::kStat);
      tma_tile<D>(m.sm, tm_q, m.item_full(), it.h, it.row0, it.b);
      tma_tile<D>(m.sm + L::kTile, tm_do, m.item_full(), it.h, it.row0, it.b);
      load_stats(m.item_stat(), it.row0, m.item_full());
    } else {  // K and V
      mbar_expect_tx(m.item_full(), 2 * L::kTile);
      tma_tile<D>(m.sm, tm_k, m.item_full(), kvh, it.row0, it.b);
      tma_tile<D>(m.sm + L::kTile, tm_v, m.item_full(), kvh, it.row0, it.b);
    }
    ++ic;
    for (int t = first; t < it.n_tiles; ++t) load_stage(t);
  }
}

// 2a. dK, dV of a 64-key item: group 0 owns S^T, P^T and dV, group 1 dP^T,
// dS^T and dK. kNoKey: some query rows see no key (P = 1 / T there, dS = 0);
// a separate instantiation, so the calls without such rows run the body
// they ran before
template <typename E, int D, bool kNoKey>
__device__ __forceinline__ void dkv_consume(const BwdSmem<D>& m, const BwdItem& it,
                                            const BwdArgs& a, int role, int tid, int& sc,
                                            int& ic) {
  using L = BwdLayout<D>;
  constexpr int NS = L::kStages;
  const int warp = tid / 32, lane = tid % 32;
  float* pbuf = m.pbuf();
  const uint32_t kv_s = smem_addr(m.sm + role * L::kTile);  // S^T reads K, dP^T reads V
  float acc[L::kPanels][32];
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  if (it.n_tiles > 0) {
    mbar_wait(m.item_full(), ic & 1);
    ++ic;
  }
  for (int t = 0; t < it.n_tiles; ++t) {
    const int s = sc % NS;
    mbar_wait(m.stage_full(s), (sc / NS) & 1);
    ++sc;
    const uint32_t q_s = smem_addr(m.stage(s));
    const uint32_t x_s = q_s + role * L::kTile;        // S^T = K Q^T, dP^T = V dO^T
    const uint32_t y_s = q_s + (1 - role) * L::kTile;  // dV += P^T dO, dK += dS^T Q
    float st[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<E>(st, desc_k(kv_s, kk), desc_k(x_s, kk), kk);
    wg_commit();
    wg_wait0();
    fence_acc(st);
    const int q0 = it.begin + t * kBwdRows;
    const float* sv = m.stage_stat(s) + role * kBwdRows;  // lse2 (group 0) or delta (group 1)
    if (role == 0) {  // P^T, shared with group 1 in fp32
      const bool need = tile_needs_mask(q0, it.row0, a);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(sv + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = it.row0 + 16 * warp + lane / 4 + 8 * i;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = st[4 * j + 2 * i + e];
            const float p = exp2f(x * a.scale_log2 - (e ? l2.y : l2.x));
            const int qpos = q0 + col + e;
            // a row that sees no key: 1 / T on every key
            const float off =
                kNoKey && qpos >= a.nokey && qpos < a.S && key < a.T ? a.inv_t : 0.0f;
            x = need && !visible(qpos, key, a.T, a.causal, a.window) ? off : p;
          }
        }
      }
      if (t > 0) named_sync(2);  // group 1 has read the last P^T
#pragma unroll
      for (int i = 0; i < 32; ++i) pbuf[i * 128 + tid] = st[i];
      named_arrive(1);
    } else {  // dS^T = P^T o (dP^T - delta)
      named_sync(1);
      float p[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pbuf[i * 128 + tid];
      named_arrive(2);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(sv + 8 * j + 2 * (lane % 4));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          st[4 * j + 2 * i] = p[4 * j + 2 * i] * (st[4 * j + 2 * i] - dl.x);
          st[4 * j + 2 * i + 1] = p[4 * j + 2 * i + 1] * (st[4 * j + 2 * i + 1] - dl.y);
        }
        if (kNoKey) {  // rows that see no key give dK nothing
          const int qpos = q0 + 8 * j + 2 * (lane % 4);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (qpos + e >= a.nokey) st[4 * j + 2 * i + e] = 0.0f;
        }
      }
    }
    uint32_t af[4][4];
    to_a_frags<E>(st, af);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
        wgmma_rs<E>(acc[p], af[kk], desc_mn(y_s + p * kPanelBytes, kk), 1);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) fence_acc(acc[p]);
    mbar_arrive(m.stage_empty(s));
  }
  if (it.n_tiles > 0) {
    mbar_arrive(m.item_empty());
    if (role == 0) named_sync(2);  // group 1's last read of P^T: P is free
  }
  // group 0 writes dV, group 1 dK (rows past T and columns past dh are not
  // written)
  const int kvh = it.h / (a.H / a.KV);
  const float mul = role == 1 && a.part == nullptr ? a.scale : 1.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = it.row0 + 16 * warp + lane / 4 + 8 * i;
    if (key >= a.T) continue;
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = p * 64 + 8 * j + 2 * (lane % 4);
        if (col >= a.dh) continue;
        const float x0 = acc[p][4 * j + 2 * i], x1 = acc[p][4 * j + 2 * i + 1];
        if (a.part != nullptr)
          *reinterpret_cast<float2*>(
              a.part + ((((size_t)(1 - role) * a.B + it.b) * a.H + it.h) * a.T + key) * a.dh +
              col) = make_float2(x0, x1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<E*>(role ? a.dk : a.dv) +
                                       (((size_t)it.b * a.T + key) * a.KV + kvh) * a.dh + col) =
              pack2<E>(x0 * mul, x1 * mul);
      }
  }
}

// 2b. dQ of a 64-row item: group 0 owns S and P, group 1 dP and dS; each
// accumulates half of dQ's columns
template <typename E, int D>
__device__ __forceinline__ void dq_consume(const BwdSmem<D>& m, const BwdItem& it,
                                           const BwdArgs& a, int role, int tid, int& sc,
                                           int& ic) {
  using L = BwdLayout<D>;
  constexpr int NS = L::kStages;
  constexpr int kHalf = L::kPanels / 2;  // dQ panels of one group
  const int warp = tid / 32, lane = tid % 32;
  float* pbuf = m.pbuf();
  uint32_t* dsf = reinterpret_cast<uint32_t*>(m.sm + L::kDs);  // dS fragments [register][thread]
  const uint32_t x_s = smem_addr(m.sm + role * L::kTile);  // S = Q K^T, dP = dO V^T
  uint32_t af[4][4];
  float acc[kHalf][32];
#pragma unroll
  for (int p = 0; p < kHalf; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  float rs[2] = {0.0f, 0.0f};  // this thread's rows' lse2 (group 0) or delta (group 1)
  if (it.n_tiles > 0) {
    mbar_wait(m.item_full(), ic & 1);
    ++ic;
    rs[0] = m.item_stat()[role * kBwdRows + 16 * warp + lane / 4];
    rs[1] = m.item_stat()[role * kBwdRows + 16 * warp + lane / 4 + 8];
  }
  for (int t = 0; t < it.n_tiles; ++t) {
    const int s = sc % NS;
    mbar_wait(m.stage_full(s), (sc / NS) & 1);
    ++sc;
    const uint32_t k_s = smem_addr(m.stage(s));
    float sc_[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<E>(sc_, desc_k(x_s, kk), desc_k(k_s + role * L::kTile, kk), kk);
    wg_commit();
    wg_wait0();
    fence_acc(sc_);
    const int t0 = it.begin + t * kBwdRows;
    if (role == 0) {  // P, shared with group 1 in fp32
      const bool need = tile_needs_mask(it.row0, t0, a);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qpos = it.row0 + 16 * warp + lane / 4 + 8 * i;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc_[4 * j + 2 * i + e];
            const float p = exp2f(x * a.scale_log2 - rs[i]);
            const int key = t0 + 8 * j + 2 * (lane % 4) + e;
            x = need && !visible(qpos, key, a.T, a.causal, a.window) ? 0.0f : p;
          }
        }
#pragma unroll
      for (int i = 0; i < 32; ++i) pbuf[i * 128 + tid] = sc_[i];
      named_arrive(1);
    } else {  // dS = P o (dP - delta), once, as the bf16 A operand of dS K
      named_sync(1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i;
          sc_[x] = pbuf[x * 128 + tid] * (sc_[x] - rs[i]);
          sc_[x + 1] = pbuf[(x + 1) * 128 + tid] * (sc_[x + 1] - rs[i]);
        }
      to_a_frags<E>(sc_, af);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsf[(kk * 4 + e) * 128 + tid] = af[kk][e];
    }
    named_sync(3);  // group 1 has read P and written dS
    if (role == 0) {  // group 1's fragments: the same rows as this thread's
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) af[kk][e] = dsf[(kk * 4 + e) * 128 + tid];
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < kHalf; ++p)
        wgmma_rs<E>(acc[p], af[kk], desc_mn(k_s + (role * kHalf + p) * kPanelBytes, kk), 1);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < kHalf; ++p) fence_acc(acc[p]);
    mbar_arrive(m.stage_empty(s));
  }
  if (it.n_tiles > 0) mbar_arrive(m.item_empty());
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = it.row0 + 16 * warp + lane / 4 + 8 * i;
    if (qpos >= a.S) continue;
    E* row = static_cast<E*>(a.dq) + (((size_t)it.b * a.S + qpos) * a.H + it.h) * a.dh;
#pragma unroll
    for (int p = 0; p < kHalf; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = role * (D / 2) + p * 64 + 8 * j + 2 * (lane % 4);
        if (col < a.dh)
          *reinterpret_cast<uint32_t*>(row + col) =
              pack2<E>(acc[p][4 * j + 2 * i] * a.scale, acc[p][4 * j + 2 * i + 1] * a.scale);
      }
  }
}

// ---- the wide body: bf16 / fp16 head dims above 256, in column passes ------
//
// The D <= 256 body keeps a dK/dV item's K and V (or a dQ item's Q and dO)
// whole in shared memory and streams its partner tiles whole: at D 512 two
// such 64 x D tiles are 128 KB, and a stage of two more another 128 KB, of
// the 227 KB a block has. Its consumer groups each hold a 64 x D fp32
// accumulator, 128 registers a thread at D 256. So past 256:
//   * Work items gain a pass c: (batch, query head, 64-row tile, pass), in
//     the same heaviest-first list (each unit's passes side by side, so the
//     snake deals them to neighbouring blocks) dealt the same way. Pass c
//     owns output columns [256 c, 256 c + 256): the groups' accumulators
//     stay 64 x 256 (dV, dK) and 64 x 128 (each half of dQ), as at D 256.
//   * Everything streams. For each partner tile, a pass walks the head dim
//     in k-steps of 128 columns; a stage holds one k-step's 64 x 128
//     pieces of Q, K, dO and V (the item's and the partner's rows), 16 KB
//     each, cut from the same tensor maps at a column offset (TMA fills
//     zeros past dh). Group 0 accumulates S (S^T) over the k-steps from the
//     Q and K pieces, group 1 dP (dP^T) from dO and V, as in the D <= 256
//     body, each freeing a stage as soon as its product is done.
//   * The pass's own k-steps come last (the walk starts after them and
//     wraps), so when P and dS are ready, the pieces the output product
//     reads are the ones still in the ring: dV_c += P^T dO_c (group 0) and
//     dK_c += dS^T Q_c (group 1), or each half of dQ_c += dS K_c. Those one
//     or two stages are freed after the output product; nothing is loaded
//     twice within a partner tile. The sums of S over the k-steps run in an
//     order that depends on the pass, so two passes' P may differ in the
//     last bit of fp32 (each column's gradient uses its own pass's P).
//   * Recompute, not store: each pass recomputes S and dP over all of dh.
//     At D 512 that is 12 products of 64 x 64 x 256 per dK/dV tile pair and
//     10 per dQ tile pair, against 4 and 3 at D 256. Storing P and dS
//     would move 4 bytes a visible pair and head through device memory.
// Shared memory (BwdWideLayout): 3 stages of 4 pieces (196,608 bytes), the
// fp32 P exchange (16,384), dS fragments (8,192), each stage's 64 rows of
// lse2 and delta (3 x 512), 6 barriers and the 1024-byte alignment slack:
// 223,792 bytes of 232,448. A fourth stage does not fit. The item's own
// pieces are streamed again for every partner tile (from L2: the same 32
// KB a k-step); at D 512 a tile pair's pass moves 256 KB through TMA.
constexpr int kStepCols = 128;              // columns of one wide k-step
constexpr int kPiece = 2 * kPanelBytes;     // 64 rows x 128 columns of one tensor
constexpr int kSlotQ = 0, kSlotK = 1, kSlotDo = 2, kSlotV = 3;  // a stage's pieces

struct BwdWideLayout {
  static constexpr int kStages = 3;
  static constexpr int kStage = 4 * kPiece;              // Q, K, dO, V pieces
  static constexpr int kStat = 2 * kBwdRows * 4;         // lse2, then delta, of 64 rows
  static constexpr int kPbuf = kBwdRows * kBwdRows * 4;  // fp32 P, [register][thread]
  static constexpr int kP = kStages * kStage;
  static constexpr int kDs = kP + kPbuf;                 // dS as A fragments, 8 KB
  static constexpr int kStageStat = kDs + kPanelBytes;
  static constexpr int kBar = kStageStat + kStages * kStat;
  static constexpr int kBytes = kBar + 8 * 2 * kStages + 1024;
  static_assert(kBytes <= 232448, "shared memory");
};

struct WideSmem {
  using L = BwdWideLayout;
  unsigned char* sm;
  __device__ __forceinline__ explicit WideSmem(unsigned char* base) : sm(base) {}
  __device__ __forceinline__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(sm + L::kBar) + 2 * s;
  }
  __device__ __forceinline__ uint64_t* empty(int s) const {
    return reinterpret_cast<uint64_t*>(sm + L::kBar) + 2 * s + 1;
  }
  __device__ __forceinline__ unsigned char* piece(int s, int slot) const {
    return sm + s * L::kStage + slot * kPiece;
  }
  __device__ __forceinline__ float* stat(int s) const {
    return reinterpret_cast<float*>(sm + L::kStageStat + s * L::kStat);
  }
  __device__ __forceinline__ float* pbuf() const { return reinterpret_cast<float*>(sm + L::kP); }
  __device__ __forceinline__ uint32_t* dsf() const {
    return reinterpret_cast<uint32_t*>(sm + L::kDs);
  }
};

// the k-steps of one pass: n over dh, of which the pass's own (columns
// [256 c, 256 c + 256) that lie below dh: 1 or 2) are walked last
struct WidePlan {
  int n, held, end;  // end: one past the pass's last k-step
};
__device__ __forceinline__ WidePlan wide_plan(int dh, int pass) {
  WidePlan w;
  w.n = (dh + kStepCols - 1) / kStepCols;
  w.end = min(2 * pass + 2, w.n);
  w.held = w.end - 2 * pass;
  return w;
}

// a 64-row x 128-column piece at column col0 of one head, two TMA boxes
__device__ __forceinline__ void tma_piece(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                          int col0, int head, int row0, int b) {
#pragma unroll
  for (int p = 0; p < 2; ++p)
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst + p * kPanelBytes)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(col0 + p * 64), "r"(head),
        "r"(row0), "r"(b)
        : "memory");
}

__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// The producer thread: for each item and partner tile, the pass's k-steps
// in walking order, each stage with the query rows' stats
__device__ __forceinline__ void bwd_produce_wide(const WideSmem& m, const CUtensorMap* tm_q,
                                                 const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                                 const CUtensorMap* tm_do, const BwdArgs& a,
                                                 int n_kv, int n_q, int passes) {
  constexpr int NS = BwdWideLayout::kStages;
  const int G = a.H / a.KV;
  const size_t n_stat = (size_t)a.B * a.H * a.S_pad;
  int sc = 0;  // stage uses so far
  for (int r = 0;; ++r) {
    const int c = snake_item(r);
    if (c >= (n_kv + n_q) * passes) break;
    const BwdItem it = bwd_item(c / passes, n_kv, n_q, a);
    const WidePlan w = wide_plan(a.dh, c % passes);
    const int kvh = it.h / G;
    for (int t = 0; t < it.n_tiles; ++t) {
      const int r0 = it.begin + t * kBwdRows;
      const int q0 = it.dq ? it.row0 : r0, k0 = it.dq ? r0 : it.row0;
      const float* st = a.stats + ((size_t)it.b * a.H + it.h) * a.S_pad + q0;
      for (int j = 0; j < w.n; ++j, ++sc) {
        const int s = sc % NS, col = ((w.end + j) % w.n) * kStepCols;
        mbar_wait(m.empty(s), ((sc / NS) & 1) ^ 1);
        mbar_expect_tx(m.full(s), BwdWideLayout::kStage + BwdWideLayout::kStat);
        tma_piece(m.piece(s, kSlotQ), tm_q, m.full(s), col, it.h, q0, it.b);
        tma_piece(m.piece(s, kSlotK), tm_k, m.full(s), col, kvh, k0, it.b);
        tma_piece(m.piece(s, kSlotDo), tm_do, m.full(s), col, it.h, q0, it.b);
        tma_piece(m.piece(s, kSlotV), tm_v, m.full(s), col, kvh, k0, it.b);
        bulk_copy(m.stat(s), st, 4 * kBwdRows, m.full(s));
        bulk_copy(m.stat(s) + kBwdRows, st + n_stat, 4 * kBwdRows, m.full(s));
      }
    }
  }
}

// x (64 x 64 fp32) = A B^T over every k-step of one partner tile, A and B
// the pieces in slots sa and sb of each stage; frees each stage but the
// pass's own as soon as its product is done. Returns the last stage.
template <typename E>
__device__ __forceinline__ int wide_scores(float (&x)[32], const WideSmem& m, const WidePlan& w,
                                           int sa, int sb, int sc) {
  constexpr int NS = BwdWideLayout::kStages;
  const int free_below = w.n - w.held;  // k-steps walked before the pass's own
  for (int j = 0; j < w.n; ++j) {
    const int s = (sc + j) % NS;
    mbar_wait(m.full(s), ((sc + j) / NS) & 1);
    const uint32_t pa = smem_addr(m.piece(s, sa)), pb = smem_addr(m.piece(s, sb));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kStepCols / 16; ++kk)
      wgmma_ss<E>(x, desc_k(pa, kk), desc_k(pb, kk), j > 0 || kk > 0);
    wg_commit();
    if (j > 0 && j <= free_below) {  // the last k-step's product is done
      wg_wait1();
      mbar_arrive(m.empty((sc + j - 1) % NS));
    }
  }
  wg_wait0();
  fence_acc(x);
  return (sc + w.n - 1) % NS;
}

// free the pass's own stages once the output product has read them
__device__ __forceinline__ void wide_release(const WideSmem& m, const WidePlan& w, int sc) {
  for (int i = 0; i < w.held; ++i)
    mbar_arrive(m.empty((sc + w.n - w.held + i) % BwdWideLayout::kStages));
}

// 2a'. dK, dV columns [256 c, 256 c + 256) of a 64-key item: the roles of
// dkv_consume, with S^T and dP^T summed over the k-steps. The pointwise
// step repeats dkv_consume's (and 2b' dq_consume's), so that the D <= 256
// instantiations keep their code as it was: a helper shared with them
// changed it (their D 256 time rose 4.5% in one H100 run).
template <typename E, bool kNoKey>
__device__ __forceinline__ void dkv_consume_wide(const WideSmem& m, const BwdItem& it, int pass,
                                                 const BwdArgs& a, int role, int tid, int& sc) {
  constexpr int NS = BwdWideLayout::kStages;
  const int warp = tid / 32, lane = tid % 32;
  const WidePlan w = wide_plan(a.dh, pass);
  float* pbuf = m.pbuf();
  float acc[4][32];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  for (int t = 0; t < it.n_tiles; ++t) {
    float st[32];
    // S^T = K Q^T (group 0), dP^T = V dO^T (group 1)
    const int last = wide_scores<E>(st, m, w, 2 * role + 1, 2 * role, sc);
    const int q0 = it.begin + t * kBwdRows;
    const float* sv = m.stat(last) + role * kBwdRows;  // lse2 (group 0) or delta (group 1)
    if (role == 0) {  // P^T, shared with group 1 in fp32
      const bool need = tile_needs_mask(q0, it.row0, a);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(sv + col);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int key = it.row0 + 16 * warp + lane / 4 + 8 * i;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = st[4 * j + 2 * i + e];
            const float p = exp2f(x * a.scale_log2 - (e ? l2.y : l2.x));
            const int qpos = q0 + col + e;
            // a row that sees no key: 1 / T on every key
            const float off =
                kNoKey && qpos >= a.nokey && qpos < a.S && key < a.T ? a.inv_t : 0.0f;
            x = need && !visible(qpos, key, a.T, a.causal, a.window) ? off : p;
          }
        }
      }
      if (t > 0) named_sync(2);  // group 1 has read the last P^T
#pragma unroll
      for (int i = 0; i < 32; ++i) pbuf[i * 128 + tid] = st[i];
      named_arrive(1);
    } else {  // dS^T = P^T o (dP^T - delta)
      named_sync(1);
      float p[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] = pbuf[i * 128 + tid];
      named_arrive(2);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(sv + 8 * j + 2 * (lane % 4));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          st[4 * j + 2 * i] = p[4 * j + 2 * i] * (st[4 * j + 2 * i] - dl.x);
          st[4 * j + 2 * i + 1] = p[4 * j + 2 * i + 1] * (st[4 * j + 2 * i + 1] - dl.y);
        }
        if (kNoKey) {  // rows that see no key give dK nothing
          const int qpos = q0 + 8 * j + 2 * (lane % 4);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (qpos + e >= a.nokey) st[4 * j + 2 * i + e] = 0.0f;
        }
      }
    }
    uint32_t af[4][4];
    to_a_frags<E>(st, af);
    // dV_c += P^T dO_c (group 0), dK_c += dS^T Q_c (group 1): the pass's
    // k-steps, still in the ring; a second one past dh is not there
    const int slot = role ? kSlotQ : kSlotDo;
    const uint32_t y0 = smem_addr(m.piece((sc + w.n - w.held) % NS, slot));
    const uint32_t y1 = smem_addr(m.piece((sc + w.n - 1) % NS, slot));
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < 4; ++p)
        if (p < 2 || w.held == 2)
          wgmma_rs<E>(acc[p], af[kk], desc_mn((p < 2 ? y0 : y1) + (p & 1) * kPanelBytes, kk), 1);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < 4; ++p) fence_acc(acc[p]);
    wide_release(m, w, sc);
    sc += w.n;
  }
  if (it.n_tiles > 0 && role == 0) named_sync(2);  // group 1's last read of P^T: P is free
  // group 0 writes dV, group 1 dK (rows past T and columns past dh are not
  // written)
  const int kvh = it.h / (a.H / a.KV);
  const float mul = role == 1 && a.part == nullptr ? a.scale : 1.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = it.row0 + 16 * warp + lane / 4 + 8 * i;
    if (key >= a.T) continue;
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = pass * kPassWidth + p * 64 + 8 * j + 2 * (lane % 4);
        if (col >= a.dh) continue;
        const float x0 = acc[p][4 * j + 2 * i], x1 = acc[p][4 * j + 2 * i + 1];
        if (a.part != nullptr)
          *reinterpret_cast<float2*>(
              a.part + ((((size_t)(1 - role) * a.B + it.b) * a.H + it.h) * a.T + key) * a.dh +
              col) = make_float2(x0, x1);
        else
          *reinterpret_cast<uint32_t*>(static_cast<E*>(role ? a.dk : a.dv) +
                                       (((size_t)it.b * a.T + key) * a.KV + kvh) * a.dh + col) =
              pack2<E>(x0 * mul, x1 * mul);
      }
  }
}

// 2b'. dQ columns [256 c, 256 c + 256) of a 64-row item: the roles of
// dq_consume, with S and dP summed over the k-steps; group r accumulates
// the pass's k-step r (128 columns)
template <typename E>
__device__ __forceinline__ void dq_consume_wide(const WideSmem& m, const BwdItem& it, int pass,
                                                const BwdArgs& a, int role, int tid, int& sc) {
  constexpr int NS = BwdWideLayout::kStages;
  const int warp = tid / 32, lane = tid % 32;
  const WidePlan w = wide_plan(a.dh, pass);
  float* pbuf = m.pbuf();
  uint32_t* dsf = m.dsf();
  uint32_t af[4][4];
  float acc[2][32];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.0f;
  for (int t = 0; t < it.n_tiles; ++t) {
    float sc_[32];
    // S = Q K^T (group 0), dP = dO V^T (group 1)
    const int last = wide_scores<E>(sc_, m, w, 2 * role, 2 * role + 1, sc);
    // this thread's rows' lse2 (group 0) or delta (group 1)
    const float* sv = m.stat(last) + role * kBwdRows + 16 * warp + lane / 4;
    const float rs[2] = {sv[0], sv[8]};
    const int t0 = it.begin + t * kBwdRows;
    if (role == 0) {  // P, shared with group 1 in fp32
      const bool need = tile_needs_mask(it.row0, t0, a);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int qpos = it.row0 + 16 * warp + lane / 4 + 8 * i;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = sc_[4 * j + 2 * i + e];
            const float p = exp2f(x * a.scale_log2 - rs[i]);
            const int key = t0 + 8 * j + 2 * (lane % 4) + e;
            x = need && !visible(qpos, key, a.T, a.causal, a.window) ? 0.0f : p;
          }
        }
#pragma unroll
      for (int i = 0; i < 32; ++i) pbuf[i * 128 + tid] = sc_[i];
      named_arrive(1);
    } else {  // dS = P o (dP - delta), once, as the A operand of dS K
      named_sync(1);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int x = 4 * j + 2 * i;
          sc_[x] = pbuf[x * 128 + tid] * (sc_[x] - rs[i]);
          sc_[x + 1] = pbuf[(x + 1) * 128 + tid] * (sc_[x + 1] - rs[i]);
        }
      to_a_frags<E>(sc_, af);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsf[(kk * 4 + e) * 128 + tid] = af[kk][e];
    }
    named_sync(3);  // group 1 has read P and written dS
    if (role == 0) {  // group 1's fragments: the same rows as this thread's
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) af[kk][e] = dsf[(kk * 4 + e) * 128 + tid];
    }
    // dQ_c += dS K_c: group r the pass's k-step r, when it lies below dh
    wg_fence();
    if (role < w.held) {
      const uint32_t k_s = smem_addr(m.piece((sc + w.n - w.held + role) % NS, kSlotK));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          wgmma_rs<E>(acc[p], af[kk], desc_mn(k_s + p * kPanelBytes, kk), 1);
    }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int p = 0; p < 2; ++p) fence_acc(acc[p]);
    wide_release(m, w, sc);
    sc += w.n;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = it.row0 + 16 * warp + lane / 4 + 8 * i;
    if (qpos >= a.S) continue;
    E* row = static_cast<E*>(a.dq) + (((size_t)it.b * a.S + qpos) * a.H + it.h) * a.dh;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = pass * kPassWidth + role * kStepCols + p * 64 + 8 * j + 2 * (lane % 4);
        if (col < a.dh)
          *reinterpret_cast<uint32_t*>(row + col) =
              pack2<E>(acc[p][4 * j + 2 * i] * a.scale, acc[p][4 * j + 2 * i + 1] * a.scale);
      }
  }
}

// 2'. the wide body of bwd_wgmma_kernel: dK/dV and dQ items of every pass
// in one persistent launch, one block per SM
template <typename E, bool kNoKey>
__device__ __forceinline__ void bwd_wide(unsigned char* base, const CUtensorMap* tm_q,
                                         const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                         const CUtensorMap* tm_do, const BwdArgs& a) {
  const WideSmem m(base);
  if (threadIdx.x == 0) {
    for (int s = 0; s < BwdWideLayout::kStages; ++s) {
      mbar_init(m.full(s), 1);
      mbar_init(m.empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int passes = (a.dh + kPassWidth - 1) / kPassWidth;
  const int n_kv = a.B * a.H * ((a.T + kBwdRows - 1) / kBwdRows);
  const int n_q = a.B * a.H * ((a.S + kBwdRows - 1) / kBwdRows);
  if (threadIdx.x >= 256) {  // producer group: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) bwd_produce_wide(m, tm_q, tm_k, tm_v, tm_do, a, n_kv, n_q, passes);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int role = threadIdx.x / 128, tid = threadIdx.x % 128;
    int sc = 0;  // stage uses so far, as the producer counts them
    for (int r = 0;; ++r) {
      const int c = snake_item(r);
      if (c >= (n_kv + n_q) * passes) break;
      const BwdItem it = bwd_item(c / passes, n_kv, n_q, a);
      if (it.dq)
        dq_consume_wide<E>(m, it, c % passes, a, role, tid, sc);
      else
        dkv_consume_wide<E, kNoKey>(m, it, c % passes, a, role, tid, sc);
    }
  }
}

// 2. dK/dV and dQ items in one persistent launch, one block per SM. kWide:
// head dims above 256 in column passes (bwd_wide; D = 256)
template <typename E, int D, bool kNoKey, bool kWide>
__global__ void __launch_bounds__(kBwdThreads, 1)
bwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                 const BwdArgs a) {
  extern __shared__ unsigned char bwd_smem[];
  if constexpr (kWide) {
    static_assert(D == kPassWidth, "the wide body runs passes of 256 columns");
    bwd_wide<E, kNoKey>(align1024(bwd_smem), &tm_q, &tm_k, &tm_v, &tm_do, a);
    return;
  }
  const BwdSmem<D> m(align1024(bwd_smem));
  if (threadIdx.x == 0) {
    for (int i = 0; i < 1 + BwdLayout<D>::kStages; ++i) {
      mbar_init(m.bar(2 * i), 1);
      mbar_init(m.bar(2 * i + 1), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_kv = a.B * a.H * ((a.T + kBwdRows - 1) / kBwdRows);
  const int n_q = a.B * a.H * ((a.S + kBwdRows - 1) / kBwdRows);
  if (threadIdx.x >= 256) {  // producer group: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) bwd_produce<D>(m, &tm_q, &tm_k, &tm_v, &tm_do, a, n_kv, n_q);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int role = threadIdx.x / 128, tid = threadIdx.x % 128;
    int sc = 0, ic = 0;  // stage and item uses so far, as the producer counts them
    for (int r = 0;; ++r) {
      const int c = snake_item(r);
      if (c >= n_kv + n_q) break;
      const BwdItem it = bwd_item(c, n_kv, n_q, a);
      if (it.dq)
        dq_consume<E, D>(m, it, a, role, tid, sc, ic);
      else
        dkv_consume<E, D, kNoKey>(m, it, a, role, tid, sc, ic);
    }
  }
}

// 3. G > 1: dK = scale * sum_g partial dK, dV = sum_g partial dV, heads in
// order, 4 columns a thread
template <typename E>
__global__ void __launch_bounds__(256)
dkv_reduce_kernel(const float* __restrict__ part, E* __restrict__ dk, E* __restrict__ dv,
                  int B, int T, int H, int KV, int D, float scale, long long n4) {
  const int G = H / KV;
  const size_t half = (size_t)B * H * T * D;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long e = i * 4;  // element of (B, T, KV, D)
    const int d = (int)(e % D);
    const long long bt_kv = e / D;
    const int kvh = (int)(bt_kv % KV);
    const long long bt = bt_kv / KV;
    const int t = (int)(bt % T), b = (int)(bt / T);
    float4 sk = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sv = sk;
    for (int g = 0; g < G; ++g) {
      const size_t off = (((size_t)b * H + kvh * G + g) * T + t) * D + d;
      const float4 x = *reinterpret_cast<const float4*>(part + off);
      const float4 y = *reinterpret_cast<const float4*>(part + half + off);
      sk.x += x.x; sk.y += x.y; sk.z += x.z; sk.w += x.w;
      sv.x += y.x; sv.y += y.y; sv.z += y.z; sv.w += y.w;
    }
    *reinterpret_cast<uint2*>(dk + e) =
        make_uint2(pack2<E>(sk.x * scale, sk.y * scale), pack2<E>(sk.z * scale, sk.w * scale));
    *reinterpret_cast<uint2*>(dv + e) = make_uint2(pack2<E>(sv.x, sv.y), pack2<E>(sv.z, sv.w));
  }
}

// ---- the 2-byte forward on wgmma (flash_tc_kernel_wgmma) ---------------------
// The body the note at the top describes under "bf16 and fp16 at the
// instantiated widths": a persistent, warp-specialised block of three warp
// groups, TMA-fed, both products on wgmma.
constexpr int kFwRows = 64;       // packed query rows of one consumer warp group
constexpr int kFwKeys = 128;      // keys of one kv tile
constexpr int kFwThreads = 384;   // consumer groups 0 and 1, then the producer group
constexpr int kMaxDynSmem = 232448;

// A D-column operand in shared memory: panels of kCols columns, each a run
// of rows of kRowBytes bytes swizzled over that span (128 bytes when D is
// a multiple of 64, else 64 or 32), so that no row carries zero columns
template <int D>
struct FwOperand {
  static_assert(D % 16 == 0, "wgmma takes k-steps of 16 columns");
  static constexpr int kRowBytes = D % 64 == 0 ? 128 : D % 32 == 0 ? 64 : 32;
  static constexpr int kCols = kRowBytes / 2;
  static constexpr int kPanels = D / kCols;
  static constexpr int kStepsPerPanel = kCols / 16;
};

template <int DQK, int DV>
struct FwLayout {  // byte offsets into the (1024-aligned) dynamic shared memory
  static constexpr int kQHalf = kFwRows * DQK * 2;  // one consumer group's Q rows
  static constexpr int kKTile = kFwKeys * DQK * 2;
  static constexpr int kVTile = kFwKeys * DV * 2;
  static constexpr int kFixed = 2 * kQHalf + 8 * (2 + 4 * 4) + 1024;
  static constexpr int kStages = std::min(4, (kMaxDynSmem - kFixed) / (kKTile + kVTile));
  static_assert(kStages >= 2, "two stages of K and V must fit");
  // Q of both groups, the K stages, the V stages, then the barriers: Q
  // full / empty, and per stage K full / empty and V full / empty
  static constexpr int kK0 = 2 * kQHalf;
  static constexpr int kV0 = kK0 + kStages * kKTile;
  static constexpr int kBar = kV0 + kStages * kVTile;
  static constexpr int kBytes = kBar + 8 * (2 + 4 * kStages) + 1024;
  static_assert(kBytes <= kMaxDynSmem, "shared memory");
};

struct FwArgs {
  void* o;     // (B, S, H, DV) of the inputs' type, dense
  float* lse;  // (B, H, S) fp32, or null
  int B, S, T, H, KV, G;
  int R;       // packed rows a consumer group takes: G (64 / G), whole positions
  int n_q;     // query tiles (2 R packed rows) of one (batch, kv head)
  int hg;      // (batch, kv head) pairs of one group of items (fw_item)
  int causal, window;
  float scale_log2;
};

struct FwItem {
  int b, kvh, p0;        // batch, kv head, first packed row of the tile
  int k_begin, n_tiles;  // the kv tiles its rows walk
};

// item u: the (batch, kv head) pairs in groups of a.hg; within a group
// query tile by query tile, heaviest first under a causal mask (the last
// tile sees the most keys), each over the group's pairs (the note at the
// top says how the launch picks a.hg)
__device__ __forceinline__ FwItem fw_item(int u, const FwArgs& a) {
  const int n_bh = a.B * a.KV, per_group = a.hg * a.n_q;
  const int g = u / per_group, rest = u - g * per_group;
  const int size = min(a.hg, n_bh - g * a.hg);  // the last group may be short
  const int bh = g * a.hg + rest % size, i = rest / size;
  FwItem it;
  it.b = bh / a.KV;
  it.kvh = bh % a.KV;
  it.p0 = (a.causal ? a.n_q - 1 - i : i) * 2 * a.R;
  const int last = min(a.S * a.G, it.p0 + 2 * a.R) - 1;
  int k_end;
  kv_range(it.p0 / a.G, last / a.G, a.T, a.causal, a.window, kFwKeys, it.k_begin, k_end);
  it.n_tiles = (k_end - it.k_begin + kFwKeys - 1) / kFwKeys;
  return it;
}

// K-major: k-step kk (16 columns) of a tile of `rows` rows whose rows run
// along the contraction dimension, panel after panel
template <int D>
__device__ __forceinline__ uint64_t fw_desc_k(uint32_t tile, int rows, int kk) {
  using Op = FwOperand<D>;
  return swz_desc<Op::kRowBytes>(tile + (kk / Op::kStepsPerPanel) * rows * Op::kRowBytes +
                                     (kk % Op::kStepsPerPanel) * 32,
                                 0, 8 * Op::kRowBytes);
}
// MN-major: k-step kk (16 keys) of a V tile, its D columns spanning the
// panels (leading offset: panel to panel; stride: 8 keys)
template <int D>
__device__ __forceinline__ uint64_t fw_desc_mn(uint32_t tile, int kk) {
  using Op = FwOperand<D>;
  return swz_desc<Op::kRowBytes>(tile + kk * 16 * Op::kRowBytes, kFwKeys * Op::kRowBytes,
                                 8 * Op::kRowBytes);
}

__device__ __forceinline__ void tma_4d(uint32_t dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_5d(uint32_t dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

// The accumulator registers of a m64nN wgmma, N / 2 a thread, as asm operands
#define FW_D8(i)                                                                              \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define FW_REGS32                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
#define FW_OUT32 FW_D8(0), FW_D8(8), FW_D8(16), FW_D8(24)
#define FW_REGS48                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "       \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, " \
  "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
#define FW_OUT48 FW_D8(0), FW_D8(8), FW_D8(16), FW_D8(24), FW_D8(32), FW_D8(40)
#define FW_REGS64                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "       \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, " \
  "%35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, " \
  "%52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
#define FW_OUT64 FW_D8(0), FW_D8(8), FW_D8(16), FW_D8(24), FW_D8(32), FW_D8(40), FW_D8(48), FW_D8(56)

// S (64 x 128 fp32) = A . B (+ S if accumulate), A and B of type E read
// K-major from shared memory through their descriptors
template <typename E>
__device__ __forceinline__ void fw_mma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                          int accumulate) {
#define FW_SS(TY)                                                                       \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                             \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " FW_REGS64 \
               "%64, %65, p, 1, 1, 0, 0;\n}\n"                                          \
               : FW_OUT64                                                               \
               : "l"(da), "l"(db), "r"(accumulate))
  if constexpr (std::is_same<E, __half>::value)
    FW_SS("f16");
  else
    FW_SS("bf16");
#undef FW_SS
}

// O (64 x N fp32) += A . B: A (64 x 16 of E) from registers in the
// accumulator's layout (to_a_frags), B read MN-major from shared memory
template <typename E, int N>
__device__ __forceinline__ void fw_mma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                          uint64_t db) {
#define FW_RS(TY, SHAPE, REGS, OUT, TAIL, ONE)                                           \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " ONE ", 0;\n"                          \
               "wgmma.mma_async.sync.aligned." SHAPE ".f32." TY "." TY " " REGS TAIL \
               ", p, 1, 1, 1;\n}\n"                                                      \
               : OUT                                                                     \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
  constexpr bool kF16 = std::is_same<E, __half>::value;
  if constexpr (N == 64) {
    if constexpr (kF16)
      FW_RS("f16", "m64n64k16", FW_REGS32, FW_OUT32, "{%32, %33, %34, %35}, %36", "%37");
    else
      FW_RS("bf16", "m64n64k16", FW_REGS32, FW_OUT32, "{%32, %33, %34, %35}, %36", "%37");
  } else if constexpr (N == 96) {
    if constexpr (kF16)
      FW_RS("f16", "m64n96k16", FW_REGS48, FW_OUT48, "{%48, %49, %50, %51}, %52", "%53");
    else
      FW_RS("bf16", "m64n96k16", FW_REGS48, FW_OUT48, "{%48, %49, %50, %51}, %52", "%53");
  } else {
    static_assert(N == 128, "instantiated output widths: 64, 96, 128");
    if constexpr (kF16)
      FW_RS("f16", "m64n128k16", FW_REGS64, FW_OUT64, "{%64, %65, %66, %67}, %68", "%69");
    else
      FW_RS("bf16", "m64n128k16", FW_REGS64, FW_OUT64, "{%64, %65, %66, %67}, %68", "%69");
  }
#undef FW_RS
}
#undef FW_D8
#undef FW_REGS32
#undef FW_OUT32
#undef FW_REGS48
#undef FW_OUT48
#undef FW_REGS64
#undef FW_OUT64

// The producer thread: per item its Q tile (both groups' rows, one box of
// R rows a panel and group), then its kv tiles, K and V of a tile in one
// stage of the ring
template <int DQK, int DV>
__device__ __forceinline__ void fw_produce(unsigned char* base, uint64_t* bar,
                                           const CUtensorMap* tm_q, const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, const FwArgs& a,
                                           int n_items) {
  using L = FwLayout<DQK, DV>;
  using QO = FwOperand<DQK>;
  using VO = FwOperand<DV>;
  constexpr int NS = L::kStages;
  const uint32_t s0 = smem_addr(base);
  int sc = 0;  // stage uses so far
  for (int r = 0;; ++r) {
    const int u = snake_item(r);
    if (u >= n_items) break;
    const FwItem it = fw_item(u, a);
    mbar_wait(&bar[1], (r & 1) ^ 1);
    mbar_expect_tx(&bar[0], 2 * QO::kPanels * a.R * QO::kRowBytes);
    for (int half = 0; half < 2; ++half)
      for (int p = 0; p < QO::kPanels; ++p)
        tma_5d(s0 + half * L::kQHalf + p * kFwRows * QO::kRowBytes, tm_q, &bar[0], p * QO::kCols,
               0, it.kvh, (it.p0 + half * a.R) / a.G, it.b);
    for (int j = 0; j < it.n_tiles; ++j, ++sc) {
      const int s = sc % NS, parity = ((sc / NS) & 1) ^ 1;
      const int k0 = it.k_begin + j * kFwKeys;
      uint64_t* b = &bar[2 + 4 * s];
      mbar_wait(&b[1], parity);
      mbar_expect_tx(&b[0], L::kKTile);
      for (int p = 0; p < QO::kPanels; ++p)
        tma_4d(s0 + L::kK0 + s * L::kKTile + p * kFwKeys * QO::kRowBytes, tm_k, &b[0],
               p * QO::kCols, it.kvh, k0, it.b);
      mbar_wait(&b[3], parity);
      mbar_expect_tx(&b[2], L::kVTile);
      for (int p = 0; p < VO::kPanels; ++p)
        tma_4d(s0 + L::kV0 + s * L::kVTile + p * kFwKeys * VO::kRowBytes, tm_v, &b[2],
               p * VO::kCols, it.kvh, k0, it.b);
    }
  }
}

// tile j's softmax in a consumer group's S registers: scale into base 2,
// mask where a row of the warp can miss a key, the running max m and sum l
// of this thread's two rows; returns the factor alpha that rescales O
template <int N>
__device__ __forceinline__ void fw_softmax(float (&s)[N], float (&m)[2], float (&l)[2],
                                           float (&alpha)[2], const FwArgs& a, int k0,
                                           int wq_lo, int wq_hi, const int (&qpos)[2],
                                           int kcol) {
  const bool edge = k0 + kFwKeys > a.T;
  const bool need_mask = edge || (a.causal && k0 + kFwKeys - 1 > wq_lo) ||
                         (a.window > 0 && k0 <= wq_hi - a.window);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = s[i] * a.scale_log2;
    if (need_mask) {
      const int kpos = k0 + (i / 4) * 8 + kcol + (i & 1);
      const int qp = qpos[(i >> 1) & 1];
      bool vis = kpos < a.T;
      if (a.causal) vis = vis && kpos <= qp;
      if (a.window > 0) vis = vis && kpos > qp - a.window;
      x = vis ? x : kNegInf;
    }
    s[i] = x;
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the 4 threads of a row share its max
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    alpha[h] = exp2f(m[h] - mx[h]);
    m[h] = mx[h];
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float p = exp2f(s[i] - m[(i >> 1) & 1]);
    if (edge && k0 + (i / 4) * 8 + kcol + (i & 1) >= a.T) p = 0.0f;
    s[i] = p;
    l[(i >> 1) & 1] += p;
  }
}

// A consumer group: 64 packed rows of every item, over its kv tiles. At
// tile j it issues S_j = Q K_j^T and O += P_{j-1} V_{j-1} back to back,
// then runs tile j's softmax while the second product is in flight; the
// two groups take turns to issue (named barriers 1 and 2), so one's
// softmax runs under the other's products. The first tile (S alone) and
// the last product (P V alone) are peeled off the loop, so that every wait
// in it retires a known product.
template <typename E, int DQK, int DV>
__device__ __forceinline__ void fw_consume(unsigned char* base, uint64_t* bar, const FwArgs& a,
                                           int n_items) {
  using L = FwLayout<DQK, DV>;
  constexpr int NS = L::kStages;
  constexpr int kSteps = kFwKeys / 16;  // k-steps of P . V
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const uint32_t s0 = smem_addr(base);
  const uint32_t q_s = s0 + wg * L::kQHalf;
  const int rows = a.S * a.G;
  const int kcol = (lane % 4) * 2;  // this thread's key / column offset in an n-block of 8
  E* out = static_cast<E*>(a.o);
  if (wg == 1) named_arrive(1);  // group 0 issues first
  int sc = 0;                     // stage uses so far, as the producer counts them
  for (int r = 0;; ++r) {
    const int u = snake_item(r);
    if (u >= n_items) break;
    const FwItem it = fw_item(u, a);
    const int n = it.n_tiles;
    // this warp's first packed row; this thread's rows are + lane / 4 + 8 i
    const int pw = it.p0 + wg * a.R + warp * 16;
    const int wq_lo = pw / a.G, wq_hi = (pw + 15) / a.G;
    const int qpos[2] = {(pw + lane / 4) / a.G, (pw + lane / 4 + 8) / a.G};
    float o[DV / 2], s[kFwKeys / 2];
    uint32_t pf[kSteps][4];
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.0f, 0.0f};  // this thread's partial row sums
    float alpha[2];
    // S_j = Q K_j^T into s, issued
    auto issue_s = [&](int j) {
      const int st = (sc + j) % NS;
      mbar_wait(&bar[2 + 4 * st], ((sc + j) / NS) & 1);
      const uint32_t k_s = s0 + L::kK0 + st * L::kKTile;
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        fw_mma_ss<E>(s, fw_desc_k<DQK>(q_s, kFwRows, kk), fw_desc_k<DQK>(k_s, kFwKeys, kk),
                     kk > 0);
      wg_commit();
    };
    // O += P_j V_j, issued
    auto issue_pv = [&](int j) {
      const int st = (sc + j) % NS;
      mbar_wait(&bar[2 + 4 * st + 2], ((sc + j) / NS) & 1);
      const uint32_t v_s = s0 + L::kV0 + st * L::kVTile;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) fw_mma_rs<E, DV>(o, pf[kk], fw_desc_mn<DV>(v_s, kk));
      wg_commit();
    };
    // S_j is done: free K_j (and Q after the last tile), P_j in s
    auto scores_done = [&](int j) {
      fence_acc(s);
      mbar_arrive(&bar[2 + 4 * ((sc + j) % NS) + 1]);
      if (j == n - 1) mbar_arrive(&bar[1]);
      fw_softmax(s, m, l, alpha, a, it.k_begin + j * kFwKeys, wq_lo, wq_hi, qpos, kcol);
    };
    auto to_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        pf[kk][0] = pack2<E>(s[8 * kk + 0], s[8 * kk + 1]);
        pf[kk][1] = pack2<E>(s[8 * kk + 2], s[8 * kk + 3]);
        pf[kk][2] = pack2<E>(s[8 * kk + 4], s[8 * kk + 5]);
        pf[kk][3] = pack2<E>(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o[i] = 0.0f;
    mbar_wait(&bar[0], r & 1);

    named_sync(1 + wg);  // tile 0: S alone
    wg_fence();
    issue_s(0);
    named_arrive(1 + (wg ^ 1));
    wg_wait0();
    scores_done(0);
    to_p();
    for (int j = 1; j < n; ++j) {
      named_sync(1 + wg);
      wg_fence();
      issue_s(j);
      issue_pv(j - 1);
      named_arrive(1 + (wg ^ 1));
      wg_wait1();  // S_j
      scores_done(j);
      wg_wait0();  // P_{j-1} V_{j-1}
      fence_acc(o);
      mbar_arrive(&bar[2 + 4 * ((sc + j - 1) % NS) + 3]);
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      to_p();
    }
    named_sync(1 + wg);  // the last P V alone
    wg_fence();
    issue_pv(n - 1);
    named_arrive(1 + (wg ^ 1));
    wg_wait0();
    fence_acc(o);
    mbar_arrive(&bar[2 + 4 * ((sc + n - 1) % NS) + 3]);
    sc += n;

    // epilogue: divide, write this thread's two rows' columns in pairs
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      const int rr = warp * 16 + lane / 4 + 8 * h;  // the row in the group's R
      const int p = it.p0 + wg * a.R + rr;
      if (rr >= a.R || p >= rows) continue;
      const float denom = fmaxf(l[h], 1e-30f), inv = 1.0f / denom;
      const int head = it.kvh * a.G + p % a.G, sq = p / a.G;
      if (a.lse != nullptr && lane % 4 == 0)  // m is in base 2: lse = (m + log2 l) ln 2
        a.lse[((size_t)it.b * a.H + head) * a.S + sq] =
            (m[h] + log2f(denom)) * 0.6931471805599453f;
      E* row = out + (((size_t)it.b * a.S + sq) * a.H + head) * DV + kcol;
#pragma unroll
      for (int jb = 0; jb < DV / 8; ++jb)
        *reinterpret_cast<uint32_t*>(row + 8 * jb) =
            pack2<E>(o[4 * jb + 2 * h] * inv, o[4 * jb + 2 * h + 1] * inv);
    }
  }
}

// the kernel: thread 0 sets up the barriers, zeros fill the Q rows past R
// of each group once (the TMA never writes them), then the producer group
// gives its registers to the two consumer groups
template <typename E, int DQK, int DV>
__global__ void __launch_bounds__(kFwThreads, 1)
flash_tc_kernel_wgmma(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, const FwArgs a) {
  using L = FwLayout<DQK, DV>;
  extern __shared__ unsigned char fw_smem[];
  unsigned char* base = align1024(fw_smem);
  uint64_t* bar = reinterpret_cast<uint64_t*>(base + L::kBar);
  if (threadIdx.x == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 256);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&bar[2 + 4 * s], 1);
      mbar_init(&bar[2 + 4 * s + 1], 256);
      mbar_init(&bar[2 + 4 * s + 2], 1);
      mbar_init(&bar[2 + 4 * s + 3], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (a.R < kFwRows && threadIdx.x < 256) {
    using QO = FwOperand<DQK>;
    const int n = 2 * QO::kPanels * (kFwRows - a.R) * (QO::kRowBytes / 16);
    for (int i = threadIdx.x; i < n; i += 256) {
      const int c = i % (QO::kRowBytes / 16), rest = i / (QO::kRowBytes / 16);
      const int row = a.R + rest % (kFwRows - a.R), panel = rest / (kFwRows - a.R);
      *reinterpret_cast<uint4*>(base + (panel / QO::kPanels) * L::kQHalf +
                                (panel % QO::kPanels) * kFwRows * QO::kRowBytes +
                                row * QO::kRowBytes + c * 16) = make_uint4(0, 0, 0, 0);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  const int n_items = a.B * a.KV * a.n_q;
  if (threadIdx.x >= 256) {  // producer group: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) fw_produce<DQK, DV>(base, bar, &tm_q, &tm_k, &tm_v, a, n_items);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    fw_consume<E, DQK, DV>(base, bar, a, n_items);
  }
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

// cuTensorMapEncodeTiled through the runtime, so the library needs no link
// against the driver library
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a size-1 axis may carry any stride; TMA wants a 16-byte one all the same
inline cuuint64_t map_stride(long long st, int n, long long dense) {
  return (cuuint64_t)(n > 1 ? st : dense) * 2;
}

// a (B, rows, heads, D) 2-byte tensor at the strides `ax` (each a multiple
// of 8 elements, as TMA needs 16-byte strides) as TMA boxes of 64 rows x
// 64 columns of one head, 128-byte swizzled, zero-filled past the edges (so
// a head dim below the kernel's width reads as zero columns)
bool make_tile_map(CUtensorMap* map, const void* base, const Axes& ax, int B, int rows,
                   int heads, int D, CUtensorMapDataType type) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {map_stride(ax.h, heads, D),
                                 map_stride(ax.s, rows, (long long)heads * D),
                                 map_stride(ax.b, B, (long long)rows * heads * D)};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)kBwdRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// kWide: D = 256, dh > 256 in `passes` column passes (bwd_wide)
template <typename E, int D, bool kWide>
int launch_bwd_tc(const void* q, const void* k, const void* v, const void* o, const void* dout,
                  const float* lse, float* stats, float* part, void* dq, void* dk, void* dv,
                  const InputAxes& ax, int B, int S, int T_len, int H, int KV, int dh, int causal,
                  int window, int passes, float scale, cudaStream_t stream) {
  constexpr int kBytes = kWide ? BwdWideLayout::kBytes : BwdLayout<D>::kBytes;
  // rows that see no key take their own instantiation (dkv_consume)
  const int nokey = first_nokey_row(S, T_len, window);
  const auto kernel = nokey < S ? bwd_wgmma_kernel<E, D, true, kWide>
                                : bwd_wgmma_kernel<E, D, false, kWide>;
  static bool configured[2] = {false, false};  // one attribute call per instantiation
  cudaError_t err = set_smem(kernel, kBytes, configured[nokey < S]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const CUtensorMapDataType type = std::is_same<E, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_tile_map(&mq, q, ax.q, B, S, H, dh, type) ||
      !make_tile_map(&mdo, dout, ax.dout, B, S, H, dh, type) ||
      !make_tile_map(&mk, k, ax.k, B, T_len, KV, dh, type) ||
      !make_tile_map(&mv, v, ax.v, B, T_len, KV, dh, type))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, n_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int S_pad = (S + kBwdRows - 1) / kBwdRows * kBwdRows;
  const long long n_rows = (long long)B * H * S_pad;
  bwd_prep_kernel<E><<<(unsigned)((n_rows + kDeltaWarps - 1) / kDeltaWarps), 32 * kDeltaWarps, 0,
                       stream>>>(static_cast<const E*>(o), static_cast<const E*>(dout), lse, stats,
                                 ax.o, ax.dout, S, H, dh, S_pad, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / KV;
  const BwdArgs args{stats, dq, dk, dv, G > 1 ? part : nullptr, B, S, T_len, H, KV, S_pad,
                     causal, window, dh, scale * kLog2e, scale, nokey, 1.0f / (float)T_len};
  const int units =
      B * H * ((T_len + kBwdRows - 1) / kBwdRows + (S + kBwdRows - 1) / kBwdRows) * passes;
  kernel<<<std::min(units, n_sm), kBwdThreads, kBytes, stream>>>(mq, mk, mv, mdo, args);
  err = cudaGetLastError();
  if (err != cudaSuccess || G == 1) return static_cast<int>(err);
  const long long n4 = (long long)B * T_len * KV * dh / 4;
  const long long blocks = std::min<long long>((n4 + 255) / 256, 16LL * n_sm);
  dkv_reduce_kernel<E><<<(unsigned)blocks, 256, 0, stream>>>(
      part, static_cast<E*>(dk), static_cast<E*>(dv), B, T_len, H, KV, dh, scale, n4);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int D, bool kWide>
int launch_bwd_fma(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv,
                   const InputAxes& ax, int B, int S, int T_len, int H, int KV, int dh,
                   int causal, int window, int passes, float scale, cudaStream_t stream) {
  constexpr size_t smem = bwd_f32_smem_bytes<D>();
  static bool cfg_kv = false, cfg_q = false;
  cudaError_t err = set_smem(dkv_f32_kernel<E, D, kWide>, smem, cfg_kv);
  if (err == cudaSuccess) err = set_smem(dq_f32_kernel<E, D, kWide>, smem, cfg_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkv_f32_kernel<E, D, kWide>
      <<<dim3((unsigned)(((long long)T_len + kBK - 1) / kBK * passes), KV, B), kThreads, smem,
          stream>>>(static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
                    static_cast<const E*>(dout), lse, delta, static_cast<E*>(dk),
                    static_cast<E*>(dv), ax, S, T_len, H, KV, dh, causal, window, scale, passes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_f32_kernel<E, D, kWide>
      <<<dim3((unsigned)(((long long)S + kBQ - 1) / kBQ * passes), H, B), kThreads, smem,
          stream>>>(static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v),
                    static_cast<const E*>(dout), lse, delta, static_cast<E*>(dq), ax, S, T_len, H,
                    KV, dh, causal, window, scale, passes);
  return static_cast<int>(cudaGetLastError());
}

// fp32: delta, then the FMA bodies at the wrapper's width and passes (the
// forward's widths, passes past 256)
int launch_bwd_fma_f32(const void* q, const void* k, const void* v, const void* o,
                       const void* dout, const float* lse, float* delta, void* dq, void* dk,
                       void* dv, const InputAxes& ax, int B, int S, int T_len, int H, int KV,
                       int D, int causal, int window, int width, int passes, float scale,
                       cudaStream_t stream) {
  using E = float;
  if (!plan_fits(D, width, passes)) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_rows = (long long)B * S * H;
  delta_kernel<E><<<(unsigned)((n_rows + kDeltaWarps - 1) / kDeltaWarps), 32 * kDeltaWarps, 0,
                    stream>>>(static_cast<const E*>(o), static_cast<const E*>(dout), delta, ax.o,
                              ax.dout, S, H, D, n_rows);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (passes > 1)
    return launch_bwd_fma<E, kPassWidth, true>(q, k, v, dout, lse, delta, dq, dk, dv, ax, B,
                                               S, T_len, H, KV, D, causal, window, passes,
                                               scale, stream);
#define FA_BWD_CASE(DIM)                                                                     \
  case DIM:                                                                                  \
    return launch_bwd_fma<E, DIM, false>(q, k, v, dout, lse, delta, dq, dk, dv, ax, B, S,    \
                                         T_len, H, KV, D, causal, window, 1, scale, stream);
  switch (width) {
    FA_BWD_CASE(16)
    FA_BWD_CASE(32)
    FA_BWD_CASE(64)
    FA_BWD_CASE(128)
    FA_BWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FA_BWD_CASE
}

// the bodies an entry is handed (the wrapper's _BODY)
constexpr int kBodyWgmma = 0, kBodyFma = 1, kBodyMma = 2;

// the 2-byte backward: wgmma at width 128 or 256 in one pass, or at 256 in
// column passes past it (D % 8 == 0: TMA rows on the 16-byte grid). The FMA
// body is refused: the 2-byte types run on the tensor cores at every D.
template <typename E>
int launch_bwd_2byte(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* stats, void* part, void* dq,
                     void* dk, void* dv, const long long* strides, int B, int S, int T, int H,
                     int KV, int D, int causal, int window, int body, int width, int passes,
                     float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const InputAxes ax = read_axes(strides, 5);
  const float* l = static_cast<const float*>(lse);
  float* st = static_cast<float*>(stats);
  float* pt = static_cast<float*>(part);
  if (body != kBodyWgmma || !plan_fits(D, width, passes) || (width != 128 && width != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o | (uintptr_t)dout |
       (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv | (uintptr_t)stats | (uintptr_t)part) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (H > KV && part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (D % 8 != 0 || D < 8) return static_cast<int>(cudaErrorInvalidValue);
  if (passes > 1)
    return launch_bwd_tc<E, kPassWidth, true>(q, k, v, o, dout, l, st, pt, dq, dk, dv, ax, B, S,
                                              T, H, KV, D, causal, window, passes, scale, s);
  if (width == 128)  // the tiles' columns past D are zero-filled by the copies
    return launch_bwd_tc<E, 128, false>(q, k, v, o, dout, l, st, pt, dq, dk, dv, ax, B, S, T, H,
                                        KV, D, causal, window, 1, scale, s);
  return launch_bwd_tc<E, 256, false>(q, k, v, o, dout, l, st, pt, dq, dk, dv, ax, B, S, T, H, KV,
                                      D, causal, window, 1, scale, s);
}

// ---- the forward on wgmma: maps and launch ------------------------------------
CUtensorMapSwizzle swizzle_of(int row_bytes) {
  return row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}


// The forward's TMA maps of one tensor, boxes one panel (row_bytes) wide,
// swizzled over it and zero-filled past the edges: k or v (B, rows, heads,
// D) as boxes of kFwKeys rows of one head; q (B, S, H, D) seen as (B, S,
// KV, G, D), boxes of 64 / G positions x G heads, so a box is R packed rows
// (`group` = G; 0 for k and v)
bool make_fw_map(CUtensorMap* map, const void* base, const Axes& ax, int B, int rows, int heads,
                 int D, int row_bytes, int group, CUtensorMapDataType type) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t cols = row_bytes / 2;
  const cuuint64_t hs = map_stride(ax.h, heads, D);
  const cuuint64_t ss = map_stride(ax.s, rows, (long long)heads * D);
  const cuuint64_t bs = map_stride(ax.b, B, (long long)rows * heads * D);
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  if (group == 0) {
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)B};
    const cuuint64_t strides[3] = {hs, ss, bs};
    const cuuint32_t box[4] = {cols, 1, (cuuint32_t)kFwKeys, 1};
    return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(row_bytes),
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }
  const cuuint64_t dims[5] = {(cuuint64_t)D, (cuuint64_t)group, (cuuint64_t)(heads / group),
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[4] = {hs, hs * group, ss, bs};
  const cuuint32_t box[5] = {cols, (cuuint32_t)group, 1, (cuuint32_t)(kFwRows / group), 1};
  return fn(map, type, 5, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(row_bytes),
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename E, int DQK, int DV>
int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* o, float* lse,
                     const InputAxes& ax, int B, int S, int T, int H, int KV, int causal,
                     int window, float scale, cudaStream_t stream) {
  using L = FwLayout<DQK, DV>;
  const auto kernel = flash_tc_kernel_wgmma<E, DQK, DV>;
  static bool configured = false;  // one attribute call per instantiation
  cudaError_t err = set_smem(kernel, L::kBytes, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = H / KV;
  if (G > kFwRows) return static_cast<int>(cudaErrorInvalidValue);
  const int R = G * (kFwRows / G);
  const CUtensorMapDataType type = std::is_same<E, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap mq, mk, mv;
  if (!make_fw_map(&mq, q, ax.q, B, S, H, DQK, FwOperand<DQK>::kRowBytes, G, type) ||
      !make_fw_map(&mk, k, ax.k, B, T, KV, DQK, FwOperand<DQK>::kRowBytes, 0, type) ||
      !make_fw_map(&mv, v, ax.v, B, T, KV, DV, FwOperand<DV>::kRowBytes, 0, type))
    return static_cast<int>(cudaErrorInvalidValue);
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long n_q = ((long long)S * G + 2 * R - 1) / (2 * R);
  const long long n_items = (long long)B * KV * n_q;
  if (n_items > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // items in groups of two pairs, or all pairs in one group when the run is
  // short (the note at the top)
  const int hg = n_items <= 16LL * n_sm ? B * KV : std::min(2, B * KV);
  const FwArgs a{o, lse, B, S, T, H, KV, G, R, (int)n_q, hg, causal, window, scale * kLog2e};
  kernel<<<(unsigned)std::min<long long>(n_items, n_sm), kFwThreads, L::kBytes, stream>>>(
      mq, mk, mv, a);
  return static_cast<int>(cudaGetLastError());
}

// the 2-byte forward: the wgmma body at its instantiated (q/k, v) widths in
// one pass, or the mma.sync body (one head dim D = Dv) at the wrapper's
// width and passes
template <typename E>
int launch_fwd_2byte(const void* q, const void* k, const void* v, void* o, float* lse,
                     const long long* strides, int B, int S, int T, int H, int KV, int D, int Dv,
                     int causal, int window, int body, int width, int passes, float scale,
                     void* stream) {
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (body == kBodyMma && Dv == D)
    return launch<E>(q, k, v, o, lse, strides, B, S, T, H, KV, D, causal, window, width, passes,
                     scale, stream);
  if (body != kBodyWgmma || passes != 1 || width != D)
    return static_cast<int>(cudaErrorInvalidValue);
  const InputAxes ax = read_axes(strides, 3);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_FWD_WGMMA_CASE(DQK, DV)                                                           \
  if (D == DQK && Dv == DV)                                                                  \
    return launch_fwd_wgmma<E, DQK, DV>(q, k, v, o, lse, ax, B, S, T, H, KV, causal, window, \
                                        scale, s);
  FA_FWD_WGMMA_CASE(64, 64)
  FA_FWD_WGMMA_CASE(96, 96)
  FA_FWD_WGMMA_CASE(128, 128)
  FA_FWD_WGMMA_CASE(192, 128)
#undef FA_FWD_WGMMA_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points for ctypes. q (B, S, H, D) and k (B, T, KV, D), v
// (B, T, KV, Dv) are read at `strides`: 9 element strides, the batch, row
// and head axes of q, k and v in turn (the last axis unit-stride); o
// (B, S, H, Dv) is contiguous; lse is null or an fp32 (B, H, S) buffer;
// H % KV == 0; causal is 0/1, window <= 0 means none; scores are scaled by
// `scale` (D^-0.5 from the wrapper). `body`, `width` and `passes` are the
// wrapper's plan (one that does not fit the head dims is refused):
//   body 2 (mma.sync, the 2-byte types) or 1 (FMA, fp32 only): Dv = D, any
//   D >= 1, one pass at a width of 16, 32, 64, 128 or 256 that holds D
//   (rows read at stride D, the columns past D zeros on the card, only D
//   columns written), or ceil(D / 256) passes at width 256;
//   body 0 (wgmma, the 2-byte types): (D, Dv) one of the instantiated
//   pairs, width D, one pass, H / KV <= 64.
// The 2-byte entries also need each pointer 16-byte aligned (rows move by
// 16-byte copies). Each launches on `stream` and returns the CUDA error
// code (0 on success).
extern "C" int flash_attention_fwd_f32(const void* q, const void* k, const void* v,
                                       void* o, void* lse, const long long* strides, int B,
                                       int S, int T, int H, int KV, int D, int Dv, int causal,
                                       int window, int body, int width, int passes, float scale,
                                       void* stream) {
  if (body != kBodyFma || Dv != D) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float>(q, k, v, o, static_cast<float*>(lse), strides, B, S, T, H, KV, D, causal,
                       window, width, passes, scale, stream);
}

extern "C" int flash_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                        void* o, void* lse, const long long* strides, int B,
                                        int S, int T, int H, int KV, int D, int Dv, int causal,
                                        int window, int body, int width, int passes, float scale,
                                        void* stream) {
  return launch_fwd_2byte<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), strides, B, S, T,
                                         H, KV, D, Dv, causal, window, body, width, passes, scale,
                                         stream);
}

extern "C" int flash_attention_fwd_f16(const void* q, const void* k, const void* v,
                                       void* o, void* lse, const long long* strides, int B,
                                       int S, int T, int H, int KV, int D, int Dv, int causal,
                                       int window, int body, int width, int passes, float scale,
                                       void* stream) {
  return launch_fwd_2byte<__half>(q, k, v, o, static_cast<float*>(lse), strides, B, S, T, H, KV,
                                  D, Dv, causal, window, body, width, passes, scale, stream);
}

// Plain C entry points for ctypes. q, o, dout (B, S, H, D) and k, v
// (B, T, KV, D) are of one type and read at `strides`: 15 element strides,
// the batch, row and head axes of q, k, v, o and dout in turn (the last
// axis unit-stride; the 2-byte types' strides multiples of 8); dq, dk, dv
// are contiguous; lse is the forward's
// (B, H, S) fp32 log-sum-exp; causal 0/1, window <= 0 means none; `scale`
// as in the forward; `body`, `width` and `passes` are the wrapper's plan
// (one that does not fit D is refused). Each launches its kernels on
// `stream` and returns the CUDA error code (0 on success).
//   body 1 (the FMA bodies, fp32 only): any D >= 1 at the forward's widths
//   and passes; stats is an fp32 (B, H, S) scratch buffer the call fills
//   with delta; part is unused.
//   body 0 (wgmma, the 2-byte types only): D a multiple of 8 at width 128
//   or 256 in one pass, or at width 256 in ceil(D / 256) passes; every
//   pointer 16-byte aligned; stats is an fp32 scratch of 2 B H S_pad
//   (S_pad: S rounded up to 64); part, when H > KV, an fp32 scratch of
//   2 B H T D for the per-head partial dK and dV.
extern "C" int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* stats, void* part, void* dq, void* dk, void* dv,
                                       const long long* strides, int B, int S, int T, int H,
                                       int KV, int D, int causal, int window, int body,
                                       int width, int passes, float scale, void* stream) {
  (void)part;
  if (body != kBodyFma) return static_cast<int>(cudaErrorInvalidValue);
  return launch_bwd_fma_f32(q, k, v, o, dout, static_cast<const float*>(lse),
                            static_cast<float*>(stats), dq, dk, dv, read_axes(strides, 5), B, S,
                            T, H, KV, D, causal, window, width, passes, scale,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                        const void* o, const void* dout, const void* lse,
                                        void* stats, void* part, void* dq, void* dk, void* dv,
                                        const long long* strides, int B, int S, int T, int H,
                                        int KV, int D, int causal, int window, int body,
                                        int width, int passes, float scale, void* stream) {
  return launch_bwd_2byte<__nv_bfloat16>(q, k, v, o, dout, lse, stats, part, dq, dk, dv,
                                         strides, B, S, T, H, KV, D, causal, window, body, width,
                                         passes, scale, stream);
}

extern "C" int flash_attention_bwd_f16(const void* q, const void* k, const void* v,
                                       const void* o, const void* dout, const void* lse,
                                       void* stats, void* part, void* dq, void* dk, void* dv,
                                       const long long* strides, int B, int S, int T, int H,
                                       int KV, int D, int causal, int window, int body,
                                       int width, int passes, float scale, void* stream) {
  return launch_bwd_2byte<__half>(q, k, v, o, dout, lse, stats, part, dq, dk, dv, strides, B, S,
                                  T, H, KV, D, causal, window, body, width, passes, scale,
                                  stream);
}
