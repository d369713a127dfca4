// AdamW's step for Hopper (sm_90a) in two multi-tensor passes: the global
// norm of the gradients, and the update of every leaf's params and moments.
//
// Replaces no Pallas TPU kernel: the reference's optimizer
// (src/repro/training/optimizer.py) is plain jnp, which XLA fuses inside the
// jitted step. The port's eager version (training/optimizer.py::
// adamw_update_) launches ~25 kernels a leaf, each reading and writing whole
// fp32 temporaries; these two passes read each input once and write each
// output once. Given the same norm the update computes the eager numbers bit
// for bit; the norm sums in fp64, within a few fp32 ulps of the eager fp32
// sum but not its bits.
//
// What bounds it on an H100: bytes, at ~1 flop a byte. Per parameter the
// update reads p, g, m and v once and writes p, m and v once (bf16 p and g,
// fp32 moments: 22 bytes) and the norm reads g once more (2 bytes): 24 bytes
// a parameter, 14.4 ms for phi3-mini at 16 layers (2.01 B parameters) at
// 3.35 TB/s.
//
// Design:
//   * Multi-tensor launches: the leaves' addresses, sizes and decay flags go
//     by value in the kernel's parameters, a table of up to kMaxLeaves leaves
//     a launch (as Apex's multi_tensor_apply does), so a CUDA graph holds
//     them and nothing is copied to the device. A leaf of another dtype pair
//     goes in another table; a tree of ~150 leaves takes a few launches.
//   * The update: a persistent grid (as many blocks as the SMs hold) walks
//     the launch's 2048-element tiles in leaf order; each thread moves 8
//     consecutive elements of p, g, m and v with 16-byte loads and stores
//     (two for a 4-byte type: six loads in flight a thread for bf16 params
//     and fp32 moments), element by element for a leaf's ragged end or for a
//     leaf whose four addresses are not all on the 16-byte grid. Offsets are
//     64-bit.
//   * The arithmetic is adamw_update's fp32 expressions in its order, each
//     op rounded once, as PyTorch's eager kernels round it: __fmul_rn,
//     __fadd_rn, __fdiv_rn and __fsqrt_rn, so that nvcc contracts nothing
//     into an FMA. The clip scale is rounded to g's type and the scaled g to
//     it before the widening (g * scale.to(g.dtype)); the Python scalars come
//     rounded to fp32 by the wrapper's ctypes floats, as PyTorch rounds a
//     scalar operand of an fp32 kernel; m and v are stored in the moment type
//     and the update reads the stored values back; p is rounded to its type
//     at the end.
//   * The norm: pass 1, one block per 32768-element tile of a gradient leaf,
//     squares each element in fp32 (torch.square of g.float()) and sums the
//     squares in fp64 in a fixed order (each thread its elements in turn,
//     then a fixed shuffle tree and the warps in turn), writing the tile's
//     partial; pass 2, one block, sums each leaf's partials (lanes strided,
//     a fixed shuffle tree), then the leaves' sums in leaf order, and writes
//     the square root as a 0-d fp32. No atomics: every call and every graph
//     replay gives the same bits. fp64 sums keep it within an ulp or two of
//     fp32 of the exact norm; the eager fp32 sums agree to ~1e-7.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;                          // elements a thread moves
constexpr long long kTile = kThreads * kVec;     // update tile: 2048
constexpr int kNormSteps = 16;
constexpr long long kNormTile = kTile * kNormSteps;  // norm tile: 32768
constexpr int kMaxLeaves = 64;                   // keeps a table under 4 KB
constexpr int kFinishThreads = 1024;

// Leaves of one update launch. tile0[i] is leaf i's first tile in the
// launch and tile0[count] the launch's tile count.
struct UpdateTable {
  void* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  void* m[kMaxLeaves];
  void* v[kMaxLeaves];
  long long n[kMaxLeaves];
  long long tile0[kMaxLeaves + 1];
  unsigned char decay[kMaxLeaves];
  unsigned char vec[kMaxLeaves];
  int count;
};

// Leaves of one norm launch (every leaf non-empty). first[i] is the index of
// leaf i's first partial in the whole call's partials (tree order), leaf[i]
// its index among the call's non-empty leaves.
struct NormTable {
  const void* g[kMaxLeaves];
  long long n[kMaxLeaves];
  long long tile0[kMaxLeaves + 1];
  long long first[kMaxLeaves];
  int leaf[kMaxLeaves];
  unsigned char vec[kMaxLeaves];
  int count;
};

struct Scalars {
  const float* scale;  // the clip's 0-d fp32 scale, or null: no clip
  const float* lr;
  const float* c1;
  const float* c2;
  float b1, omb1, b2, omb2, eps, wd;
};

template <typename T> struct Elt;
template <> struct Elt<float> {
  static __device__ __forceinline__ float widen(float x) { return x; }
  static __device__ __forceinline__ float narrow(float x) { return x; }
};
template <> struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float widen(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 narrow(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <> struct Elt<__half> {
  static __device__ __forceinline__ float widen(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half narrow(float x) { return __float2half_rn(x); }
};

// x rounded to T and widened back: what a tensor of type T holds.
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return Elt<T>::widen(Elt<T>::narrow(x));
}

// 8 consecutive elements of type T from/to an address on the 16-byte grid.
template <typename T>
__device__ __forceinline__ void load8(const T* src, float (&x)[kVec]) {
  constexpr int kWords = sizeof(T) * kVec / 16;
  uint4 w[kWords];
#pragma unroll
  for (int i = 0; i < kWords; ++i) w[i] = reinterpret_cast<const uint4*>(src)[i];
  const T* e = reinterpret_cast<const T*>(w);
#pragma unroll
  for (int j = 0; j < kVec; ++j) x[j] = Elt<T>::widen(e[j]);
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&x)[kVec]) {
  constexpr int kWords = sizeof(T) * kVec / 16;
  uint4 w[kWords];
  T* e = reinterpret_cast<T*>(w);
#pragma unroll
  for (int j = 0; j < kVec; ++j) e[j] = Elt<T>::narrow(x[j]);
#pragma unroll
  for (int i = 0; i < kWords; ++i) reinterpret_cast<uint4*>(dst)[i] = w[i];
}

// One element of adamw_update: p, m, v in and out (as their types hold
// them), g as its type holds it.
template <typename P, typename M>
__device__ __forceinline__ void adamw_elem(float& p, float g, float& m, float& v,
                                           bool clip, float scale, float lr,
                                           float c1, float c2, bool decay,
                                           const Scalars& s) {
  if (clip) g = rnd<P>(__fmul_rn(g, scale));                   // g * scale
  m = rnd<M>(__fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.omb1)));
  v = rnd<M>(__fadd_rn(__fmul_rn(v, s.b2),
                       __fmul_rn(__fmul_rn(g, s.omb2), g)));  // (1-b2) g g
  float u = __fdiv_rn(__fdiv_rn(m, c1),
                      __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), s.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(p, s.wd));
  p = rnd<P>(__fsub_rn(p, __fmul_rn(lr, u)));
}

template <typename P, typename M>
__global__ void __launch_bounds__(kThreads)
update_kernel(const __grid_constant__ UpdateTable t, const Scalars s) {
  const bool clip = s.scale != nullptr;
  const float scale = clip ? rnd<P>(*s.scale) : 1.0f;       // scale.to(g.dtype)
  const float lr = *s.lr, c1 = *s.c1, c2 = *s.c2;
  const long long total = t.tile0[t.count];
  int leaf = 0;
  for (long long tile = blockIdx.x; tile < total; tile += gridDim.x) {
    while (tile >= t.tile0[leaf + 1]) ++leaf;
    const long long n = t.n[leaf];
    const long long i0 = (tile - t.tile0[leaf]) * kTile + threadIdx.x * kVec;
    if (i0 >= n) continue;
    P* p = static_cast<P*>(t.p[leaf]) + i0;
    const P* g = static_cast<const P*>(t.g[leaf]) + i0;
    M* m = static_cast<M*>(t.m[leaf]) + i0;
    M* v = static_cast<M*>(t.v[leaf]) + i0;
    const bool decay = t.decay[leaf];
    if (t.vec[leaf] && i0 + kVec <= n) {
      float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
      load8(p, pf);
      load8(g, gf);
      load8(m, mf);
      load8(v, vf);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        adamw_elem<P, M>(pf[j], gf[j], mf[j], vf[j], clip, scale, lr, c1, c2,
                         decay, s);
      store8(p, pf);
      store8(m, mf);
      store8(v, vf);
    } else {
      const int k = n - i0 < kVec ? static_cast<int>(n - i0) : kVec;
      for (int j = 0; j < k; ++j) {
        float pf = Elt<P>::widen(p[j]), mf = Elt<M>::widen(m[j]);
        float vf = Elt<M>::widen(v[j]);
        adamw_elem<P, M>(pf, Elt<P>::widen(g[j]), mf, vf, clip, scale, lr, c1,
                         c2, decay, s);
        p[j] = Elt<P>::narrow(pf);
        m[j] = Elt<M>::narrow(mf);
        v[j] = Elt<M>::narrow(vf);
      }
    }
  }
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;  // the same bits in every lane
}

__device__ __forceinline__ double sq(float x) {
  return static_cast<double>(__fmul_rn(x, x));
}

// The launch's leaf holding tile `tile`: the last i with tile0[i] <= tile.
__device__ __forceinline__ int find_leaf(const NormTable& t, long long tile) {
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.tile0[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
norm_tiles_kernel(const __grid_constant__ NormTable t, double* partial,
                  long long* bounds) {
  const long long tile = blockIdx.x;
  const int leaf = find_leaf(t, tile);
  const long long c = tile - t.tile0[leaf];
  const long long n = t.n[leaf];
  const T* g = static_cast<const T*>(t.g[leaf]);
  long long i0 = c * kNormTile + threadIdx.x * kVec;
  double acc = 0.0;
  float x[kVec];
  if (t.vec[leaf] && (c + 1) * kNormTile <= n) {           // a whole tile
#pragma unroll 4
    for (int st = 0; st < kNormSteps; ++st) {
      load8(g + i0 + st * kTile, x);
#pragma unroll
      for (int j = 0; j < kVec; ++j) acc += sq(x[j]);
    }
  } else {
    for (int st = 0; st < kNormSteps && i0 < n; ++st, i0 += kTile) {
      if (t.vec[leaf] && i0 + kVec <= n) {
        load8(g + i0, x);
#pragma unroll
        for (int j = 0; j < kVec; ++j) acc += sq(x[j]);
      } else {
        for (long long i = i0; i < i0 + kVec && i < n; ++i)
          acc += sq(Elt<T>::widen(g[i]));
      }
    }
  }
  __shared__ double warps[kThreads / 32];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warps[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double sum = 0.0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) sum += warps[w];
    partial[t.first[leaf] + c] = sum;
    if (c == 0) bounds[t.leaf[leaf]] = t.first[leaf];
  }
}

__global__ void __launch_bounds__(kFinishThreads)
norm_finish_kernel(const double* partial, const long long* bounds,
                   double* leaf_sums, int leaves, long long total, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int l = warp; l < leaves; l += kFinishThreads / 32) {
    const long long end = l + 1 < leaves ? bounds[l + 1] : total;
    double s = 0.0;
    for (long long i = bounds[l] + lane; i < end; i += 32) s += partial[i];
    s = warp_sum(s);
    if (lane == 0) leaf_sums[l] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int l = 0; l < leaves; ++l) s += leaf_sums[l];
    *out = static_cast<float>(sqrt(s));
  }
}

bool on_grid(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

constexpr int kMaxDevices = 64;

// Blocks of update_kernel<P, M> that fill the current device once, asked of
// the CUDA runtime on the first call on a device (an eager call: a capture
// then only reads the cache).
template <typename P, typename M>
int update_grid(long long tiles, cudaError_t* err) {
  static int full[kMaxDevices];   // per device, 0 until asked
  int dev = 0;
  if ((*err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  if (dev >= kMaxDevices) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (full[dev] == 0) {
    int sms = 0, per_sm = 0;
    if ((*err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev)) != cudaSuccess) return 0;
    if ((*err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, update_kernel<P, M>, kThreads, 0)) != cudaSuccess)
      return 0;
    full[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  return static_cast<int>(tiles < full[dev] ? tiles : full[dev]);
}

template <typename P, typename M>
int launch_update(void* const* p, const void* const* g, void* const* m,
                  void* const* v, const long long* n, const unsigned char* decay,
                  int count, const Scalars& s, cudaStream_t stream,
                  int* launches) {
  UpdateTable t;
  int k = 0;
  long long tiles = 0;
  auto flush = [&]() -> int {
    if (k == 0) return 0;
    t.count = k;
    t.tile0[k] = tiles;
    cudaError_t err = cudaSuccess;
    const int grid = update_grid<P, M>(tiles, &err);
    if (err != cudaSuccess) return static_cast<int>(err);
    update_kernel<P, M><<<grid, kThreads, 0, stream>>>(t, s);
    ++*launches;
    k = 0;
    tiles = 0;
    return static_cast<int>(cudaGetLastError());
  };
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0) continue;
    t.p[k] = p[i];
    t.g[k] = g[i];
    t.m[k] = m[i];
    t.v[k] = v[i];
    t.n[k] = n[i];
    t.tile0[k] = tiles;
    t.decay[k] = decay[i] ? 1 : 0;
    t.vec[k] = on_grid(p[i]) && on_grid(g[i]) && on_grid(m[i]) && on_grid(v[i]);
    tiles += (n[i] + kTile - 1) / kTile;
    if (++k == kMaxLeaves) {
      if (const int e = flush()) return e;
    }
  }
  return flush();
}

template <typename T>
int launch_norm_tiles(const void* const* g, const long long* n, const int* dt,
                      int code, int count, double* partial, long long* bounds,
                      cudaStream_t stream, int* launches) {
  NormTable t;
  int k = 0, leaf = 0;
  long long tiles = 0, first = 0;
  auto flush = [&]() -> int {
    if (k == 0) return 0;
    t.count = k;
    t.tile0[k] = tiles;
    norm_tiles_kernel<T><<<static_cast<unsigned>(tiles), kThreads, 0, stream>>>(
        t, partial, bounds);
    ++*launches;
    k = 0;
    tiles = 0;
    return static_cast<int>(cudaGetLastError());
  };
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0) continue;
    const long long nt = (n[i] + kNormTile - 1) / kNormTile;
    if (dt[i] == code) {
      t.g[k] = g[i];
      t.n[k] = n[i];
      t.tile0[k] = tiles;
      t.first[k] = first;
      t.leaf[k] = leaf;
      t.vec[k] = on_grid(g[i]);
      tiles += nt;
      if (++k == kMaxLeaves) {
        if (const int e = flush()) return e;
      }
    }
    first += nt;
    ++leaf;
  }
  return flush();
}

}  // namespace

// dtype codes: 0 float32, 1 bfloat16, 2 float16.

// fp64 words of scratch that adamw_global_norm needs for these leaf sizes.
extern "C" long long adamw_norm_scratch(const long long* n, int count) {
  long long tiles = 0, leaves = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0) continue;
    tiles += (n[i] + kNormTile - 1) / kNormTile;
    ++leaves;
  }
  return tiles + 2 * leaves;
}

// out (0-d fp32) = sqrt(sum over every leaf of sum(g * g)), the leaves g[i]
// dense, of n[i] elements of type dt[i]; scratch holds
// adamw_norm_scratch(n, count) fp64 words. *launches: the kernels launched.
extern "C" int adamw_global_norm(const void* const* g, const long long* n,
                                 const int* dt, int count, double* scratch,
                                 float* out, void* stream, int* launches) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launches = 0;
  long long tiles = 0;
  int leaves = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] <= 0) continue;
    if (dt[i] < 0 || dt[i] > 2) return static_cast<int>(cudaErrorInvalidValue);
    tiles += (n[i] + kNormTile - 1) / kNormTile;
    ++leaves;
  }
  double* partial = scratch;
  double* leaf_sums = scratch + tiles;
  long long* bounds = reinterpret_cast<long long*>(scratch + tiles + leaves);
  int e = launch_norm_tiles<float>(g, n, dt, 0, count, partial, bounds, st,
                                   launches);
  if (!e) e = launch_norm_tiles<__nv_bfloat16>(g, n, dt, 1, count, partial,
                                               bounds, st, launches);
  if (!e) e = launch_norm_tiles<__half>(g, n, dt, 2, count, partial, bounds, st,
                                        launches);
  if (e) return e;
  norm_finish_kernel<<<1, kFinishThreads, 0, st>>>(partial, bounds, leaf_sums,
                                                   leaves, tiles, out);
  ++*launches;
  return static_cast<int>(cudaGetLastError());
}

// One AdamW step in place over `count` leaves: p[i], g[i] of type pdt,
// m[i], v[i] of type mdt (0 or 1), n[i] elements each, dense; decay[i]
// nonzero where the leaf takes weight decay. scale (null: no clip), lr, c1
// and c2 are 0-d fp32 device tensors; b1, 1 - b1, b2, 1 - b2, eps and the
// weight decay as fp32. *launches: the kernels launched.
extern "C" int adamw_update(int pdt, int mdt, void* const* p,
                            const void* const* g, void* const* m,
                            void* const* v, const long long* n,
                            const unsigned char* decay, int count,
                            const float* scale, const float* lr,
                            const float* c1, const float* c2, float b1,
                            float omb1, float b2, float omb2, float eps,
                            float wd, void* stream, int* launches) {
  const Scalars s{scale, lr, c1, c2, b1, omb1, b2, omb2, eps, wd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launches = 0;
  if (pdt < 0 || pdt > 2 || mdt < 0 || mdt > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (pdt * 2 + mdt) {
    case 0: return launch_update<float, float>(p, g, m, v, n, decay, count, s, st, launches);
    case 1: return launch_update<float, __nv_bfloat16>(p, g, m, v, n, decay, count, s, st, launches);
    case 2: return launch_update<__nv_bfloat16, float>(p, g, m, v, n, decay, count, s, st, launches);
    case 3: return launch_update<__nv_bfloat16, __nv_bfloat16>(p, g, m, v, n, decay, count, s, st, launches);
    case 4: return launch_update<__half, float>(p, g, m, v, n, decay, count, s, st, launches);
    case 5: return launch_update<__half, __nv_bfloat16>(p, g, m, v, n, decay, count, s, st, launches);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
