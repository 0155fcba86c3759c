// Shared device helpers for the hand-written Hopper kernels of
// tinysql_tpu_torch (HK1-HK4).  Every .cu file of csrc/ is compiled on its
// own into a shared library with a plain C interface (ops/_ext.py), so the
// helpers here live in an anonymous namespace: each library carries its own
// copy and no symbol crosses a library boundary.
//
// Conventions shared by all kernels:
// - values are int64 or float64 lanes, NULL masks are uint8 (torch.bool);
// - every C entry point launches on the caller's stream, allocates nothing
//   (the Python wrapper passes outputs and scratch from torch.empty), and
//   returns cudaGetLastError() after its launches;
// - no float atomics anywhere: float sums reduce in a fixed order, so a
//   kernel gives bit-identical results from run to run.
#pragma once

#include <cmath>
#include <cstdint>

#ifndef TINYSQL_EMU
#include <cuda_runtime.h>
#define LAUNCH(k, g, b, smem, st, ...) k<<<(g), (b), (smem), (st)>>>(__VA_ARGS__)
#define DYN_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
#endif

#define TS_API extern "C" __attribute__((visibility("default")))

// Kinds and ops of a reduction lane (HK1 and HK2 share the lane contract).
enum LaneKind { KIND_I64 = 0, KIND_F64 = 1 };
enum LaneOp { OP_SUM = 0, OP_MIN = 1, OP_MAX = 2, OP_COUNT = 3 };

constexpr int kMaxLanes = 16;

// One launch reduces up to kMaxLanes lanes; passed BY VALUE as a kernel
// parameter so no device-side pointer table is needed.
struct Lanes {
  const void* vals[kMaxLanes];      // int64* or double*; null for OP_COUNT
  const uint8_t* nulls[kMaxLanes];  // null = lane has no NULLs
  int kind[kMaxLanes];
  int op[kMaxLanes];
  int n;
};

// The batched entry points (K12's stacked rounds) run B members of one
// program over shared data in one launch: member b's lane j starts at
// vals[j] + b * v[j] (elements) and nulls[j] + b * nl[j] (bytes); a
// stride of 0 shares the lane between members.  A solo launch is the
// batched one with B = 1 and all strides 0.
struct LaneStrides {
  int64_t v[kMaxLanes];
  int64_t nl[kMaxLanes];
};

namespace {

constexpr int64_t kI64Max = 0x7fffffffffffffffLL;
constexpr int64_t kI64Min = -kI64Max - 1;
constexpr unsigned long long kSign = 0x8000000000000000ULL;

__device__ __forceinline__ double bits_to_f64(int64_t b) {
  return __longlong_as_double(b);
}
__device__ __forceinline__ int64_t f64_to_bits(double d) {
  return __double_as_longlong(d);
}

// float64 -> int64 whose SIGNED order is the float order (-0.0 < +0.0;
// positive NaN above +inf).  Used for order-independent (hence
// deterministic) min/max through integer atomics.
__device__ __forceinline__ int64_t f64_order_key(double d) {
  int64_t b = f64_to_bits(d);
  return b < 0 ? (b ^ kI64Max) : b;
}
__device__ __forceinline__ double f64_from_order_key(int64_t k) {
  return bits_to_f64(k < 0 ? (k ^ kI64Max) : k);
}

__device__ __forceinline__ bool is_nan_f64(double d) { return d != d; }

// Lane j of member b (LaneStrides).
__device__ __forceinline__ const void* member_vals(const Lanes& L,
                                                   const LaneStrides& S,
                                                   int j, int64_t b) {
  return L.vals[j] ? (const void*)((const int64_t*)L.vals[j] + b * S.v[j])
                   : nullptr;
}
__device__ __forceinline__ const uint8_t* member_nulls(const Lanes& L,
                                                       const LaneStrides& S,
                                                       int j, int64_t b) {
  return L.nulls[j] ? L.nulls[j] + b * S.nl[j] : nullptr;
}
// Every lane of member b, as a solo launch would see them.
__device__ __forceinline__ Lanes member_lanes(const Lanes& L,
                                              const LaneStrides& S,
                                              int64_t b) {
  Lanes m = L;
  for (int j = 0; j < L.n; ++j) {
    m.vals[j] = member_vals(L, S, j, b);
    m.nulls[j] = member_nulls(L, S, j, b);
  }
  return m;
}

constexpr unsigned kFull = 0xffffffffu;  // every lane of a warp

// A decoupled look-back's status word (HK3's pick, HK2's compaction,
// HK9, the radix passes of lex_sort.cuh): one 64-bit load / store through
// L2, so a flag and its count are seen together.
__device__ __forceinline__ unsigned long long lb_load(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}
__device__ __forceinline__ void lb_store(unsigned long long* p,
                                         unsigned long long v) {
  *(volatile unsigned long long*)p = v;
}

// look_back's words: flag in the top two bits, the count below (0: not
// yet published)
constexpr unsigned long long kFlagA = 1ULL << 62;  // the tile's own count
constexpr unsigned long long kFlagP = 2ULL << 62;  // inclusive prefix
constexpr unsigned long long kValue = kFlagA - 1;

// The single-pass exclusive scan of per-tile counts (HK3's ej_pick, HK2's
// present_pass, HK9's rb_pass).  Tiles are numbered in the order blocks
// claim them from an atomic counter, so every earlier tile belongs to a
// block that already runs and the wait below cannot deadlock.  Warp 0 of
// tile `tile`: publish the tile's count, walk back over the earlier
// tiles 32 at a time until an inclusive prefix, publish this tile's.
// Returns the tile's exclusive prefix to every lane.  `status` holds one
// word a tile, zeroed before the launch.
__device__ int64_t look_back(unsigned long long* status, int64_t tile,
                             int64_t agg) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) lb_store(&status[0], kFlagP | (unsigned long long)agg);
    return 0;
  }
  if (lane == 0) lb_store(&status[tile], kFlagA | (unsigned long long)agg);
  int64_t prefix = 0;
  for (int64_t idx = tile - 1;; idx -= 32) {
    const int64_t p = idx - lane;  // lane 0: the nearest earlier tile
    unsigned long long s = kFlagP;  // before tile 0: a prefix of 0
    if (p >= 0) {
      do {
        s = lb_load(&status[p]);
      } while ((s >> 62) == 0);
    }
    const unsigned pm = __ballot_sync(kFull, (s >> 62) == 2);
    const int stop = pm ? __ffs(pm) - 1 : 31;  // the nearest prefix
    int64_t x = lane <= stop ? (int64_t)(s & kValue) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x += (int64_t)__shfl_xor_sync(kFull, (long long)x, o);
    prefix += x;
    if (pm) break;
  }
  if (lane == 0)
    lb_store(&status[tile], kFlagP | (unsigned long long)(prefix + agg));
  return prefix;
}

// int64 sum with two's-complement wrap (no signed-overflow UB).
__device__ __forceinline__ int64_t wrap_add(int64_t a, int64_t b) {
  return (int64_t)((unsigned long long)a + (unsigned long long)b);
}

__device__ __forceinline__ void atomic_add_i64(int64_t* p, int64_t v) {
  atomicAdd((unsigned long long*)p, (unsigned long long)v);
}
__device__ __forceinline__ void atomic_min_i64(int64_t* p, int64_t v) {
  atomicMin((long long*)p, (long long)v);
}
__device__ __forceinline__ void atomic_max_i64(int64_t* p, int64_t v) {
  atomicMax((long long*)p, (long long)v);
}

// ---- exclusive scan of int64 counts -----------------------------------
// Three launches: per-block totals, one block scanning the block totals,
// then a per-block shared-memory scan that hands every element its
// exclusive prefix.  Deterministic (integer, fixed order).  S is a functor
// struct with __device__ `int64_t count(int64_t i) const` and
// `void write(int64_t i, int64_t excl, int64_t v) const` (write is called
// for every i < n; no extended lambdas needed).

constexpr int kScanThreads = 1024;

template <class S>
__global__ void scan_block_totals(S sc, int64_t n, int64_t* btot) {
  __shared__ int64_t s[kScanThreads];
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  s[threadIdx.x] = i < n ? sc.count(i) : 0;
  __syncthreads();
  for (int st = blockDim.x >> 1; st > 0; st >>= 1) {
    if ((int)threadIdx.x < st) s[threadIdx.x] += s[threadIdx.x + st];
    __syncthreads();
  }
  if (threadIdx.x == 0) btot[blockIdx.x] = s[0];
}

// Exclusive scan of bt[0, nb) in place by the calling block of
// kScanThreads threads, one chunk of kScanThreads entries after another;
// returns the total to every thread.  Integer adds: exact in any order.
__device__ int64_t block_scan_totals(int64_t* bt, int64_t nb) {
  __shared__ int64_t s[2][kScanThreads];
  const int t = threadIdx.x;
  int64_t carry = 0;
  for (int64_t c0 = 0; c0 < nb; c0 += blockDim.x) {
    const int64_t k = c0 + t;
    const int64_t v = k < nb ? bt[k] : 0;
    int cur = 0;
    s[cur][t] = v;
    __syncthreads();
    for (int off = 1; off < (int)blockDim.x; off <<= 1) {
      int64_t x = s[cur][t];
      if (t >= off) x += s[cur][t - off];
      s[cur ^ 1][t] = x;
      cur ^= 1;
      __syncthreads();
    }
    if (k < nb) bt[k] = carry + s[cur][t] - v;
    carry += s[cur][blockDim.x - 1];
    __syncthreads();  // every thread has read the chunk's total
  }
  return carry;
}

// exclusive scan of the block totals in place (one block of
// kScanThreads threads); grand total -> *total
__global__ void scan_totals(int64_t* btot, int64_t nb, int64_t* total) {
  const int64_t run = block_scan_totals(btot, nb);
  if (threadIdx.x == 0) *total = run;
}

template <class S>
__global__ void scan_apply(S sc, int64_t n, const int64_t* boff) {
  __shared__ int64_t s[2][kScanThreads];
  const int t = threadIdx.x;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + t;
  int64_t v = i < n ? sc.count(i) : 0;
  int cur = 0;
  s[cur][t] = v;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {
    int64_t x = s[cur][t];
    if (t >= off) x += s[cur][t - off];
    s[cur ^ 1][t] = x;
    cur ^= 1;
    __syncthreads();
  }
  if (i < n) sc.write(i, boff[blockIdx.x] + s[cur][t] - v, v);
}

inline int64_t scan_nblocks(int64_t n) {
  return n <= 0 ? 1 : (n + kScanThreads - 1) / kScanThreads;
}

// Launch the three scan kernels.  `btot` needs scan_nblocks(n) int64s,
// `total` one int64.
template <class S>
void launch_scan(const S& sc, int64_t n, int64_t* btot, int64_t* total,
                 cudaStream_t st) {
  int64_t nb = scan_nblocks(n);
  LAUNCH(scan_block_totals<S>, (unsigned)nb, kScanThreads, 0, st, sc, n,
         btot);
  LAUNCH(scan_totals, 1, kScanThreads, 0, st, btot, nb, total);
  LAUNCH(scan_apply<S>, (unsigned)nb, kScanThreads, 0, st, sc, n,
         (const int64_t*)btot);
}

inline int64_t align16(int64_t b) { return (b + 15) & ~(int64_t)15; }

inline unsigned grid_for(int64_t n, int threads, int64_t cap = 65535) {
  int64_t g = (n + threads - 1) / threads;
  if (g < 1) g = 1;
  if (g > cap) g = cap;
  return (unsigned)g;
}

}  // namespace
