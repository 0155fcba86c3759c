// HK13 shard_exchange: the mesh tier's all-to-all of rows by key hash.
//
// Replaces what tinysql_tpu/parallel/dist.py:251 hash_dest_traced, :270
// exchange_lanes and lax.all_to_all(tiled=True) compute together inside
// the shuffle join's shard_map (executor/devpipe.py:1315
// _prepare_unique_shuffle, K18 shuffle / K26).  The mesh is n virtual
// shards on one card: source shard s owns rows [s * m, (s + 1) * m) of
// every lane (m = nb / n).  Every row g gets a destination
//   d = ((key * HASH_GOLDEN) >> 33) & (n - 1)   (int64 wrap-around)
// for g < n_rows, and g % n for a padding row, and a rank: its place
// among the rows of source s with destination d, in row order (stable).
// Lane values land at out[d][s][rank] (flat (d * n + s) * cap + rank), and
// every other slot holds the lane's fill: exactly the lanes shard d
// receives from the reference's exchange, slot for slot.
//
// Bound: bytes.  The key lane is read twice (histogram, rank), the slot
// lane written once and read once per launch of lanes, each input lane
// read once and each output slot written once (by the scatter or by the
// fill, never both).
//
// Design, all integer and without a global atomic, so the output is the
// same bytes from run to run:
//   1. ex_hist: one block per (source shard, tile of kTile rows) counts
//      its destinations in shared memory;
//   2. ex_scan: one warp per (source, destination) scans the counts over
//      the tiles: each tile's first rank, and the pair's total, which
//      must fit cap (else the error word is set: the host bounds cap
//      exactly, so no row is ever dropped silently);
//   3. ex_rank: the block of a tile walks its rows in rounds of 256;
//      __match_any_sync groups a warp's lanes by destination, so a row's
//      rank is the tile's running count of its destination + the rows of
//      that destination in earlier warps of the round + the lower lanes of
//      its own warp; the row's output slot goes to the slot lane;
//   4. ex_fill and ex_scatter per up to kMaxLanes lanes.
#include "common.cuh"

// Lanes of one exchange, passed by value: element width 1, 2, 4 or 8 and
// the fill of the slots no row reaches (its low bytes).
struct ExchangeLanes {
  const void* vals[kMaxLanes];
  void* outs[kMaxLanes];
  int64_t fill[kMaxLanes];
  int width[kMaxLanes];
  int n;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 8;
constexpr int64_t kTile = (int64_t)kThreads * kRounds;
constexpr int kMaxShards = 1024;
constexpr unsigned long long kGolden = 0x9E3779B97F4A7C15ULL;

__device__ __forceinline__ int dest_of(const int64_t* keys, int64_t g,
                                       int64_t n_rows, int n) {
  if (g >= n_rows) return (int)(g & (n - 1));
  const unsigned long long h = (unsigned long long)keys[g] * kGolden;
  return (int)((h >> 33) & (unsigned long long)(n - 1));
}

inline int64_t tiles_of(int64_t m) { return (m + kTile - 1) / kTile; }

// block (s, t): counts[(s * n + d) * tiles + t]
__global__ void ex_hist(const int64_t* __restrict__ keys, int64_t m,
                        int64_t tiles, int64_t n_rows, int n,
                        int64_t* __restrict__ counts) {
  DYN_SMEM(sm);
  int* cnt = (int*)sm;
  const int64_t s = blockIdx.x / tiles, t = blockIdx.x % tiles;
  for (int d = threadIdx.x; d < n; d += blockDim.x) cnt[d] = 0;
  __syncthreads();
  const int64_t r0 = t * kTile;
  const int64_t r1 = r0 + kTile < m ? r0 + kTile : m;
  for (int64_t r = r0 + threadIdx.x; r < r1; r += blockDim.x)
    atomicAdd(&cnt[dest_of(keys, s * m + r, n_rows, n)], 1);
  __syncthreads();
  for (int d = threadIdx.x; d < n; d += blockDim.x)
    counts[(s * n + d) * tiles + t] = cnt[d];
}

// one warp per (s, d) pair: exclusive scan over the tiles in place; the
// pair's total -> total[s * n + d]; a total past cap sets *err
__global__ void ex_scan(int64_t* __restrict__ counts, int64_t tiles,
                        int64_t pairs, int64_t cap,
                        int64_t* __restrict__ total,
                        int64_t* __restrict__ err) {
  const int lane = threadIdx.x & 31;
  const int64_t p = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (p >= pairs) return;
  int64_t* c = counts + p * tiles;
  int64_t carry = 0;
  for (int64_t t0 = 0; t0 < tiles; t0 += 32) {
    const int64_t t = t0 + lane;
    const int64_t v = t < tiles ? c[t] : 0;
    int64_t x = v;
    for (int off = 1; off < 32; off <<= 1) {
      const int64_t y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (t < tiles) c[t] = carry + x - v;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) {
    total[p] = carry;
    if (carry > cap) *err = 1;
  }
}

// block (s, t): each row's output slot (-1 past cap)
__global__ void ex_rank(const int64_t* __restrict__ keys, int64_t m,
                        int64_t tiles, int64_t n_rows, int n, int64_t cap,
                        const int64_t* __restrict__ offs,
                        int64_t* __restrict__ slot) {
  DYN_SMEM(sm);
  int64_t* run = (int64_t*)sm;           // [n] the tile's next rank
  int* wcnt = (int*)(run + n);           // [kWarps][n]
  const int64_t s = blockIdx.x / tiles, t = blockIdx.x % tiles;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int d = threadIdx.x; d < n; d += blockDim.x) {
    run[d] = offs[(s * n + d) * tiles + t];
    for (int k = 0; k < kWarps; ++k) wcnt[k * n + d] = 0;
  }
  __syncthreads();
  const unsigned lower = (1u << lane) - 1u;
  for (int rnd = 0; rnd < kRounds; ++rnd) {
    const int64_t r = t * kTile + (int64_t)rnd * kThreads + threadIdx.x;
    const bool live = r < m && r < (t + 1) * kTile;
    const int d = live ? dest_of(keys, s * m + r, n_rows, n) : -1;
    const unsigned same = __match_any_sync(0xffffffffu, d);
    if (live && (same & lower) == 0) wcnt[w * n + d] = __popc(same);
    __syncthreads();
    if (live) {
      int64_t rank = run[d] + __popc(same & lower);
      for (int k = 0; k < w; ++k) rank += wcnt[k * n + d];
      slot[s * m + r] = rank < cap ? ((int64_t)d * n + s) * cap + rank : -1;
    }
    __syncthreads();
    for (int d2 = threadIdx.x; d2 < n; d2 += blockDim.x) {
      int64_t add = 0;
      for (int k = 0; k < kWarps; ++k) {
        add += wcnt[k * n + d2];
        wcnt[k * n + d2] = 0;
      }
      run[d2] += add;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void put_elem(void* dst, int64_t j, int w,
                                         const void* src, int64_t i) {
  if (w == 8) ((int64_t*)dst)[j] = ((const int64_t*)src)[i];
  else if (w == 4) ((int32_t*)dst)[j] = ((const int32_t*)src)[i];
  else if (w == 2) ((int16_t*)dst)[j] = ((const int16_t*)src)[i];
  else ((uint8_t*)dst)[j] = ((const uint8_t*)src)[i];
}

__device__ __forceinline__ void put_fill(void* dst, int64_t j, int w,
                                         int64_t f) {
  if (w == 8) ((int64_t*)dst)[j] = f;
  else if (w == 4) ((int32_t*)dst)[j] = (int32_t)f;
  else if (w == 2) ((int16_t*)dst)[j] = (int16_t)f;
  else ((uint8_t*)dst)[j] = (uint8_t)f;
}

// the slots of (d, s) at or past that pair's total
__global__ void ex_fill(ExchangeLanes L, const int64_t* __restrict__ total,
                        int n, int64_t cap) {
  const int64_t n_slots = (int64_t)n * n * cap;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       j < n_slots; j += stride) {
    const int64_t ds = j / cap, rank = j - ds * cap;
    const int64_t d = ds / n, s = ds - d * n;
    if (rank < total[s * n + d]) continue;
    for (int l = 0; l < L.n; ++l) put_fill(L.outs[l], j, L.width[l], L.fill[l]);
  }
}

__global__ void ex_scatter(ExchangeLanes L, const int64_t* __restrict__ slot,
                           int64_t nb) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nb;
       i += stride) {
    const int64_t j = slot[i];
    if (j < 0) continue;
    for (int l = 0; l < L.n; ++l) put_elem(L.outs[l], j, L.width[l], L.vals[l], i);
  }
}

}  // namespace

// int64 scratch of a plan: slot[nb], counts[n * n * tiles], total[n * n],
// the error word
TS_API int64_t hk13_scratch_words(int64_t nb, int n) {
  if (n < 2 || nb < n) return -1;
  return nb + (int64_t)n * n * tiles_of(nb / n) + (int64_t)n * n + 1;
}

// keys: int64[nb] (nb = n * m); n a power of two in [2, kMaxShards].
// Writes slot[i] (flat output index, -1 past cap), total[s * n + d] and the
// error word (1 when a (source, destination) pair holds more than cap).
TS_API int hk13_exchange_plan(const int64_t* keys, int64_t nb, int64_t n_rows,
                              int n, int64_t cap, int64_t* scratch,
                              cudaStream_t st) {
  if (n < 2 || n > kMaxShards || (n & (n - 1)) || nb < n || nb % n ||
      cap < 1)
    return -1;
  const int64_t m = nb / n, tiles = tiles_of(m);
  int64_t* slot = scratch;
  int64_t* counts = slot + nb;
  int64_t* total = counts + (int64_t)n * n * tiles;
  int64_t* err = total + (int64_t)n * n;
  cudaMemsetAsync(err, 0, sizeof(int64_t), st);
  const int64_t blocks = (int64_t)n * tiles;
  if (blocks > 0x7fffffffLL) return -1;
  LAUNCH(ex_hist, (unsigned)blocks, kThreads, n * sizeof(int), st, keys, m,
         tiles, n_rows, n, counts);
  const int64_t pairs = (int64_t)n * n;
  LAUNCH(ex_scan, grid_for(pairs * 32, kThreads), kThreads, 0, st, counts,
         tiles, pairs, cap, total, err);
  LAUNCH(ex_rank, (unsigned)blocks, kThreads,
         n * (sizeof(int64_t) + kWarps * sizeof(int)), st, keys, m, tiles,
         n_rows, n, cap, (const int64_t*)counts, slot);
  return (int)cudaGetLastError();
}

// The lanes of one plan: every output slot of [n][n][cap] written once.
TS_API int hk13_exchange_lanes(const int64_t* scratch, int64_t nb, int n,
                               int64_t cap, const ExchangeLanes* lanes,
                               cudaStream_t st) {
  if (n < 2 || nb < n || nb % n || cap < 1 || lanes->n < 1 ||
      lanes->n > kMaxLanes)
    return -1;
  for (int l = 0; l < lanes->n; ++l) {
    const int w = lanes->width[l];
    if (w != 1 && w != 2 && w != 4 && w != 8) return -1;
  }
  const int64_t tiles = tiles_of(nb / n);
  const int64_t* slot = scratch;
  const int64_t* total = slot + nb + (int64_t)n * n * tiles;
  const int64_t n_slots = (int64_t)n * n * cap;
  LAUNCH(ex_fill, grid_for(n_slots, kThreads, 1 << 16), kThreads, 0, st,
         *lanes, total, n, cap);
  LAUNCH(ex_scatter, grid_for(nb, kThreads, 1 << 16), kThreads, 0, st,
         *lanes, slot, nb);
  return (int)cudaGetLastError();
}
