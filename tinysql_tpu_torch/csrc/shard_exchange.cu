// HK13 shard_exchange: the mesh tier's all-to-all of rows by key hash
// (exchange mode) and K25's hash partition of one input side (partition
// mode).  Both are one stable scatter of rows into per-destination runs.
//
// Exchange mode replaces what tinysql_tpu/parallel/dist.py:251
// hash_dest_traced, :270 exchange_lanes and lax.all_to_all(tiled=True)
// compute together inside the shuffle join's shard_map
// (executor/devpipe.py:1315 _prepare_unique_shuffle, K18 shuffle / K26).
// The mesh is n virtual shards on one card: source shard s owns rows
// [s * m, (s + 1) * m) of every lane (m = nb / n).  Every row g gets a
// destination
//   d = ((key * HASH_GOLDEN) >> 33) & (n - 1)   (int64 wrap-around)
// for g < n_rows, and g % n for a padding row, and a rank: its place
// among the rows of source s with destination d, in row order (stable).
// Lane values land at out[d][s][rank] (flat (d * n + s) * cap + rank), and
// every other slot holds the lane's fill: exactly the lanes shard d
// receives from the reference's exchange, slot for slot.  A pair over
// cap sets the error word (the wrapper raises; no row is dropped
// silently).
//
// Partition mode replaces tinysql_tpu/ops/shardops.py:204 _Partitioned
// (K25's join and member modes: the host's numpy hash partition, stable
// argsort and scatter of each side).  One source, a live byte mask (a
// dead row takes no slot), the destination splitmix64 of the key's raw
// 64 bits from the spill partitioner's depth-0 seed (float64 keys: -0.0
// as +0.0, a NaN keeps its bits), & (n - 1); two lanes, the key (fill 0)
// and the row's index (fill -1), into flat [n][cap] blocks, each live row
// at its stable rank among the live rows of its destination.  A count
// call gives the per-destination totals first: the host sets cap from
// them with its one pull, then the scatter call writes the blocks.
//
// Bound: bytes.  Each input lane read once (the keys twice: plan and
// scatter, or count and scatter), each output slot written once: a
// reached slot by the pass, an unreached one by the fill.
//
// Design, all integer, and the one global atomic hands out tile numbers
// (the order it hands them in reaches no output byte), so the output is
// the same bytes from run to run:
//   ex_pass: a block takes a tile of kThreads * rounds rows of one source
//     (rounds = kRounds, or fewer where the grid would be small).  Warp w
//     ranks its 32 * rounds contiguous rows in rounds of 32 (every key
//     load issued first, with the first lane's values; a ballot a
//     destination bit groups a round's lanes by destination; the warp's
//     running counts sit in shared memory).  One barrier pair turns the
//     per-warp counts into each row's place in the tile reordered by
//     destination (a counting sort in shared memory); each thread then
//     holds the output slots of its places in registers.
//     The tile's base in each (source, destination) run comes from a
//     decoupled look-back over its source's tiles (common.cuh look_back,
//     one warp a destination: exchange mode, n <= kLookShards), or from
//     the inclusive prefixes ex_scan left (n above, the partition's
//     scatter call, the lanes past the first kMaxLanes).  Each lane is
//     then staged in shared memory in that order (two buffers: one
//     barrier a lane; the next lanes' loads in flight meanwhile, eight
//     values a thread) and written as one contiguous run per destination.
//     No row's slot reaches device memory.
//   ex_pass's counting mode (the partition's count call; the exchange
//     for n > kLookShards) skips the ranking: a thread takes consecutive
//     rows (16-byte key loads, one live word), one shared add a
//     destination a warp round, the tile's counts to pre; ex_scan then
//     turns them into inclusive prefixes and totals, a warp a (source,
//     destination) pair for few tiles, a block for many (a thread a run
//     of consecutive tiles).  A look-back
//     over one source's thousands of tiles would chain: its prefixes
//     advance about 32 tiles an L2 round trip.
//   ex_fill: each pair's tail [total, cap) per lane, as 16-byte stores of
//     the lane's fill where alignment allows: a block a lane and a
//     kFillBytes chunk of a pair.
// Launches: exchange mode a memset, ex_pass, ex_fill (n <= kLookShards,
// <= kMaxLanes lanes; each further kMaxLanes lanes adds an ex_pass and an
// ex_fill); the partition's count call ex_pass and ex_scan, its scatter
// call ex_pass and ex_fill.
#include "common.cuh"

// Lanes of one exchange, passed by value: element width 1, 2, 4 or 8 and
// the fill of the slots no row reaches (its low bytes).  A null `vals`
// is the row index lane (int64 g).
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
constexpr int kRounds = 8;  // the most rows a thread takes a tile
// a call's tile takes fewer rounds while its grid would hold fewer
// blocks than kFewBlocks (three an SM), down to one round a thread
constexpr int64_t kFewBlocks = 3 * 132;
// ex_scan takes a block a pair from this many tiles a source on
constexpr int64_t kBlockScanTiles = 64;
constexpr int kMaxShards = 1024;
constexpr int kLookShards = 64;
constexpr int64_t kFillBytes = 32768;  // bytes of one lane a fill block takes
constexpr unsigned long long kGolden = 0x9E3779B97F4A7C15ULL;
// splitmix64 (tinysql_tpu/ops/spill.py hash_partition at depth 0)
constexpr unsigned long long kSeed0 = 0x9E3779B97F4A7C15ULL;
constexpr unsigned long long kMix1 = 0xBF58476D1CE4E5B9ULL;
constexpr unsigned long long kMix2 = 0x94D049BB133111EBULL;

enum PassMode {
  M_HIST = 0,          // per-tile counts into pre (ex_scan follows)
  M_LOOK_SCATTER = 1,  // the look-back (pre, totals, error), the lanes
  M_SCATTER = 2,       // bases from pre's inclusive prefixes, the lanes
};

struct PassArgs {
  const int64_t* keys;
  const uint8_t* live;  // partition mode's live mask; null: exchange mode
  int64_t m;            // rows a source
  int64_t tiles;        // tiles a source
  int rounds;           // rows a thread a tile (kThreads * rounds a tile)
  int64_t n_rows;       // exchange mode: keyed rows (the rest padding)
  int64_t cap;
  unsigned long long* pre;  // [(s * n + d) * tiles + t]
  int64_t* totals;          // [s * n + d]
  int64_t* err;
  unsigned long long* ctr;  // the tile counter (look-back modes)
  int n;                    // destinations
  int bits;                 // log2(n)
  int n_src;                // sources: n (exchange), 1 (partition)
  int is_float;             // partition mode: float64 keys
};

// rounds a tile for sources of m rows: the same for a call's plan and
// every later call on its scratch (both derive it from m and n_src)
inline int rounds_for(int64_t m, int n_src) {
  int r = kRounds;
  while (r > 1 && n_src * ((m + kThreads * r - 1) / (kThreads * r)) <
                      kFewBlocks)
    r >>= 1;
  return r;
}

inline int64_t tiles_of(int64_t m, int n_src) {
  const int64_t rows = (int64_t)kThreads * rounds_for(m, n_src);
  return (m + rows - 1) / rows;
}

// row g's destination from its key bits u and live byte
__device__ __forceinline__ int dest_from(const PassArgs& A, int64_t g,
                                         unsigned long long u, bool live) {
  if (A.live) {
    if (!live) return -1;
    if (A.is_float && u == kSign) u = 0;  // -0.0 hashes as +0.0
    u += kSeed0;
    u ^= u >> 30;
    u *= kMix1;
    u ^= u >> 27;
    u *= kMix2;
    u ^= u >> 31;
    return (int)(u & (unsigned long long)(A.n - 1));
  }
  if (g >= A.n_rows) return (int)(g & (A.n - 1));
  return (int)(((u * kGolden) >> 33) & (unsigned long long)(A.n - 1));
}

__device__ __forceinline__ int dest_of(const PassArgs& A, int64_t g) {
  // the key and its live byte loaded together
  return dest_from(A, g, (unsigned long long)A.keys[g],
                   !A.live || A.live[g]);
}

// The lanes of the warp whose destination equals this lane's: a ballot
// for liveness and one a destination bit (CUB's MatchAny; cheaper than
// __match_any_sync).  A dead lane (d < 0) gets the dead lanes.
__device__ __forceinline__ unsigned peers_of(int d, int bits) {
  const unsigned live = __ballot_sync(kFull, d >= 0);
  unsigned m = live;
  for (int b = 0; b < bits; ++b) {  // every lane votes (bits is uniform)
    const unsigned x = __ballot_sync(kFull, (d >> b) & 1);
    m &= (d >> b) & 1 ? x : ~x;
  }
  return d >= 0 ? m : ~live;
}

// The destinations of rows [g, g + R) (all inside the source): 16-byte
// key loads and one live word where the pointers allow.
template <int R>
__device__ __forceinline__ void dests_run(const PassArgs& A, int64_t g,
                                          int (&d)[R]) {
  unsigned long long u[R];
  bool lv[R];
  const bool vk = R % 2 == 0 && ((uintptr_t)(A.keys + g) & 15) == 0;
  if (vk) {
#pragma unroll
    for (int k = 0; k < R; k += 2) {
      const ulonglong2 x = *(const ulonglong2*)(A.keys + g + k);
      u[k] = x.x;
      u[k + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) u[k] = (unsigned long long)A.keys[g + k];
  }
  if (A.live && R == 8 && ((uintptr_t)(A.live + g) & 7) == 0) {
    const unsigned long long b = *(const unsigned long long*)(A.live + g);
#pragma unroll
    for (int k = 0; k < R; ++k) lv[k] = (b >> (8 * k)) & 0xff;
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) lv[k] = !A.live || A.live[g + k];
  }
#pragma unroll
  for (int k = 0; k < R; ++k) d[k] = dest_from(A, g + k, u[k], lv[k]);
}

__device__ __forceinline__ unsigned long long get_elem(const void* src,
                                                       int64_t i, int w) {
  if (w == 8) return (unsigned long long)((const int64_t*)src)[i];
  if (w == 4) return (unsigned long long)((const uint32_t*)src)[i];
  if (w == 2) return (unsigned long long)((const uint16_t*)src)[i];
  return (unsigned long long)((const uint8_t*)src)[i];
}

__device__ __forceinline__ void put_elem(void* dst, int64_t j, int w,
                                         unsigned long long v) {
  if (w == 8) ((unsigned long long*)dst)[j] = v;
  else if (w == 4) ((uint32_t*)dst)[j] = (uint32_t)v;
  else if (w == 2) ((uint16_t*)dst)[j] = (uint16_t)v;
  else ((uint8_t*)dst)[j] = (uint8_t)v;
}

// lane j's values of a thread's rows (its row index for a null lane)
template <int R>
__device__ __forceinline__ void load_lane(const ExchangeLanes& L, int j,
                                          int64_t g0, const int (&d)[R],
                                          unsigned long long (&v)[R]) {
  const void* src = L.vals[j];
  const int wd = L.width[j];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int64_t g = g0 + k * 32;
    v[k] = d[k] < 0 ? 0 : src ? get_elem(src, g, wd) : (unsigned long long)g;
  }
}

inline size_t pass_smem(int n, bool scatter, int rounds) {
  // scatter: base[n] int64, stage[2][tile], wcnt[kWarps][n], cnt[n],
  // loff[n] int, sdest[tile] uint16; counts: cnt[n]
  const size_t tile = (size_t)kThreads * rounds;
  return scatter ? (size_t)n * 8 + 16 * tile + (size_t)(kWarps + 2) * n * 4 +
                       2 * tile
                 : (size_t)n * 4;
}

template <int kMode, int R>
__global__ void __launch_bounds__(kThreads, 4)
    ex_pass(PassArgs A, ExchangeLanes L) {
  constexpr bool kLook = kMode == M_LOOK_SCATTER;
  constexpr bool kScat = kMode != M_HIST;
  constexpr int P = kRounds / R;  // lanes whose loads are in flight at once
  constexpr int tile_rows = kThreads * R;
  DYN_SMEM(sm);
  __shared__ int64_t s_tile;
  __shared__ int s_wsum[kWarps];
  const int n = A.n;
  int64_t* base = (int64_t*)sm;
  unsigned long long* stage = (unsigned long long*)(base + n);
  int* wcnt = (int*)(stage + 2 * tile_rows);
  int* cnt = kScat ? wcnt + kWarps * n : (int*)sm;
  int* loff = cnt + n;
  uint16_t* sdest = (uint16_t*)(loff + n);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  if (kLook && tid == 0) s_tile = (int64_t)atomicAdd(A.ctr, 1ULL);
  if (kScat)
    for (int i = tid; i < kWarps * n; i += kThreads) wcnt[i] = 0;
  else
    for (int i = tid; i < n; i += kThreads) cnt[i] = 0;
  __syncthreads();
  const int64_t tile = kLook ? s_tile : (int64_t)blockIdx.x;
  const int64_t s = tile / A.tiles, t = tile - s * A.tiles;
  const int64_t row0 = s * A.m + t * tile_rows;  // the tile's first row
  const int64_t rows =
      A.m - t * tile_rows < tile_rows ? A.m - t * tile_rows : tile_rows;
  const int wrow = w * 32 * R;  // warp w's rows: [wrow, wrow + 32 * R)
  const int64_t g0 = row0 + wrow + lane;  // the thread's first row
  int d[R];
  if (!kScat && (tid + 1) * R <= rows) {
    // counting needs no row order: a thread takes R consecutive rows
    dests_run<R>(A, row0 + tid * R, d);
  } else if (!kScat) {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int r = tid * R + k;
      d[k] = r < rows ? dest_of(A, row0 + r) : -1;
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) {  // every load first
      const int r = wrow + k * 32 + lane;
      d[k] = r < rows ? dest_of(A, row0 + r) : -1;
    }
  }
  unsigned long long v[P][R];  // the values of the lanes in flight
  if (kScat) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (j < L.n) load_lane<R>(L, j, g0, d, v[j]);
  }
  const unsigned lower = (1u << lane) - 1u;
  if (!kScat) {
    // counts only: one shared add a destination a round (integer adds:
    // the same counts in any order)
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const unsigned peers = peers_of(d[k], A.bits);
      if (d[k] >= 0 && (peers & lower) == 0)
        atomicAdd(&cnt[d[k]], __popc(peers));
    }
    __syncthreads();
    for (int dd = tid; dd < n; dd += kThreads)
      A.pre[(s * n + dd) * A.tiles + t] = (unsigned long long)cnt[dd];
    return;
  }
  int pos[R];  // the row's place in the tile reordered by destination
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const unsigned peers = peers_of(d[k], A.bits);
    const int before = d[k] >= 0 ? wcnt[w * n + d[k]] : 0;
    __syncwarp();
    if (d[k] >= 0 && (peers & lower) == 0)
      wcnt[w * n + d[k]] = before + __popc(peers);
    __syncwarp();
    pos[k] = before + __popc(peers & lower);
  }
  __syncthreads();
  // per destination: each warp's exclusive offset and the tile's count;
  // then the exclusive scan of the counts over the destinations (a thread
  // owns a run of `per` consecutive destinations)
  const int per = (n + kThreads - 1) / kThreads;
  const int d0 = tid * per < n ? tid * per : n;
  const int d1 = d0 + per < n ? d0 + per : n;
  int mine = 0;
  for (int dd = d0; dd < d1; ++dd) {
    int run = 0;
    for (int k = 0; k < kWarps; ++k) {
      const int c = wcnt[k * n + dd];
      wcnt[k * n + dd] = run;
      run += c;
    }
    cnt[dd] = run;
    mine += run;
  }
  int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_wsum[w] = incl;
  __syncthreads();
  int excl = incl - mine, n_live = 0;
  for (int k = 0; k < kWarps; ++k) {
    if (k < w) excl += s_wsum[k];
    n_live += s_wsum[k];
  }
  for (int dd = d0; dd < d1; ++dd) {
    loff[dd] = excl;
    excl += cnt[dd];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < R; ++k) {
    if (d[k] >= 0) {
      pos[k] += loff[d[k]] + wcnt[w * n + d[k]];
      sdest[pos[k]] = (uint16_t)d[k];
    } else {
      pos[k] = -1;  // a dead row: no place, no load
    }
  }
  if (kLook) {
    for (int dd = w; dd < n; dd += kWarps) {
      const int64_t prefix = look_back(A.pre + (s * n + dd) * A.tiles, t,
                                       cnt[dd]);
      if (lane == 0) {
        base[dd] = prefix;
        if (t == A.tiles - 1) {
          const int64_t total = prefix + cnt[dd];
          A.totals[s * n + dd] = total;
          if (total > A.cap) *A.err = 1;
        }
      }
    }
  } else {
    for (int dd = d0; dd < d1; ++dd)
      base[dd] = (int64_t)(A.pre[(s * n + dd) * A.tiles + t] & kValue) -
                 cnt[dd];
  }
  __syncthreads();
  // place p = tid + i * kThreads of the reordered tile goes to slot[i] of
  // every lane (-1: no row there, or past cap)
  int64_t slot[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int p = tid + i * kThreads;
    slot[i] = -1;
    if (p < n_live) {
      const int dd = sdest[p];
      const int64_t jj = base[dd] + (p - loff[dd]);
      if (jj < A.cap) slot[i] = ((int64_t)dd * A.n_src + s) * A.cap + jj;
    }
  }
  for (int l0 = 0; l0 < L.n; l0 += P) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int l = l0 + j;
      if (l < L.n) {  // the same for every thread of the block
        unsigned long long* buf = stage + (l & 1) * tile_rows;
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (pos[k] >= 0) buf[pos[k]] = v[j][k];
        // lane l + P's loads fly during this lane's barrier and stores
        if (l + P < L.n) load_lane<R>(L, l + P, g0, pos, v[j]);
        __syncthreads();
        // the other buffer takes the next lane, so the barrier after its
        // staging also orders these reads before this buffer is staged
        // again
        void* out = L.outs[l];
        const int wd = L.width[l];
#pragma unroll
        for (int i = 0; i < R; ++i)
          if (slot[i] >= 0) put_elem(out, slot[i], wd, buf[tid + i * kThreads]);
      }
    }
  }
}

// the inclusive scan of pair p's tile counts in place (the counts of
// M_HIST); its total -> totals[p], a total past cap sets *err.  One warp
// a pair for few tiles a source, one block a pair for many.
__device__ __forceinline__ void pair_done(int64_t p, int64_t total,
                                          int64_t cap, int64_t* totals,
                                          int64_t* err) {
  totals[p] = total;
  if (total > cap) *err = 1;
}

__global__ void ex_scan_warp(unsigned long long* __restrict__ pre,
                             int64_t tiles, int64_t pairs, int64_t cap,
                             int64_t* __restrict__ totals,
                             int64_t* __restrict__ err) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (blockDim.x >> 5);
  for (int64_t p = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       p < pairs; p += warps) {
    unsigned long long* c = pre + p * tiles;
    int64_t carry = 0;
    for (int64_t t0 = 0; t0 < tiles; t0 += 32) {
      const int64_t t = t0 + lane;
      const int64_t v = t < tiles ? (int64_t)c[t] : 0;
      int64_t x = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int64_t y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      if (t < tiles) c[t] = (unsigned long long)(carry + x);
      carry += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) pair_done(p, carry, cap, totals, err);
  }
}

__global__ void __launch_bounds__(kThreads)
    ex_scan_block(unsigned long long* __restrict__ pre, int64_t tiles,
                  int64_t pairs, int64_t cap, int64_t* __restrict__ totals,
                  int64_t* __restrict__ err) {
  // a thread sums a run of `per` consecutive tiles, one block scan of
  // the runs' sums, then each thread rewrites its run as prefixes
  __shared__ int64_t s_w[kWarps];
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int64_t per = (tiles + kThreads - 1) / kThreads;
  const int64_t t0 = tid * per < tiles ? tid * per : tiles;
  const int64_t t1 = t0 + per < tiles ? t0 + per : tiles;
  for (int64_t p = blockIdx.x; p < pairs; p += gridDim.x) {
    unsigned long long* c = pre + p * tiles;
    int64_t mine = 0;
    for (int64_t t = t0; t < t1; ++t) mine += (int64_t)c[t];
    int64_t x = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int64_t y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) s_w[w] = x;
    __syncthreads();
    int64_t run = x - mine, total = 0;
    for (int k = 0; k < kWarps; ++k) {
      if (k < w) run += s_w[k];
      total += s_w[k];
    }
    for (int64_t t = t0; t < t1; ++t) {
      run += (int64_t)c[t];
      c[t] = (unsigned long long)run;
    }
    if (tid == 0) pair_done(p, total, cap, totals, err);
    __syncthreads();  // s_w is read before the next pair writes it
  }
}

// A lane's fill replicated over 16 bytes (elements of width w).
__device__ __forceinline__ uint4 fill16(int64_t f, int w) {
  unsigned long long u = (unsigned long long)f;
  if (w == 4) u = (u & 0xffffffffULL) * 0x0000000100000001ULL;
  else if (w == 2) u = (u & 0xffffULL) * 0x0001000100010001ULL;
  else if (w == 1) u = (u & 0xffULL) * 0x0101010101010101ULL;
  return make_uint4((unsigned)u, (unsigned)(u >> 32), (unsigned)u,
                    (unsigned)(u >> 32));
}

// block (pair q = d * n_src + s, chunk c; lane blockIdx.y): the lane's
// slots [max(c * per, total), min((c + 1) * per, cap)) of that pair, per =
// kFillBytes / its width
__global__ void __launch_bounds__(kThreads)
    ex_fill(ExchangeLanes L, const int64_t* __restrict__ totals, int n,
            int n_src, int64_t cap, int64_t chunks) {
  const int l = blockIdx.y, w = L.width[l];
  const int64_t per = kFillBytes / w;
  const int64_t q = blockIdx.x / chunks, c = blockIdx.x - q * chunks;
  const int64_t d = q / n_src, s = q - d * n_src;
  int64_t lo = totals[s * n + d];
  if (lo < c * per) lo = c * per;
  const int64_t hi = (c + 1) * per < cap ? (c + 1) * per : cap;
  if (lo >= hi) return;
  const int64_t e0 = q * cap + lo, e1 = q * cap + hi;
  char* p = (char*)L.outs[l];
  const uintptr_t a0 = (uintptr_t)(p + e0 * w), a1 = (uintptr_t)(p + e1 * w);
  const uintptr_t b0 = (a0 + 15) & ~(uintptr_t)15, b1 = a1 & ~(uintptr_t)15;
  int64_t head = e1, tail = e1;  // elements written one by one
  if (b0 < b1) {
    head = e0 + (int64_t)(b0 - a0) / w;
    tail = e1 - (int64_t)(a1 - b1) / w;
    const uint4 pat = fill16(L.fill[l], w);
    uint4* q16 = (uint4*)b0;
    const int64_t n16 = (int64_t)(b1 - b0) / 16;
    for (int64_t i = threadIdx.x; i < n16; i += kThreads) q16[i] = pat;
  }
  const unsigned long long f = (unsigned long long)L.fill[l];
  for (int64_t e = e0 + threadIdx.x; e < head; e += kThreads)
    put_elem(p, e, w, f);
  for (int64_t e = tail + threadIdx.x; e < e1; e += kThreads)
    put_elem(p, e, w, f);
}

template <int kMode, int R>
int launch_pass_r(const PassArgs& A, const ExchangeLanes& L, cudaStream_t st) {
  const int64_t blocks = (int64_t)A.n_src * A.tiles;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return -1;
  const size_t smem = pass_smem(A.n, kMode != M_HIST, R);
  void (*kern)(PassArgs, ExchangeLanes) = ex_pass<kMode, R>;
  if (smem > 32 * 1024)  // the static words count toward 48 KB too
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  LAUNCH(kern, (unsigned)blocks, kThreads, smem, st, A, L);
  return 0;
}

template <int kMode>
int launch_pass(const PassArgs& A, const ExchangeLanes& L, cudaStream_t st) {
  switch (A.rounds) {
    case 8: return launch_pass_r<kMode, 8>(A, L, st);
    case 4: return launch_pass_r<kMode, 4>(A, L, st);
    case 2: return launch_pass_r<kMode, 2>(A, L, st);
    default: return launch_pass_r<kMode, 1>(A, L, st);
  }
}

int launch_fill(const PassArgs& A, const ExchangeLanes& L, cudaStream_t st) {
  // the chunks of an 8-byte lane; a narrower lane's last chunks exit
  const int64_t chunks = (A.cap * 8 + kFillBytes - 1) / kFillBytes;
  const int64_t blocks = (int64_t)A.n * A.n_src * chunks;
  if (blocks > 0x7fffffffLL) return -1;
  LAUNCH(ex_fill, dim3((unsigned)blocks, (unsigned)L.n), kThreads, 0, st, L,
         (const int64_t*)A.totals, A.n, A.n_src, A.cap, chunks);
  return 0;
}

// The counts (pre, totals, error word): with lanes and few destinations
// the look-back pass, which also writes the lanes; else the counting pass
// and ex_scan (then the lanes' pass, if any).
int launch_plan(const PassArgs& A, const ExchangeLanes& L, cudaStream_t st) {
  if (L.n > 0 && A.n <= kLookShards)
    return launch_pass<M_LOOK_SCATTER>(A, L, st);
  int rc = launch_pass<M_HIST>(A, L, st);
  if (rc) return rc;
  const int64_t pairs = (int64_t)A.n_src * A.n;
  if (A.tiles >= kBlockScanTiles)
    LAUNCH(ex_scan_block, grid_for(pairs, 1), kThreads, 0, st, A.pre,
           A.tiles, pairs, A.cap, A.totals, A.err);
  else
    LAUNCH(ex_scan_warp, grid_for(pairs * 32, kThreads), kThreads, 0, st,
           A.pre, A.tiles, pairs, A.cap, A.totals, A.err);
  return L.n > 0 ? launch_pass<M_SCATTER>(A, L, st) : 0;
}

// scratch: pre[n_src * n * tiles], totals[n_src * n], the error word, the
// tile counter
PassArgs plan_args(const int64_t* keys, const uint8_t* live, int64_t nb,
                   int64_t n_rows, int n, int n_src, int64_t cap,
                   int is_float, int64_t* scratch) {
  PassArgs A;
  A.keys = keys;
  A.live = live;
  A.m = nb / n_src;
  A.rounds = rounds_for(A.m, n_src);
  A.tiles = tiles_of(A.m, n_src);
  A.n_rows = n_rows;
  A.cap = cap;
  A.pre = (unsigned long long*)scratch;
  A.totals = scratch + (int64_t)n_src * n * A.tiles;
  A.err = A.totals + (int64_t)n_src * n;
  A.ctr = (unsigned long long*)(A.err + 1);
  A.n = n;
  A.bits = __builtin_ctz((unsigned)n);
  A.n_src = n_src;
  A.is_float = is_float;
  return A;
}

bool bad_lanes(const ExchangeLanes& L) {
  if (L.n < 1 || L.n > kMaxLanes) return true;
  for (int l = 0; l < L.n; ++l) {
    const int w = L.width[l];
    if (w != 1 && w != 2 && w != 4 && w != 8) return true;
  }
  return false;
}

bool bad_shards(int n) {
  return n < 2 || n > kMaxShards || (n & (n - 1));
}

}  // namespace

// int64 words of a call's scratch: nb rows from n_src sources (exchange:
// n_src = n; partition: 1) into n destinations.  The totals start at
// word n_src * n * tiles, the error word follows them.
TS_API int64_t hk13_scratch_words(int64_t nb, int n, int n_src) {
  if (bad_shards(n) || n_src < 1 || nb < 0 || nb % n_src) return -1;
  return (int64_t)n_src * n * tiles_of(nb / n_src, n_src) +
         (int64_t)n_src * n + 2;
}

// Exchange mode.  keys: int64[nb] (nb = n * m); n a power of two in [2,
// kMaxShards]; chunks[c] up to kMaxLanes lanes each, outputs [n * n * cap]
// each.  Sets the error word when a (source, destination) pair holds more
// than cap rows.
TS_API int hk13_exchange(const int64_t* keys, int64_t nb, int64_t n_rows,
                         int n, int64_t cap, int64_t* scratch,
                         const ExchangeLanes* chunks, int n_chunks,
                         cudaStream_t st) {
  if (bad_shards(n) || nb < n || nb % n || cap < 1 || n_chunks < 1)
    return -1;
  for (int c = 0; c < n_chunks; ++c)
    if (bad_lanes(chunks[c])) return -1;
  const PassArgs A =
      plan_args(keys, nullptr, nb, n_rows, n, n, cap, 0, scratch);
  cudaMemsetAsync(scratch, 0, 8 * hk13_scratch_words(nb, n, n), st);
  int rc = launch_plan(A, chunks[0], st);
  if (!rc) rc = launch_fill(A, chunks[0], st);
  for (int c = 1; c < n_chunks && !rc; ++c) {
    rc = launch_pass<M_SCATTER>(A, chunks[c], st);
    if (!rc) rc = launch_fill(A, chunks[c], st);
  }
  return rc ? rc : (int)cudaGetLastError();
}

// Partition mode, the count call.  keys: int64[nb] (float64 bits when
// is_float), live: uint8[nb].  Writes the per-destination live counts at
// the scratch's totals (word n * tiles on) and the prefixes the scatter
// call reads.
TS_API int hk13_partition_count(const int64_t* keys, const uint8_t* live,
                                int64_t nb, int n, int is_float,
                                int64_t* scratch, cudaStream_t st) {
  if (bad_shards(n) || nb < 0) return -1;
  const PassArgs A = plan_args(keys, live, nb, nb, n, 1, kI64Max, is_float,
                               scratch);
  // no memset: the counting pass writes every prefix word, ex_scan every
  // total (0 for no rows)
  ExchangeLanes none;
  none.n = 0;
  const int rc = launch_plan(A, none, st);
  return rc ? rc : (int)cudaGetLastError();
}

// Partition mode, the scatter call, on the scratch of its count call:
// out_keys (the key's width 8) and out_ids int64, [n * cap] each; cap at
// least every destination's count.
TS_API int hk13_partition_scatter(const int64_t* keys, const uint8_t* live,
                                  int64_t nb, int n, int is_float,
                                  int64_t cap, int64_t* scratch,
                                  void* out_keys, int64_t* out_ids,
                                  cudaStream_t st) {
  if (bad_shards(n) || nb < 0 || cap < 1) return -1;
  const PassArgs A =
      plan_args(keys, live, nb, nb, n, 1, cap, is_float, scratch);
  ExchangeLanes L;
  L.n = 2;
  L.vals[0] = keys;
  L.outs[0] = out_keys;
  L.fill[0] = 0;
  L.width[0] = 8;
  L.vals[1] = nullptr;  // the row index
  L.outs[1] = out_ids;
  L.fill[1] = -1;
  L.width[1] = 8;
  int rc = launch_pass<M_SCATTER>(A, L, st);
  if (!rc) rc = launch_fill(A, L, st);
  return rc ? rc : (int)cudaGetLastError();
}
