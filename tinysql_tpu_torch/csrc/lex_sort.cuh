// Lexicographic sort of rows by up to kMaxSortLanes uint64 key lanes, with
// a unique int64 position as the last lane (the row index, or the row's
// place in an earlier order).  Shared by HK4 lex_order and the
// many-segment regime of HK2 segment_reduce (and its batched entry point
// HK2b).
//
// Because the position breaks every tie, all elements are distinct: the
// sort is a STABLE lexsort, and a top-k keeps the lowest-index row among
// equal keys (lax.top_k's tie-break).
//
// Bound on an H100: bytes.  A full sort must read each key lane once
// and write the permutation once (one key at 2^23 rows: 64 MB + 64 MB,
// ~0.04 ms at 3.35 TB/s).  A sort by digits moves every element once per
// digit that is not the same in all rows, so the design's aim is to take
// as few such passes as the data allows and to make each one a single
// sweep over device memory.
//
// Four regimes, chosen on the host from (m, n, k) alone:
// - n <= T (one tile): lex_tile sorts the tile in shared memory with a
//   bitonic network and writes the first min(k, n) positions straight to
//   the output: one launch (Q1's 16-row ORDER BY);
// - a top-k with k <= T / 4: lex_tile rounds, each tile keeping its best
//   k, until one tile holds every candidate (K10, the pipeline's top-16);
// - up to kMergeMaxRows rows (2^16; the crossover measured below):
//   sorted tiles, then lex_merge passes that place each element at its
//   index in its run plus a binary search in the neighbouring run;
// - everything else: a stable least-significant-digit radix sort with
//   8-bit digits, taken lane by lane from the last lane to the first:
//   1. radix_hist reads every lane once and counts, per lane, the eight
//      256-bin digit histograms (shared-memory atomics, merged into global
//      counts); its last block plans the passes: a digit whose 256 bins
//      hold all n rows in one bin is trivial and is skipped (the NULL-rank
//      lane of a key without NULLs, the upper bytes of HK2's group ids or
//      of a shard lane), every other digit gets its bucket offsets and its
//      index among the non-trivial passes;
//   2. the host launches eight radix_pass kernels per lane, a fixed
//      sequence (no host synchronisation); a trivial pass exits at once.
//      A non-trivial pass is one sweep over (key, position) pairs: a block
//      takes its tile from an atomic counter (so every tile it waits on
//      is held by a running block), ranks the tile's elements by digit
//      with __match_any_sync and per-warp counters (ranks follow element
//      order: stable), publishes its per-digit counts as (tag, count)
//      words packed in 64 bits, looks back over the tiles before it for
//      its global offset in each bucket, stages the tile in shared memory
//      by digit and writes each bucket's run contiguously.  Its source
//      and destination buffers follow the parity of its pass index; the
//      first pass of a lane gathers that lane's keys through the current
//      positions, the first pass of the sort reads the lane and the
//      identity; the last pass writes the positions (the first `want`)
//      straight to the output and no keys;
//   3. radix_identity writes 0..n-1 when no pass ran (all keys equal).
//   Only integer atomics, and the positions are distinct, so the output
//   is bit-identical from run to run.
#pragma once

#include "common.cuh"

constexpr int kMaxSortLanes = 8;

struct SortIn {
  const uint64_t* lanes[kMaxSortLanes];
  const int64_t* pos;  // null = identity (pos = index); the tile rounds'
                       // and merges' own buffers; null at lex_sort_host
};
struct SortOut {
  uint64_t* lanes[kMaxSortLanes];  // lanes[0] null: positions only
  int64_t* pos;
};

namespace {

inline int lex_tile_size(int m) { return m <= 2 ? 1024 : (m <= 5 ? 512 : 256); }

// shared-memory element a < element b
__device__ __forceinline__ bool lex_less_sm(const uint64_t* sl,
                                            const int64_t* sp, int m, int T,
                                            int a, int b) {
  for (int l = 0; l < m; ++l) {
    uint64_t x = sl[l * T + a], y = sl[l * T + b];
    if (x != y) return x < y;
  }
  return sp[a] < sp[b];
}

__global__ void lex_tile(SortIn in, int m, int64_t n, int T, int64_t keep,
                         SortOut out) {
  DYN_SMEM(sm);
  uint64_t* sl = (uint64_t*)sm;                    // [m][T]
  int64_t* sp = (int64_t*)(sl + (size_t)m * T);    // [T]
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * T;
  const int64_t i = base + t;
  if (i < n) {
    for (int l = 0; l < m; ++l) sl[l * T + t] = in.lanes[l][i];
    sp[t] = in.pos ? in.pos[i] : i;
  } else {  // padding sorts after every real element
    for (int l = 0; l < m; ++l) sl[l * T + t] = ~0ULL;
    sp[t] = kI64Max;
  }
  __syncthreads();
  for (int k = 2; k <= T; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      int p = t ^ j;
      if (p > t) {
        bool asc = (t & k) == 0;
        bool gt = lex_less_sm(sl, sp, m, T, p, t);
        if (gt == asc) {
          for (int l = 0; l < m; ++l) {
            uint64_t x = sl[l * T + t];
            sl[l * T + t] = sl[l * T + p];
            sl[l * T + p] = x;
          }
          int64_t q = sp[t];
          sp[t] = sp[p];
          sp[p] = q;
        }
      }
      __syncthreads();
    }
  }
  int64_t valid = n - base;
  if (valid > T) valid = T;
  int64_t kk = keep < valid ? keep : valid;
  if (t < kk) {
    int64_t o = (int64_t)blockIdx.x * keep + t;
    if (out.lanes[0])
      for (int l = 0; l < m; ++l) out.lanes[l][o] = sl[l * T + t];
    out.pos[o] = sp[t];
  }
}

// element idx of `in` < (key, p)
__device__ __forceinline__ bool lex_less_global(const SortIn& in, int m,
                                                int64_t idx,
                                                const uint64_t* key,
                                                int64_t p) {
  for (int l = 0; l < m; ++l) {
    uint64_t x = in.lanes[l][idx];
    if (x != key[l]) return x < key[l];
  }
  return in.pos[idx] < p;
}

// Merge neighbouring sorted runs of length `run`: an element's rank is its
// index in its own run plus a binary search (lower bound) in the other.
// Only the first `keep` outputs are written.
__global__ void lex_merge(SortIn in, int m, int64_t n, int64_t run,
                          int64_t keep, SortOut out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint64_t key[kMaxSortLanes];
    for (int l = 0; l < m; ++l) key[l] = in.lanes[l][i];
    const int64_t p = in.pos[i];
    const int64_t r = i / run;
    const int64_t base = (r >> 1) * 2 * run;
    int64_t own, lo, hi;
    if ((r & 1) == 0) {
      own = i - base;
      lo = base + run;
      hi = base + 2 * run;
    } else {
      own = i - base - run;
      lo = base;
      hi = base + run;
    }
    if (hi > n) hi = n;
    if (hi < lo) hi = lo;
    int64_t a = lo, b = hi;
    while (a < b) {
      int64_t mid = a + ((b - a) >> 1);
      if (lex_less_global(in, m, mid, key, p)) a = mid + 1;
      else b = mid;
    }
    const int64_t o = base + own + (a - lo);
    if (o >= keep) continue;
    if (out.lanes[0])
      for (int l = 0; l < m; ++l) out.lanes[l][o] = key[l];
    out.pos[o] = p;
  }
}

inline SortIn as_in(const SortOut& o, int m) {
  SortIn r;
  for (int l = 0; l < kMaxSortLanes; ++l) r.lanes[l] = l < m ? o.lanes[l] : nullptr;
  r.pos = o.pos;
  return r;
}

// ---- the radix sort --------------------------------------------------

constexpr int kDigits = 8;    // 8-bit digits of a 64-bit lane
constexpr int kBins = 256;
constexpr int kHThreads = 512;
constexpr int kHUnroll = 4;
constexpr int kRThreads = 256;  // == kBins: one thread per digit value
constexpr int kRWarps = kRThreads / 32;
constexpr int kRItems = 16;
constexpr int kRTile = kRThreads * kRItems;
constexpr int kBlocksPerSM = 2;

// How a non-trivial pass reads its elements
enum RadixMode { kFromLane = 0, kGather = 1, kFromBuf = 2 };

struct RadixPlan {
  int k;         // index among the non-trivial passes; -1: trivial
  int mode;      // RadixMode
  int keys_out;  // a later pass of the same lane reads the keys
  int last;      // the sort's last non-trivial pass: writes the output
};

// Scratch words, zeroed on the stream before every sort.
struct RadixWords {
  unsigned* hist;    // [slot][kBins] digit counts (slot = lane * 8 + digit)
  unsigned* start;   // [slot][kBins] exclusive bucket offsets
  RadixPlan* plan;   // [slot]
  int* total;        // non-trivial passes
  unsigned* done;    // histogram blocks finished
  unsigned* tiles;   // [slot] tile counter of each pass
  unsigned long long* status;  // [tile][kBins] (tag, count) look-back words
};

// Ping-pong (key, position) buffers of the passes.
struct RadixBufs {
  uint64_t* keys[2];
  int64_t* pos[2];
};

// look-back word: high half (slot + 1) << 2 | flag, low half a count
constexpr unsigned kAggregate = 1, kPrefix = 2;

__host__ __device__ inline int64_t radix_tiles(int64_t n) {
  return (n + kRTile - 1) / kRTile;
}

// byte offsets of the words after the 4n buffer words; returns their size
inline int64_t radix_words_layout(int m, int64_t n, int64_t off[7]) {
  const int64_t slots = (int64_t)m * kDigits;
  const int64_t sizes[7] = {4 * kBins * slots, 4 * kBins * slots,
                            (int64_t)sizeof(RadixPlan) * slots, 4, 4,
                            4 * slots, 8 * kBins * radix_tiles(n)};
  int64_t at = 0;
  for (int i = 0; i < 7; ++i) {
    off[i] = at;
    at += align16(sizes[i]);
  }
  return at;
}

inline int64_t radix_scratch_bytes(int m, int64_t n) {
  int64_t off[7];
  return 4 * 8 * n + radix_words_layout(m, n, off);
}

// The pass plan, by the last histogram block (blockDim == kHThreads).
__device__ void radix_plan(int m, int64_t n, const RadixWords& W) {
  __shared__ unsigned s[2][kBins];
  __shared__ int triv[kMaxSortLanes * kDigits];
  const int b = threadIdx.x;
  for (int slot = 0; slot < m * kDigits; ++slot) {
    const unsigned c = b < kBins ? __ldcg(&W.hist[slot * kBins + b]) : 0u;
    const int one = __syncthreads_or(b < kBins && (int64_t)c == n);
    int cur = 0;
    if (b < kBins) s[cur][b] = c;
    __syncthreads();
    for (int off = 1; off < kBins; off <<= 1) {
      unsigned x = 0;
      if (b < kBins) {
        x = s[cur][b];
        if (b >= off) x += s[cur][b - off];
        s[cur ^ 1][b] = x;
      }
      cur ^= 1;
      __syncthreads();
    }
    if (b < kBins) W.start[slot * kBins + b] = s[cur][b] - c;
    if (b == 0) triv[slot] = one;
    __syncthreads();
  }
  if (b != 0) return;
  int k = 0, last = -1;
  for (int l = m - 1; l >= 0; --l) {
    int prev = -1;  // the lane's previous non-trivial slot
    for (int d = 0; d < kDigits; ++d) {
      const int slot = l * kDigits + d;
      RadixPlan p = {-1, kFromLane, 0, 0};
      if (!triv[slot]) {
        p.k = k;
        p.mode = k == 0 ? kFromLane : (prev < 0 ? kGather : kFromBuf);
        if (prev >= 0) W.plan[prev].keys_out = 1;
        prev = last = slot;
        ++k;
      }
      W.plan[slot] = p;
    }
  }
  if (last >= 0) W.plan[last].last = 1;
  *W.total = k;
}

__device__ __forceinline__ void radix_count(unsigned* h,
                                            unsigned (&prev)[kDigits],
                                            unsigned (&cnt)[kDigits],
                                            uint64_t x) {
#pragma unroll
  for (int d = 0; d < kDigits; ++d) {
    const unsigned b = (unsigned)(x >> (8 * d)) & 0xFFu;
    if (cnt[d] && b == prev[d]) {
      ++cnt[d];
    } else {
      if (cnt[d]) atomicAdd(&h[d * kBins + prev[d]], cnt[d]);
      prev[d] = b;
      cnt[d] = 1;
    }
  }
}

// Digit histograms of every lane; the last block to finish plans.  A
// thread counts a run of equal digits in a register and adds it once, so
// a digit that is the same in every row costs one shared atomic a thread.
__global__ void __launch_bounds__(kHThreads)
radix_hist(SortIn in, int m, int64_t n, RadixWords W) {
  __shared__ unsigned h[kDigits * kBins];
  __shared__ int is_last;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int l = 0; l < m; ++l) {
    for (int i = threadIdx.x; i < kDigits * kBins; i += blockDim.x) h[i] = 0;
    __syncthreads();
    const uint64_t* __restrict__ x = in.lanes[l];
    unsigned prev[kDigits], cnt[kDigits];
#pragma unroll
    for (int d = 0; d < kDigits; ++d) prev[d] = cnt[d] = 0;
    for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i0 < n;
         i0 += kHUnroll * stride) {
      uint64_t v[kHUnroll];
#pragma unroll
      for (int u = 0; u < kHUnroll; ++u) {
        const int64_t i = i0 + u * stride;
        v[u] = i < n ? x[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < kHUnroll; ++u)
        if (i0 + u * stride < n) radix_count(h, prev, cnt, v[u]);
    }
#pragma unroll
    for (int d = 0; d < kDigits; ++d)
      if (cnt[d]) atomicAdd(&h[d * kBins + prev[d]], cnt[d]);
    __syncthreads();
    for (int i = threadIdx.x; i < kDigits * kBins; i += blockDim.x)
      if (h[i]) atomicAdd(&W.hist[l * kDigits * kBins + i], h[i]);
    __syncthreads();
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(W.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  radix_plan(m, n, W);
}

__device__ __forceinline__ unsigned long long lb_load(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}
__device__ __forceinline__ void lb_store(unsigned long long* p,
                                         unsigned long long v) {
  *(volatile unsigned long long*)p = v;
}

// One stable counting pass on digit d of lane `lane` (plan slot `slot`).
__global__ void __launch_bounds__(kRThreads, kBlocksPerSM)
radix_pass(const uint64_t* __restrict__ lane, int slot, int d, int64_t n,
           int64_t want, RadixBufs B, RadixWords W,
           int64_t* __restrict__ out_pos) {
  const RadixPlan p = W.plan[slot];
  if (p.k < 0) return;
  DYN_SMEM(sm);
  uint64_t* skey = (uint64_t*)sm;                     // [kRTile]
  int64_t* spos = (int64_t*)(skey + kRTile);          // [kRTile]
  long long* gbase = (long long*)(spos + kRTile);     // [kBins]
  unsigned* whist = (unsigned*)(gbase + kBins);       // [kRWarps][kBins]
  unsigned* tstart = whist + kRWarps * kBins;         // [kBins]
  unsigned* wsum = tstart + kBins;                    // [kRWarps]
  unsigned* tile_s = wsum + kRWarps;                  // [1]
  unsigned char* sdig = (unsigned char*)(tile_s + 4); // [kRTile]
  const int t = threadIdx.x, w = t >> 5, ln = t & 31;
  const uint64_t* __restrict__ kin = B.keys[p.k & 1];
  const int64_t* __restrict__ pin = B.pos[p.k & 1];
  uint64_t* __restrict__ kout = B.keys[(p.k + 1) & 1];
  int64_t* __restrict__ pout = p.last ? out_pos : B.pos[(p.k + 1) & 1];
  const int64_t tiles = radix_tiles(n);
  const int shift = 8 * d;
  const unsigned tag = (unsigned)(slot + 1) << 2;
  unsigned long long* __restrict__ st = W.status;
  for (;;) {
    if (t == 0) *tile_s = atomicAdd(&W.tiles[slot], 1u);
    for (int i = t; i < kRWarps * kBins; i += kRThreads) whist[i] = 0;
    __syncthreads();
    const int64_t tile = *tile_s;
    if (tile >= tiles) return;
    const int64_t base = tile * kRTile;
    const int nvalid = (int)(n - base < kRTile ? n - base : kRTile);
    // warp w holds elements [w * 32 * kRItems, (w + 1) * 32 * kRItems) of
    // the tile; round r, lane ln: element w * 32 * kRItems + r * 32 + ln
    const int64_t wbase = base + (int64_t)w * 32 * kRItems;
    uint64_t key[kRItems];
    int64_t pos[kRItems];
    unsigned rank[kRItems];
#pragma unroll
    for (int r = 0; r < kRItems; ++r) {
      const int64_t e = wbase + r * 32 + ln;
      key[r] = 0;
      pos[r] = 0;
      if (e < n) {
        if (p.mode == kFromLane) {
          key[r] = lane[e];
          pos[r] = e;
        } else if (p.mode == kGather) {
          pos[r] = pin[e];
          key[r] = lane[pos[r]];
        } else {
          key[r] = kin[e];
          pos[r] = pin[e];
        }
      }
    }
    // ranks within the warp: earlier rounds, then lower lanes
#pragma unroll
    for (int r = 0; r < kRItems; ++r) {
      const int64_t e = wbase + r * 32 + ln;
      const unsigned dig =
          e < n ? (unsigned)(key[r] >> shift) & 0xFFu : (unsigned)kBins;
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, dig);
      const unsigned below = __popc(peers & ((1u << ln) - 1u));
      const unsigned c0 = dig < kBins ? whist[w * kBins + dig] : 0u;
      __syncwarp();
      if (dig < kBins && below == 0)
        whist[w * kBins + dig] = c0 + __popc(peers);
      __syncwarp();
      rank[r] = c0 + below;
    }
    __syncthreads();
    // thread t = digit value: the warps' exclusive offsets, the tile's count
    unsigned tot = 0;
    for (int ww = 0; ww < kRWarps; ++ww) {
      const unsigned c = whist[ww * kBins + t];
      whist[ww * kBins + t] = tot;
      tot += c;
    }
    // tile-local bucket starts: exclusive scan of the counts over digits
    unsigned x = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(0xFFFFFFFFu, x, off);
      if (ln >= off) x += y;
    }
    if (ln == 31) wsum[w] = x;
    __syncthreads();
    if (w == 0) {
      const unsigned v = ln < kRWarps ? wsum[ln] : 0u;
      unsigned y = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned z = __shfl_up_sync(0xFFFFFFFFu, y, off);
        if (ln >= off) y += z;
      }
      if (ln < kRWarps) wsum[ln] = y - v;
    }
    __syncthreads();
    tstart[t] = wsum[w] + x - tot;
    // decoupled look-back: the count of digit t in the tiles before
    unsigned excl = 0;
    unsigned long long* mine = st + tile * kBins + t;
    if (tile == 0) {
      lb_store(mine, ((unsigned long long)(tag | kPrefix) << 32) | tot);
    } else {
      lb_store(mine, ((unsigned long long)(tag | kAggregate) << 32) | tot);
      for (int64_t j = tile - 1;; --j) {
        unsigned long long v;
        do {
          v = lb_load(st + j * kBins + t);
        } while (((unsigned)(v >> 32) & ~3u) != tag);
        excl += (unsigned)v;
        if (((unsigned)(v >> 32) & 3u) == kPrefix) break;
      }
      lb_store(mine,
               ((unsigned long long)(tag | kPrefix) << 32) | (excl + tot));
    }
    gbase[t] = (long long)W.start[slot * kBins + t] + excl - tstart[t];
    __syncthreads();
    // stage the tile by digit, then write each bucket's run
#pragma unroll
    for (int r = 0; r < kRItems; ++r) {
      const int64_t e = wbase + r * 32 + ln;
      if (e < n) {
        const unsigned dig = (unsigned)(key[r] >> shift) & 0xFFu;
        const unsigned s = tstart[dig] + whist[w * kBins + dig] + rank[r];
        skey[s] = key[r];
        spos[s] = pos[r];
        sdig[s] = (unsigned char)dig;
      }
    }
    __syncthreads();
    for (int s = t; s < nvalid; s += kRThreads) {
      const long long dest = gbase[sdig[s]] + s;
      if (p.keys_out) kout[dest] = skey[s];
      if (!p.last || dest < want) pout[dest] = spos[s];
    }
    __syncthreads();  // the next tile reuses the shared memory
  }
}

constexpr size_t kRSmem = (size_t)kRTile * (8 + 8 + 1) + 8 * kBins +
                          4 * (kRWarps * kBins + kBins + kRWarps + 4);

// no non-trivial pass: the rows in their own order
__global__ void radix_identity(const int* __restrict__ total, int64_t want,
                               int64_t* __restrict__ out) {
  if (*total != 0) return;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < want;
       i += stride)
    out[i] = i;
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    sms = v > 0 ? v : 132;
  }
  return sms;
}

inline int radix_sort_host(const SortIn& in, int m, int64_t n, int64_t want,
                           void* scratch, int64_t* out_pos, cudaStream_t st) {
  if (n >= ((int64_t)1 << 31)) return -1;  // look-back counts are 32-bit
  int64_t off[7];
  const int64_t wbytes = radix_words_layout(m, n, off);
  RadixBufs B;
  B.keys[0] = (uint64_t*)scratch;
  B.keys[1] = B.keys[0] + n;
  B.pos[0] = (int64_t*)(B.keys[1] + n);
  B.pos[1] = B.pos[0] + n;
  char* words = (char*)(B.pos[1] + n);
  RadixWords W;
  W.hist = (unsigned*)(words + off[0]);
  W.start = (unsigned*)(words + off[1]);
  W.plan = (RadixPlan*)(words + off[2]);
  W.total = (int*)(words + off[3]);
  W.done = (unsigned*)(words + off[4]);
  W.tiles = (unsigned*)(words + off[5]);
  W.status = (unsigned long long*)(words + off[6]);
  cudaMemsetAsync(words, 0, (size_t)wbytes, st);
  const int64_t resident = (int64_t)sm_count() * kBlocksPerSM;
  const int64_t hb = (n + kHThreads - 1) / kHThreads;
  LAUNCH(radix_hist, (unsigned)(hb < resident ? hb : resident), kHThreads, 0,
         st, in, m, n, W);
  cudaFuncSetAttribute(radix_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)kRSmem);
  const int64_t tiles = radix_tiles(n);
  const unsigned grid = (unsigned)(tiles < resident ? tiles : resident);
  for (int l = m - 1; l >= 0; --l)
    for (int d = 0; d < kDigits; ++d)
      LAUNCH(radix_pass, grid, kRThreads, kRSmem, st, in.lanes[l],
             l * kDigits + d, d, n, want, B, W, out_pos);
  LAUNCH(radix_identity, grid_for(want, 256, resident), 256, 0, st,
         (const int*)W.total, want, out_pos);
  return 0;
}

// ---- the sort ----------------------------------------------------------

inline int64_t sort_want(int64_t n, int64_t k) {
  return (k < 0 || k > n) ? n : k;
}

// A round keeps `want` of every T rows, so it shrinks the candidates at
// least fourfold only for want <= T / 4; a larger k sorts in full.
inline bool topk_rounds(int T, int64_t want) { return 4 * want <= T; }

// Full sorts of at most this many rows take the tiles and merge passes:
// there the radix sort's fixed launches (a histogram, eight passes a lane,
// most of them empty) cost more than the merges.  Measured on an H100
// 80GB HBM3 at 700 W (bench/sort_bench.py, merge / radix ms, two runs
// each): one 62-bit key through sort_lanes at 2^16 rows 0.1487, 0.1584 /
// 0.1936, 0.2090, at 2^17 0.2038, 0.1955 / 0.1980, 0.2181; HK3's
// two-lane build sort at 2^16 0.1537, 0.1561 / 0.1338, 0.1296, at 2^17
// 0.2144, 0.2020 / 0.1388, 0.1524.
constexpr int64_t kMergeMaxRows = (int64_t)1 << 16;

// Scratch bytes lex_sort_host needs for (m, n, k).
inline int64_t lex_sort_scratch_bytes(int m, int64_t n, int64_t k) {
  const int T = lex_tile_size(m);
  const int64_t want = sort_want(n, k);
  if (n <= T) return 0;
  if (topk_rounds(T, want) || n <= kMergeMaxRows)
    return 2 * 8 * (m + 1) * n;  // ping-pong lanes and positions
  return radix_scratch_bytes(m, n);
}

// Sort rows 0..n-1 of `in` (m lanes, in.pos null) ascending; write the
// first min(k, n) row indices (k < 0: all n) to out_pos.  `scratch` holds
// lex_sort_scratch_bytes(m, n, k) bytes.
inline int lex_sort_host(const SortIn& in, int m, int64_t n, int64_t k,
                         void* scratch, int64_t* out_pos, cudaStream_t st) {
  if (m < 1 || m > kMaxSortLanes || in.pos) return -1;
  if (n <= 0) return 0;
  const int T = lex_tile_size(m);
  const size_t smem = (size_t)T * (8 * m + 8);
  const int64_t want = sort_want(n, k);
  SortOut final_out;
  for (int l = 0; l < kMaxSortLanes; ++l) final_out.lanes[l] = nullptr;
  final_out.pos = out_pos;
  if (n <= T) {
    LAUNCH(lex_tile, 1, T, smem, st, in, m, n, T, want, final_out);
    return 0;
  }
  const bool rounds = topk_rounds(T, want);
  if (!rounds && n > kMergeMaxRows)
    return radix_sort_host(in, m, n, want, scratch, out_pos, st);
  SortOut buf[2];
  uint64_t* s = (uint64_t*)scratch;
  for (int i = 0; i < 2; ++i) {
    uint64_t* b = s + (size_t)i * (m + 1) * n;
    for (int l = 0; l < kMaxSortLanes; ++l)
      buf[i].lanes[l] = l < m ? b + (size_t)l * n : nullptr;
    buf[i].pos = (int64_t*)(b + (size_t)m * n);
  }
  if (!rounds) {  // sorted tiles, then merge passes; the last one writes
    LAUNCH(lex_tile, (unsigned)((n + T - 1) / T), T, smem, st, in, m, n, T,
           (int64_t)T, buf[0]);
    int cur = 0;
    for (int64_t run = T; run < n; run *= 2, cur ^= 1) {
      const bool last = 2 * run >= n;
      LAUNCH(lex_merge, grid_for(n, 256, 1 << 20), 256, 0, st,
             as_in(buf[cur], m), m, n, run, last ? want : n,
             last ? final_out : buf[cur ^ 1]);
    }
    return 0;
  }
  // top-k rounds: each tile keeps its best `want`, until one tile holds
  // every candidate
  int64_t cnt = n;
  SortIn src = in;
  for (int cur = 0;; cur ^= 1) {
    const int64_t tiles = (cnt + T - 1) / T;
    LAUNCH(lex_tile, (unsigned)tiles, T, smem, st, src, m, cnt, T, want,
           tiles == 1 ? final_out : buf[cur]);
    if (tiles == 1) break;
    const int64_t last = cnt - (tiles - 1) * T;
    cnt = (tiles - 1) * want + (last < want ? last : want);
    src = as_in(buf[cur], m);
  }
  return 0;
}

}  // namespace
