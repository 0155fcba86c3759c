// HK3 equi_join: (li, ri) match pairs of a single-key int64 equi-join.
//
// Replaces tinysql_tpu/ops/kernels.py:1803-1960 unique_join_match (K6:
// lexsort of the build side, searchsorted probe, live-candidate check,
// nonzero compaction) and :1641-1800 join_match (K7: per-probe live match
// counts, exclusive scan, expansion with ri = -1 for unmatched outer rows).
//
// Keys arrive as int64 whose signed order is the key order: integer keys
// as they are, float keys as order keys with -0.0 folded into +0.0 and NaN
// moved into the NULL mask (ops/kernels.py does that in torch).  A probe
// row is live when valid and not NULL; a build row when valid and not
// NULL.  Dead build rows are simply never inserted, so a live key equal to
// any sentinel (int64 max) is found like any other (the collision of
// tests/test_tpu_ops.py:384 cannot happen).
//
// Bound: bytes for the probe (key, NULL and valid of every probe row, one
// table read, the outputs), random table accesses for the build.
//
// Unique build side (K6), four kernels and no host pull (the host waited
// for the build statistics, then for the output size, before):
// - stats (ej_stats): blocks write (live rows, kmin, kmax) partials; the
//   LAST block to finish (an atomic ticket after __threadfence) folds them
//   with all its threads and writes the device header: n_live, kmin,
//   kmax, the table kind and size.  The kind follows the host twin's
//   rule: dense when card = kmax - kmin + 1 <= max(2^22, 4 * n_live),
//   else hash;
// - dense: a key -> row table indexed by key - kmin, in dense_table.cuh's
//   format (int32, -1 absent) and probed by its in-range lookup, as HK6
//   and HK8 probe theirs; the index is computed only for probe keys inside
//   [kmin, kmax], so key - kmin never wraps (R4);
// - hash: open addressing with linear probing over slots that hold row +
//   1, the capacity the power of two >= max(1024, 2 * n_live); keys are
//   compared through the build key column, so no key value is reserved as
//   "empty".
//   Either way equal live keys keep the LOWEST row (atomicMin), which is
//   the row the reference's stable lexsort finds first.
//   The host sizes the table buffer from n_r alone (the larger of the two
//   kinds the rule can pick); the fill (ej_fill) touches only the entries
//   the header names, the build (ej_build) inserts the live rows.
//   The table is built from the live rows alone and never assumes a sorted
//   build side, so no "build keys ascend" claim exists to be broken by a
//   validity mask with holes mid-array (the reference's R3);
// - probe + compaction in one pass (ej_pick): tiles of kPickTile probe
//   rows, taken in launch order from an atomic counter; a tile's kept rows
//   (matched rows, or every valid row for an outer join) are ranked by
//   warp ballots, the tile's exclusive prefix comes from a decoupled
//   look-back over the earlier tiles' published counts (a single-pass
//   scan), and the pairs land in probe order in one packed buffer,
//   out = [count, li_0, ri_0, li_1, ri_1, ...]: li ascending, the same
//   bytes on every run.  The count is the first word, so the host pulls
//   the count and the first pairs in one transfer;
// - membership alone (K8, ej_member): the same table, one flag a probe row.
// The ticket, the tile counter and the look-back words are zeroed by one
// small memset on the caller's stream; nothing static lives on the card.
//
// Any multiplicity (K7): the build side is sorted by HK4 (live rows first,
// then key, then row); every probe row binary-searches its run of equal
// keys among the header's n_live rows (the same stats kernel, no pull),
// and expand.cuh (shared with HK8) places the expansion in probe-major
// order with build rows in stable key order: an inclusive scan of the
// per-row output counts, then one thread per output slot.
#include "dense_table.cuh"
#include "expand.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStatBlocks = 1024;
constexpr int kPickRows = 4;  // rows a thread owns in a probe tile
constexpr int kUnroll = 4;    // rows a grid-stride step loads at once
constexpr int64_t kPickTile = (int64_t)kThreads * kPickRows;
constexpr int64_t kDenseMin = 1LL << 22;  // dense_ok's floor
constexpr int64_t kHashMin = 1024;
static_assert(kPickRows * kWarps == 32, "one warp scans a tile's counts");

// The workspace, int64 words: the header, the stats partials, then the
// words the memset zeroes (the stats ticket, the pick's tile counter, one
// look-back word a tile).
constexpr int kHdrWords = 8;
constexpr int64_t kPartOff = kHdrWords;
constexpr int64_t kZeroOff = kPartOff + 3 * kStatBlocks;
enum { H_LIVE = 0, H_KMIN = 1, H_KMAX = 2, H_DENSE = 3, H_TSIZE = 4 };

// Row i's key, liveness (valid and not NULL) and validity, zero past n:
// the three loads are issued together (no load waits on another's value).
struct KeyRow {
  int64_t key;
  bool live, valid;
};

__device__ __forceinline__ KeyRow key_row(const int64_t* __restrict__ k,
                                          const uint8_t* __restrict__ nl,
                                          const uint8_t* __restrict__ v,
                                          int64_t i, int64_t n) {
  if (i >= n) return KeyRow{0, false, false};
  const uint8_t a = v[i], b = nl[i];
  const int64_t x = k[i];
  return KeyRow{x, static_cast<bool>((a != 0) & (b == 0)), a != 0};
}

__device__ __forceinline__ unsigned long long mix64(unsigned long long x) {
  x ^= x >> 30;
  x *= 0xbf58476d1ce4e5b9ULL;
  x ^= x >> 27;
  x *= 0x94d049bb133111ebULL;
  x ^= x >> 31;
  return x;
}

// (live rows, kmin, kmax) over the block in a tree: a shuffle tree a
// warp, then warp 0's over the warp results; valid in thread 0.  Integer
// sums and min / max, exact in any order.
struct Stats {
  int64_t cnt, mn, mx;
};

__device__ __forceinline__ Stats stats_merge(Stats a, Stats b) {
  return Stats{a.cnt + b.cnt, b.mn < a.mn ? b.mn : a.mn,
               b.mx > a.mx ? b.mx : a.mx};
}

__device__ __forceinline__ Stats stats_shfl(Stats a, int o) {
  return Stats{(int64_t)__shfl_down_sync(kFull, (long long)a.cnt, o),
               (int64_t)__shfl_down_sync(kFull, (long long)a.mn, o),
               (int64_t)__shfl_down_sync(kFull, (long long)a.mx, o)};
}

__device__ Stats stats_block(Stats a, Stats* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a = stats_merge(a, stats_shfl(a, o));
  if (lane == 0) sh[warp] = a;
  __syncthreads();
  if (warp == 0) {
    a = sh[lane < kWarps ? lane : 0];
#pragma unroll
    for (int o = kWarps / 2; o > 0; o >>= 1)
      a = stats_merge(a, stats_shfl(a, o));
  }
  __syncthreads();  // sh is reused by the next tree
  return a;
}

// Build statistics; the last block writes the header (hdr = ws).
__global__ void __launch_bounds__(kThreads)
    ej_stats(const int64_t* __restrict__ k, const uint8_t* __restrict__ nl,
             const uint8_t* __restrict__ v, int64_t n, int64_t* ws) {
  __shared__ Stats sh[kWarps];
  __shared__ bool last;
  const int t = threadIdx.x;
  Stats a = {0, kI64Max, kI64Min};
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x + t; i0 < n;
       i0 += kUnroll * stride) {
    KeyRow r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)  // the loads first, then the uses
      r[u] = key_row(k, nl, v, i0 + u * stride, n);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (r[u].live) a = stats_merge(a, Stats{1, r[u].key, r[u].key});
  }
  a = stats_block(a, sh);
  int64_t* part = ws + kPartOff;
  if (t == 0) {
    part[3 * blockIdx.x] = a.cnt;
    part[3 * blockIdx.x + 1] = a.mn;
    part[3 * blockIdx.x + 2] = a.mx;
    __threadfence();
    last = atomicAdd((unsigned*)(ws + kZeroOff), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the last block folds the partials (read through L2: other blocks
  // wrote them)
  a = Stats{0, kI64Max, kI64Min};
#pragma unroll 4
  for (int q = t; q < (int)gridDim.x; q += kThreads) {
    const long long* p = (const long long*)part + 3 * q;
    a = stats_merge(a, Stats{__ldcg(p), __ldcg(p + 1), __ldcg(p + 2)});
  }
  a = stats_block(a, sh);
  if (t != 0) return;
  // card = mx - mn + 1 (as uint64: no wrap) <= max(2^22, 4 * n_live)
  const unsigned long long range =
      (unsigned long long)a.mx - (unsigned long long)a.mn;
  const int64_t limit = 4 * a.cnt > kDenseMin ? 4 * a.cnt : kDenseMin;
  const bool dense = a.cnt > 0 && range < (unsigned long long)limit;
  int64_t cap = kHashMin;
  while (cap < 2 * (a.cnt > 1 ? a.cnt : 1)) cap <<= 1;
  ws[H_LIVE] = a.cnt;
  ws[H_KMIN] = a.mn;
  ws[H_KMAX] = a.mx;
  ws[H_DENSE] = dense;
  ws[H_TSIZE] = dense ? (int64_t)range + 1 : cap;
}

// The table the header names: int32 -1 (dense) or int64 0 (hash) over its
// entries only, 16 bytes a store (the buffer is 16-byte aligned and holds
// whole stores).
__global__ void ej_fill(const int64_t* __restrict__ hdr, uint4* tbuf) {
  const bool dense = hdr[H_DENSE] != 0;
  const int64_t ts = hdr[H_TSIZE];
  const int64_t words = dense ? (ts + 3) / 4 : (ts + 1) / 2;
  const uint4 val = dense ? make_uint4(~0u, ~0u, ~0u, ~0u)
                          : make_uint4(0u, 0u, 0u, 0u);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < words; i += stride)
    tbuf[i] = val;
}

__global__ void ej_build(const int64_t* __restrict__ hdr,
                         const int64_t* __restrict__ k,
                         const uint8_t* __restrict__ nl,
                         const uint8_t* __restrict__ v, int64_t n,
                         void* tbuf) {
  const bool dense = hdr[H_DENSE] != 0;
  const int64_t kmin = hdr[H_KMIN], cap = hdr[H_TSIZE];
  const unsigned long long mask = (unsigned long long)cap - 1;
  int64_t* slots = (int64_t*)tbuf;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i0 < n;
       i0 += kUnroll * stride) {
    KeyRow r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)  // the loads first, then the inserts
      r[u] = key_row(k, nl, v, i0 + u * stride, n);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!r[u].live) continue;
      const int64_t i = i0 + u * stride, x = r[u].key;
      if (dense) {
        // live keys lie in [kmin, kmax]: the difference is the table index
        table_insert_min((int32_t*)tbuf, kmin, x, i);
        continue;
      }
      // slots hold row + 1 (0 = empty)
      unsigned long long s = mix64((unsigned long long)x) & mask;
      for (;;) {
        const unsigned long long old =
            atomicCAS((unsigned long long*)&slots[s], 0ULL,
                      (unsigned long long)(i + 1));
        if (old == 0ULL) break;
        if (k[(int64_t)old - 1] == x) {  // same key: keep the lowest row
          atomic_min_i64(&slots[s], i + 1);
          break;
        }
        s = (s + 1) & mask;
      }
    }
  }
}

// The table a probe reads, from the header.
struct Table {
  const void* buf;
  int64_t kmin, kmax, size;
  bool dense;
};

__device__ __forceinline__ Table table_of(const int64_t* hdr,
                                          const void* buf) {
  return Table{buf, hdr[H_KMIN], hdr[H_KMAX], hdr[H_TSIZE],
               hdr[H_DENSE] != 0};
}

// The build row of a live probe key, -1 when none.
__device__ __forceinline__ int64_t table_find(const Table& T,
                                              const int64_t* __restrict__ rk,
                                              int64_t x) {
  if (T.dense)  // R4: key - kmin only for keys inside [kmin, kmax]
    return table_lookup((const int32_t*)T.buf, T.size, T.kmin, T.kmax, x);
  const int64_t* slots = (const int64_t*)T.buf;
  const unsigned long long mask = (unsigned long long)T.size - 1;
  unsigned long long s = mix64((unsigned long long)x) & mask;
  for (;;) {
    const int64_t r1 = slots[s];
    if (r1 == 0) return -1;
    if (rk[r1 - 1] == x) return r1 - 1;
    s = (s + 1) & mask;
  }
}

// Probe + compaction, one pass.  zero = [stats ticket, tile counter,
// look-back word a tile]; out = [count, (li, ri) a kept row].
__global__ void __launch_bounds__(kThreads)
    ej_pick(const int64_t* __restrict__ hdr, const int64_t* __restrict__ lk,
            const uint8_t* __restrict__ ln, const uint8_t* __restrict__ lv,
            int64_t n, const int64_t* __restrict__ rk, const void* tbuf,
            int outer, int64_t* zero, int64_t* __restrict__ out) {
  __shared__ int64_t s_tile;
  __shared__ unsigned s_cnt[32];
  __shared__ int64_t s_off[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0)
    s_tile = (int64_t)atomicAdd((unsigned long long*)&zero[1], 1ULL);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * kPickTile;
  const Table T = table_of(hdr, tbuf);
  int64_t cand[kPickRows];
  unsigned ball[kPickRows];
  KeyRow row[kPickRows];
#pragma unroll
  for (int r = 0; r < kPickRows; ++r)  // the loads first, then the probes
    row[r] = key_row(lk, ln, lv, base + r * kThreads + t, n);
#pragma unroll
  for (int r = 0; r < kPickRows; ++r) {
    const int64_t c = row[r].live ? table_find(T, rk, row[r].key) : -1;
    const bool keep = outer ? row[r].valid : c >= 0;
    cand[r] = c;
    ball[r] = __ballot_sync(kFull, keep);
    if (lane == 0) s_cnt[r * kWarps + warp] = __popc(ball[r]);
  }
  __syncthreads();
  if (warp == 0) {
    // the tile's rows in order: (r, warp, lane); lane l scans entry l
    const unsigned c = s_cnt[lane];
    unsigned incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int64_t agg = __shfl_sync(kFull, incl, 31);
    const int64_t prefix =
        look_back((unsigned long long*)(zero + 2), tile, agg);
    s_off[lane] = prefix + (incl - c);
    if (lane == 0 && tile == (int64_t)gridDim.x - 1) out[0] = prefix + agg;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPickRows; ++r) {
    if (!((ball[r] >> lane) & 1u)) continue;
    const int64_t pos =
        s_off[r * kWarps + warp] + __popc(ball[r] & ((1u << lane) - 1u));
    out[1 + 2 * pos] = base + r * kThreads + t;
    out[2 + 2 * pos] = cand[r];
  }
}

// Membership alone: match[i] = the live probe key equals a live build key.
__global__ void ej_member(const int64_t* __restrict__ hdr,
                          const int64_t* __restrict__ lk,
                          const uint8_t* __restrict__ ln,
                          const uint8_t* __restrict__ lv, int64_t n,
                          const int64_t* __restrict__ rk, const void* tbuf,
                          uint8_t* __restrict__ match) {
  const Table T = table_of(hdr, tbuf);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i0 < n;
       i0 += kUnroll * stride) {
    KeyRow r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)  // the loads first, then the probes
      r[u] = key_row(lk, ln, lv, i0 + u * stride, n);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = i0 + u * stride;
      if (i < n) match[i] = r[u].live && table_find(T, rk, r[u].key) >= 0;
    }
  }
}

// any multiplicity: per probe row, the run of equal live build keys
__global__ void ej_mult_count(const int64_t* __restrict__ lk,
                              const uint8_t* __restrict__ ln,
                              const uint8_t* __restrict__ lv, int64_t n,
                              const int64_t* __restrict__ rk,
                              const int64_t* __restrict__ perm,
                              const int64_t* __restrict__ hdr,
                              int64_t* __restrict__ lo,
                              int64_t* __restrict__ cnt) {
  const int64_t n_live = hdr[H_LIVE];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    int64_t a = 0, c = 0;
    const KeyRow r = key_row(lk, ln, lv, i, n);
    if (r.live) {
      const int64_t x = r.key;
      int64_t b = n_live;
      while (a < b) {  // lower bound
        int64_t m = a + ((b - a) >> 1);
        if (rk[perm[m]] < x) a = m + 1;
        else b = m;
      }
      int64_t e = a;
      b = n_live;
      while (e < b) {  // upper bound
        int64_t m = e + ((b - e) >> 1);
        if (rk[perm[m]] <= x) e = m + 1;
        else b = m;
      }
      c = e - a;
    }
    lo[i] = a;
    cnt[i] = c;
  }
}

// output rows of probe row i: its matches, or one for an unmatched valid
// row of an outer join
struct MultCount {
  const uint8_t* lv;
  const int64_t* cnt;
  int outer;
  __device__ int64_t operator()(int64_t i) const {
    return (outer && lv[i] && cnt[i] == 0) ? 1 : cnt[i];
  }
};

__global__ void ej_mult_fill(MultCount mc, const int64_t* __restrict__ incl,
                             int64_t n_l, const int64_t* __restrict__ lo,
                             const int64_t* __restrict__ perm, int64_t total,
                             int64_t* __restrict__ li,
                             int64_t* __restrict__ ri) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < total;
       j += stride) {
    const int64_t p = owner_of(incl, n_l, j);
    const int64_t t = j - (incl[p] - mc(p));
    li[j] = p;
    ri[j] = mc.cnt[p] > 0 ? perm[lo[p] + t] : -1;
  }
}

inline int64_t pick_tiles(int64_t n_l) {
  return n_l > 0 ? (n_l + kPickTile - 1) / kPickTile : 1;
}

// The stats kernel after zeroing `zero_words` words of the workspace's
// zeroed region (the ticket first).
void launch_stats(const int64_t* rk, const uint8_t* rn, const uint8_t* rv,
                  int64_t n_r, int64_t* ws, int64_t zero_words,
                  cudaStream_t st) {
  cudaMemsetAsync(ws + kZeroOff, 0, (size_t)zero_words * sizeof(int64_t), st);
  LAUNCH(ej_stats, grid_for(n_r, kThreads, kStatBlocks), kThreads, 0, st, rk,
         rn, rv, n_r, ws);
}

// The header's table: filled, then the live build rows inserted.
// tbytes: the buffer's size (a multiple of 16 bytes).
void launch_table(const int64_t* rk, const uint8_t* rn, const uint8_t* rv,
                  int64_t n_r, const int64_t* ws, void* tbuf, int64_t tbytes,
                  cudaStream_t st) {
  LAUNCH(ej_fill, grid_for(tbytes / 16, kThreads, 4 * 132), kThreads, 0, st,
         ws, (uint4*)tbuf);
  if (n_r > 0)
    LAUNCH(ej_build, grid_for(n_r, kThreads), kThreads, 0, st, ws, rk, rn, rv,
           n_r, tbuf);
}

}  // namespace

// The workspace hk3_build_stats, hk3_unique_pick and hk3_unique_match
// take: int64[kZeroOff + 2 + pick_tiles(n_l)] (the Python wrapper sizes it
// from the same constants); the header is its first kHdrWords words.
// tbuf: the table buffer, 16-byte aligned, tbytes >= the larger of
// 4 * max(2^22, 4 * n_r) and 8 * the hash capacity for n_r live rows.

// The header alone (K7's n_live).
TS_API int hk3_build_stats(const int64_t* rk, const uint8_t* rn,
                           const uint8_t* rv, int64_t n_r, int64_t* ws,
                           cudaStream_t st) {
  launch_stats(rk, rn, rv, n_r, ws, 1, st);
  return (int)cudaGetLastError();
}

// Unique build side: the kept probe rows (matched rows; every valid row
// when outer, ri = -1 where unmatched) as out = int64[1 + 2 * n_l]:
// [count, li_0, ri_0, ...], li ascending; words past 1 + 2 * count are
// not written.
TS_API int hk3_unique_pick(const int64_t* lk, const uint8_t* ln,
                           const uint8_t* lv, int64_t n_l, const int64_t* rk,
                           const uint8_t* rn, const uint8_t* rv, int64_t n_r,
                           int outer, int64_t* ws, void* tbuf, int64_t tbytes,
                           int64_t* out, cudaStream_t st) {
  if (n_r >= (1LL << 31) || n_l < 0) return -1;
  const int64_t tiles = pick_tiles(n_l);
  launch_stats(rk, rn, rv, n_r, ws, 2 + tiles, st);
  launch_table(rk, rn, rv, n_r, ws, tbuf, tbytes, st);
  LAUNCH(ej_pick, (unsigned)tiles, kThreads, 0, st, ws, lk, ln, lv, n_l, rk,
         (const void*)tbuf, outer, ws + kZeroOff, out);
  return (int)cudaGetLastError();
}

// Unique build side, membership alone: match uint8[n_l].
TS_API int hk3_unique_match(const int64_t* lk, const uint8_t* ln,
                            const uint8_t* lv, int64_t n_l, const int64_t* rk,
                            const uint8_t* rn, const uint8_t* rv, int64_t n_r,
                            int64_t* ws, void* tbuf, int64_t tbytes,
                            uint8_t* match, cudaStream_t st) {
  if (n_r >= (1LL << 31)) return -1;
  launch_stats(rk, rn, rv, n_r, ws, 1, st);
  launch_table(rk, rn, rv, n_r, ws, tbuf, tbytes, st);
  if (n_l > 0)
    LAUNCH(ej_member, grid_for(n_l, kThreads), kThreads, 0, st, ws, lk, ln,
           lv, n_l, rk, (const void*)tbuf, match);
  return (int)cudaGetLastError();
}

// Any multiplicity, phase 1: per-row run (lo, cnt), the inclusive ends of
// the per-row output counts (incl int64[n_l]) and the output size.
// perm: build rows sorted (live first, then key, then row); hdr: the
// header hk3_build_stats wrote (its n_live rows of perm are live).  btot:
// int64[ceil(n_l / 1024)].
TS_API int hk3_mult_count(const int64_t* lk, const uint8_t* ln,
                          const uint8_t* lv, int64_t n_l, const int64_t* rk,
                          const int64_t* perm, const int64_t* hdr, int outer,
                          int64_t* lo, int64_t* cnt, int64_t* incl,
                          int64_t* btot, int64_t* total, cudaStream_t st) {
  if (n_l > 0)
    LAUNCH(ej_mult_count, grid_for(n_l, kThreads), kThreads, 0, st, lk, ln,
           lv, n_l, rk, perm, hdr, lo, cnt);
  launch_scan(InclusiveEnds<MultCount>{MultCount{lv, cnt, outer}, incl}, n_l,
              btot, total, st);
  return (int)cudaGetLastError();
}

// Any multiplicity, phase 2: li/ri int64[total] in probe-major order.
TS_API int hk3_mult_expand(const uint8_t* lv, int64_t n_l, const int64_t* lo,
                           const int64_t* cnt, const int64_t* incl,
                           const int64_t* perm, int outer, int64_t total,
                           int64_t* li, int64_t* ri, cudaStream_t st) {
  if (total > 0)
    LAUNCH(ej_mult_fill, grid_for(total, kThreads, 1 << 16), kThreads, 0, st,
           MultCount{lv, cnt, outer}, incl, n_l, lo, perm, total, li, ri);
  return (int)cudaGetLastError();
}
