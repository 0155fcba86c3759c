// HK8 csr_expand: the pipeline tier's join with a non-unique build side,
// expanded over the build replica's group index (a CSR layout).
//
// Replaces tinysql_tpu/executor/devpipe.py:1502-1748 (K18's multiplicity
// mode, _prepare_mult's kernel), whose XLA program took a cumsum over the
// sorted build validity, compacted the sorted order with nonzero, mapped
// each probe key to its group through the dense table, scanned the
// per-probe multiplicities and filled the static output bucket by a
// scatter of starts and a running max; also its multi-key variant, whose
// probe key is the composite lane (dense_table.cuh).
//
// Inputs: the group index over the build key (order int64[nbb]: sorted
// position -> row, positions at or past n_rows padding; ends int64[ngb]:
// each group's last sorted position, groups at or past ng padding), the
// build validity bvalid (row space), the key -> group table tbl over
// [lo, hi] (dense_table.cuh's format), the probe keys and validity, LEFT's
// flag, and the static bucket ob, which the host bounds at prepare time
// from the pre-filter group sizes, so no count ever travels to the host.
//
// Per probe row i: g = the group of its key (-1 when invalid, NULL, out
// of range or absent), m = the valid build rows of g, cnt = m (inner) or
// max(m, 1) for a valid row (LEFT).  Output slot j < total (the sum of
// cnt) belongs to the probe row p whose run holds it, at k = j - start(p);
// it is matched when k < m[p], and then names the build row at place
// start_c[g] + k of the compacted sorted order.  Slots are probe-major,
// and each probe row's build rows come in group-index order (ascending
// rows): the reference's order.  Slots past the total are invalid and
// name probe row 0 and build row 0, as do unmatched ones on the build
// side (whose NULL flags are then set).  Shard mode: shard s expands its
// probe rows [s * nbl, (s + 1) * nbl) into its bucket [s * ob, (s + 1) *
// ob), and its invalid slots name its first probe row.
//
// Bound: bytes.  The build's order and validity are read once over its
// rows, its group ends once; the probe validity once over the bucket,
// the probe keys, one table entry and each probe lane once per valid
// probe row; each build lane once over the build rows; the valid flag is
// written per output slot and the gathered lanes per live slot.
//
// Design: a memset and three passes, the first two single-pass scans
// with common.cuh's decoupled look-back (tiles taken in launch order
// from an atomic counter; the counters and look-back words are the
// memset's):
//   1. ce_build, over the n_rows sorted positions in tiles of
//      kBuildTile: writes comp, the valid build rows in sorted order, and
//      for each group whose last position lies in the tile ce[g], the
//      valid rows up to its end (two warp-wide searches of ends find the
//      tile's groups), so group g's valid rows start at ce[g - 1] in comp
//      and number ce[g] - ce[g - 1]: ng words, not a prefix over every
//      position.  A warp's positions are contiguous, its valid flags one
//      ballot each, so every load and every store of comp is a warp's
//      contiguous run.
//   2. ce_probe, over the probe rows: g, its start and m, cnt, and the
//      inclusive end of cnt (the look-back's scan) per row, written as
//      incl[i] and rec[i] = (start, m); the row at each shard's start
//      writes the shard's base, the last row the total.
//   3. ce_fill, over tiles of kFillTile output slots of one shard: two
//      warp-wide searches find the probe rows the tile's first and last
//      live slots belong to; the rows between are staged in shared
//      memory (their inclusive ends and records, kFillRows at a time),
//      each slot finds its owner there, and the same launch gathers the
//      probe and build lanes straight from registers: no slot -> row
//      index reaches device memory.  A thread's kFillPer slots lie a
//      block apart, so every store is a warp's contiguous run, and each
//      lane's loads go out for all of them before its stores.
// What the card spends is requests, not bytes: the build lanes are read
// at random rows (one 32-byte request for each 8-byte value and each NULL
// byte) and the first two passes each wait on a look-back.  The fill runs
// four blocks an SM (its register cap), so its random loads from many
// warps are in flight at once.
// A further ce_fill launch takes each further kMaxLanes lanes.  All
// integer, no float and no order-dependent atomics: the output is the
// same bytes from run to run.
#include "dense_table.cuh"

namespace {

constexpr int kBuildThreads = 256;
constexpr int kBuildWarps = kBuildThreads / 32;
constexpr int kBuildPer = 16;  // sorted positions a thread, a block's apart
constexpr int kBuildTile = kBuildThreads * kBuildPer;
constexpr int kBuildLane = kBuildPer * kBuildWarps / 32;  // counts a lane
constexpr int kThreads = 256;  // probe and fill
constexpr int kWarps = kThreads / 32;
constexpr int kProbeRounds = 4;  // probe rows a thread, a block's apart
constexpr int kProbeTile = kThreads * kProbeRounds;
static_assert(kProbeRounds * kWarps <= 32, "one warp scans a tile's counts");
constexpr int kFillPer = 4;  // output slots a thread, a block's apart
constexpr int kFillTile = kThreads * kFillPer;
constexpr int kFillRows = 1024;  // probe rows a fill tile stages at once

// The first i in [0, n) with a[i] >= x (n when none), by the 32 lanes of
// a warp together: each round probes 32 evenly spaced entries of the
// range left, so 2^18 entries take four rounds of one load a lane.
__device__ int64_t warp_lower_bound(const int64_t* __restrict__ a,
                                    int64_t n, int64_t x) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = n;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + lane * step;
    const unsigned below = __ballot_sync(kFull, p < hi && a[p] < x);
    const int c = __popc(below);  // lanes 0 .. c - 1: a[p] < x
    if (c == 0) break;            // a[lo] >= x
    const int64_t next = lo + (int64_t)c * step;  // a[next] >= x or past
    lo = lo + (int64_t)(c - 1) * step + 1;
    if (next < hi) hi = next;
  }
  return lo;
}

// The scratch words of one call, in order.
struct Layout {
  int64_t ce, comp, incl, rec, sbase, zero, tiles_b, tiles_p, words;
  Layout(int64_t n_rows, int64_t ng, int64_t nb, int n_shards) {
    tiles_b = n_rows > 0 ? (n_rows + kBuildTile - 1) / kBuildTile : 1;
    tiles_p = (nb + kProbeTile - 1) / kProbeTile;
    ce = 0;
    comp = ce + (ng > 0 ? ng : 1);
    incl = comp + (n_rows > 0 ? n_rows : 1);
    rec = (incl + nb + 1) & ~(int64_t)1;  // 16-byte records
    sbase = rec + 2 * nb;
    zero = sbase + n_shards + 1;  // two tile counters, the look-back words
    words = zero + 2 + tiles_b + tiles_p;
  }
};

// Sorted position q of a tile is (k, warp, lane) = (q / kBuildThreads,
// q % kBuildThreads / 32, q % 32): every load and store of a warp is
// contiguous, and a warp's valid flags of one k are one ballot.
__global__ void __launch_bounds__(kBuildThreads)
    ce_build(const int64_t* __restrict__ order,
             const uint8_t* __restrict__ bvalid, int64_t n_rows,
             const int64_t* __restrict__ ends, int64_t ng, int64_t tiles,
             unsigned long long* status, unsigned long long* ctr,
             int64_t* __restrict__ comp, int64_t* __restrict__ ce) {
  __shared__ unsigned s_mask[kBuildPer * kBuildWarps];  // (k, warp)
  __shared__ int s_off[kBuildPer * kBuildWarps];  // valid before (k, warp)
  __shared__ int64_t s_tile, s_prefix, s_g[2];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = (int64_t)atomicAdd(ctr, 1ULL);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t t0 = tile * kBuildTile;
  const int64_t rest = n_rows - t0;
  const int len = (int)(rest < 0 ? 0 : rest < kBuildTile ? rest : kBuildTile);
  if (warp < 2) {  // the groups whose last position lies in the tile
    const int64_t g = warp == 1 && tile == tiles - 1
                          ? ng
                          : warp_lower_bound(ends, ng, t0 + warp * len);
    if (lane == 0) s_g[warp] = g;
  }
  int64_t o[kBuildPer];
#pragma unroll
  for (int k = 0; k < kBuildPer; ++k) {
    const int q = k * kBuildThreads + t;
    o[k] = q < len ? order[t0 + q] : 0;
  }
  unsigned mask[kBuildPer];
#pragma unroll
  for (int k = 0; k < kBuildPer; ++k) {
    const int q = k * kBuildThreads + t;
    mask[k] = __ballot_sync(kFull, q < len && bvalid[o[k]]);
    if (lane == 0) s_mask[k * kBuildWarps + warp] = mask[k];
  }
  __syncthreads();
  if (warp == 0) {  // the tile's counts in (k, warp) order, kBuildLane a lane
    int c[kBuildLane], sum = 0;
#pragma unroll
    for (int e = 0; e < kBuildLane; ++e) {
      c[e] = __popc(s_mask[lane * kBuildLane + e]);
      sum += c[e];
    }
    int inc = sum;
#pragma unroll
    for (int o2 = 1; o2 < 32; o2 <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, o2);
      if (lane >= o2) inc += y;
    }
    const int agg = __shfl_sync(kFull, inc, 31);
    const int64_t prefix = look_back(status, tile, agg);
    int run = inc - sum;
#pragma unroll
    for (int e = 0; e < kBuildLane; ++e) {
      s_off[lane * kBuildLane + e] = run;
      run += c[e];
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const int64_t prefix = s_prefix;
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int k = 0; k < kBuildPer; ++k)
    if ((mask[k] >> lane) & 1)
      comp[prefix + s_off[k * kBuildWarps + warp] +
           __popc(mask[k] & below)] = o[k];
  for (int64_t g = s_g[0] + t; g < s_g[1]; g += kBuildThreads) {
    int64_t v = prefix;  // no position in the tile (n_rows = 0)
    if (len > 0) {
      int64_t e = ends[g] - t0;  // >= 0: its end is at or past t0
      if (e >= len) e = len - 1;
      const int q = (int)e, slot = q / 32 % kBuildWarps + q / kBuildThreads
                                       * kBuildWarps;
      const unsigned upto = 0xFFFFFFFFu >> (31 - q % 32);
      v += s_off[slot] + __popc(s_mask[slot] & upto);
    }
    ce[g] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
    ce_probe(KeySet K, const uint8_t* __restrict__ pvalid, int64_t nb,
             const int32_t* __restrict__ tbl, int64_t tbl_len, int64_t lo,
             int64_t hi, int64_t ng, const int64_t* __restrict__ ce,
             int outer, int64_t nbl, int n_shards,
             unsigned long long* status, unsigned long long* ctr,
             int64_t* __restrict__ incl, longlong2* __restrict__ rec,
             int64_t* __restrict__ sbase) {
  __shared__ int64_t s_cnt[kProbeRounds * kWarps];
  __shared__ int64_t s_tile, s_prefix;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t == 0) s_tile = (int64_t)atomicAdd(ctr, 1ULL);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t t0 = tile * kProbeTile;
  int64_t cnt[kProbeRounds], st[kProbeRounds], m[kProbeRounds],
      winc[kProbeRounds];
#pragma unroll
  for (int r = 0; r < kProbeRounds; ++r) {
    const int64_t i = t0 + r * kThreads + t;
    int64_t key = 0, g = -1;
    const bool ok = i < nb && pvalid[i];
    if (ok && probe_key(K, i, &key)) {
      g = table_lookup(tbl, tbl_len, lo, hi, key);
      if (g >= ng) g = -1;
    }
    st[r] = g > 0 ? ce[g - 1] : 0;
    m[r] = g >= 0 ? ce[g] - st[r] : 0;
    cnt[r] = outer ? (ok ? (m[r] > 1 ? m[r] : 1) : 0) : m[r];
    int64_t x = cnt[r];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = (int64_t)__shfl_up_sync(kFull, (long long)x, o);
      if (lane >= o) x += y;
    }
    winc[r] = x;
    if (lane == 31) s_cnt[r * kWarps + warp] = x;
  }
  __syncthreads();
  if (warp == 0) {  // the tile's rows in order: (round, warp, lane)
    const int64_t c = lane < kProbeRounds * kWarps ? s_cnt[lane] : 0;
    int64_t x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int64_t y = (int64_t)__shfl_up_sync(kFull, (long long)x, o);
      if (lane >= o) x += y;
    }
    const int64_t agg = (int64_t)__shfl_sync(kFull, (long long)x, 31);
    const int64_t prefix = look_back(status, tile, agg);
    if (lane < kProbeRounds * kWarps) s_cnt[lane] = x - c;
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kProbeRounds; ++r) {
    const int64_t i = t0 + r * kThreads + t;
    if (i >= nb) break;
    const int64_t e = s_prefix + s_cnt[r * kWarps + warp] + winc[r];
    incl[i] = e;
    rec[i] = make_longlong2(st[r], m[r]);
    if (i % nbl == 0) sbase[i / nbl] = e - cnt[r];
    if (i == nb - 1) sbase[n_shards] = e;
  }
}

// One lane of W-byte values gathered at the kFillPer slots' rows (the
// probe row or the build row by side; slot k of the thread is o0 + k *
// kThreads, nk of them in the bucket), NULL flags or-ed with "unmatched"
// on the build side: every load goes out before the stores.
template <int W>
__device__ __forceinline__ void fill_lane(const BlockLanes& L, int l,
                                          int64_t o0, int nk,
                                          const int64_t (&row)[kFillPer],
                                          unsigned miss) {
  using T = typename Elem<W>::T;
  const T* src = (const T*)L.vals[l];
  const uint8_t* nulls = L.nulls[l];
  T* dst = (T*)L.out_vals[l];
  uint8_t* dn = L.out_nulls[l];
  T v[kFillPer];
  uint8_t nl[kFillPer];
#pragma unroll
  for (int k = 0; k < kFillPer; ++k) v[k] = k < nk ? __ldg(src + row[k]) : T(0);
#pragma unroll
  for (int k = 0; k < kFillPer; ++k)
    nl[k] = nulls && k < nk ? __ldg(nulls + row[k]) : 0;
#pragma unroll
  for (int k = 0; k < kFillPer; ++k) {
    if (k >= nk) break;
    dst[o0 + k * kThreads] = v[k];
    dn[o0 + k * kThreads] = (nl[k] || ((miss >> k) & 1)) ? 1 : 0;
  }
}

__device__ __forceinline__ void fill_lane_any(
    const BlockLanes& L, int l, int64_t o0, int nk,
    const int64_t (&row)[kFillPer], unsigned miss) {
  switch (L.width[l]) {
    case 8: fill_lane<8>(L, l, o0, nk, row, miss); break;
    case 4: fill_lane<4>(L, l, o0, nk, row, miss); break;
    case 2: fill_lane<2>(L, l, o0, nk, row, miss); break;
    default: fill_lane<1>(L, l, o0, nk, row, miss); break;
  }
}

__global__ void __launch_bounds__(kThreads, 4)
    ce_fill(const int64_t* __restrict__ incl,
            const longlong2* __restrict__ rec,
            const int64_t* __restrict__ sbase,
            const int64_t* __restrict__ comp, int64_t nbl, int64_t ob,
            const __grid_constant__ GatherLanes G,
            uint8_t* __restrict__ valid_out) {
  __shared__ int64_t s_e[kFillRows + 1];  // s_e[1 + i]: row c0 + i's end
  __shared__ longlong2 s_rec[kFillRows];
  __shared__ int64_t s_p[2];
  __shared__ BlockLanes L;
  load_lanes(L, G);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t s = blockIdx.y, r0 = s * nbl;
  const int64_t j0 = (int64_t)blockIdx.x * kFillTile;
  const int64_t j1 = j0 + kFillTile < ob ? j0 + kFillTile : ob;
  const int64_t base = sbase[s], tot = sbase[s + 1] - base;
  // live slots [j0, live), then the invalid ones [max(j0, live), j1)
  const int64_t live = tot < j0 ? j0 : tot < j1 ? tot : j1;
  // thread t: slots j0 + t + k * kThreads of the shard's bucket, k < nk
  const int64_t first = j0 + t;
  const int nk = first >= j1 ? 0 : (int)((j1 - first + kThreads - 1) /
                                         kThreads);
  int64_t prow[kFillPer], brow[kFillPer];
  unsigned valid = 0, mt = 0;
#pragma unroll
  for (int k = 0; k < kFillPer; ++k) {
    prow[k] = r0;  // invalid slots: the shard's first row, build row 0
    brow[k] = 0;
  }
  if (j0 < live) {
    if (warp < 2) {  // the rows of the tile's first and last live slot
      const int64_t j = base + (warp == 0 ? j0 : live - 1);
      const int64_t p = r0 + warp_lower_bound(incl + r0, nbl, j + 1);
      if (lane == 0) s_p[warp] = p;
    }
    __syncthreads();
    const int64_t pa = s_p[0], pb = s_p[1];
    for (int64_t c0 = pa; c0 <= pb; c0 += kFillRows) {
      const int cn = (int)(pb - c0 + 1 < kFillRows ? pb - c0 + 1 : kFillRows);
      if (t == 0) s_e[0] = c0 > 0 ? incl[c0 - 1] : 0;
      for (int i = t; i < cn; i += kThreads) {
        s_e[1 + i] = incl[c0 + i];
        s_rec[i] = rec[c0 + i];
      }
      __syncthreads();
      const int64_t e_lo = s_e[0], e_hi = s_e[cn];  // the chunk's slots
#pragma unroll
      for (int k = 0; k < kFillPer; ++k) {
        const int64_t jj = first + k * kThreads;
        const int64_t j = base + jj;
        if (jj >= live || j < e_lo || j >= e_hi) continue;
        int a = 0, b = cn - 1;  // the first row of the chunk ending past j
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (s_e[1 + mid] > j) b = mid;
          else a = mid + 1;
        }
        const int64_t kk = j - s_e[a];
        const longlong2 sm = s_rec[a];
        prow[k] = c0 + a;
        valid |= 1u << k;
        if (kk < sm.y) {
          mt |= 1u << k;
          brow[k] = sm.x + kk;  // its place in comp, read below
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < kFillPer; ++k)
      if ((mt >> k) & 1) brow[k] = comp[brow[k]];
  }
  const int64_t o0 = s * ob + first;
  if (valid_out) {
#pragma unroll
    for (int k = 0; k < kFillPer; ++k)
      if (k < nk) valid_out[o0 + k * kThreads] = (valid >> k) & 1;
  }
  for (int l = 0; l < G.n; ++l) {
    if (L.side[l]) fill_lane_any(L, l, o0, nk, brow, ~mt);
    else fill_lane_any(L, l, o0, nk, prow, 0u);
  }
}

}  // namespace

// int64 words of one call's scratch: ce, comp, the probe rows' ends and
// records, the shard bases and the memset's counters and look-back words.
TS_API int64_t hk8_scratch_words(int64_t n_rows, int64_t ng, int64_t nb,
                                 int n_shards) {
  return Layout(n_rows, ng, nb, n_shards).words;
}

// The expansion into valid_out uint8[n_shards * ob] (ob slots a shard;
// n_shards divides nb) and the lanes of n_groups gather tables (the
// first writes valid_out, each further one is one more fill launch).
TS_API int hk8_csr_expand(const int64_t* order, int64_t nbb, int64_t n_rows,
                          const int64_t* ends, int64_t ng,
                          const uint8_t* bvalid, const int32_t* tbl,
                          int64_t tbl_len, int64_t lo, int64_t hi,
                          const KeySet* keys, const uint8_t* pvalid,
                          int64_t nb, int outer, int64_t ob, int n_shards,
                          int64_t* scratch, const GatherLanes* lanes,
                          int n_groups, uint8_t* valid_out,
                          cudaStream_t st) {
  if (nbb < 1 || nb < 1 || ob < 1 || n_rows < 0 || n_rows > nbb || ng < 0 ||
      keys->n < 1 || keys->n > kMaxKeys || n_shards < 1 ||
      n_shards > 65535 || nb % n_shards || n_groups < 1)
    return -1;
  for (int q = 0; q < n_groups; ++q)
    if (!gather_ok(&lanes[q])) return -1;
  const Layout L(n_rows, ng, nb, n_shards);
  auto* ctr = (unsigned long long*)(scratch + L.zero);
  cudaMemsetAsync(ctr, 0, 8 * (L.words - L.zero), st);
  LAUNCH(ce_build, (unsigned)L.tiles_b, kBuildThreads, 0, st, order, bvalid,
         n_rows, ends, ng, L.tiles_b, ctr + 2, ctr, scratch + L.comp,
         scratch + L.ce);
  LAUNCH(ce_probe, (unsigned)L.tiles_p, kThreads, 0, st, *keys, pvalid,
         nb, tbl, tbl_len, lo, hi, ng, (const int64_t*)(scratch + L.ce),
         outer, nb / n_shards, n_shards, ctr + 2 + L.tiles_b, ctr + 1,
         scratch + L.incl, (longlong2*)(scratch + L.rec),
         scratch + L.sbase);
  const dim3 grid((unsigned)((ob + kFillTile - 1) / kFillTile),
                  (unsigned)n_shards);
  for (int q = 0; q < n_groups; ++q)
    LAUNCH(ce_fill, grid, kThreads, 0, st, (const int64_t*)(scratch + L.incl),
           (const longlong2*)(scratch + L.rec),
           (const int64_t*)(scratch + L.sbase),
           (const int64_t*)(scratch + L.comp), nb / n_shards, ob, lanes[q],
           q == 0 ? valid_out : nullptr);
  return (int)cudaGetLastError();
}
