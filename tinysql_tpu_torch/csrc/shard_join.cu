// HK12 shard_probe: the per-partition probe of the mesh tier's unique
// join.
//
// Replaces the body of tinysql_tpu/ops/shardops.py:271
// _local_unique_join_kernel, run per shard under shard_map: sort the
// shard's build block by (key with dead slots at the sentinel, liveness,
// slot) and searchsorted every probe slot of the shard's probe block.
// The host scatter (shardops._Partitioned) lays both sides out as
// [n][cap] blocks; the sort is HK4 (lex_order.cu) over
// (shard, key order, dead, slot) in one launch, so perm[s * cap_b + r] is
// the r-th slot of shard s's sorted run and its key lane is
//   key(s, r) = bord[perm[s * cap_b + r]]   (ascending in r).
// This kernel finishes the join: per probe slot i of shard s = i / cap_p,
// lo = the first r whose key is >= the probe key's, then
//   hit  = pid[i] >= 0 && lo < cap_b && key(s, lo) == the probe key
//          && that slot is live (bid >= 0) && the key is not NaN
//   brow = hit ? bid[that slot] : -1
// exactly the reference's (hit, where(hit, bid[sperm[loc]], -1)); the
// first equal position is the lowest slot among equal keys, as HK4's
// stable sort left them.
//
// Keys are int64 or float64 (is_float), compared as the uint64 order
// keys HK4 sorted on: int64 through the sign-bit flip, float64 through
// its monotone bits after -0.0 folds into +0.0; dead build slots carry
// the sentinel of int64 max / +inf.  bord is that build order lane.
//
// Member mode (brow null): hit only, the membership bit of K25's
// partitioned semi / anti join (tinysql_tpu/ops/shardops.py:380
// _local_member_kernel); the host applies the NOT IN ladder.
//
// Count mode (hk12_shard_count): the match count of every probe row
// against ONE replicated build run sorted ascending, hi - lo of the two
// searchsorted bounds (0 for an invalid row), and each shard's sum of
// them as a partial table [n][1][1] for HK11: K26's broadcast join
// counts (tinysql_tpu/parallel/dist.py:197 make_broadcast_join_counts).
//
// Bound: bytes.  Each probe slot reads its key and id and writes hit and
// brow (25 B; member mode 17 B), the build run is read once (bord and
// perm: 16 B a slot) and bid at the hit slots (probe mode; member mode
// reads it only for a key at the sentinel); count mode reads a key and a valid
// byte and writes a count (17 B) per probe row, the build run once.
// What the card spends is requests for dependent loads: a binary search
// over 2^19 slots through perm is 19 levels of two random loads each.
//
// Design: a staged search.  Block (x, s) probes slots of shard s only,
// so it first stages shard s's search index in shared memory: the whole
// run's keys when the run fits the block's share of the probe, else
// every S-th key (index_stride: at most half that share, at most kIndex
// keys).  A block stages its index for itself, so an index larger than
// its share of the probe costs more loads than it saves.  A probe then
// searches the index in shared memory and finishes with log2(S) levels
// in the window of S run positions between two index keys.  The search
// is bounded by the shard's live slots to within a window, from the
// index alone: U = nu * S for nu the first index key at or past the
// sentinel, so every probe key below the sentinel has its first position
// in [0, U] and a key at the sentinel (int64 max, +inf) lands on the
// first position of that key, where live slots sort before the dead
// ones.  Padding slots and NaN keys skip the search; bid is read only
// where the key matched (member mode: only for a key at the sentinel,
// since a slot whose key is below it is live).  In the window the key
// lane is read through perm (two dependent loads a level) rather than
// through a key lane gathered contiguous by a pre-pass, which costs a
// pass over the build side (twice the probe at NOT IN's member shape).
// A thread takes kRows slots at once and puts every level's loads (the
// index's in shared memory, then the window's) in flight for all of them
// together, and a block stages its index with all of a thread's loads in
// flight.
//
// Count mode: the replicated run is contiguous, so the index holds every
// S-th key of it (5,860 keys at 1.5M, S = 256); the lower bound takes
// the index and log2(S) window levels, the upper bound gallops from it
// (lo + 1, lo + 2, lo + 4, ... then a binary search of the last gap): a
// key with few duplicates costs a few loads, a skewed key O(log m).  A
// block's sum is reduced with warp shuffles and added to its shard's
// partial once (integer atomics, exact in any order): the same bytes on
// every run.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kIndex = 8192;  // keys of the shared-memory index (64 KB)
constexpr int kStage = (int)(kIndex / kThreads);  // index keys a thread
constexpr int kRows = 4;  // probe slots a thread, their loads in flight
constexpr int kBlocks = 264;  // two blocks an SM (132 SMs)

// The index's stride S, a power of two: 1 (the whole run) when the run
// has at most cap slots, cap the slots a block probes rounded up to a
// power of two (at most kIndex); else the least S whose ceil(len / S)
// keys are at most cap / 2 (probe and member modes, whose blocks stage
// through perm, two loads a key) or cap (count mode).
inline int64_t index_stride(int64_t len, int64_t per_block, bool half) {
  int64_t cap = kThreads;
  while (cap < per_block && cap < kIndex) cap <<= 1;
  if (len <= cap) return 1;
  const int64_t keys = half ? cap / 2 : cap;
  int64_t s = 1;
  while ((len + s - 1) / s > keys) s <<= 1;
  return s;
}

__device__ __forceinline__ unsigned long long probe_order(int64_t raw,
                                                          int is_float) {
  if (!is_float) return (unsigned long long)raw ^ kSign;
  const double x = bits_to_f64(raw) + 0.0;  // -0.0 -> +0.0
  const long long b = f64_to_bits(x);
  return b < 0 ? ~(unsigned long long)b : (unsigned long long)b ^ kSign;
}

// t[r] = the first index of idx[0, n) >= x[r] (n when none), for kRows
// keys at once: a branch-free bisection whose steps depend on n alone,
// so every level's shared-memory loads go out together.
template <class T>
__device__ __forceinline__ void index_lower_bound(const T* idx, int64_t n,
                                                  const T (&x)[kRows],
                                                  int64_t (&t)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) t[r] = 0;
  if (n == 0) return;
  int64_t len = n;
  while (len > 1) {
    const int64_t half = len >> 1;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      t[r] = idx[t[r] + half] < x[r] ? t[r] + half : t[r];
    len -= half;
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) t[r] += idx[t[r]] < x[r] ? 1 : 0;
}

// Stage shard s's index, idx[t] = key(t * S) for t < nt: two rounds of
// loads (perm, then bord) with every key of a thread in flight.
__device__ __forceinline__ void stage_index(unsigned long long* idx,
                                            int64_t nt, int64_t S,
                                            const int64_t* __restrict__ bord,
                                            const int64_t* __restrict__ run) {
  int64_t j[kStage];
#pragma unroll
  for (int q = 0; q < kStage; ++q) {
    const int64_t t = threadIdx.x + (int64_t)q * kThreads;
    j[q] = t < nt ? run[t * S] : 0;
  }
#pragma unroll
  for (int q = 0; q < kStage; ++q) {
    const int64_t t = threadIdx.x + (int64_t)q * kThreads;
    if (t < nt) idx[t] = (unsigned long long)bord[j[q]];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 2)
    sp_probe(const int64_t* __restrict__ pk, const int64_t* __restrict__ pid,
             int64_t cap_p, const int64_t* __restrict__ bord,
             const int64_t* __restrict__ bid,
             const int64_t* __restrict__ perm, int64_t cap_b, int64_t S,
             int is_float, uint8_t* __restrict__ hit,
             int64_t* __restrict__ brow) {
  DYN_SMEM(smem);
  unsigned long long* idx = reinterpret_cast<unsigned long long*>(smem);
  const int64_t s = blockIdx.y;
  const int64_t nt = (cap_b + S - 1) / S;
  const int64_t* run = perm + s * cap_b;  // shard s's run
  const unsigned long long sentinel =
      is_float ? 0xFFF0000000000000ULL : ~0ULL;  // order of +inf / max
  stage_index(idx, nt, S, bord, run);
  // U, the search's end: nu * S for nu the first index key at or past the
  // sentinel (the run's end when there is none), so every live slot lies
  // below it and at most S - 1 dead ones do
  int64_t nu = 0;
  {
    int64_t hi = nt;
    while (nu < hi) {
      const int64_t m = (nu + hi) >> 1;
      if (idx[m] < sentinel) nu = m + 1;
      else hi = m;
    }
  }
  const int64_t U = nu * S < cap_b ? nu * S : cap_b;
  int levels = 0;  // a window holds at most S positions
  while ((1LL << levels) < S) ++levels;
  const int64_t step = (int64_t)gridDim.x * kThreads * kRows;
  for (int64_t i0 = (int64_t)blockIdx.x * kThreads * kRows; i0 < cap_p;
       i0 += step) {
    int64_t g[kRows], raw[kRows];
    bool go[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t i = i0 + r * kThreads + threadIdx.x;
      g[r] = i < cap_p ? s * cap_p + i : -1;
      go[r] = g[r] >= 0 && pid[g[r]] >= 0;
      raw[r] = g[r] >= 0 ? pk[g[r]] : 0;
    }
    unsigned long long x[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      go[r] = go[r] && !(is_float && is_nan_f64(bits_to_f64(raw[r])));
      x[r] = probe_order(raw[r], is_float);
    }
    int64_t t[kRows];
    index_lower_bound(idx, nu, x, t);
    // bisect (a, b]: key(a) < x (idx[t - 1]), b the first candidate
    // (idx[t], or U); kb = key(b) where known, jb its slot where read
    int64_t a[kRows], b[kRows], jb[kRows];
    unsigned long long kb[kRows];
    bool known[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t tr = t[r];
      a[r] = tr == 0 ? -1 : (tr - 1) * S;
      b[r] = tr == 0 ? 0 : (tr * S < U ? tr * S : U);
      known[r] = b[r] == tr * S && tr < nt;
      kb[r] = known[r] ? idx[tr] : 0;
      jb[r] = -1;
      if (!go[r]) a[r] = b[r];  // nothing to search
    }
    for (int lev = 0; lev < levels; ++lev) {
      int64_t mid[kRows], jm[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        mid[r] = (a[r] + b[r]) >> 1;
        jm[r] = b[r] - a[r] > 1 ? run[mid[r]] : -1;
      }
      unsigned long long km[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        km[r] = jm[r] >= 0 ? (unsigned long long)bord[jm[r]] : 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (jm[r] < 0) continue;
        if (km[r] < x[r]) {
          a[r] = mid[r];
        } else {
          b[r] = mid[r];
          kb[r] = km[r];
          jb[r] = jm[r];
          known[r] = true;
        }
      }
    }
    // the candidate at b: its key where the search did not read it, then
    // its slot and id where the key matched
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      go[r] = go[r] && b[r] < cap_b;
      if (go[r] && !known[r]) jb[r] = run[b[r]];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (go[r] && !known[r]) kb[r] = (unsigned long long)bord[jb[r]];
    // a key below the sentinel is a live slot's: member mode reads bid
    // only for a key at the sentinel (live int64 max / +inf, or dead)
    bool need[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      go[r] = go[r] && kb[r] == x[r];
      need[r] = go[r] && (brow || x[r] == sentinel);
      if (need[r] && jb[r] < 0) jb[r] = run[b[r]];
    }
    int64_t id[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      id[r] = need[r] ? bid[jb[r]] : go[r] ? 0 : -1;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (g[r] < 0) continue;
      const bool h = id[r] >= 0;
      hit[g[r]] = h ? 1 : 0;
      if (brow) brow[g[r]] = h ? id[r] : -1;
    }
  }
}

// block (x, shard): rows of shard blockIdx.y, kRows a thread at once;
// each block adds its sum to the shard's partial once
__global__ void __launch_bounds__(kThreads, 2)
    sp_count(const int64_t* __restrict__ lk,
             const uint8_t* __restrict__ lvalid, int64_t rows,
             const int64_t* __restrict__ rs, int64_t nr, int64_t S,
             int64_t* __restrict__ counts, int64_t* __restrict__ partial) {
  DYN_SMEM(smem);
  int64_t* idx = reinterpret_cast<int64_t*>(smem);
  __shared__ int64_t s_warp[kWarps];
  const int64_t nt = (nr + S - 1) / S;
#pragma unroll
  for (int q = 0; q < kStage; ++q) {
    const int64_t t = threadIdx.x + (int64_t)q * kThreads;
    if (t < nt) idx[t] = rs[t * S];
  }
  __syncthreads();
  int levels = 0;
  while ((1LL << levels) < S) ++levels;
  const int64_t s = blockIdx.y;
  int64_t acc = 0;
  const int64_t step = (int64_t)gridDim.x * kThreads * kRows;
  for (int64_t i0 = (int64_t)blockIdx.x * kThreads * kRows; i0 < rows;
       i0 += step) {
    int64_t g[kRows], x[kRows];
    bool go[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t i = i0 + r * kThreads + threadIdx.x;
      g[r] = i < rows ? s * rows + i : -1;
      go[r] = g[r] >= 0 && lvalid[g[r]];
      x[r] = g[r] >= 0 ? lk[g[r]] : 0;
    }
    int64_t t[kRows];
    index_lower_bound(idx, nt, x, t);
    // the lower bound: bisect (a, b] as the probe mode does
    int64_t a[kRows], b[kRows], kb[kRows];
    bool known[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int64_t tr = t[r];
      a[r] = tr == 0 ? -1 : (tr - 1) * S;
      b[r] = tr == 0 ? 0 : (tr * S < nr ? tr * S : nr);
      known[r] = b[r] == tr * S && tr < nt;
      kb[r] = known[r] ? idx[tr] : 0;
      if (!go[r]) a[r] = b[r];
    }
    for (int lev = 0; lev < levels; ++lev) {
      int64_t mid[kRows], km[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        mid[r] = (a[r] + b[r]) >> 1;
        km[r] = b[r] - a[r] > 1 ? rs[mid[r]] : 0;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (b[r] - a[r] <= 1) continue;
        if (km[r] < x[r]) {
          a[r] = mid[r];
        } else {
          b[r] = mid[r];
          kb[r] = km[r];
          known[r] = true;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      go[r] = go[r] && b[r] < nr;
      if (go[r] && !known[r]) kb[r] = rs[b[r]];
    }
    // the upper bound: gallop from b over equal keys (b + 1, b + 2,
    // b + 4, ...), then bisect the last gap; the first step's loads
    // go out together
    int64_t nx[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      go[r] = go[r] && kb[r] == x[r];
      nx[r] = go[r] && b[r] + 1 < nr ? rs[b[r] + 1] : 0;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      int64_t c = 0;
      if (go[r]) {
        const int64_t lo = b[r];
        int64_t lo_eq = lo, e = lo + 1;  // rs[lo_eq] == x
        if (e < nr && nx[r] == x[r]) {
          int64_t stp = 2;
          lo_eq = e;
          e = lo + stp;
          while (e < nr && rs[e] == x[r]) {
            lo_eq = e;
            stp <<= 1;
            e = lo + stp;
          }
          if (e > nr) e = nr;
          while (e - lo_eq > 1) {  // e: past the last equal key
            const int64_t mid = lo_eq + ((e - lo_eq) >> 1);
            if (rs[mid] == x[r]) lo_eq = mid;
            else e = mid;
          }
        }
        c = e - lo;
      }
      if (g[r] >= 0) counts[g[r]] = c;
      acc += c;
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc += (int64_t)__shfl_xor_sync(kFull, (long long)acc, o);
  if (lane == 0) s_warp[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    int64_t v = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      v += (int64_t)__shfl_xor_sync(kFull, (long long)v, o);
    if (lane == 0 && v) atomic_add_i64(&partial[s], v);
  }
}

// blocks a shard: one for each kThreads * kRows slots, at most kBlocks
// in all
inline unsigned shard_blocks(int64_t per_shard, int n) {
  int64_t bx = (per_shard + (int64_t)kThreads * kRows - 1) /
               ((int64_t)kThreads * kRows);
  const int64_t cap = kBlocks / n > 1 ? kBlocks / n : 1;
  if (bx > cap) bx = cap;
  return (unsigned)(bx < 1 ? 1 : bx);
}

}  // namespace

// pk, pid: int64 [n * cap_p] (pk holds float64 bits when is_float);
// bord, bid, perm: int64 [n * cap_b]; hit: bool, brow: int64 [n * cap_p]
// (brow null: member mode)
TS_API int hk12_shard_probe(const int64_t* pk, const int64_t* pid,
                            int64_t cap_p, const int64_t* bord,
                            const int64_t* bid, const int64_t* perm,
                            int64_t cap_b, int n, int is_float, uint8_t* hit,
                            int64_t* brow, cudaStream_t st) {
  if (n < 1 || n > 65535 || cap_p < 1 || cap_b < 1) return -1;
  dim3 grid(shard_blocks(cap_p, n), (unsigned)n);
  const int64_t S = index_stride(cap_b, (cap_p + grid.x - 1) / grid.x, true);
  const int64_t nt = (cap_b + S - 1) / S;
  cudaFuncSetAttribute(sp_probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)(kIndex * 8));
  LAUNCH(sp_probe, grid, kThreads, (size_t)nt * 8, st, pk, pid, cap_p, bord,
         bid, perm, cap_b, S, is_float, hit, brow);
  return (int)cudaGetLastError();
}

// lk: int64 [n * rows], lvalid: bool [n * rows], rs: int64 [nr] sorted
// ascending; counts: int64 [n * rows], partial: int64 [n] (zeroed here)
TS_API int hk12_shard_count(const int64_t* lk, const uint8_t* lvalid,
                            int64_t rows, int n, const int64_t* rs,
                            int64_t nr, int64_t* counts, int64_t* partial,
                            cudaStream_t st) {
  if (n < 1 || n > 65535 || rows < 1 || nr < 0) return -1;
  dim3 grid(shard_blocks(rows, n), (unsigned)n);
  const int64_t S = index_stride(nr, (rows + grid.x - 1) / grid.x, false);
  const int64_t nt = (nr + S - 1) / S;
  cudaFuncSetAttribute(sp_count, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)(kIndex * 8));
  cudaMemsetAsync(partial, 0, (size_t)n * sizeof(int64_t), st);
  LAUNCH(sp_count, grid, kThreads, (size_t)nt * 8, st, lk, lvalid, rows, rs,
         nr, S, counts, partial);
  return (int)cudaGetLastError();
}
